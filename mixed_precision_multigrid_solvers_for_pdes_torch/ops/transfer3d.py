"""Plain PyTorch 3D intergrid transfers: 27-point full-weighting restriction
and trilinear prolongation.

Counterpart of ``restrict3d`` (full weighting, ``boundary='zero'``) and
``prolong3d`` in ``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/
transfer3d.py``, written with strided slices of the logical arrays and
summed in the order of the JAX package's CPU path (parity planes for the
restriction, axis-by-axis z, y, x for the prolongation). The fine grid
relates to the coarse one as nf = 2*(nc - 1) + 1 along each axis. These are
the plain twins that kernels F and G (``ops/cuda_kernels/transfer3d.py``)
are held against. Injection and the 'reflect' boundary are ROADMAP item 13.
"""

from __future__ import annotations

import itertools

import torch


def _restrict_terms():
    """(weight, (dx, dy, dz)) of the 27 fine nodes of a coarse node's window
    in the JAX package's summation order: the parity patterns in (x, y, z)
    binary order, weight 8 / 2^(odd axes), so the centre (8) first; on the
    odd axes the offsets run over (+1, -1)^(odd axes), first axis slowest."""
    terms = []
    for par in itertools.product((0, 1), repeat=3):
        odd = [ax for ax in range(3) if par[ax]]
        for signs in itertools.product((1, -1), repeat=len(odd)):
            d = [0, 0, 0]
            for ax, sgn in zip(odd, signs):
                d[ax] = sgn
            terms.append((8.0 / 2 ** len(odd), tuple(d)))
    return tuple(terms)


RESTRICT_TERMS = _restrict_terms()


def restrict3d(rf: torch.Tensor, ncx: int, ncy: int, ncz: int, *,
               method: str = "full_weighting", boundary: str = "zero",
               dtype=None) -> torch.Tensor:
    """Fine (nfx, nfy, nfz) -> coarse (ncx, ncy, ncz) full weighting,
    (1,2,1)^3/64 over the fine window around (2I, 2J, 2K), coarse shell
    zero."""
    if method != "full_weighting":
        raise NotImplementedError(
            f"3D restriction {method!r} is not ported yet (ROADMAP item 13)")
    if boundary != "zero":
        raise NotImplementedError(
            f"3D boundary {boundary!r} is not ported yet (ROADMAP item 13)")
    dtype = dtype or rf.dtype
    r = rf.to(dtype)
    nf = tuple(2 * (nc - 1) + 1 for nc in (ncx, ncy, ncz))
    if tuple(r.shape) != nf:
        raise ValueError(f"fine shape {tuple(r.shape)} does not coarsen to "
                         f"({ncx}, {ncy}, {ncz})")

    def win(d):  # fine[2I+dx, 2J+dy, 2K+dz] over the coarse interior
        return r[tuple(slice(2 + di, n - 2 + di, 2) for di, n in zip(d, nf))]

    acc = None
    for wgt, d in RESTRICT_TERMS:
        term = wgt * win(d)
        acc = term if acc is None else acc + term
    out = torch.zeros((ncx, ncy, ncz), dtype=dtype, device=r.device)
    out[1:-1, 1:-1, 1:-1] = acc / 64.0
    return out


def _refine_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation along ``axis``: n samples -> 2n - 1, the even
    entries copied, the odd ones the mean of their two neighbours."""
    n = a.shape[axis]
    shape = list(a.shape)
    shape[axis] = 2 * n - 1
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    even = [slice(None)] * a.dim()
    odd = [slice(None)] * a.dim()
    even[axis] = slice(0, None, 2)
    odd[axis] = slice(1, None, 2)
    out[tuple(even)] = a
    out[tuple(odd)] = 0.5 * (a.narrow(axis, 0, n - 1) + a.narrow(axis, 1,
                                                                 n - 1))
    return out


def prolong3d(ec: torch.Tensor, nfx: int, nfy: int, nfz: int, *,
              dtype=None) -> torch.Tensor:
    """Coarse (ncx, ncy, ncz) -> fine (nfx, nfy, nfz) trilinear
    interpolation, axis by axis: z, then y, then x."""
    dtype = dtype or ec.dtype
    c = ec.to(dtype)
    if (nfx, nfy, nfz) != tuple(2 * (n - 1) + 1 for n in c.shape):
        raise ValueError(f"coarse shape {tuple(c.shape)} does not refine to "
                         f"({nfx}, {nfy}, {nfz})")
    for axis in (2, 1, 0):
        c = _refine_axis(c, axis)
    return c
