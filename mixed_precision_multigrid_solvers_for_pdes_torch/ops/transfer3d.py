"""Plain PyTorch 3D intergrid transfers: 27-point full-weighting restriction
and trilinear prolongation.

Counterpart of ``restrict3d`` (full weighting and injection; boundaries
'zero' and 'reflect', periodic ``wrap``) and ``prolong3d`` in ``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/
transfer3d.py``, written with strided slices of the logical arrays and
summed in the order of the JAX package's CPU path (parity planes for the
restriction, axis-by-axis z, y, x for the prolongation). The fine grid
relates to the coarse one as nf = 2*(nc - 1) + 1 along each axis. These are
the plain twins that kernels F and G (``ops/cuda_kernels/transfer3d.py``)
are held against.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


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
               dtype=None, wrap=(False, False, False)) -> torch.Tensor:
    """Fine (nfx, nfy, nfz) -> coarse (ncx, ncy, ncz) restriction, in
    ``dtype`` (``rf`` is cast first, as the JAX package casts it).

    ``method``: 'full_weighting' ((1,2,1)^3/64 over the fine window around
    (2I, 2J, 2K), summed in ``RESTRICT_TERMS`` order) or 'injection' (the
    coincident fine node). ``boundary``: 'zero' leaves the coarse shell at
    zero (Dirichlet residuals); 'reflect' restricts onto the shell too,
    folding the out-of-domain window planes back onto the interior (plane
    -1 takes plane 1, plane nf takes plane nf-2; x first, then y, then z):
    the residual transfer of Neumann/Robin faces. ``wrap``: per-axis
    periodic flags; on a wrapped axis coarse node 0 is restricted too,
    reading its fine neighbour -1 as node nf-2, and the duplicate coarse
    node nc-1 is left to the level's sync (zero under 'zero', its computed
    value under 'reflect')."""
    if method not in ("full_weighting", "injection"):
        raise ValueError(f"unknown restriction {method!r}")
    if boundary not in ("zero", "reflect"):
        raise ValueError(f"unknown restriction boundary {boundary!r}")
    dtype = dtype or rf.dtype
    r = rf.to(dtype)
    nc = (ncx, ncy, ncz)
    nf = tuple(2 * (n - 1) + 1 for n in nc)
    if tuple(r.shape) != nf:
        raise ValueError(f"fine shape {tuple(r.shape)} does not coarsen to "
                         f"({ncx}, {ncy}, {ncz})")
    out = torch.zeros(nc, dtype=dtype, device=r.device)
    if boundary == "reflect" or any(wrap):
        # one ghost plane around the fine array, p[k + 1] = fine k: wrap
        # neighbours on a periodic axis, the reflection otherwise
        p = F.pad(r, (1, 1, 1, 1, 1, 1))
        for axis in range(3):
            if wrap[axis]:  # ghost -1 = fine nf-2, ghost nf = fine 1
                pairs = ((0, -3), (-1, 2))
            elif boundary == "reflect":  # ghost -1 = 1, ghost nf = nf-2
                pairs = ((0, 2), (-1, -3))
            else:
                continue
            for ghost, node in pairs:
                dst = [slice(None)] * axis + [ghost] + [slice(1, -1)] * (
                    2 - axis)
                src = dst[:axis] + [node] + dst[axis + 1:]
                p[tuple(dst)] = p[tuple(src)]
        r, inner, lo = p, out, 1  # every coarse node
    else:
        inner, lo = out[1:-1, 1:-1, 1:-1], 2  # coarse interior only

    def win(d):  # fine[2I+dx, 2J+dy, 2K+dz] for the coarse nodes in inner
        return r[tuple(slice(lo + di, lo + di + 2 * m - 1, 2)
                       for di, m in zip(d, inner.shape))]

    if method == "injection":
        inner[...] = win((0, 0, 0))
    else:
        acc = None
        for wgt, d in RESTRICT_TERMS:
            term = wgt * win(d)
            acc = term if acc is None else acc + term
        inner[...] = acc / 64.0
    if inner is out and boundary != "reflect":
        # the wrap path computed every coarse node: keep the core,
        # [0 or 1, nc - 1) per axis, and zero the rest
        core = torch.zeros(nc, dtype=torch.bool, device=out.device)
        core[tuple(slice(0 if w else 1, n - 1)
                   for w, n in zip(wrap, nc))] = True
        return torch.where(core, out, torch.zeros((), dtype=dtype,
                                                  device=out.device))
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
