"""Plain PyTorch intergrid transfers: full-weighting restriction and bilinear
prolongation.

Counterpart of ``restrict`` (full weighting; ``boundary='zero'`` and
``'inject'``) and ``prolong`` (bilinear) in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/transfer.py``, written
with strided slices of the logical arrays. The fine grid relates to the
coarse one as nf = 2*(nc - 1) + 1. Half weighting, injection restriction and
the 'reflect' boundary (Neumann/Robin rings) are ROADMAP item 7.
"""

from __future__ import annotations

import torch


def restrict(rf: torch.Tensor, ncx: int, ncy: int, *,
             method: str = "full_weighting", boundary: str = "zero",
             dtype=None) -> torch.Tensor:
    """Fine (nfx, nfy) -> coarse (ncx, ncy) full-weighting restriction.

    Coarse interior node (I, J) gets [1 2 1; 2 4 2; 1 2 1]/16 over the fine
    window around (2I, 2J), summed in the JAX package's CPU order (centre,
    then the four edge neighbours, then the four corners). ``boundary``:
    'zero' leaves the coarse ring at zero (residual transfers with Dirichlet
    rings); 'inject' copies the coincident fine nodes onto the ring (the FMG
    right-hand side).
    """
    if method != "full_weighting":
        raise NotImplementedError(
            f"restriction {method!r} is not ported yet (ROADMAP item 7)")
    if boundary not in ("zero", "inject"):
        raise NotImplementedError(
            f"boundary {boundary!r} is not ported yet (ROADMAP item 7)")
    dtype = dtype or rf.dtype
    r = rf.to(dtype)
    nfx, nfy = 2 * (ncx - 1) + 1, 2 * (ncy - 1) + 1
    if r.shape != (nfx, nfy):
        raise ValueError(f"fine shape {tuple(r.shape)} does not coarsen to "
                         f"({ncx}, {ncy})")

    def win(di, dj):  # fine[2I+di, 2J+dj] for coarse interior I, J
        return r[2 + di: nfx - 2 + di: 2, 2 + dj: nfy - 2 + dj: 2]

    out = torch.zeros((ncx, ncy), dtype=dtype, device=r.device)
    out[1:-1, 1:-1] = (
        4.0 * win(0, 0)
        + 2.0 * (win(1, 0) + win(-1, 0) + win(0, 1) + win(0, -1))
        + (win(1, 1) + win(-1, 1) + win(1, -1) + win(-1, -1))
    ) / 16.0
    if boundary == "inject":
        out[0, :] = r[0, ::2]
        out[-1, :] = r[-1, ::2]
        out[:, 0] = r[::2, 0]
        out[:, -1] = r[::2, -1]
    return out


def prolong(ec: torch.Tensor, nfx: int, nfy: int, *,
            method: str = "bilinear", dtype=None) -> torch.Tensor:
    """Coarse (ncx, ncy) -> fine (nfx, nfy) bilinear interpolation.

    Coincident fine nodes copy the coarse value, edge nodes average two
    coarse neighbours and centre nodes average four.
    """
    if method != "bilinear":
        raise NotImplementedError(
            f"prolongation {method!r} is not ported yet (ROADMAP item 7)")
    dtype = dtype or ec.dtype
    c = ec.to(dtype)
    ncx, ncy = c.shape
    if (nfx, nfy) != (2 * (ncx - 1) + 1, 2 * (ncy - 1) + 1):
        raise ValueError(f"coarse shape {(ncx, ncy)} does not refine to "
                         f"({nfx}, {nfy})")
    out = torch.empty((nfx, nfy), dtype=dtype, device=c.device)
    out[0::2, 0::2] = c
    out[0::2, 1::2] = 0.5 * (c[:, :-1] + c[:, 1:])
    out[1::2, 0::2] = 0.5 * (c[:-1, :] + c[1:, :])
    out[1::2, 1::2] = 0.25 * (c[:-1, :-1] + c[1:, :-1] + c[:-1, 1:]
                              + c[1:, 1:])
    return out
