"""Plain PyTorch intergrid transfers: full-weighting restriction and bilinear
prolongation.

Counterpart of ``restrict`` (full weighting; ``boundary='zero'`` and
``'inject'``) and ``prolong`` (bilinear) in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/transfer.py``, written
with strided slices of the logical arrays. The fine grid relates to the
coarse one as nf = 2*(nc - 1) + 1. Half weighting and injection restriction
are ROADMAP item 7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def restrict(rf: torch.Tensor, ncx: int, ncy: int, *,
             method: str = "full_weighting", boundary: str = "zero",
             dtype=None) -> torch.Tensor:
    """Fine (nfx, nfy) -> coarse (ncx, ncy) full-weighting restriction.

    Coarse interior node (I, J) gets [1 2 1; 2 4 2; 1 2 1]/16 over the fine
    window around (2I, 2J), summed in the JAX package's CPU order (centre,
    then the four edge neighbours, then the four corners). ``boundary``:
    'zero' leaves the coarse ring at zero (residual transfers with Dirichlet
    rings); 'inject' copies the coincident fine nodes onto the ring (the FMG
    right-hand side); 'reflect' restricts onto the ring too, folding the
    out-of-domain window rows back onto the interior (row -1 takes row 1,
    row nfx takes row nfx-2; x first, then y, which gives the 2x2-mean
    corner rule): the residual transfer of Neumann/Robin rings.
    """
    if method != "full_weighting":
        raise NotImplementedError(
            f"restriction {method!r} is not ported yet (ROADMAP item 7)")
    if boundary not in ("zero", "inject", "reflect"):
        raise NotImplementedError(
            f"boundary {boundary!r} is not ported yet (ROADMAP item 7)")
    dtype = dtype or rf.dtype
    r = rf.to(dtype)
    nfx, nfy = 2 * (ncx - 1) + 1, 2 * (ncy - 1) + 1
    if r.shape != (nfx, nfy):
        raise ValueError(f"fine shape {tuple(r.shape)} does not coarsen to "
                         f"({ncx}, {ncy})")

    out = torch.zeros((ncx, ncy), dtype=dtype, device=r.device)
    if boundary == "reflect":
        p = F.pad(r, (1, 1, 1, 1))
        p[0, 1:-1], p[-1, 1:-1] = r[1], r[-2]
        p[:, 0], p[:, -1] = p[:, 2], p[:, -3]
        r, inner, lo = p, out, 1  # every coarse node; p[k + 1] is fine k
    else:
        inner, lo = out[1:-1, 1:-1], 2  # coarse interior only

    def win(di, dj):  # fine[2I+di, 2J+dj] for the coarse nodes in `inner`
        i0, j0 = lo + di, lo + dj
        return r[i0: i0 + 2 * inner.shape[0] - 1: 2,
                 j0: j0 + 2 * inner.shape[1] - 1: 2]

    inner[...] = (
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
