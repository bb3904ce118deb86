"""Plain PyTorch intergrid transfers: full-weighting, half-weighting and
injection restriction; bilinear and injection prolongation.

Counterpart of ``restrict`` (boundaries 'zero', 'inject' and 'reflect',
periodic ``wrap``) and ``prolong`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/transfer.py``, written
with strided slices of the logical arrays. The fine grid relates to the
coarse one as nf = 2*(nc - 1) + 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RESTRICTIONS = ("full_weighting", "half_weighting", "injection")
PROLONGATIONS = ("bilinear", "injection")


def restrict(rf: torch.Tensor, ncx: int, ncy: int, *,
             method: str = "full_weighting", boundary: str = "zero",
             dtype=None, wrap=(False, False)) -> torch.Tensor:
    """Fine (nfx, nfy) -> coarse (ncx, ncy) restriction.

    ``method``: 'full_weighting' ([1 2 1; 2 4 2; 1 2 1]/16 over the fine
    window around (2I, 2J), summed in the JAX package's CPU order: centre,
    then the four edge neighbours, then the four corners), 'half_weighting'
    ([0 1 0; 1 4 1; 0 1 0]/8: centre, then the edge neighbours) or
    'injection' (the coincident fine node). ``boundary``: 'zero' leaves the
    coarse ring at zero (residual transfers with Dirichlet rings); 'inject'
    copies the coincident fine nodes onto the ring (the FMG right-hand
    side); 'reflect' restricts onto the ring too, folding the out-of-domain
    window rows back onto the interior (row -1 takes row 1, row nfx takes
    row nfx-2; x first, then y, which gives the 2x2-mean corner rule): the
    residual transfer of Neumann/Robin rings.

    ``wrap``: per-axis periodic flags. On a wrapped axis coarse node 0 is
    restricted too, reading its fine neighbour -1 as node nf-2, and coarse
    node nc-1 (the duplicate) is left to the level's ``periodic_sync``: zero
    under 'zero', its ring value under 'inject' and 'reflect'.
    """
    if method not in RESTRICTIONS:
        raise ValueError(f"unknown restriction {method!r}")
    if boundary not in ("zero", "inject", "reflect"):
        raise ValueError(f"unknown restriction boundary {boundary!r}")
    dtype = dtype or rf.dtype
    r = rf.to(dtype)
    nfx, nfy = 2 * (ncx - 1) + 1, 2 * (ncy - 1) + 1
    if r.shape != (nfx, nfy):
        raise ValueError(f"fine shape {tuple(r.shape)} does not coarsen to "
                         f"({ncx}, {ncy})")

    out = torch.zeros((ncx, ncy), dtype=dtype, device=r.device)
    if boundary == "reflect" or any(wrap):
        # one ghost line around the fine array, p[k + 1] = fine k: wrap
        # neighbours on a periodic axis, the reflection otherwise
        p = F.pad(r, (1, 1, 1, 1))
        if wrap[0]:
            p[0, 1:-1], p[-1, 1:-1] = r[-2], r[1]
        elif boundary == "reflect":
            p[0, 1:-1], p[-1, 1:-1] = r[1], r[-2]
        if wrap[1]:
            p[:, 0], p[:, -1] = p[:, -3], p[:, 2]
        elif boundary == "reflect":
            p[:, 0], p[:, -1] = p[:, 2], p[:, -3]
        r, inner, lo = p, out, 1  # every coarse node
    else:
        inner, lo = out[1:-1, 1:-1], 2  # coarse interior only

    def win(di, dj):  # fine[2I+di, 2J+dj] for the coarse nodes in `inner`
        i0, j0 = lo + di, lo + dj
        return r[i0: i0 + 2 * inner.shape[0] - 1: 2,
                 j0: j0 + 2 * inner.shape[1] - 1: 2]

    if method == "full_weighting":
        inner[...] = (
            4.0 * win(0, 0)
            + 2.0 * (win(1, 0) + win(-1, 0) + win(0, 1) + win(0, -1))
            + (win(1, 1) + win(-1, 1) + win(1, -1) + win(-1, -1))
        ) / 16.0
    elif method == "half_weighting":
        inner[...] = (4.0 * win(0, 0) + win(1, 0) + win(-1, 0) + win(0, 1)
                      + win(0, -1)) / 8.0
    else:
        inner[...] = win(0, 0)
    if inner is out and boundary != "reflect":
        # the wrap path computed every coarse node: keep the core,
        # [0 or 1, nc - 1) per axis, and inject or zero the rest
        core = torch.zeros((ncx, ncy), dtype=torch.bool, device=out.device)
        core[0 if wrap[0] else 1: ncx - 1, 0 if wrap[1] else 1: ncy - 1] = True
        ring = (rf.to(dtype)[::2, ::2] if boundary == "inject"
                else torch.zeros((), dtype=dtype, device=out.device))
        return torch.where(core, out, ring)
    if boundary == "inject":
        out[0, :] = r[0, ::2]
        out[-1, :] = r[-1, ::2]
        out[:, 0] = r[::2, 0]
        out[:, -1] = r[::2, -1]
    return out


def prolong(ec: torch.Tensor, nfx: int, nfy: int, *,
            method: str = "bilinear", dtype=None) -> torch.Tensor:
    """Coarse (ncx, ncy) -> fine (nfx, nfy) interpolation.

    'bilinear': coincident fine nodes copy the coarse value, edge nodes
    average two coarse neighbours and centre nodes average four.
    'injection': coincident fine nodes copy the coarse value, the others
    are zero. On a periodic level the caller syncs ``ec`` first: the last
    fine lines average with the coarse duplicate node."""
    if method not in PROLONGATIONS:
        raise ValueError(f"unknown prolongation {method!r}")
    dtype = dtype or ec.dtype
    c = ec.to(dtype)
    ncx, ncy = c.shape
    if (nfx, nfy) != (2 * (ncx - 1) + 1, 2 * (ncy - 1) + 1):
        raise ValueError(f"coarse shape {(ncx, ncy)} does not refine to "
                         f"({nfx}, {nfy})")
    if method == "injection":
        out = torch.zeros((nfx, nfy), dtype=dtype, device=c.device)
        out[0::2, 0::2] = c
        return out
    out = torch.empty((nfx, nfy), dtype=dtype, device=c.device)
    out[0::2, 0::2] = c
    out[0::2, 1::2] = 0.5 * (c[:, :-1] + c[:, 1:])
    out[1::2, 0::2] = 0.5 * (c[:-1, :] + c[1:, :])
    out[1::2, 1::2] = 0.25 * (c[:-1, :-1] + c[1:, :-1] + c[:-1, 1:]
                              + c[1:, 1:])
    return out
