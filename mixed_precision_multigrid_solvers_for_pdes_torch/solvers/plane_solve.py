"""Level-0 parity-plane mixed-precision solver.

Counterpart of ``plane_solve_ok``, ``plane_cycle`` and ``plane_ir_solve``
(``_plane_ir_jit``) in
``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/plane_solve.py``.
The finest level's u, f and r live as the four parity planes of
``ops/planes.py`` for the whole solve: split once, merged once. Level-0
smoothing runs kernel K through ``ops/dispatch.smooth_planes``; the level-0
residual, restriction and prolongation are plain PyTorch plane operations,
as they were XLA operations in the JAX package; levels >= 1 run the standard
cycle (kernels A-D on the card). The outer loop is ``refinement.ir_solve``'s
without FMG: an fp64 residual and norm in plane space, ``inner_cycles`` fp32
plane cycles per step, a masked update, one host readback per step.

Scope (``plane_solve_ok``): at least two levels, a V-cycle, an fp32 level 0
with a constant-coefficient all-Dirichlet 5-point stencil (never a
``Stencil9``) on the whole
rectangle (no irregular domain), full-weighting restriction, bilinear
prolongation and an RB-GS-family smoother. As in the
JAX package, level-0 post-smoothing sweeps red then black even when
``cfg.symmetric`` reverses the colours on the levels below.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..ops import dispatch, planes as pln, smooth as smooth_mod
from ..ops.stencil import Stencil9
from . import multigrid as mg_mod
from .multigrid import Level, MultigridConfig


def plane_solve_ok(levels, cfg: MultigridConfig) -> bool:
    """True when the parity-plane level-0 path applies."""
    if len(levels) < 2 or cfg.cycle != "V":
        return False
    lev0 = levels[0]
    if isinstance(lev0.stencil, Stencil9):
        return False  # K reads five coefficients
    if not lev0.stencil.scalar or not lev0.spec.all_dirichlet:
        return False
    if lev0.domain is not None:
        return False  # K builds its unknowns from the rectangle
    if cfg.restriction != "full_weighting" or cfg.prolongation != "bilinear":
        return False
    if cfg.smoother not in smooth_mod.RBGS_METHODS:
        return False
    return lev0.dtype == torch.float32


def plane_cycle(levels, up, fp, cfg: MultigridConfig, masks):
    """One V-cycle with level 0 in plane space (levels >= 1 standard);
    returns the new level-0 planes (kernel K and the correction work out of
    place, so ``up`` may be left as it was: take the return value)."""
    lev0, nxt = levels[0], levels[1]
    up = dispatch.smooth_planes(lev0, up, fp, cfg, cfg.pre_sweeps)
    rp = pln.plane_residual(lev0.stencil.coefs, up, fp, masks)
    fc = pln.restrict_planes(rp, nxt.grid.nx, nxt.grid.ny, dtype=nxt.dtype)
    ec = mg_mod._cycle(levels, nxt.zeros(), fc, 1, cfg, "V")
    up = pln.prolong_correct_planes(ec, up, masks)
    return dispatch.smooth_planes(lev0, up, fp, cfg, cfg.post_sweeps)


def plane_ir_solve(levels: Tuple[Level, ...], f, u0=None,
                   cfg: MultigridConfig = MultigridConfig(), *,
                   inner_cycles: int = 2, max_outer: int = 100
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mixed-precision IR solve with the level-0 state held as parity
    planes. The same outer structure and stopping rule as
    ``refinement.ir_solve`` without FMG; returns the merged (nx, ny) fp64
    solution and the standard info dict (``method`` 'plane_ir')."""
    if not plane_solve_ok(levels, cfg):
        raise ValueError("plane_ir_solve: configuration outside the "
                         "parity-plane gate (see plane_solve_ok)")
    lev0 = levels[0]
    g, dev, f64 = lev0.grid, lev0.device, torch.float64
    masks = pln.plane_masks(g, device=dev)
    stp_hi = lev0.stencil.astype(f64).coefs
    fp64 = pln.split_field(f.to(device=dev, dtype=f64))
    u64 = (torch.zeros_like(fp64) if u0 is None
           else pln.split_field(u0.to(device=dev, dtype=f64)))

    zero = torch.zeros((), dtype=f64, device=dev)
    fnorm = pln.plane_norm_scaled_l2(torch.where(masks, fp64, zero), g.hx,
                                     g.hy)
    r = pln.plane_residual(stp_hi, u64, fp64, masks)
    rnorm0 = pln.plane_norm_scaled_l2(r, g.hx, g.hy)
    tol_eff = mg_mod.tolerance(cfg, torch.maximum(fnorm, rnorm0))
    state = {"u": u64, "r": r}

    def step():
        rp32 = state["r"].to(torch.float32)
        ep = torch.zeros_like(rp32)
        for _ in range(inner_cycles):
            ep = plane_cycle(levels, ep, rp32, cfg, masks)
        u = torch.where(masks, state["u"] + ep.to(f64), state["u"])
        state["u"] = u
        state["r"] = pln.plane_residual(stp_hi, u, fp64, masks)
        return pln.plane_norm_scaled_l2(state["r"], g.hx, g.hy)

    info = mg_mod.outer_iterate(step, rnorm0, tol_eff, fnorm, max_outer)
    info["method"] = "plane_ir"
    return pln.merge_field(state["u"], g.shape), info
