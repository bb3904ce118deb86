"""Mixed-precision iterative refinement.

Counterpart of ``ir_solve`` / ``_ir_jit`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/refinement.py``: the
solution, the residual and the norms live in float64 (native on the GPU,
plain PyTorch), while each correction A e = r comes from low-precision
multigrid cycles on the level hierarchy (fp32, through the CUDA kernels on
the GPU). Converges to fp64 accuracy while kappa(A)*eps_low < 1.
On a periodic level the residuals read the wrap neighbours, and the
duplicate nodes of the solution are synced once at the end: the JAX
package's ``_ir_jit`` updates unknowns only and never syncs, so its
duplicates stay at the initial guess, which this port does not copy.
Adaptive staging (``adaptive_solve``) is ROADMAP item 9.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..ops import norms, stencil as st_mod
from . import multigrid as mg_mod
from .multigrid import MultigridConfig


def ir_solve(levels, f, u0=None, cfg: MultigridConfig = MultigridConfig(), *,
             inner_cycles: int = 1, max_outer: int = 100,
             use_fmg: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Solve A u = f to fp64 accuracy with low-precision multigrid cycles.

    ``levels`` is a low-precision hierarchy; the fine-level stencil is
    widened to float64 for the outer residual. Each outer step starts the
    correction from zero, runs ``inner_cycles`` cycles on the residual cast
    to the hierarchy's dtype, and adds the correction on unknowns only.
    ``use_fmg`` starts from a full-multigrid guess. The tolerance scale
    max(||f||, ||r(u0)||) is taken before that start. The stopping test reads
    the norm back once per outer step.
    """
    lev0 = levels[0]
    unknown = lev0.unknown
    hx, hy = lev0.grid.hx, lev0.grid.hy
    lo, f64 = lev0.dtype, torch.float64
    st_hi = lev0.stencil.astype(f64)

    f = f.to(device=lev0.device, dtype=f64)
    u = (torch.zeros(lev0.grid.shape, dtype=f64, device=lev0.device)
         if u0 is None else u0.to(device=lev0.device, dtype=f64, copy=True))
    fnorm = norms.masked_scaled_l2(f, unknown, hx, hy)
    r_init = st_mod.residual(st_hi, u, f, unknown)
    tol_eff = mg_mod.tolerance(
        cfg, torch.maximum(fnorm, norms.scaled_l2(r_init, hx, hy)))

    if use_fmg:
        u = u + mg_mod.fmg(levels, f.to(lo), cfg).to(f64)
    r = st_mod.residual(st_hi, u, f, unknown)
    state = {"u": u, "r": r}

    def step():
        e = lev0.zeros()
        r_lo = state["r"].to(lo)
        for _ in range(inner_cycles):
            e = mg_mod.mg_cycle(levels, e, r_lo, cfg)
        u = torch.where(unknown, state["u"] + e.to(f64), state["u"])
        state["u"] = u
        state["r"] = st_mod.residual(st_hi, u, f, unknown)
        return norms.scaled_l2(state["r"], hx, hy)

    info = mg_mod.outer_iterate(step, norms.scaled_l2(r, hx, hy), tol_eff,
                                fnorm, max_outer)
    if lev0.sync is not None:
        lev0.sync(state["u"])
    info["method"] = "iterative_refinement"
    return state["u"], info
