"""The 2D Poisson/elliptic front end: one call from a problem to a checked
solution, and grid-convergence studies.

Counterpart of ``PoissonResult``, ``solve_poisson``, ``observed_order``,
``convergence_study`` and ``fit_study`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/applications/poisson.py``
for uniform fp32 and fp64 solves. fp32 at a tolerance below 1e-6 wraps the
fp32 cycles in float64 iterative refinement (``ir_solve``, two cycles per
outer step), since an fp32 residual floors near 1e-7 relative. The 'mixed',
'bf16', 'adaptive' and 'auto' precisions and ``PrecisionPolicy`` objects
(per-level dtype policies, staged promotion, autotuning) are ROADMAP item 9;
``mesh=`` (sharding) is item 14.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.precision import Precision
from ..models.problems import Problem
from ..solvers import multigrid as mg_mod, refinement
from ..solvers.multigrid import MultigridConfig


@dataclasses.dataclass
class PoissonResult:
    """Solution and solve metadata."""

    u: Any
    info: Dict[str, Any]
    errors: Optional[Dict[str, float]] = None
    solve_time: float = 0.0

    @property
    def iterations(self) -> int:
        return self.info["iterations"]

    @property
    def converged(self) -> bool:
        return self.info["converged"]


def uniform_precision(precision: Any, mesh=None) -> Precision:
    """The Precision of a uniform fp32 or fp64 solve; raises for what the
    port does not have yet."""
    if mesh is not None:
        raise NotImplementedError("mesh= (sharded solves) is not ported yet "
                                  "(ROADMAP item 14)")
    mode = None
    if isinstance(precision, Precision):
        mode = precision
    elif isinstance(precision, str) and precision in {p.value
                                                      for p in Precision}:
        mode = Precision(precision)
    if mode not in (Precision.FP32, Precision.FP64):
        name = getattr(precision, "value", precision)
        raise NotImplementedError(
            f"precision {name!r} (per-level dtype policies, staged promotion "
            "and autotuning) is not ported yet (ROADMAP item 9)")
    return mode


def solve_poisson(problem: Problem, *, precision: Any = "fp32",
                  cfg: MultigridConfig = MultigridConfig(smoother="rbgs",
                                                         omega=1.0),
                  use_fmg: bool = False, mesh=None,
                  device="cpu") -> PoissonResult:
    """Solve ``A u = f`` for a 2D Problem on ``device`` with one call.

    precision: 'fp32' or 'fp64', a uniform hierarchy at that dtype (fp32
    below tol 1e-6 under float64 iterative refinement, which takes no FMG
    start; ``use_fmg`` applies to the plain cycle iteration).
    ``solve_time`` is the wall time of the solve, hierarchy set-up
    included, synchronized with the device."""
    mode = uniform_precision(precision, mesh)
    device = torch.device(device)

    t0 = time.perf_counter()
    levels = mg_mod.build_hierarchy(problem.grid, problem.spec, a=problem.a,
                                    lam=problem.lam, dtype=mode.dtype,
                                    device=device, cfg=cfg)
    if mode == Precision.FP32 and cfg.tol < 1e-6:
        u, info = refinement.ir_solve(
            levels, problem.rhs(torch.float64, device),
            problem.initial_guess(torch.float64, device), cfg,
            inner_cycles=2)
    else:
        u, info = mg_mod.mg_solve(levels, problem.rhs(mode.dtype, device),
                                  problem.initial_guess(mode.dtype, device),
                                  cfg, use_fmg=use_fmg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_time = time.perf_counter() - t0

    errors = problem.error_norms(u) if problem.exact is not None else None
    return PoissonResult(u=u, info=info, errors=errors, solve_time=solve_time)


def observed_order(hs, errs) -> float:
    """Least-squares slope of log(err) against log(h)."""
    hs, errs = np.asarray(hs, float), np.asarray(errs, float)
    good = errs > 0
    if good.sum() < 2:
        return float("nan")
    return float(np.polyfit(np.log(hs[good]), np.log(errs[good]), 1)[0])


def convergence_study(problem_factory: Callable[[int], Problem],
                      sizes: List[int], *, precision: Any = "fp64",
                      cfg: MultigridConfig = MultigridConfig(smoother="rbgs",
                                                             omega=1.0),
                      device="cpu") -> Dict[str, Any]:
    """h-refinement study: solve on a ladder of sizes and fit the observed
    orders (see ``fit_study``)."""
    rows = []
    for n in sizes:
        prob = problem_factory(n)
        if prob.exact is None:
            raise ValueError("convergence study needs exact solutions")
        res = solve_poisson(prob, precision=precision, cfg=cfg, device=device)
        rows.append(dict(n=n, h=max(prob.grid.hx, prob.grid.hy),
                         iterations=res.iterations, converged=res.converged,
                         **res.errors))
    return fit_study(list(sizes), rows)


def fit_study(sizes: List[int], rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Order fits of a ladder whose rows carry h, l2, linf, h1, iterations
    and converged for each size."""
    h = np.array([r["h"] for r in rows])
    l2 = np.array([r["l2"] for r in rows])
    linf = np.array([r["linf"] for r in rows])
    h1 = np.array([r.get("h1", np.nan) for r in rows])
    pairwise = list(np.log(l2[:-1] / l2[1:]) / np.log(h[:-1] / h[1:]))
    return {
        "sizes": list(sizes),
        "h": h,
        "l2": l2,
        "linf": linf,
        "h1": h1,
        "iterations": [r["iterations"] for r in rows],
        "converged": all(r["converged"] for r in rows),
        "order_l2": observed_order(h, l2),
        "order_linf": observed_order(h, linf),
        "order_h1": observed_order(h[np.isfinite(h1)], h1[np.isfinite(h1)]),
        "pairwise_orders": pairwise,
    }
