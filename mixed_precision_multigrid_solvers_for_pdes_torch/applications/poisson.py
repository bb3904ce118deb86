"""The 2D Poisson/elliptic front end: one call from a problem to a checked
solution, and grid-convergence studies.

Counterpart of ``PoissonResult``, ``solve_poisson``, ``observed_order``,
``convergence_study`` and ``fit_study`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/applications/poisson.py``,
with every precision of the JAX package: uniform 'fp32', 'fp64' and 'bf16'
hierarchies, where fp32 at a tolerance below 1e-6 wraps the fp32 cycles in
float64 iterative refinement (``ir_solve``, two cycles per outer step),
since an fp32 residual floors near 1e-7 relative; 'mixed' (fp32 fine and
bf16 coarse levels under iterative refinement); 'adaptive' (staged
promotion, ``refinement.adaptive_solve``); 'auto' (the measured choice of
``precision_analysis.autotune``); or a ``PrecisionPolicy``. A problem's
irregular domain goes to every hierarchy. ``mesh=`` runs every precision
over a mesh of ranks (``parallel.distributed``), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import Precision, PrecisionPolicy, \
    policy as make_policy
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


def precision_policy(precision: Any, problem: Problem,
                     cfg: MultigridConfig, device, mesh=None
                     ) -> PrecisionPolicy:
    """The policy of a ``solve_poisson`` precision: a PrecisionPolicy as
    given, 'auto' measured by ``autotune`` on ``problem`` (unsharded; on a
    mesh every rank takes its first rank's choice), else the named mode (a
    string or a Precision)."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    if isinstance(precision, Precision):
        return make_policy(precision)
    if precision == "auto":
        from .precision_analysis import autotune

        choice = autotune(problem, cfg=cfg, device=device)
        if mesh is not None:
            choice = mesh.broadcast(choice)
        return make_policy(choice)
    if isinstance(precision, str):
        return make_policy(precision)
    raise TypeError(f"precision must be a mode name, a Precision or a "
                    f"PrecisionPolicy, got {precision!r}")


def solve_poisson(problem: Problem, *, precision: Any = "fp32",
                  cfg: MultigridConfig = MultigridConfig(smoother="rbgs",
                                                         omega=1.0),
                  use_fmg: bool = False, mesh=None,
                  device=None) -> PoissonResult:
    """Solve ``A u = f`` for a 2D Problem on ``device`` with one call.

    precision: 'fp32', 'fp64' or 'bf16', a uniform hierarchy at that dtype
    (fp32 below tol 1e-6 under float64 iterative refinement, which takes no
    FMG start; ``use_fmg`` applies to the plain cycle iteration); 'mixed',
    the policy's fp32/bf16 levels under iterative refinement (two cycles
    per outer step); 'adaptive', staged promotion; 'auto', the fastest of
    fp32, mixed and adaptive that holds accuracy on this problem, measured
    once and cached; or a PrecisionPolicy, used as given.
    ``solve_time`` is the wall time of the solve, hierarchy set-up
    included, synchronized with the device.

    ``mesh`` (``parallel.mesh.make_mesh`` or ``make_graded_mesh``) runs the
    solve in every precision on this rank's blocks, on the plain path
    (``parallel.distributed.make_constrainer``): every rank of the mesh
    calls with the same problem, on its own device, and gets the global
    solution."""
    device = resolve_device(device)
    pol = precision_policy(precision, problem, cfg, device, mesh)
    constrain = None
    if mesh is not None:
        from ..parallel import distributed

        constrain = distributed.make_constrainer(mesh)

    t0 = time.perf_counter()
    f64 = torch.float64
    if pol.mode == Precision.ADAPTIVE:
        u, info = refinement.adaptive_solve(
            problem.grid, problem.spec, problem.rhs(f64, device),
            problem.initial_guess(f64, device), a=problem.a, lam=problem.lam,
            domain=problem.domain, policy=pol, cfg=cfg, mesh=mesh,
            device=device)
    elif pol.mode == Precision.MIXED:
        levels = mg_mod.build_hierarchy(
            problem.grid, problem.spec, a=problem.a, lam=problem.lam,
            domain=problem.domain, policy=pol, device=device, cfg=cfg)
        u, info = refinement.ir_solve(
            levels, problem.rhs(f64, device),
            problem.initial_guess(f64, device), cfg, inner_cycles=2,
            constrain=constrain)
    else:
        dt = pol.mode.dtype
        levels = mg_mod.build_hierarchy(
            problem.grid, problem.spec, a=problem.a, lam=problem.lam,
            domain=problem.domain, dtype=dt, device=device, cfg=cfg)
        if dt == torch.float32 and cfg.tol < 1e-6:
            u, info = refinement.ir_solve(
                levels, problem.rhs(f64, device),
                problem.initial_guess(f64, device), cfg, inner_cycles=2,
                constrain=constrain)
        else:
            u, info = mg_mod.mg_solve(levels, problem.rhs(dt, device),
                                      problem.initial_guess(dt, device),
                                      cfg, use_fmg=use_fmg,
                                      constrain=constrain)
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
                      device=None) -> Dict[str, Any]:
    """h-refinement study: solve on a ladder of sizes and fit the observed
    orders (see ``fit_study``)."""
    device = resolve_device(device)
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
