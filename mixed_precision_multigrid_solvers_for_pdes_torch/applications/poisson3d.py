"""The 3D Poisson front end: one call from a problem to a checked solution,
and grid-convergence studies.

Counterpart of ``solve_poisson3d`` and ``convergence_study3d`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/applications/poisson3d.py``,
every precision: 'fp64', 'fp32' and 'bf16' solve on a uniform hierarchy
(fp32 at a tolerance below 1e-6 under float64 iterative refinement with two
cycles per outer step, since an fp32 residual floors near 1e-7 relative);
'mixed' builds the per-level dtypes of its policy (fp32 fine levels, bf16
coarse ones) under float64 iterative refinement; 'adaptive' runs
``refinement.adaptive_solve3d``. A ``PrecisionPolicy`` may be given in
place of a name. ``mesh=`` (sharding) is ROADMAP item 14b.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch

from ..core.device import resolve_device
from ..core.precision import Precision, PrecisionPolicy, policy as make_policy
from ..models.problems3d import Problem3D
from ..solvers import multigrid3d as mg3, refinement
from ..solvers.multigrid import MultigridConfig
from .poisson import PoissonResult, fit_study


def solve_poisson3d(problem: Problem3D, *, precision: Any = "fp32",
                    cfg: MultigridConfig = MultigridConfig(smoother="rbgs",
                                                           omega=1.0),
                    mesh=None, device=None) -> PoissonResult:
    """Solve the 3D problem on ``device`` (the card when None) with one
    call, at ``precision`` (see the module docstring). ``solve_time`` is
    the wall time of the hierarchy's build and the solve, synchronized with
    the device."""
    if mesh is not None:
        raise NotImplementedError("mesh= (sharded solves) is not ported yet "
                                  "(ROADMAP item 14b)")
    pol = precision if isinstance(precision, PrecisionPolicy) \
        else make_policy(precision)
    device = resolve_device(device)
    f64 = torch.float64

    t0 = time.perf_counter()
    if pol.mode == Precision.ADAPTIVE:
        u, info = refinement.adaptive_solve3d(
            problem.grid, problem.spec, problem.rhs(f64, device),
            problem.initial_guess(f64, device), a=problem.a, lam=problem.lam,
            policy=pol, cfg=cfg, device=device)
    else:
        dt = None if pol.mode == Precision.MIXED else pol.mode.dtype
        if dt == torch.float32 and cfg.tol < 1e-6:
            dt = None  # fp32 cycles under float64 refinement
        if dt is None:
            levels = mg3.build_hierarchy3d(
                problem.grid, problem.spec, a=problem.a, lam=problem.lam,
                dtype=torch.float32,
                policy=pol if pol.mode == Precision.MIXED else None,
                device=device, cfg=cfg)
            u, info = mg3.ir_solve3d(levels, problem.rhs(f64, device),
                                     problem.initial_guess(f64, device), cfg,
                                     inner_cycles=2)
        else:
            levels = mg3.build_hierarchy3d(
                problem.grid, problem.spec, a=problem.a, lam=problem.lam,
                dtype=dt, device=device, cfg=cfg)
            u, info = mg3.mg_solve3d(levels, problem.rhs(dt, device),
                                     problem.initial_guess(dt, device), cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_time = time.perf_counter() - t0

    errors = problem.error_norms(u) if problem.exact is not None else None
    return PoissonResult(u=u, info=info, errors=errors, solve_time=solve_time)


def convergence_study3d(problem_factory: Callable[[int], Problem3D],
                        sizes: List[int], *, precision: Any = "fp64",
                        cfg: MultigridConfig = MultigridConfig(
                            smoother="rbgs", omega=1.0),
                        device=None) -> Dict[str, Any]:
    """3D h-refinement study: a solve per size and the observed orders of
    the error norms (``applications.poisson.fit_study``)."""
    rows = []
    for n in sizes:
        prob = problem_factory(n)
        if prob.exact is None:
            raise ValueError("convergence study needs exact solutions")
        res = solve_poisson3d(prob, precision=precision, cfg=cfg,
                              device=device)
        rows.append(dict(n=n, h=max(prob.grid.hx, prob.grid.hy,
                                    prob.grid.hz),
                         iterations=res.iterations, converged=res.converged,
                         **res.errors))
    return fit_study(list(sizes), rows)
