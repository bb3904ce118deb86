"""The 3D Poisson front end: one call from a problem to a checked solution.

Counterpart of ``solve_poisson3d`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/applications/poisson3d.py``
for uniform fp32 and fp64 solves. fp32 at a tolerance below 1e-6 wraps the
fp32 cycles in float64 iterative refinement (``ir_solve3d``, two cycles per
outer step), since an fp32 residual floors near 1e-7 relative. The 'mixed',
'bf16' and 'adaptive' precisions in 3D (per-level dtype policies, staged
promotion) are ROADMAP item 13, as is ``convergence_study3d``; ``mesh=``
(sharding) is item 14.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from ..core.device import resolve_device
from ..core.precision import Precision
from ..models.problems3d import Problem3D
from ..solvers import multigrid3d as mg3
from ..solvers.multigrid import MultigridConfig
from .poisson import PoissonResult


def uniform_precision(precision: Any, mesh=None) -> Precision:
    """The Precision of a uniform fp32 or fp64 3D solve; raises for what
    the port does not have yet."""
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
            f"precision {name!r} in 3D (per-level dtype policies and staged "
            "promotion) is not ported yet (ROADMAP item 13)")
    return mode


def solve_poisson3d(problem: Problem3D, *, precision: Any = "fp32",
                    cfg: MultigridConfig = MultigridConfig(smoother="rbgs",
                                                           omega=1.0),
                    mesh=None, device=None) -> PoissonResult:
    """Solve the 3D problem on ``device`` with one call.

    precision: 'fp32' or 'fp64', a uniform hierarchy at that dtype (fp32
    below tol 1e-6 under float64 iterative refinement). ``solve_time`` is
    the wall time of the solve, synchronized with the device."""
    mode = uniform_precision(precision, mesh)
    device = resolve_device(device)

    t0 = time.perf_counter()
    levels = mg3.build_hierarchy3d(problem.grid, problem.spec,
                                   lam=problem.lam, dtype=mode.dtype,
                                   device=device, cfg=cfg)
    if mode == Precision.FP32 and cfg.tol < 1e-6:
        u, info = mg3.ir_solve3d(
            levels, problem.rhs(torch.float64, device),
            problem.initial_guess(torch.float64, device), cfg,
            inner_cycles=2)
    else:
        u, info = mg3.mg_solve3d(levels, problem.rhs(mode.dtype, device),
                                 problem.initial_guess(mode.dtype, device),
                                 cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_time = time.perf_counter() - t0

    errors = problem.error_norms(u) if problem.exact is not None else None
    return PoissonResult(u=u, info=info, errors=errors, solve_time=solve_time)
