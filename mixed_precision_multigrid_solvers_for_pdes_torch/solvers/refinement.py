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

Adaptive staging (``adaptive_solve``, ``adaptive_solve3d``,
``_adaptive_core``): a host loop that
runs chunks of cycles at one precision and moves up (bf16, fp32, then
iterative refinement at the current precision) when the chunk reached its
precision's floor or the ``PrecisionPolicy`` sees stagnation or
near-convergence, as the JAX package's does.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

import numpy as np

from ..core.precision import Precision, PrecisionPolicy
from ..ops import norms, stencil as st_mod
from . import multigrid as mg_mod, multigrid3d as mg3
from .multigrid import MultigridConfig, convergence_factor


def ir_solve(levels, f, u0=None, cfg: MultigridConfig = MultigridConfig(), *,
             inner_cycles: int = 1, max_outer: int = 100,
             use_fmg: bool = False, constrain=None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Solve A u = f to fp64 accuracy with low-precision multigrid cycles.

    ``levels`` is a low-precision hierarchy (fp32, bf16, or per-level
    dtypes); the fine-level stencil is widened to float64 for the outer
    residual. Each outer step starts the correction from zero, runs
    ``inner_cycles`` cycles on the residual cast to level 0's dtype, and adds
    the correction on unknowns only.
    ``use_fmg`` starts from a full-multigrid guess. The tolerance scale
    max(||f||, ||r(u0)||) is taken before that start. The stopping test reads
    the norm back once per outer step.
    ``constrain`` (``parallel.distributed.make_constrainer``) keeps the
    float64 solution and residual in this rank's level-0 blocks and runs
    the inner cycles on the blocks, every rank of the mesh calling it; each
    outer step's norm is one all_reduce, and every rank gets the global
    solution. An array hook goes to the inner cycles.
    """
    if isinstance(constrain, mg_mod.BlockHook):
        return constrain.ir_solve(levels, f, u0, cfg,
                                  inner_cycles=inner_cycles,
                                  max_outer=max_outer, use_fmg=use_fmg)
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
        u = u + mg_mod.fmg(levels, f.to(lo), cfg,
                           constrain=constrain).to(f64)
    r = st_mod.residual(st_hi, u, f, unknown)
    state = {"u": u, "r": r}

    def step():
        e = lev0.zeros()
        r_lo = state["r"].to(lo)
        for _ in range(inner_cycles):
            e = mg_mod.mg_cycle(levels, e, r_lo, cfg, constrain)
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


_STAGE_ORDER = [Precision.BF16, Precision.FP32, Precision.FP64]


def adaptive_solve(grid, spec, f, u0=None, *, a=None, lam=0.0, domain=None,
                   policy: PrecisionPolicy = PrecisionPolicy(
                       mode=Precision.ADAPTIVE),
                   cfg: MultigridConfig = MultigridConfig(),
                   start: Precision = Precision.FP32, chunk: int = 5,
                   mesh=None, device=None
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Adaptive-precision solve: chunks of ``chunk`` cycles from the
    ``start`` precision, promoted on the policy's triggers, finished by
    iterative refinement when ``cfg.tol`` is below what the working
    precision can reach. Each stage's hierarchy is built once, on
    ``device`` (the card when None). ``mesh`` runs every stage on the
    blocks of that mesh (``parallel.distributed.make_constrainer``), every
    rank calling; every rank reads the same all-reduced norms, so every
    rank takes the same promotion branch."""
    constrain = None
    if mesh is not None:
        from ..parallel import distributed

        constrain = distributed.make_constrainer(mesh)
    hierarchies: Dict[Precision, Any] = {}

    def get_levels(p: Precision):
        if p not in hierarchies:
            hierarchies[p] = mg_mod.build_hierarchy(
                grid, spec, a=a, lam=lam, domain=domain, dtype=p.dtype,
                device=device, cfg=cfg)
        return hierarchies[p]

    return _adaptive_core(f, u0, get_levels=get_levels,
                          solve=functools.partial(mg_mod.mg_solve,
                                                  constrain=constrain),
                          ir=functools.partial(ir_solve, constrain=constrain),
                          policy=policy, cfg=cfg, start=start, chunk=chunk)


def adaptive_solve3d(grid, spec, f, u0=None, *, a=None, lam=0.0,
                     policy: PrecisionPolicy = PrecisionPolicy(
                         mode=Precision.ADAPTIVE),
                     cfg: MultigridConfig = MultigridConfig(),
                     start: Precision = Precision.FP32, chunk: int = 5,
                     mesh=None, device=None
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The staged solve of ``adaptive_solve`` over the 3D solver stack
    (``build_hierarchy3d``, ``mg_solve3d``, ``ir_solve3d`` with its two
    inner cycles), as the JAX package's ``adaptive_solve3d``. ``mesh``
    runs every stage on this rank's (x, y) blocks of whole z-lines
    (``parallel.distributed.make_constrainer3d``), every rank calling with
    the same global inputs and reading the same all-reduced norms."""
    constrain = None
    if mesh is not None:
        from ..parallel import distributed

        constrain = distributed.make_constrainer3d(mesh)
    hierarchies: Dict[Precision, Any] = {}

    def get_levels(p: Precision):
        if p not in hierarchies:
            hierarchies[p] = mg3.build_hierarchy3d(
                grid, spec, a=a, lam=lam, dtype=p.dtype, device=device,
                cfg=cfg)
        return hierarchies[p]

    def ir3(levels, f, u0, cfg, *, max_outer):
        return mg3.ir_solve3d(levels, f, u0, cfg, max_outer=max_outer,
                              constrain=constrain)

    u, info = _adaptive_core(f, u0, get_levels=get_levels,
                             solve=functools.partial(mg3.mg_solve3d,
                                                     constrain=constrain),
                             ir=ir3, policy=policy, cfg=cfg, start=start,
                             chunk=chunk)
    info["method"] = "adaptive_3d"
    return u, info


def _adaptive_core(f, u0, *, get_levels, solve, ir, policy, cfg, start,
                   chunk):
    """The staged promotion loop: each stage runs ``solve`` for at most
    ``chunk`` cycles at tolerance max(cfg.tol, 20 eps) of its precision;
    a stage that converged, stagnates (``should_promote``) or is near
    convergence (``should_upgrade``) moves to the next precision, and the
    move to fp64 becomes ``ir`` at the current stage's precision. Reports
    each stage's convergence factor, since one over a history that spans
    stages means nothing."""
    stage_idx = _STAGE_ORDER.index(start)
    history: list = []
    switches: list = []
    segments: list = []
    u = u0
    total_iters = 0
    while True:
        p = _STAGE_ORDER[stage_idx]
        stage_tol = max(cfg.tol, 20.0 * torch.finfo(p.dtype).eps)
        levels = get_levels(p)
        stage_cfg = cfg.replace(tol=stage_tol, max_iterations=chunk)
        u, info = solve(levels, f, u, stage_cfg)
        history.extend(info["history"][1:].tolist())
        segments.append((p.value, "cycle", info["history"]))
        total_iters += info["iterations"]

        rel = info["residual_norm"] / max(info["rhs_norm"], 1e-300)
        done = info["converged"] and stage_tol <= cfg.tol
        if done or total_iters >= cfg.max_iterations:
            break
        promote = (info["converged"]  # the stage's floor: more precision
                   or policy.should_promote(info["history"])
                   or policy.should_upgrade(rel))
        if promote and stage_idx + 1 < len(_STAGE_ORDER):
            if _STAGE_ORDER[stage_idx + 1] == Precision.FP64:
                # refinement at the current (cheap) precision, not fp64
                # cycles
                switches.append((total_iters, "ir"))
                u, info = ir(levels, f, u, cfg,
                             max_outer=max(1, cfg.max_iterations
                                           - total_iters))
                history.extend(info["history"][1:].tolist())
                segments.append(("ir", "ir_outer", info["history"]))
                total_iters += info["iterations"]
                break
            stage_idx += 1
            switches.append((total_iters, _STAGE_ORDER[stage_idx].value))

    hist = np.asarray([h for h in history if np.isfinite(h)])
    stage_factors = [{"stage": label, "rho_kind": kind,
                      "factor": convergence_factor(seg_hist)}
                     for label, kind, seg_hist in segments]
    return u, {
        "iterations": total_iters,
        "residual_norm": float(hist[-1]) if hist.size else float("nan"),
        "rhs_norm": info["rhs_norm"],
        "history": hist,
        "converged": bool(info["converged"]),
        # the final stage's factor; every stage's in 'stage_factors'
        "convergence_factor": (stage_factors[-1]["factor"]
                               if stage_factors else float("nan")),
        "stage_factors": stage_factors,
        "precision_switches": switches,
        "method": "adaptive",
    }
