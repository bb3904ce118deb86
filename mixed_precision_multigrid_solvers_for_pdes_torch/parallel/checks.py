"""Rank functions that hold the distribution paths against the
single-device solver, for ``launch.run``.

Every rank of a world runs ``run_cases(cases, device)``: each ``Case``
names a problem, a size, a mesh shape (four axes for a graded mesh), a
dtype, configuration changes and entry-point options; it builds its
problem and hierarchy on the rank's device and runs it on its mesh: the
explicit path (``halo_solve``, ``shard_smooth``, ``global_residual_norm``,
``make_sharded_field``), the GSPMD path (``sharded_solve``,
``solve_poisson(mesh=)``, MG-preconditioned CG on ``shard_inputs``
vectors, the block smoothers), its 3D hook (``mg_solve3d``/``ir_solve3d``
with ``make_constrainer3d``, ``solve_poisson3d(mesh=)``, MG-PCG with
``multigrid_preconditioner3d(constrain=)``, the 3D block operators) or
sharded time stepping (``solve_heat(mesh=)``, ``solve_heat3d(mesh=)``),
and the port's single-device plain counterpart. It returns the numbers
and, for the caller's comparisons, its solution as a float64 numpy
array. The caller holds the list of cases and
passes it in, as plain data that a spawned rank unpickles without
importing the caller.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..applications import heat as heat_mod, heat3d as heat3d_mod, \
    heat_problems as HP
from ..applications.poisson import solve_poisson
from ..applications.poisson3d import solve_poisson3d
from ..core import bc as bc_mod
from ..core.device import resolve_device
from ..core.grid import Grid
from ..core.precision import policy as make_policy
from ..models import problems as P, problems3d as P3
from ..ops import dispatch, norms, smooth as smooth_mod, smooth3d as sm3, \
    stencil as st_mod, stencil3d as st3, transfer3d
from ..ops.cuda_kernels import smooth as k_smooth, \
    smooth3d as k_smooth3d, smooth_var as k_smooth_var
from ..preconditioning import multigrid_preconditioner, \
    multigrid_preconditioner3d
from ..solvers import krylov, multigrid3d as mg3
from ..solvers.multigrid import MultigridConfig, build_hierarchy, mg_solve
from ..utils.checkpoint import CheckpointManager
from . import blocks as bk, blocks3d as bk3, distributed, \
    halo_solve as hs, mesh as mesh_mod, multihost

CFG = MultigridConfig(smoother="rbgs", omega=1.0, backend="torch",
                      max_iterations=30)


def _periodic_x_dirichlet_y(n):
    """sin(2 pi x) sin(pi y): periodic in x, Dirichlet in y (a torus along
    one mesh axis only)."""
    pi = np.pi
    spec = bc_mod.BoundarySpec(
        west=bc_mod.BCSide(kind=bc_mod.BCKind.PERIODIC),
        east=bc_mod.BCSide(kind=bc_mod.BCKind.PERIODIC))
    return P.from_callables(
        "periodic_x_dirichlet_y", Grid(n, n),
        u_exact=lambda X, Y: np.sin(2 * pi * X) * np.sin(pi * Y),
        f=lambda X, Y: 5 * pi ** 2 * np.sin(2 * pi * X) * np.sin(pi * Y),
        spec=spec)


PROBLEMS = {
    "poisson_mms_sinsin": P.poisson_mms_sinsin,
    "variable_coefficient_mms": P.variable_coefficient_mms,
    "jump_coefficient_problem": P.jump_coefficient_problem,
    "periodic_helmholtz_mms": P.periodic_helmholtz_mms,
    "periodic_x_dirichlet_y": _periodic_x_dirichlet_y,
    "neumann_test_problem": P.neumann_test_problem,
    "mixed_segment_mms": P.mixed_segment_mms,
    "mixed_segment_problem": P.mixed_segment_problem,
    "l_shaped_problem": P.l_shaped_problem,
    "poisson_mms_anisotropic": P.poisson_mms_anisotropic,
}
PROBLEMS3D = {
    "poisson3d_mms_sinsinsin": P3.poisson3d_mms_sinsinsin,
    "varcoef3d_mms": P3.varcoef3d_mms,
    "jump_coefficient3d": P3.jump_coefficient3d,
    "neumann3d_test": P3.neumann3d_test,
    "periodic3d_helmholtz": P3.periodic3d_helmholtz,
    "anisotropic3d_z": P3.anisotropic3d_z,
}
HEAT = {"pure_diffusion": HP.pure_diffusion,
        "pure_diffusion3d": heat3d_mod.pure_diffusion3d}


class Case(NamedTuple):
    """One check: what to run (``kind``: the explicit path's 'solve',
    'overlap', 'raises', 'smooth', 'norm' or 'field'; the GSPMD path's
    'sharded', 'frontend', 'pcg' or 'smooth_blocks'; its 3D hook's
    'sharded3d', 'frontend3d', 'pcg3d' or 'blocks3d'; time stepping's
    'heat' or 'heat3d'), on which problem of ``PROBLEMS`` (``PROBLEMS3D``,
    ``HEAT``) at n x n (x n), on which mesh (None: the 2D mesh of the whole
    world; four axes: a graded mesh), in which dtype ('mixed': the mixed
    policy's level dtypes), with which ``MultigridConfig`` changes from
    ``CFG``, and with which entry-point ``options`` ('use_fmg';
    'precision'; 'tol' and 'maxiter' of CG; 'min_points_per_device' of
    the 3D hook in 'sharded3d', 'pcg3d' and 'blocks3d' (the front ends
    split as the JAX package's, from 16); the
    heat run's 'scheme', 't_final', 'dt', 'n_steps', 'step_rtol',
    'adaptive_dt' and 'resume_at' with a checkpoint 'directory'; 'repeats':
    timed calls after the first, whose minimum is reported; 'digest': the
    solution comes back as its SHA-256; 'profile': on a card, one more
    sharded and one-rank call under torch.profiler, reporting busy share
    and the device ms of the kernels whose name holds this string;
    'plain': False skips the single-device plain run; 'blocks': a
    'sharded3d' solve takes ``shard_inputs`` blocks)."""

    kind: str
    problem: str
    n: int
    mesh: Optional[Tuple[int, ...]]
    dtype: str = "float64"
    changes: Optional[dict] = None
    options: Optional[dict] = None


def case_inputs(case: Case, device=None):
    """The problem, configuration and hierarchy of ``case`` (the same on
    every rank and in the caller), on ``device`` (the card by default)."""
    device = resolve_device(device)
    prob = PROBLEMS[case.problem](case.n)
    cfg = CFG.replace(**(case.changes or {}))
    levels = build_hierarchy(prob.grid, prob.spec, a=prob.a, lam=prob.lam,
                             domain=prob.domain, dtype=case.dtype, cfg=cfg,
                             device=device)
    return prob, cfg, levels


def smooth_input(lev, seed: int = 0):
    """A random iterate on the level's unknowns (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(lev.grid.shape)
    return torch.from_numpy(u).to(lev.device).where(
        lev.unknown, torch.zeros((), dtype=torch.float64, device=lev.device))


def _mesh(shape, meshes):
    if shape not in meshes:
        if shape is None:
            meshes[shape] = multihost.make_global_mesh()
        elif len(shape) == 4:
            meshes[shape] = mesh_mod.make_graded_mesh(shape=shape)
        else:
            meshes[shape] = mesh_mod.make_mesh(shape=shape)
    return meshes[shape]


def _np(t):
    return t.detach().to("cpu", torch.float64).numpy()


def _timed(run, device):
    """``run()`` and its wall seconds (the card synchronized)."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = run()
    sync()
    return out, time.perf_counter() - t0


def _solve_case(case, mesh, device):
    prob, cfg, levels = case_inputs(case, device)
    f = prob.rhs(torch.float64, device)
    u0 = prob.initial_guess(torch.float64, device)
    (u, info), seconds = _timed(
        lambda: hs.halo_solve(mesh, levels, f, u0, cfg), device)
    (u_ref, info_ref), ref_seconds = _timed(
        lambda: mg_solve(levels, f, u0, cfg), device)
    out = {"iterations": info["iterations"], "converged": info["converged"],
           "seconds": seconds, "ref_seconds": ref_seconds,
           "history": np.asarray(info["history"]).tolist(),
           "ref_iterations": info_ref["iterations"],
           "max_diff_ref": float((u.double() - u_ref.double()).abs().max()),
           "n_sharded": hs.make_plan(levels, mesh).n_sharded,
           "u": _np(u)}
    if prob.exact is not None:
        out["l2"] = prob.error_norms(u.double())["l2"]
    return out


def _launches() -> int:
    """Launches of the smoothing kernels A, H and E so far (the wrappers'
    counts: CUDA launches only)."""
    return (k_smooth.multisweep.launches + k_smooth_var.multisweep_var.launches
            + k_smooth3d.rbgs3d.launches)


def _best(run, device, repeats: int):
    """``run()``'s result, its first call's seconds, the least seconds of
    ``repeats`` more calls (None without) and the smoothing kernels'
    launches in the first call."""
    n0 = _launches()
    out, first = _timed(run, device)
    launches = _launches() - n0
    best = min((_timed(run, device)[1] for _ in range(repeats)),
               default=None)
    return out, first, best, launches


def one_rank_mesh() -> mesh_mod.Mesh:
    """A mesh of this rank alone: it splits nothing, and a solve on it is
    the single-device solve under the sharding hook."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return mesh_mod.Mesh((1, 1), ranks=(rank,))


def _global(x):
    """A result field as a global tensor (a sharded one gathered)."""
    return x.gather() if isinstance(x, multihost.ShardedField) else x


def _compare(case, mesh, run, cfg, device):
    """``run(mesh, cfg)`` (an entry point on a mesh, or on None for the
    single-device call) on ``mesh`` beside the same call on a
    one-rank mesh (the single-device solve under the hook, which the
    sharded one must equal), the single-device plain call (backend
    'torch'; None with the option 'plain' False) and, on a card, the
    kernel path's (backend 'auto', unhooked; its count and its largest
    difference from the sharded result), each timed: (the sharded result,
    the one-rank one, the plain one, the record's numbers)."""
    opts = case.options or {}
    repeats = opts.get("repeats", 0)
    got, first, best, launches = _best(lambda: run(mesh, cfg), device,
                                       repeats)
    one, _, one_best, one_launches = _best(
        lambda: run(one_rank_mesh(), cfg), device, repeats)
    ref, ref_first, ref_best = None, None, None
    if opts.get("plain", True):
        plain = cfg.replace(backend="torch")
        ref, ref_first, ref_best, _ = _best(lambda: run(None, plain), device,
                                            repeats)
    out = {"seconds": first, "best": best, "ref_seconds": ref_first,
           "ref_best": ref_best, "one_best": one_best,
           "launches": launches, "one_launches": one_launches}
    if torch.device(device).type == "cuda":
        kern, k_first, k_best, _ = _best(lambda: run(
            None, cfg.replace(backend="auto")), device, repeats)
        out["kernel_best"] = k_first if k_best is None else k_best
        out["kernel_iterations"] = kern[1]["iterations"]
        out["max_diff_kernel"] = float((_global(got[0]).double() - _global(
            kern[0]).double()).abs().max())
        kernel = opts.get("profile")
        if kernel:
            out["profile"] = _profile(lambda: run(mesh, cfg), kernel)
            if mesh.size > 1:  # else the sharded call is the one-rank one
                out["profile_one"] = _profile(
                    lambda: run(one_rank_mesh(), cfg), kernel)
    return got, one, ref, out


def _profile(run, kernel: str) -> dict:
    """One more call of ``run`` on the card, unprofiled and then under
    torch.profiler (device activity alone): its wall ms, device ms, busy
    share (device time over the unprofiled wall; NCCL kernels count for
    the time they wait), the launches and device ms per launch of the CUDA
    kernels whose name holds ``kernel``, and the six device ops that took
    the most time (name, ms, count)."""
    from torch.profiler import ProfilerActivity, profile

    _, wall = _timed(run, "cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _timed(run, "cuda")
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    mine = [e for e in events if kernel in e.key]
    k_us = sum(e.self_device_time_total for e in mine)
    k_n = sum(e.count for e in mine)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "busy": dev_us / 1e6 / wall, "kernel_launches": k_n,
            "kernel_ms_per_launch": k_us / 1e3 / max(k_n, 1),
            "kernel_device_ms": k_us / 1e3,
            "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                    for e in top]}


def _record(u, info, one, ref, prob) -> dict:
    """A GSPMD solve's numbers beside those of its one-rank and plain
    single-device references ((solution, info) each)."""
    out = {"iterations": info["iterations"], "converged": info["converged"],
           "history": np.asarray(info["history"]).tolist(),
           "one_iterations": one[1]["iterations"],
           "max_diff_one": float((u.double() - one[0].double()).abs().max()),
           "u": _np(u)}
    if ref is not None:
        out.update(ref_iterations=ref[1]["iterations"],
                   ref_converged=ref[1]["converged"],
                   max_diff_ref=float((u.double() - ref[0].double()).abs()
                                      .max()))
    if prob.exact is not None:
        out["l2"] = prob.error_norms(u.double())["l2"]
    return out


def _tiers(mesh, levels) -> list:
    """Per sharded level, the mesh axes splitting x and y (the coarser
    levels are replicated)."""
    return [[list(n) for n in t.names]
            for t in distributed.make_tilings(mesh, levels)]


def _options(case) -> dict:
    """The entry point's keyword arguments among the case's options."""
    return {k: v for k, v in (case.options or {}).items()
            if k not in ("repeats", "digest", "profile", "plain")}


def _sharded_case(case, mesh, device):
    """``sharded_solve`` against the single-device ``mg_solve``."""
    prob, cfg, levels = case_inputs(case, device)
    kw = _options(case)
    f = prob.rhs(torch.float64, device)
    u0 = prob.initial_guess(torch.float64, device)

    def run(on, cfg):
        if on is None:
            return mg_solve(levels, f, u0, cfg, **kw)
        return distributed.sharded_solve(on, levels, f, u0, cfg, **kw)

    (u, info), one, ref, times = _compare(case, mesh, run, cfg, device)
    return {**_record(u, info, one, ref, prob), **times,
            "tiers": _tiers(mesh, levels)}


def _frontend_case(case, mesh, device):
    """``solve_poisson(mesh=)`` against the single-device call."""
    prob = PROBLEMS[case.problem](case.n)
    cfg = CFG.replace(**(case.changes or {}))
    kw = _options(case)

    def run(on, cfg):
        res = solve_poisson(prob, cfg=cfg, mesh=on, device=device, **kw)
        return res.u, res.info

    (u, info), one, ref, times = _compare(case, mesh, run, cfg, device)
    levels = build_hierarchy(prob.grid, prob.spec, cfg=cfg, device=device)
    return {**_record(u, info, one, ref, prob), **times,
            "tiers": _tiers(mesh, levels),
            "switches": [list(s) for s in info.get(
                "precision_switches", [])]}


def _pcg_case(case, mesh, device):
    """A Krylov solver (``options['solver']``, CG by default) on
    ``shard_inputs`` vectors with a ``make_constrainer`` multigrid
    preconditioner, against the single-device one; the vectors stay
    blocks."""
    prob, cfg, levels = case_inputs(case, device)
    kw = _options(case)
    solver = getattr(krylov, kw.pop("solver", "pcg"))
    lev0 = levels[0]
    mv = krylov.stencil_matvec(lev0.stencil, lev0.unknown)
    f = prob.rhs(torch.float64, device)

    def run(on, cfg):
        if on is None:
            return solver(mv, f, precond=multigrid_preconditioner(
                levels, cfg), **kw)
        x, info = solver(mv, distributed.shard_inputs(on, levels, f),
                         precond=multigrid_preconditioner(
                             levels, cfg,
                             constrain=distributed.make_constrainer(on)),
                         **kw)
        return x, info

    (x, info), (x1, info1), ref, times = _compare(case, mesh, run, cfg, device)
    return {**_record(x.gather(), info, (x1.gather(), info1), ref, prob),
            **times, "tiers": _tiers(mesh, levels),
            "block_shape": list(x.block.shape),
            "global_shape": list(f.shape)}


def _smooth_blocks_case(case, mesh, device):
    """The line smoothers, ADI and Chebyshev on every sharded level's
    blocks against the plain smoother on the whole level, bit for bit."""
    prob, cfg, levels = case_inputs(case, device)
    cycle = distributed.make_constrainer(mesh).blocks(levels)
    out = {"tiers": _tiers(mesh, levels)}
    for lvl in range(cycle.S):
        lev, tiling = levels[lvl], cycle.tilings[lvl]
        u, f = smooth_input(lev, seed=lvl), smooth_input(lev, seed=lvl + 7)
        for method in ("line_x", "line_y", "adi", "chebyshev"):
            ref = smooth_mod.smooth(lev.stencil, u.clone(), f, lev.unknown,
                                    method=method, sweeps=2, omega=1.0)
            got = cycle.smooth(lvl, bk.cut_block(mesh, tiling, lev.grid, u),
                               bk.cut_block(mesh, tiling, lev.grid, f), 2,
                               method, 1.0)
            got = bk.from_layout(bk.gather_axes(mesh, got, tiling.names),
                                 lev.grid)
            out[f"{method}_{lvl}"] = bool(torch.equal(got, ref))
    return out


# ---------------------------------------------------------------------------
# the 3D hook and sharded time stepping


def _mpd(case) -> int:
    return (case.options or {}).get("min_points_per_device", 16)


def case_inputs3d(case: Case, device=None):
    """The 3D problem, configuration and hierarchy of ``case``."""
    device = resolve_device(device)
    prob = PROBLEMS3D[case.problem](case.n)
    cfg = CFG.replace(**(case.changes or {}))
    pol = make_policy("mixed") if case.dtype == "mixed" else None
    levels = mg3.build_hierarchy3d(
        prob.grid, prob.spec, a=prob.a, lam=prob.lam, policy=pol,
        dtype=None if pol else case.dtype, cfg=cfg, device=device)
    return prob, cfg, levels


def _tiers3d(mesh, levels, mpd) -> list:
    return [[list(n) for n in t.names] for t in distributed.make_tilings(
        mesh, levels, mpd, dims=3)]


def _sharded3d_case(case, mesh, device):
    """``mg_solve3d`` (fp64 levels) or ``ir_solve3d`` with the 3D hook
    against the single-device solve. The hierarchy is built once, and so is
    each mesh's hook with its block cycle; with the option 'blocks' the
    inputs go in as ``shard_inputs`` blocks, cut once. So a call after the
    first ('repeats') times the solve alone, its closing gather of the
    global solution included."""
    prob, cfg, levels = case_inputs3d(case, device)
    mpd = _mpd(case)
    ir = case.dtype != "float64"
    dt = torch.float64 if ir else levels[0].dtype
    f, u0 = prob.rhs(dt, device), prob.initial_guess(dt, device)
    solve = mg3.ir_solve3d if ir else mg3.mg_solve3d
    hooks = {}  # by mesh size: the whole world's mesh, or one rank's

    def run(on, cfg):
        if on is None:
            return solve(levels, f, u0, cfg)
        if on.size not in hooks:
            c = distributed.make_constrainer3d(on, mpd)
            hooks[on.size] = (c, *(distributed.shard_inputs(
                on, levels, f, u0, min_points_per_device=mpd)
                if (case.options or {}).get("blocks") else (f, u0)))
        c, fb, ub = hooks[on.size]
        return solve(levels, fb, ub, cfg, constrain=c)

    (u, info), one, ref, times = _compare(case, mesh, run, cfg, device)
    return {**_record(u, info, one, ref, prob), **times,
            "tiers": _tiers3d(mesh, levels, mpd)}


def _frontend3d_case(case, mesh, device):
    """``solve_poisson3d(mesh=)`` against the single-device call."""
    prob = PROBLEMS3D[case.problem](case.n)
    cfg = CFG.replace(**(case.changes or {}))
    kw = _options(case)

    def run(on, cfg):
        res = solve_poisson3d(prob, cfg=cfg, mesh=on, device=device, **kw)
        return res.u, res.info

    (u, info), one, ref, times = _compare(case, mesh, run, cfg, device)
    levels = mg3.build_hierarchy3d(prob.grid, prob.spec, cfg=cfg,
                                   device=device)
    return {**_record(u, info, one, ref, prob), **times,
            "tiers": _tiers3d(mesh, levels, 16),
            "switches": [list(s) for s in info.get(
                "precision_switches", [])]}


def _pcg3d_case(case, mesh, device):
    """CG on global 3D vectors preconditioned by
    ``multigrid_preconditioner3d`` with the 3D hook."""
    prob, cfg, levels = case_inputs3d(case, device)
    kw = _options(case)
    mpd = kw.pop("min_points_per_device", 16)
    lev0 = levels[0]
    mv = krylov.stencil_matvec3d(lev0.stencil, lev0.unknown)
    f = prob.rhs(torch.float64, device)

    def run(on, cfg):
        c = None if on is None else distributed.make_constrainer3d(on, mpd)
        return krylov.pcg(mv, f, precond=multigrid_preconditioner3d(
            levels, cfg, constrain=c), **kw)

    (x, info), one, ref, times = _compare(case, mesh, run, cfg, device)
    return {**_record(x, info, one, ref, prob), **times,
            "tiers": _tiers3d(mesh, levels, mpd)}


def _blocks3d_case(case, mesh, device):
    """Each 3D block operator on every split level against the plain
    operator on the whole level, bit for bit: Jacobi, RB-GS and line_z
    (E's window twin too on an fp32 or bf16 all-Dirichlet scalar level,
    with a sweep count that takes one window and one that takes two), the
    restriction with its agglomeration, and the prolongation."""
    prob, cfg, levels = case_inputs3d(case, device)
    hook = distributed.make_constrainer3d(mesh, _mpd(case))
    cycle = hook.blocks(levels)
    out = {"tiers": _tiers3d(mesh, levels, _mpd(case))}

    def whole(lvl, x):  # a level's field from its blocks (or itself)
        if lvl >= cycle.S:
            return x
        return bk.from_layout(bk.gather_axes(mesh, x, cycle.tilings[
            lvl].names), levels[lvl].grid)

    def cut(lvl, x):
        if lvl >= cycle.S:
            return x
        return bk.cut_block(mesh, cycle.tilings[lvl], levels[lvl].grid, x)

    def held(lvl, got, ref):  # compared on the level's unknowns
        unk = levels[lvl].unknown
        zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
        return bool(torch.equal(torch.where(unk, whole(lvl, got), zero),
                                torch.where(unk, ref, zero)))

    for lvl in range(cycle.S):
        lev, nxt = levels[lvl], levels[lvl + 1]
        u = smooth_input(lev, seed=lvl).to(lev.dtype)
        f = smooth_input(lev, seed=lvl + 7).to(lev.dtype)
        for method, omega in (("jacobi", 0.8), ("rbgs", 1.0),
                              ("line_z", 1.0)):
            ref = sm3.smooth3d(lev.stencil, u.clone(), f, lev.unknown,
                               method=method, sweeps=2, omega=omega)
            got = cycle.smooth(lvl, cut(lvl, u), cut(lvl, f), 2, method,
                               omega)
            out[f"{method}_{lvl}"] = held(lvl, got, ref)
        lev32 = dataclasses.replace(lev, stencil=lev.stencil.astype(
            torch.float32), dtype=torch.float32)
        for dt in (torch.float32, torch.bfloat16):
            if not dispatch.kernel_smooth3d_ok(u.to(dt), lev32, "auto",
                                               "rbgs", f.to(dt)):
                continue
            for sweeps in (2, 12):
                ref = k_smooth3d.rbgs3d(lev.stencil, u.to(dt), f.to(dt),
                                        sweeps=sweeps, omega=1.0)
                got = bk3._window_smooth3d(
                    mesh, cycle.blocks[lvl], cut(lvl, u.to(dt)),
                    cut(lvl, f.to(dt)), sweeps=sweeps, omega=1.0,
                    reverse=False)
                out[f"kernel_E_{str(dt)[6:]}_{sweeps}_{lvl}"] = held(
                    lvl, got, ref)
        r = st3.residual(lev.stencil, u, f, lev.unknown)
        boundary = "zero" if lev.spec.plain else "reflect"
        ref = transfer3d.restrict3d(r, *nxt.grid.shape, boundary=boundary,
                                    dtype=nxt.dtype, wrap=lev.spec.wrap)
        got = cycle.restrict(lvl, cut(lvl, r), "full_weighting", boundary)
        out[f"restrict_{lvl}"] = held(lvl + 1, got, ref)
        ec = smooth_input(nxt, seed=lvl + 3).to(nxt.dtype)
        ref = ec.clone()
        if nxt.sync is not None:
            nxt.sync(ref)
        ref = transfer3d.prolong3d(ref, *lev.grid.shape, dtype=lev.dtype)
        got = cycle.prolong(lvl, cut(lvl + 1, ec), "trilinear")
        out[f"prolong_{lvl}"] = held(lvl, got, ref)
    return out


def _heat_run(case, on, mg_cfg, device, tag: str):
    """The case's heat run (``solve_heat``, or ``solve_heat3d`` for a 3D
    problem) on mesh ``on`` (None: unsharded); a 'resume_at' run first
    stops there with checkpoints in its own directory, then resumes to
    't_final'. Returns (u, steps, l2, gathers)."""
    opts = dict(case.options or {})
    three_d = case.problem.endswith("3d")
    cfg = heat_mod.HeatConfig(
        scheme=opts.get("scheme", "crank_nicolson"), cycles_per_step=2,
        step_rtol=opts.get("step_rtol", 1e-9), dtype=case.dtype, mg=mg_cfg,
        adaptive_dt=opts.get("adaptive_dt", False))
    kw = {"mesh": on, "device": device}
    if "n_steps" in opts:
        kw["n_steps"] = opts["n_steps"]
    prob = HEAT[case.problem](case.n)
    stops = [opts["t_final"]]
    if "resume_at" in opts:
        rank = dist.get_rank() if dist.is_initialized() else 0
        where = "mesh" if tag == "mesh" else f"{tag}{rank}"
        kw["checkpoint"] = CheckpointManager(f"{opts['directory']}/{where}")
        kw["checkpoint_every"] = 1
        stops.insert(0, opts["resume_at"])
    g0 = bk.BlockCycle.gathers
    for t_final in stops:
        if three_d:
            res = heat3d_mod.solve_heat3d(prob, t_final, opts["dt"], cfg,
                                          **kw)
            u, steps = res["u"], res["steps"]
            l2 = res["errors"]["l2"]
        else:
            res = heat_mod.solve_heat(prob, t_final, opts.get("dt"), cfg,
                                      **kw)
            u, steps, l2 = res.u, res.steps, res.errors["l2"]
    return u, steps, l2, bk.BlockCycle.gathers - g0


def _heat_case(case, mesh, device):
    """A sharded heat run against the same run on a one-rank mesh and the
    unsharded one; the global gathers it made (its end and checkpoints
    only) and the block a step returns (the state stays sharded)."""
    cfg = CFG.replace(**(case.changes or {}))
    runs = {}

    def run(on, cfg):
        tag = ("plain" if on is None else "mesh" if on is mesh else "one")
        out = _heat_run(case, on, cfg, device, tag)
        runs.setdefault(tag, out)
        return out[0], {"iterations": out[1]}

    (u, info), one, ref, times = _compare(case, mesh, run, cfg, device)
    _, steps, l2, gathers = runs["mesh"]
    prob = HEAT[case.problem](case.n)
    out = {"steps": steps, "one_steps": one[1]["iterations"], "l2": l2,
           "gathers": gathers,
           "max_diff_one": float((u.double() - one[0].double()).abs().max()),
           "u": _np(u), **times}
    if ref is not None:
        out.update(ref_steps=ref[1]["iterations"], max_diff_ref=float(
            (u.double() - ref[0].double()).abs().max()))
    if not case.problem.endswith("3d"):
        dtype = torch.float64 if case.dtype == "float64" else torch.float32
        levels = build_hierarchy(prob.grid, prob.spec, dtype=dtype,
                                 cfg=cfg, device=device)
        hook = distributed.make_constrainer(mesh)
        step = heat_mod.make_step_fn(prob, levels, heat_mod.HeatConfig(
            dtype=case.dtype, mg=cfg), constrain=hook)
        u0 = prob.initial_state(dtype, device)
        nxt = step(u0, u0, 0.0, (case.options or {}).get("dt") or 1e-4)
        out["step_block"] = list(nxt.block.shape)
        out["step_is_field"] = isinstance(nxt, multihost.ShardedField)
        out["tiers"] = _tiers(mesh, levels)
    else:
        out["tiers"] = _tiers3d(mesh, mg3.build_hierarchy3d(
            prob.grid, cfg=cfg, device=device), 16)
    return out


def run_case(case: Case, device=None, meshes=None) -> dict:
    """``case`` on this rank (on ``device``, the card by default); its
    numbers and solution."""
    device = resolve_device(device)
    meshes = {} if meshes is None else meshes
    mesh = _mesh(case.mesh, meshes)
    kind = case.kind
    gspmd = {"sharded": _sharded_case, "frontend": _frontend_case,
             "pcg": _pcg_case, "smooth_blocks": _smooth_blocks_case,
             "sharded3d": _sharded3d_case, "frontend3d": _frontend3d_case,
             "pcg3d": _pcg3d_case, "blocks3d": _blocks3d_case,
             "heat": _heat_case, "heat3d": _heat_case}
    if kind in gspmd:
        return gspmd[kind](case, mesh, device)
    if kind == "solve":
        return _solve_case(case, mesh, device)
    prob, cfg, levels = case_inputs(case, device)
    lev = levels[0]
    f = prob.rhs(torch.float64, device)
    if kind == "overlap":
        on, _ = hs.halo_solve(mesh, levels, f, cfg=cfg, overlap=True)
        off, _ = hs.halo_solve(mesh, levels, f, cfg=cfg, overlap=False)
        return {"equal": bool(torch.equal(on, off)), "u": _np(on)}
    if kind == "raises":
        try:
            hs.halo_solve(mesh, levels, f, cfg=cfg)
        except NotImplementedError as exc:
            return {"raised": str(exc)}
        return {"raised": None}
    if kind == "smooth":
        u = smooth_input(lev)
        out = {}
        for method in ("jacobi", "rbgs"):
            got = hs.shard_smooth(mesh, lev, u, f, method=method, sweeps=3,
                                  omega=0.9)
            ref = smooth_mod.smooth(lev.stencil, u.clone(), f, lev.unknown,
                                    method=method, sweeps=3, omega=0.9)
            out[method] = {"equal": bool(torch.equal(got, ref)),
                           "u": _np(got)}
        return out
    if kind == "norm":
        u = torch.zeros_like(f)
        got = hs.global_residual_norm(mesh, lev, u, f)
        ref = norms.scaled_l2(st_mod.residual(lev.stencil, u, f,
                                              lev.unknown),
                              lev.grid.hx, lev.grid.hy)
        return {"norm": float(got), "ref": float(ref)}
    if kind == "field":
        fn = (lambda X, Y: np.sin(np.pi * X) * np.sin(np.pi * Y))
        sf = multihost.make_sharded_field(mesh, prob.grid, fn, device=device)
        whole = torch.from_numpy(fn(*prob.grid.coordinates())).to(device)
        block = mesh_mod.shard_level_arrays(mesh, prob.grid, whole)
        return {"block_equal": bool(torch.equal(sf.block, block)),
                "gather_equal": bool(torch.equal(sf.gather(), whole)),
                "spec": list(sf.sharding.spec),
                "block_shape": list(sf.block.shape)}
    raise ValueError(f"unknown case kind {kind!r}")


def run_cases(cases: Dict[str, Case], device=None) -> dict:
    """Every case of ``cases`` on this rank, in order (every rank runs the
    same cases); ``device`` 'cuda' (or None) means this rank's card. Also
    the mesh shape of each case."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    meshes = {}
    out = {"rank": dist.get_rank() if dist.is_initialized() else 0,
           "summary": multihost.process_summary()}
    for name, case in cases.items():
        out[name] = run_case(case, device, meshes)
        out[name]["mesh"] = list(_mesh(case.mesh, meshes).shape.values())
        if (case.options or {}).get("digest") and "u" in out[name]:
            # a large solution travels back as its digest
            out[name]["u"] = hashlib.sha256(
                out[name]["u"].tobytes()).hexdigest()
    return out
