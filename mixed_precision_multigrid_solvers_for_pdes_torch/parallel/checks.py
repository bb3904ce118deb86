"""Rank functions that hold the distribution paths against the
single-device solver, for ``launch.run``.

Every rank of a world runs ``run_cases(cases, device)``: each ``Case``
names a problem, a size, a mesh shape (four axes for a graded mesh), a
dtype, configuration changes and entry-point options; it builds its
problem and hierarchy on the rank's device and runs it on its mesh: the
explicit path (``halo_solve``, ``shard_smooth``, ``global_residual_norm``,
``make_sharded_field``) or the GSPMD path (``sharded_solve``,
``solve_poisson(mesh=)``, MG-preconditioned CG on ``shard_inputs``
vectors, the block smoothers), and the port's single-device plain
counterpart. It returns the numbers and, for the caller's comparisons, its
solution as a float64 numpy array. The caller holds the list of cases and
passes it in, as plain data that a spawned rank unpickles without
importing the caller.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..applications.poisson import solve_poisson
from ..core import bc as bc_mod
from ..core.device import resolve_device
from ..core.grid import Grid
from ..models import problems as P
from ..ops import norms, smooth as smooth_mod, stencil as st_mod
from ..ops.cuda_kernels import smooth as k_smooth, smooth_var as k_smooth_var
from ..preconditioning import multigrid_preconditioner
from ..solvers import krylov
from ..solvers.multigrid import MultigridConfig, build_hierarchy, mg_solve
from . import blocks as bk, distributed, halo_solve as hs, mesh as mesh_mod, \
    multihost

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


class Case(NamedTuple):
    """One check: what to run (``kind``: the explicit path's 'solve',
    'overlap', 'raises', 'smooth', 'norm' or 'field'; the GSPMD path's
    'sharded', 'frontend', 'pcg' or 'smooth_blocks'), on which problem of
    ``PROBLEMS`` at n x n, on which mesh (None: the 2D mesh of the whole
    world; four axes: a graded mesh), in which dtype, with which
    ``MultigridConfig`` changes from ``CFG``, and with which entry-point
    ``options`` ('use_fmg'; 'precision'; 'tol' and 'maxiter' of CG;
    'repeats': timed calls after the first, whose minimum is reported)."""

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
    """Launches of the smoothing kernels A and H so far (the wrappers'
    counts: CUDA launches only)."""
    return k_smooth.multisweep.launches + k_smooth_var.multisweep_var.launches


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


def _compare(case, mesh, run, cfg, device):
    """``run(mesh, cfg)`` (an entry point on a mesh, or on None for the
    single-device call) on ``mesh`` beside the same call on a
    one-rank mesh (the single-device solve under the hook, which the
    sharded one must equal), the single-device plain call (backend
    'torch') and, on a card, the kernel path's (backend 'auto', unhooked),
    each timed: (the sharded result, the one-rank one, the plain one, the
    record's numbers)."""
    repeats = (case.options or {}).get("repeats", 0)
    got, first, best, launches = _best(lambda: run(mesh, cfg), device,
                                       repeats)
    one, _, one_best, one_launches = _best(
        lambda: run(one_rank_mesh(), cfg), device, repeats)
    plain = cfg.replace(backend="torch")
    ref, ref_first, ref_best, _ = _best(lambda: run(None, plain), device,
                                        repeats)
    out = {"seconds": first, "best": best, "ref_seconds": ref_first,
           "ref_best": ref_best, "one_best": one_best,
           "launches": launches, "one_launches": one_launches}
    if torch.device(device).type == "cuda":
        out["kernel_best"] = _best(lambda: run(
            None, cfg.replace(backend="auto")), device, max(repeats, 1))[2]
    return got, one, ref, out


def _record(u, info, one, ref, prob) -> dict:
    """A GSPMD solve's numbers beside those of its one-rank and plain
    single-device references ((solution, info) each)."""
    out = {"iterations": info["iterations"], "converged": info["converged"],
           "history": np.asarray(info["history"]).tolist(),
           "one_iterations": one[1]["iterations"],
           "max_diff_one": float((u.double() - one[0].double()).abs().max()),
           "ref_iterations": ref[1]["iterations"],
           "ref_converged": ref[1]["converged"],
           "max_diff_ref": float((u.double() - ref[0].double()).abs().max()),
           "u": _np(u)}
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
    return {k: v for k, v in (case.options or {}).items() if k != "repeats"}


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


def run_case(case: Case, device=None, meshes=None) -> dict:
    """``case`` on this rank (on ``device``, the card by default); its
    numbers and solution."""
    device = resolve_device(device)
    meshes = {} if meshes is None else meshes
    mesh = _mesh(case.mesh, meshes)
    kind = case.kind
    gspmd = {"sharded": _sharded_case, "frontend": _frontend_case,
             "pcg": _pcg_case, "smooth_blocks": _smooth_blocks_case}
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
    return out
