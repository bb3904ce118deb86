"""Rank functions that hold the explicit distribution path against the
single-device solver, for ``launch.run``.

Every rank of a world runs ``run_cases(cases, device)``: each ``Case``
names a problem, a size, a mesh shape, a dtype and configuration changes;
it builds its problem and hierarchy on the rank's device, solves it with
``halo_solve`` on its mesh (or runs ``shard_smooth``,
``global_residual_norm`` or ``make_sharded_field``) and with the port's
single-device ``mg_solve`` (or plain smoother, norm, field), and returns
the numbers and, for the caller's comparisons, its solution as a float64
numpy array. The caller holds the list of cases and passes it in, as
plain data that a spawned rank unpickles without importing the caller.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import bc as bc_mod
from ..core.grid import Grid
from ..models import problems as P
from ..ops import norms, smooth as smooth_mod, stencil as st_mod
from ..solvers.multigrid import MultigridConfig, build_hierarchy, mg_solve
from . import halo_solve as hs, mesh as mesh_mod, multihost

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
}


class Case(NamedTuple):
    """One check: what to run (``kind``: 'solve', 'overlap', 'raises',
    'smooth', 'norm' or 'field'), on which problem of ``PROBLEMS`` at n x n,
    on which mesh (None: the mesh of the whole world), in which dtype, with
    which ``MultigridConfig`` changes from ``CFG``."""

    kind: str
    problem: str
    n: int
    mesh: Optional[Tuple[int, int]]
    dtype: str = "float64"
    changes: Optional[dict] = None


def case_inputs(case: Case, device="cpu"):
    """The problem, configuration and hierarchy of ``case`` (the same on
    every rank and in the caller)."""
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
        meshes[shape] = (multihost.make_global_mesh() if shape is None
                         else mesh_mod.make_mesh(shape=shape))
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


def run_case(case: Case, device="cpu", meshes=None) -> dict:
    """``case`` on this rank; its numbers and solution."""
    meshes = {} if meshes is None else meshes
    mesh = _mesh(case.mesh, meshes)
    kind = case.kind
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


def run_cases(cases: Dict[str, Case], device: str = "cpu") -> dict:
    """Every case of ``cases`` on this rank, in order (every rank runs the
    same cases); ``device`` 'cuda' means this rank's card. Also the mesh
    shape of each case."""
    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    meshes = {}
    out = {"rank": dist.get_rank() if dist.is_initialized() else 0,
           "summary": multihost.process_summary()}
    for name, case in cases.items():
        out[name] = run_case(case, device, meshes)
        out[name]["mesh"] = list(_mesh(case.mesh, meshes).shape.values())
    return out
