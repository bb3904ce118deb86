"""3D geometric multigrid: V-cycles, the cycle-iteration solve and
mixed-precision iterative refinement.

Counterpart of ``Level3D``, ``build_hierarchy3d`` (rediscretization, one
dtype), ``smooth3d``, ``_cycle3`` (V), ``mg_cycle3d``, ``mg_solve3d`` and
``ir_solve3d`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/multigrid3d.py``.
It shares ``MultigridConfig``, ``outer_iterate`` and ``tolerance`` with
``solvers/multigrid.py``. ``smooth3d`` is the plain smoother of
``ops/smooth3d.py``.

As in 2D, the cycle recursion runs in Python and each level step goes
through ``ops/dispatch.py``, which picks the CUDA kernels (E, F, G) or the
plain path; cycles update the fine-level iterate IN PLACE. Not ported yet,
each raising ``NotImplementedError`` with its ROADMAP item: W-cycles and the
'line_z' smoother (13), Galerkin coarsening (10), per-level dtype policies
(9), sharding constraints (14).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from ..core import bc3d
from ..core.bc3d import BoundarySpec3D
from ..core.device import resolve_device
from ..core.grid3d import Grid3D
from ..core.precision import as_dtype
from ..ops import dispatch, norms, stencil3d as st3, transfer3d
from ..ops.smooth import RBGS_METHODS
from ..ops.smooth3d import smooth3d  # noqa: F401  (re-exported)
from ..ops.stencil3d import Stencil3D
from .multigrid import MultigridConfig, outer_iterate, tolerance


@dataclasses.dataclass(frozen=True)
class Level3D:
    """One 3D grid level: stencil, geometry, BCs, dtype and device."""

    stencil: Stencil3D
    grid: Grid3D
    spec: BoundarySpec3D
    dtype: torch.dtype
    device: torch.device

    @functools.cached_property
    def unknown(self) -> torch.Tensor:
        """Bool (nx, ny, nz) mask of the nodes the solver owns (built
        once)."""
        return bc3d.unknown_mask3d(*self.grid.shape, self.spec,
                                   device=self.device)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.grid.shape, dtype=self.dtype,
                           device=self.device)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _check_options(constrain) -> None:
    if constrain is not None:
        raise _not_ported("constrain= (3D sharding)", "item 14")


def build_hierarchy3d(grid: Grid3D, spec: BoundarySpec3D = BoundarySpec3D(),
                      *, a=None, lam: float = 0.0, dtype=torch.float32,
                      policy=None, device=None,
                      cfg: MultigridConfig = MultigridConfig()
                      ) -> Tuple[Level3D, ...]:
    """Levels by repeated 2:1 coarsening and rediscretization, finest first,
    all in ``dtype``."""
    if policy is not None:
        raise _not_ported("policy= (per-level dtypes in 3D)", "item 13")
    if cfg.coarsening != "rediscretize":
        raise _not_ported(f"3D coarsening {cfg.coarsening!r}", "item 13")
    dtype = as_dtype(dtype)
    device = resolve_device(device)
    grids = [grid]
    while grids[-1].can_coarsen() and len(grids) < cfg.max_levels:
        grids.append(grids[-1].coarsen())
    return tuple(
        Level3D(stencil=st3.make_stencil3d(g, spec, a=a, lam=lam,
                                           dtype=dtype),
                grid=g, spec=spec, dtype=dtype, device=device)
        for g in grids)


def _smooth3(lev: Level3D, u, f, cfg: MultigridConfig, *, method: str,
             sweeps: int, omega: float, reverse: bool = False):
    if sweeps <= 0:
        return u
    return dispatch.smooth3d(lev, u, f, method=method, sweeps=sweeps,
                             omega=omega, reverse=reverse,
                             backend=cfg.backend)


def _cycle3(levels: Tuple[Level3D, ...], u, f, lvl: int,
            cfg: MultigridConfig, cycle_type: str):
    if cycle_type != "V":
        raise _not_ported(f"3D {cycle_type}-cycles", "item 13")
    lev = levels[lvl]
    if lvl == len(levels) - 1:
        # coarsest: RB-GS to (near-)exactness
        return _smooth3(lev, u, f, cfg, method="rbgs",
                        sweeps=cfg.coarse_sweeps, omega=1.0)

    u = _smooth3(lev, u, f, cfg, method=cfg.smoother, sweeps=cfg.pre_sweeps,
                 omega=cfg.omega)
    nxt = levels[lvl + 1]
    fused = dispatch.transfer_fused3d_ok(lev, nxt, cfg, u, f)
    if fused:
        fc = dispatch.residual_restrict3d(lev, nxt, u, f)
    else:
        # 3D always restricts by full weighting, as the JAX package does
        r = st3.residual(lev.stencil, u, f, lev.unknown)
        fc = transfer3d.restrict3d(r, *nxt.grid.shape, boundary="zero",
                                   dtype=nxt.dtype)
    ec = _cycle3(levels, nxt.zeros(), fc, lvl + 1, cfg, "V")
    if fused:
        u = dispatch.prolong_correct3d(lev, nxt, ec, u)
    else:
        e = transfer3d.prolong3d(ec, *lev.grid.shape, dtype=lev.dtype)
        u = torch.where(lev.unknown, u + e, u)
    return _smooth3(lev, u, f, cfg, method=cfg.smoother,
                    sweeps=cfg.post_sweeps, omega=cfg.omega,
                    reverse=cfg.symmetric and cfg.smoother in RBGS_METHODS)


def mg_cycle3d(levels: Tuple[Level3D, ...], u, f,
               cfg: MultigridConfig = MultigridConfig(), constrain=None):
    """One multigrid cycle on the finest level; updates ``u`` in place where
    the path allows and returns the new iterate."""
    _check_options(constrain)
    return _cycle3(levels, u, f, 0, cfg, cfg.cycle)


def _norm3(r, g: Grid3D) -> torch.Tensor:
    return norms.scaled_l2(r, g.hx, g.hy, g.hz)


def mg_solve3d(levels: Tuple[Level3D, ...], f, u0=None,
               cfg: MultigridConfig = MultigridConfig(), *, constrain=None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Solve A u = f by repeated cycles at the finest level's dtype.

    ``f`` and ``u0`` are (nx, ny, nz) tensors; ``u0`` carries the Dirichlet
    values on its shell. The tolerance scale is max(||f||, ||r(u0)||).
    Returns the solution and an info dict."""
    _check_options(constrain)
    lev0 = levels[0]
    g, unknown = lev0.grid, lev0.unknown
    f = f.to(device=lev0.device, dtype=lev0.dtype)
    u = (lev0.zeros() if u0 is None
         else u0.to(device=lev0.device, dtype=lev0.dtype, copy=True))
    fnorm = norms.masked_scaled_l2(f, unknown, g.hx, g.hy, g.hz)
    rnorm0 = _norm3(st3.residual(lev0.stencil, u, f, unknown), g)
    tol_eff = tolerance(cfg, torch.maximum(fnorm, rnorm0))
    state = {"u": u}

    def step():
        state["u"] = mg_cycle3d(levels, state["u"], f, cfg)
        return _norm3(st3.residual(lev0.stencil, state["u"], f, unknown), g)

    info = outer_iterate(step, rnorm0, tol_eff, fnorm, cfg.max_iterations)
    return state["u"], info


def ir_solve3d(levels: Tuple[Level3D, ...], f, u0=None,
               cfg: MultigridConfig = MultigridConfig(), *,
               inner_cycles: int = 2, max_outer: int = 100, constrain=None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """3D mixed-precision solve: float64 solution, residual and norms around
    low-precision cycles on ``levels``.

    Each outer step runs ``inner_cycles`` cycles on the residual cast to the
    hierarchy's dtype, starting the correction from zero, and adds it on
    unknowns (the interior, updated in place). The stopping test reads the
    residual norm back once per outer step."""
    _check_options(constrain)
    lev0 = levels[0]
    g, unknown = lev0.grid, lev0.unknown
    lo, f64 = lev0.dtype, torch.float64
    st_hi = lev0.stencil.astype(f64)
    f = f.to(device=lev0.device, dtype=f64)
    u = (torch.zeros(g.shape, dtype=f64, device=lev0.device) if u0 is None
         else u0.to(device=lev0.device, dtype=f64, copy=True))
    fnorm = norms.masked_scaled_l2(f, unknown, g.hx, g.hy, g.hz)
    state = {"r": st3.residual(st_hi, u, f, unknown)}
    rnorm0 = _norm3(state["r"], g)
    tol_eff = tolerance(cfg, torch.maximum(fnorm, rnorm0))

    def step():
        e = lev0.zeros()
        r_lo = state["r"].to(lo)
        for _ in range(inner_cycles):
            e = mg_cycle3d(levels, e, r_lo, cfg)
        # e is zero on the shell, so this is the masked update u += e
        u[1:-1, 1:-1, 1:-1] += e[1:-1, 1:-1, 1:-1]
        state["r"] = st3.residual(st_hi, u, f, unknown)
        return _norm3(state["r"], g)

    info = outer_iterate(step, rnorm0, tol_eff, fnorm, max_outer)
    info["method"] = "iterative_refinement_3d"
    return u, info
