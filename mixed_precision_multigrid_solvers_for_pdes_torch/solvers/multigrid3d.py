"""3D geometric multigrid: V and W cycles, the cycle-iteration solve and
mixed-precision iterative refinement.

Counterpart of ``Level3D``, ``build_hierarchy3d`` (rediscretization or
Galerkin coarsening, one dtype or a ``PrecisionPolicy``'s per-level
dtypes), ``smooth3d``, ``_cycle3``, ``mg_cycle3d``, ``mg_solve3d`` and
``ir_solve3d`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/multigrid3d.py``.
It shares ``MultigridConfig``, ``outer_iterate`` and ``tolerance`` with
``solvers/multigrid.py``. ``smooth3d`` is the plain smoother of
``ops/smooth3d.py``.

As in 2D, the cycle recursion runs in Python and each level step goes
through ``ops/dispatch.py``, which picks the CUDA kernels (E, F, G) or the
plain path; cycles update the fine-level iterate IN PLACE. The JAX
package's 3D cycle makes the second coarse visit for 'W' only, so a 3D
'F' cycle is a V-cycle there and here. It always restricts by full
weighting ('zero' on a plain spec, 'reflect' with Neumann/Robin faces, the
coarse right-hand side then zeroed off the coarse unknowns) and prolongs
trilinearly. A periodic level syncs its duplicate nodes where they are
read (the coarse correction before it is prolonged) and where a solution
is handed out (the end of ``mg_solve3d`` and ``ir_solve3d``); its
operators read the wrap neighbours directly. Levels may differ in dtype
(a fine fp32 level over coarse bf16 ones under 'mixed'): the residual is
restricted into the coarse level's dtype and the correction prolonged into
the fine level's. With ``coarsening='galerkin'`` every level below the
finest holds the RAP operator of the level above (``ops/galerkin.py``), a
``Stencil27``, built in float64 down the chain and cast to each level's
dtype; such levels take no kernel.

``constrain=`` is a sharding hook, as in the JAX package: an array hook,
(array, Level3D) -> array (``multigrid.whole``), applied to the coarse
right-hand side and the prolonged correction of each cycle and to the
float64 iterate of ``ir_solve3d``, turns the fused transfers F and G off
(the JAX package's ``_cycle3`` :239) and leaves smoothing dispatched (E);
``parallel.distributed.make_constrainer3d``'s hook (a ``BlockHook``)
takes the whole cycle or solve and runs it on this rank's (x, y) blocks
of whole z-lines, as ``mg_solve`` hands its work over in 2D.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core import bc3d
from ..core.bc3d import BoundarySpec3D
from ..core.device import resolve_device
from ..core.grid3d import Grid3D
from ..core.precision import PrecisionPolicy, as_dtype
from ..ops import dispatch, galerkin as galerkin_mod, norms, \
    stencil3d as st3, transfer3d
from ..ops.smooth import RBGS_METHODS
from ..ops.smooth3d import smooth3d  # noqa: F401  (re-exported)
from ..ops.stencil3d import Stencil3D
from .multigrid import BlockHook, MultigridConfig, outer_iterate, \
    tolerance


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

    @functools.cached_property
    def sync(self):
        """In-place refresh of the periodic duplicate nodes, or None
        (``core/bc3d.periodic_sync3d``)."""
        return bc3d.periodic_sync3d(self.spec)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.grid.shape, dtype=self.dtype,
                           device=self.device)


def _block_hook(constrain):
    """``constrain`` when it is a block hook of 3D levels
    (``make_constrainer3d``), else None."""
    if not isinstance(constrain, BlockHook):
        return None
    if getattr(constrain, "dims", 2) != 3:
        raise ValueError("the 3D solvers take make_constrainer3d's hook, "
                         "not a 2D one")
    return constrain


def _sample_coarse3(field):
    """Injection-sample an (nx, ny, nz) node field onto the 2:1 coarse
    grid; scalars pass through."""
    if field is None or np.ndim(field) == 0:
        return field
    return field[::2, ::2, ::2]


def build_hierarchy3d(grid: Grid3D, spec: BoundarySpec3D = BoundarySpec3D(),
                      *, a=None, lam=0.0, dtype=None,
                      policy: PrecisionPolicy = None, device=None,
                      cfg: MultigridConfig = MultigridConfig()
                      ) -> Tuple[Level3D, ...]:
    """Levels by repeated 2:1 coarsening, finest first. With
    ``cfg.coarsening='rediscretize'`` the coefficient field ``a`` and an
    array ``lam`` ((nx, ny, nz), any array type) are injection-sampled onto
    each coarse grid and the operator is rebuilt there; with 'galerkin'
    each coarse operator is the RAP of the one above in float64, from the
    finest level's operator in float64, cast to the level's dtype. The
    levels' dtypes come from ``policy`` when it is given
    (``PrecisionPolicy.level_dtypes``), else every level takes ``dtype``
    (float32 by default)."""
    if cfg.coarsening not in ("rediscretize", "galerkin"):
        raise ValueError(f"unknown coarsening {cfg.coarsening!r}")
    device = resolve_device(device)
    grids = [grid]
    while grids[-1].can_coarsen() and len(grids) < cfg.max_levels:
        grids.append(grids[-1].coarsen())
    if policy is not None:
        dtypes = policy.level_dtypes(len(grids))
    else:
        dtypes = (as_dtype(torch.float32 if dtype is None else dtype),) \
            * len(grids)
    galerkin = cfg.coarsening == "galerkin"
    levels = []
    for i, (g, dt) in enumerate(zip(grids, dtypes)):
        if i == 0 or not galerkin:
            st = st3.make_stencil3d(g, spec, a=a, lam=lam, dtype=dt,
                                    device=device)
            if galerkin:
                st_hi = st3.make_stencil3d(g, spec, a=a, lam=lam,
                                           dtype=torch.float64, device=device)
        else:
            st_hi = galerkin_mod.galerkin_coarse_stencil3d(
                st_hi, grids[i - 1], g, spec, device=device)
            st = st_hi.astype(dt)
        levels.append(Level3D(stencil=st, grid=g, spec=spec, dtype=dt,
                              device=device))
        a, lam = _sample_coarse3(a), _sample_coarse3(lam)
    return tuple(levels)


def _smooth3(lev: Level3D, u, f, cfg: MultigridConfig, *, method: str,
             sweeps: int, omega: float, reverse: bool = False):
    if sweeps <= 0:
        return u
    return dispatch.smooth3d(lev, u, f, method=method, sweeps=sweeps,
                             omega=omega, reverse=reverse,
                             backend=cfg.backend)


def _cycle3(levels: Tuple[Level3D, ...], u, f, lvl: int,
            cfg: MultigridConfig, cycle_type: str, constrain=None):
    """One cycle from level ``lvl``; ``constrain`` is an array hook (see the
    module docstring): with one, F and G are off."""
    if cycle_type not in ("V", "W", "F"):
        raise ValueError(f"unknown cycle {cycle_type!r}")
    lev = levels[lvl]
    if lvl == len(levels) - 1:
        # coarsest: RB-GS to (near-)exactness
        return _smooth3(lev, u, f, cfg, method="rbgs",
                        sweeps=cfg.coarse_sweeps, omega=1.0)

    u = _smooth3(lev, u, f, cfg, method=cfg.smoother, sweeps=cfg.pre_sweeps,
                 omega=cfg.omega)
    nxt = levels[lvl + 1]
    fused = constrain is None and dispatch.transfer_fused3d_ok(lev, nxt, cfg,
                                                               u, f)
    if fused:
        fc = dispatch.residual_restrict3d(lev, nxt, u, f)
    else:
        # 3D always restricts by full weighting, as the JAX package does
        r = st3.residual(lev.stencil, u, f, lev.unknown)
        plain = lev.spec.plain
        fc = transfer3d.restrict3d(r, *nxt.grid.shape,
                                   boundary="zero" if plain else "reflect",
                                   dtype=nxt.dtype, wrap=lev.spec.wrap)
        if constrain is not None:
            fc = constrain(fc, nxt)
        if not plain:
            fc = torch.where(nxt.unknown, fc, torch.zeros(
                (), dtype=fc.dtype, device=fc.device))
    branch = cycle_type if lvl + 1 < cfg.w_depth else "V"
    ec = _cycle3(levels, nxt.zeros(), fc, lvl + 1, cfg, branch, constrain)
    if cycle_type == "W" and branch == "W":
        ec = _cycle3(levels, ec, fc, lvl + 1, cfg, "W", constrain)
    if fused:
        u = dispatch.prolong_correct3d(lev, nxt, ec, u)
    else:
        if nxt.sync is not None:
            nxt.sync(ec)  # the coarse duplicate enters the interpolation
        e = transfer3d.prolong3d(ec, *lev.grid.shape, dtype=lev.dtype)
        if constrain is not None:
            e = constrain(e, lev)
        u = torch.where(lev.unknown, u + e, u)
    return _smooth3(lev, u, f, cfg, method=cfg.smoother,
                    sweeps=cfg.post_sweeps, omega=cfg.omega,
                    reverse=cfg.symmetric and cfg.smoother in RBGS_METHODS)


def mg_cycle3d(levels: Tuple[Level3D, ...], u, f,
               cfg: MultigridConfig = MultigridConfig(), constrain=None):
    """One multigrid cycle on the finest level; updates ``u`` in place where
    the path allows and returns the new iterate. ``make_constrainer3d``'s
    hook runs it on this rank's blocks (``u`` and ``f`` global tensors, the
    result gathered, or level-0 ``ShardedField`` blocks, the result one)."""
    hook = _block_hook(constrain)
    if hook is not None:
        return hook.mg_cycle(levels, u, f, cfg)
    return _cycle3(levels, u, f, 0, cfg, cfg.cycle, constrain)


def _norm3(r, g: Grid3D) -> torch.Tensor:
    return norms.scaled_l2(r, g.hx, g.hy, g.hz)


def mg_solve3d(levels: Tuple[Level3D, ...], f, u0=None,
               cfg: MultigridConfig = MultigridConfig(), *, constrain=None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Solve A u = f by repeated cycles at the finest level's dtype.

    ``f`` and ``u0`` are (nx, ny, nz) tensors; ``u0`` carries the Dirichlet
    values on its shell. The tolerance scale is max(||f||, ||r(u0)||).
    Returns the solution and an info dict. ``make_constrainer3d``'s hook
    runs the solve on this rank's blocks, every rank of the mesh calling
    it (``f`` and ``u0`` global, or ``shard_inputs`` blocks), and every
    rank gets the global solution."""
    hook = _block_hook(constrain)
    if hook is not None:
        return hook.mg_solve(levels, f, u0, cfg)
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
        state["u"] = mg_cycle3d(levels, state["u"], f, cfg, constrain)
        return _norm3(st3.residual(lev0.stencil, state["u"], f, unknown), g)

    info = outer_iterate(step, rnorm0, tol_eff, fnorm, cfg.max_iterations)
    if lev0.sync is not None:
        lev0.sync(state["u"])  # consistent duplicate nodes for the output
    return state["u"], info


def ir_solve3d(levels: Tuple[Level3D, ...], f, u0=None,
               cfg: MultigridConfig = MultigridConfig(), *,
               inner_cycles: int = 2, max_outer: int = 100, constrain=None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """3D mixed-precision solve: float64 solution, residual and norms around
    low-precision cycles on ``levels``.

    Each outer step runs ``inner_cycles`` cycles on the residual cast to
    level 0's dtype, starting the correction from zero, and adds it on
    unknowns (in place on an all-Dirichlet box, whose unknowns are the
    interior). The stopping test reads the residual norm back once per
    outer step; a periodic solution's duplicate nodes are synced at the
    end (the JAX package's ``_ir3_jit`` leaves them at the initial
    guess). ``make_constrainer3d``'s hook runs it on this rank's blocks,
    the float64 solution and residual kept there (as ``mg_solve3d``); an
    array hook is applied to the float64 iterate too."""
    hook = _block_hook(constrain)
    if hook is not None:
        return hook.ir_solve(levels, f, u0, cfg, inner_cycles=inner_cycles,
                             max_outer=max_outer, use_fmg=False)
    lev0 = levels[0]
    g, unknown = lev0.grid, lev0.unknown
    lo, f64 = lev0.dtype, torch.float64
    st_hi = lev0.stencil.astype(f64)
    f = f.to(device=lev0.device, dtype=f64)
    u = (torch.zeros(g.shape, dtype=f64, device=lev0.device) if u0 is None
         else u0.to(device=lev0.device, dtype=f64, copy=True))
    fnorm = norms.masked_scaled_l2(f, unknown, g.hx, g.hy, g.hz)
    state = {"u": u, "r": st3.residual(st_hi, u, f, unknown)}
    rnorm0 = _norm3(state["r"], g)
    tol_eff = tolerance(cfg, torch.maximum(fnorm, rnorm0))
    box = lev0.spec.all_dirichlet

    def step():
        e = lev0.zeros()
        r_lo = state["r"].to(lo)
        for _ in range(inner_cycles):
            e = mg_cycle3d(levels, e, r_lo, cfg, constrain)
        if constrain is not None:
            state["u"] = constrain(torch.where(
                unknown, state["u"] + e.to(f64), state["u"]), lev0)
        elif box:
            # e is zero on the shell, so this is the masked update u += e
            u[1:-1, 1:-1, 1:-1] += e[1:-1, 1:-1, 1:-1]
        else:
            state["u"] = torch.where(unknown, state["u"] + e.to(f64),
                                     state["u"])
        state["r"] = st3.residual(st_hi, state["u"], f, unknown)
        return _norm3(state["r"], g)

    info = outer_iterate(step, rnorm0, tol_eff, fnorm, max_outer)
    if lev0.sync is not None:
        lev0.sync(state["u"])
    info["method"] = "iterative_refinement_3d"
    return state["u"], info
