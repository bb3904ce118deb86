"""Geometric multigrid driver: V, W and F cycles, FMG and the
cycle-iteration solve.

Counterpart of ``Level``, ``MultigridConfig``, ``build_hierarchy``
(rediscretization), ``_cycle``, ``mg_cycle``, ``fmg``, ``mg_solve``,
``_unpack_info``, ``_sample_coarse`` and ``convergence_factor`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/multigrid.py``,
Galerkin coarsening included.

PyTorch runs eagerly, so the cycle recursion runs in Python and each level
step goes through ``ops/dispatch.py``, which picks the CUDA kernels or the
plain path. Cycles update the fine-level iterate IN PLACE (the smoothers and
the prolongation-correction write into it) and return it. The outer loop's
stopping test reads the residual norm back to the host once per iteration.
A periodic level syncs its duplicate nodes where they are read (a coarse
field before it is prolonged, in the cycle and in FMG) and where a solution
is handed out (the end of ``mg_solve``); its operators and smoothers read
the wrap neighbours directly. The JAX package's FMG prolongs a duplicate
one update stale (its smoothers sync before each update, not
after); the port's prolongs it fresh.
A level may carry an irregular domain (``core/domain.py``), ANDed into its
unknowns; such a level takes no kernel. A hierarchy's levels may differ in
dtype (``PrecisionPolicy.level_dtypes``): the residual is restricted into
the coarse level's dtype and the correction prolonged into the fine
level's. The fields of a level may be wider than the level (a multigrid
preconditioner under an fp64 Krylov loop hands level 0 an fp64 iterate):
they then stay wide through that level's smoothing, residual and
correction, as PyTorch's type promotion and the JAX package's agree, and
the kernel gates send that level to the plain path.
With ``coarsening='galerkin'`` every level below the finest holds the RAP
operator of the level above (``ops/galerkin.py``), a ``Stencil9``, built
in ``galerkin_dtype`` down the chain and cast to each level's dtype; such
levels take no 2D kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..core import bc as bc_mod, domain as domain_mod
from ..core.bc import BoundarySpec
from ..core.device import resolve_device
from ..core.grid import Grid
from ..core.precision import PrecisionPolicy, as_dtype
from ..ops import dispatch, galerkin as galerkin_mod, norms, \
    smooth as smooth_mod, stencil as st_mod, transfer
from ..ops.stencil import Stencil
from ..utils.timing import span, spanned


@dataclasses.dataclass(frozen=True)
class Level:
    """One grid level: stencil, geometry, BCs, dtype and device, and an
    optional irregular domain (``core/domain.py``; None is the whole
    rectangle)."""

    stencil: Stencil
    grid: Grid
    spec: BoundarySpec
    dtype: torch.dtype
    device: torch.device
    domain: Any = None

    @functools.cached_property
    def unknown(self) -> torch.Tensor:
        """Bool (nx, ny) mask of the nodes the solver owns (built once)."""
        return domain_mod.unknown_mask(self.grid, self.spec, self.domain,
                                       device=self.device)

    @functools.cached_property
    def sync(self):
        """In-place refresh of the periodic duplicate nodes, or None
        (``core/bc.periodic_sync``)."""
        return bc_mod.periodic_sync(self.spec)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.grid.shape, dtype=self.dtype,
                           device=self.device)


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    """Static solver configuration."""

    cycle: str = "V"              # V | W | F
    pre_sweeps: int = 2
    post_sweeps: int = 2
    smoother: str = "jacobi"      # jacobi | rbgs | sor | line_x | line_y
                                  # | adi | chebyshev
    omega: float = 0.8
    coarse_sweeps: int = 32
    max_levels: int = 32
    restriction: str = "full_weighting"
    prolongation: str = "bilinear"
    max_iterations: int = 100
    tol: float = 1e-10
    rtol: bool = True             # tolerance relative to max(||f||, ||r0||)
    backend: str = "auto"         # auto | torch (see ops/dispatch.py)
    # 'rediscretize' rebuilds the operator on each coarse grid; 'galerkin'
    # forms A_c = R A P (ops/galerkin.py), 9-point below the finest level
    coarsening: str = "rediscretize"
    # the RAP chain's dtype for coarsening='galerkin'
    galerkin_dtype: str = "float64"
    # W/F branching applies on the finest `w_depth` levels; below them the
    # recursion is a V-cycle
    w_depth: int = 4
    # symmetric=True reverses the RB-GS colour order in post-smoothing,
    # which makes the V-cycle a symmetric operator
    symmetric: bool = False

    def replace(self, **kw) -> "MultigridConfig":
        return dataclasses.replace(self, **kw)


def _sample_coarse(field):
    """Injection-sample an (nx, ny) node field onto the 2:1 coarse grid;
    scalars pass through."""
    if field is None or np.ndim(field) == 0:
        return field
    return field[::2, ::2]


def build_hierarchy(grid: Grid, spec: BoundarySpec = BoundarySpec(), *,
                    a=None, lam=0.0, policy: PrecisionPolicy = None,
                    dtype=None, domain=None, device=None,
                    cfg: MultigridConfig = MultigridConfig()
                    ) -> Tuple[Level, ...]:
    """Levels by repeated 2:1 coarsening, finest first. With
    ``cfg.coarsening='rediscretize'`` the coefficient field ``a`` and an
    array ``lam`` ((nx, ny), any array type) are injection-sampled onto each
    coarse grid and the operator is rebuilt there; with 'galerkin' each
    coarse operator is the RAP of the one above, computed in
    ``cfg.galerkin_dtype`` from the finest level's operator in that dtype
    and cast to the level's. The levels' dtypes come from ``policy`` when
    it is given (``PrecisionPolicy.level_dtypes``), else every level takes
    ``dtype`` (float32 by default); every level carries ``domain``."""
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
    rap_dt = as_dtype(cfg.galerkin_dtype)
    levels = []
    for i, (g, dt) in enumerate(zip(grids, dtypes)):
        if i == 0 or not galerkin:
            st = st_mod.make_stencil(g, spec, a=a, lam=lam, dtype=dt,
                                     device=device)
            if galerkin:
                st_hi = st_mod.make_stencil(g, spec, a=a, lam=lam,
                                            dtype=rap_dt, device=device)
        else:
            st_hi = galerkin_mod.galerkin_coarse_stencil(
                st_hi, grids[i - 1], g, spec, domain=domain, dtype=rap_dt,
                restriction=cfg.restriction, prolongation=cfg.prolongation,
                device=device)
            st = st_hi.astype(dt)
        levels.append(Level(stencil=st, grid=g, spec=spec, dtype=dt,
                            device=device, domain=domain))
        a, lam = _sample_coarse(a), _sample_coarse(lam)
    return tuple(levels)


def _smooth(lev: Level, u, f, cfg: MultigridConfig, sweeps: int,
            post: bool = False):
    if sweeps <= 0:
        return u
    method = cfg.smoother
    if post and cfg.symmetric and method in smooth_mod.RBGS_METHODS:
        method = "rbgs_rev"  # adjoint colour order -> symmetric cycle
    return dispatch.smooth(lev.stencil, u, f, lev, method=method,
                           sweeps=sweeps, omega=cfg.omega,
                           backend=cfg.backend)


class BlockHook:
    """A sharding hook that runs whole solves on this rank's blocks
    (``parallel.distributed.Constrainer``): ``mg_cycle``, ``fmg``,
    ``mg_solve`` and ``refinement.ir_solve`` hand it their work. Any other
    ``constrain=`` is an array hook, (array, Level) -> array, as in the
    JAX package (``whole``)."""


def whole(arr, lev):
    """The array hook of levels every rank holds whole (a mesh of one rank,
    the replicated levels of a sharded hierarchy): the identity. Under it,
    as under any hook, the cycle takes no tail kernel and no fused
    transfer, as the JAX package's does; smoothing still dispatches."""
    return arr


def _cycle(levels: Tuple[Level, ...], u, f, lvl: int, cfg: MultigridConfig,
           cycle_type: str, constrain=None):
    """One cycle from level ``lvl``. ``constrain`` is an array hook
    ((array, Level) -> array, e.g. ``whole``), applied to the coarse
    right-hand side and the prolonged correction; with one, as in the JAX
    package's ``_cycle``, the tail kernel and the fused transfers are
    off."""
    if cycle_type not in ("V", "W", "F"):
        raise ValueError(f"unknown cycle {cycle_type!r}")
    lev = levels[lvl]
    if constrain is None and dispatch.tail_ok(levels, lvl, cfg, cycle_type,
                                              u, f):
        # the whole remaining V-recursion in one tail-kernel launch
        return dispatch.tail_vcycle(levels, lvl, u, f, cfg)
    if lvl == len(levels) - 1:
        # coarsest: RB-GS to (near-)exactness; exact in one sweep when a
        # single interior unknown remains
        coarse_cfg = cfg.replace(smoother="rbgs", omega=1.0)
        return _smooth(lev, u, f, coarse_cfg, cfg.coarse_sweeps)

    u = _smooth(lev, u, f, cfg, cfg.pre_sweeps)
    nxt = levels[lvl + 1]
    fused = constrain is None and dispatch.transfer_fused_ok(lev, nxt, cfg,
                                                             u, f)
    if fused:
        fc = dispatch.residual_restrict(lev, nxt, u, f)
    else:
        r = st_mod.residual(lev.stencil, u, f, lev.unknown)
        # 'reflect' restricts onto every ring; Dirichlet rings are zeroed
        boundary = "zero" if lev.spec.plain else "reflect"
        fc = transfer.restrict(r, nxt.grid.nx, nxt.grid.ny,
                               method=cfg.restriction, boundary=boundary,
                               dtype=nxt.dtype, wrap=lev.spec.wrap)
        if constrain is not None:
            fc = constrain(fc, nxt)
        if boundary == "reflect":
            fc = torch.where(nxt.unknown, fc, torch.zeros(
                (), dtype=fc.dtype, device=fc.device))
    ec = nxt.zeros()
    branch = cycle_type if lvl + 1 < cfg.w_depth else "V"
    if branch == "V":
        ec = _cycle(levels, ec, fc, lvl + 1, cfg, "V", constrain)
    elif branch == "W":
        ec = _cycle(levels, ec, fc, lvl + 1, cfg, "W", constrain)
        ec = _cycle(levels, ec, fc, lvl + 1, cfg, "W", constrain)
    else:  # F: an F-recursion, then a V-recursion
        ec = _cycle(levels, ec, fc, lvl + 1, cfg, "F", constrain)
        ec = _cycle(levels, ec, fc, lvl + 1, cfg, "V", constrain)
    if fused:
        u = dispatch.prolong_correct(lev, nxt, ec, u)
    else:
        if nxt.sync is not None:
            nxt.sync(ec)  # the coarse duplicate enters the interpolation
        e = transfer.prolong(ec, lev.grid.nx, lev.grid.ny,
                             method=cfg.prolongation, dtype=lev.dtype)
        if constrain is not None:
            e = constrain(e, lev)
        u = torch.where(lev.unknown, u + e, u)
    return _smooth(lev, u, f, cfg, cfg.post_sweeps, post=True)


@spanned("mg.cycle")
def mg_cycle(levels: Tuple[Level, ...], u, f,
             cfg: MultigridConfig = MultigridConfig(), constrain=None):
    """One multigrid cycle on the finest level; updates ``u`` in place where
    the path allows and returns the new iterate.

    ``constrain`` (``parallel.distributed.make_constrainer``) runs the
    cycle on this rank's blocks of every split level: ``u`` and ``f`` are
    then global (nx, ny) tensors, and the result is gathered, or level-0
    ``ShardedField`` blocks (``shard_inputs``), and the result is one. An
    array hook goes to ``_cycle``."""
    if isinstance(constrain, BlockHook):
        return constrain.mg_cycle(levels, u, f, cfg)
    return _cycle(levels, u, f, 0, cfg, cfg.cycle, constrain)


@spanned("mg.fmg")
def fmg(levels: Tuple[Level, ...], f, cfg: MultigridConfig = MultigridConfig(),
        cycles_per_level: int = 1, constrain=None):
    """Full multigrid start: restrict the right-hand side to every level
    (ring injected), solve the coarsest, then prolong and cycle upward.
    ``constrain`` runs it on the blocks, as for ``mg_cycle``; an array hook
    is applied to every level's right-hand side and start."""
    if isinstance(constrain, BlockHook):
        return constrain.fmg(levels, f, cfg, cycles_per_level)
    _c = constrain if constrain is not None else (lambda a, lev: a)
    rhs = [_c(f.to(levels[0].dtype), levels[0])]
    for nxt in levels[1:]:
        rhs.append(_c(transfer.restrict(
            rhs[-1], nxt.grid.nx, nxt.grid.ny, method=cfg.restriction,
            boundary="inject", dtype=nxt.dtype), nxt))
    u = _cycle(levels, levels[-1].zeros(), rhs[-1], len(levels) - 1, cfg,
               "V", constrain)
    for lvl in range(len(levels) - 2, -1, -1):
        lev = levels[lvl]
        if levels[lvl + 1].sync is not None:
            levels[lvl + 1].sync(u)
        u = _c(transfer.prolong(u, lev.grid.nx, lev.grid.ny,
                                method=cfg.prolongation, dtype=lev.dtype),
               lev)
        for _ in range(cycles_per_level):
            u = _cycle(levels, u, rhs[lvl], lvl, cfg, cfg.cycle, constrain)
    return u


def outer_iterate(step: Callable[[], torch.Tensor], rnorm0: torch.Tensor,
                  tol_eff: torch.Tensor, fnorm: torch.Tensor,
                  max_iterations: int) -> Dict[str, Any]:
    """Run ``step`` (one outer iteration, returning the new residual norm as
    a 0-d tensor) until the norm is at most ``tol_eff`` or
    ``max_iterations`` is reached. Reads one value back to the host per
    iteration (plus one for the start), each counted in
    ``outer_iterate.readbacks``, and returns the info dict."""
    with span("mg.readback"):
        rnorm, tol, fn = torch.stack([rnorm0, tol_eff, fnorm]).tolist()
    outer_iterate.readbacks += 1
    hist = [rnorm]
    while rnorm > tol and len(hist) <= max_iterations:
        with span("mg.outer"):
            norm = step()
        with span("mg.readback"):
            rnorm = norm.item()
        outer_iterate.readbacks += 1
        hist.append(rnorm)
    it = len(hist) - 1
    return _unpack_info(np.array([it, rnorm, hist[0], fn, rnorm <= tol]
                                 + hist, dtype=np.float64))


# the host's reads of a norm in outer_iterate, each a wait for the card;
# never reset here (as the kernel wrappers' ``launches``)
outer_iterate.readbacks = 0


def _unpack_info(packed: np.ndarray) -> Dict[str, Any]:
    """Decode [iterations, rnorm, rnorm0, fnorm, converged, history...]."""
    it = int(packed[0])
    hist = packed[5:][: it + 1]
    return {
        "iterations": it,
        "residual_norm": float(packed[1]),
        "initial_residual_norm": float(packed[2]),
        "rhs_norm": float(packed[3]),
        "converged": bool(packed[4]),
        "history": hist,
        "convergence_factor": convergence_factor(hist),
    }


def convergence_factor(history: np.ndarray) -> float:
    """Asymptotic factor: mean of the last <= 5 residual ratios."""
    h = np.asarray(history, dtype=np.float64)
    h = h[np.isfinite(h) & (h > 0)]
    if h.size < 2:
        return float("nan")
    ratios = h[1:] / h[:-1]
    return float(np.mean(ratios[-5:]))


def tolerance(cfg: MultigridConfig, scale: torch.Tensor) -> torch.Tensor:
    """Absolute stopping tolerance: cfg.tol relative to ``scale`` when
    ``cfg.rtol``, else cfg.tol itself (0-d tensor on scale's device)."""
    if cfg.rtol:
        return cfg.tol * torch.clamp(scale, min=1e-300)
    return torch.full((), cfg.tol, dtype=scale.dtype, device=scale.device)


@spanned("mg.solve")
def mg_solve(levels: Tuple[Level, ...], f, u0=None,
             cfg: MultigridConfig = MultigridConfig(), *,
             use_fmg: bool = False, constrain=None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Solve A u = f by repeated cycles at the finest level's dtype.

    ``f`` and ``u0`` are (nx, ny) tensors; ``u0`` carries the Dirichlet
    values on its ring. Returns the solution and an info dict (iterations,
    residual history, convergence factor, ...). ``constrain``
    (``parallel.distributed.make_constrainer``) runs the solve on this
    rank's blocks on the plain path, every rank of the mesh calling it:
    ``f`` and ``u0`` may then be level-0 ``ShardedField`` blocks, and every
    rank gets the global solution. An array hook goes to the cycles."""
    if isinstance(constrain, BlockHook):
        return constrain.mg_solve(levels, f, u0, cfg, use_fmg=use_fmg)
    lev0 = levels[0]
    unknown = lev0.unknown
    hx, hy = lev0.grid.hx, lev0.grid.hy
    f = f.to(device=lev0.device, dtype=lev0.dtype)
    u = (lev0.zeros() if u0 is None
         else u0.to(device=lev0.device, dtype=lev0.dtype, copy=True))

    fnorm = norms.masked_scaled_l2(f, unknown, hx, hy)
    # relative scale max(||f||, ||r(u0)||), measured BEFORE any FMG start:
    # boundary-driven problems have f = 0
    r_init = st_mod.residual(lev0.stencil, u, f, unknown)
    tol_eff = tolerance(cfg, torch.maximum(fnorm,
                                           norms.scaled_l2(r_init, hx, hy)))
    if use_fmg:
        u = fmg(levels, f, cfg, constrain=constrain)
    rnorm0 = norms.scaled_l2(st_mod.residual(lev0.stencil, u, f, unknown),
                             hx, hy)
    state = {"u": u}

    def step():
        state["u"] = mg_cycle(levels, state["u"], f, cfg, constrain)
        r = st_mod.residual(lev0.stencil, state["u"], f, unknown)
        return norms.scaled_l2(r, hx, hy)

    info = outer_iterate(step, rnorm0, tol_eff, fnorm, cfg.max_iterations)
    if lev0.sync is not None:
        lev0.sync(state["u"])  # consistent duplicate nodes for the output
    return state["u"], info
