"""Geometric multigrid driver: V-cycles, FMG and the cycle-iteration solve.

Counterpart of ``Level``, ``MultigridConfig``, ``build_hierarchy``
(rediscretization), ``_cycle`` (V), ``mg_cycle``, ``fmg``, ``mg_solve``,
``_unpack_info``, ``_sample_coarse`` and ``convergence_factor`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/multigrid.py``.

PyTorch runs eagerly, so the cycle recursion runs in Python and each level
step goes through ``ops/dispatch.py``, which picks the CUDA kernels or the
plain path. Cycles update the fine-level iterate IN PLACE (the smoothers and
the prolongation-correction write into it) and return it. The outer loop's
stopping test reads the residual norm back to the host once per iteration.
W/F cycles and Galerkin coarsening are ROADMAP item 7 and 10.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..core import bc as bc_mod
from ..core.bc import BoundarySpec
from ..core.device import resolve_device
from ..core.grid import Grid
from ..core.precision import as_dtype
from ..ops import dispatch, norms, smooth as smooth_mod, stencil as st_mod, \
    transfer
from ..ops.stencil import Stencil


@dataclasses.dataclass(frozen=True)
class Level:
    """One grid level: stencil, geometry, BCs, dtype and device."""

    stencil: Stencil
    grid: Grid
    spec: BoundarySpec
    dtype: torch.dtype
    device: torch.device

    @functools.cached_property
    def unknown(self) -> torch.Tensor:
        """Bool (nx, ny) mask of the nodes the solver owns (built once)."""
        return bc_mod.unknown_mask(self.grid.nx, self.grid.ny, self.spec,
                                   device=self.device)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.grid.shape, dtype=self.dtype,
                           device=self.device)


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    """Static solver configuration."""

    cycle: str = "V"              # V (W and F: ROADMAP item 7)
    pre_sweeps: int = 2
    post_sweeps: int = 2
    smoother: str = "jacobi"      # jacobi | rbgs | sor
    omega: float = 0.8
    coarse_sweeps: int = 32
    max_levels: int = 32
    restriction: str = "full_weighting"
    prolongation: str = "bilinear"
    max_iterations: int = 100
    tol: float = 1e-10
    rtol: bool = True             # tolerance relative to max(||f||, ||r0||)
    backend: str = "auto"         # auto | torch (see ops/dispatch.py)
    coarsening: str = "rediscretize"  # galerkin: ROADMAP item 10
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
                    a=None, lam=0.0, dtype=torch.float32, device=None,
                    cfg: MultigridConfig = MultigridConfig()
                    ) -> Tuple[Level, ...]:
    """Levels by repeated 2:1 coarsening and rediscretization, finest
    first. The coefficient field ``a`` and an array ``lam`` ((nx, ny), any
    array type) are injection-sampled onto each coarse grid and the operator
    is rebuilt there."""
    if cfg.coarsening != "rediscretize":
        raise NotImplementedError(
            f"coarsening {cfg.coarsening!r} is not ported yet (ROADMAP item "
            "10, ops/galerkin.py)")
    dtype = as_dtype(dtype)
    device = resolve_device(device)
    grids = [grid]
    while grids[-1].can_coarsen() and len(grids) < cfg.max_levels:
        grids.append(grids[-1].coarsen())
    levels = []
    for g in grids:
        levels.append(Level(
            stencil=st_mod.make_stencil(g, spec, a=a, lam=lam, dtype=dtype,
                                        device=device),
            grid=g, spec=spec, dtype=dtype, device=device))
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


def _cycle(levels: Tuple[Level, ...], u, f, lvl: int, cfg: MultigridConfig,
           cycle_type: str):
    if cycle_type != "V":
        raise NotImplementedError(
            f"{cycle_type}-cycles are not ported yet (ROADMAP item 7)")
    lev = levels[lvl]
    if dispatch.tail_ok(levels, lvl, cfg, cycle_type):
        # the whole remaining V-recursion in one tail-kernel launch
        return dispatch.tail_vcycle(levels, lvl, u, f, cfg)
    if lvl == len(levels) - 1:
        # coarsest: RB-GS to (near-)exactness; exact in one sweep when a
        # single interior unknown remains
        coarse_cfg = cfg.replace(smoother="rbgs", omega=1.0)
        return _smooth(lev, u, f, coarse_cfg, cfg.coarse_sweeps)

    u = _smooth(lev, u, f, cfg, cfg.pre_sweeps)
    nxt = levels[lvl + 1]
    fused = dispatch.transfer_fused_ok(lev, nxt, cfg)
    if fused:
        fc = dispatch.residual_restrict(lev, nxt, u, f)
    else:
        r = st_mod.residual(lev.stencil, u, f, lev.unknown)
        # 'reflect' restricts onto every ring; Dirichlet rings are zeroed
        boundary = "zero" if lev.spec.plain else "reflect"
        fc = transfer.restrict(r, nxt.grid.nx, nxt.grid.ny,
                               method=cfg.restriction, boundary=boundary,
                               dtype=nxt.dtype)
        if boundary == "reflect":
            fc = torch.where(nxt.unknown, fc, torch.zeros(
                (), dtype=fc.dtype, device=fc.device))
    ec = _cycle(levels, nxt.zeros(), fc, lvl + 1, cfg, "V")
    if fused:
        u = dispatch.prolong_correct(lev, nxt, ec, u)
    else:
        e = transfer.prolong(ec, lev.grid.nx, lev.grid.ny,
                             method=cfg.prolongation, dtype=lev.dtype)
        u = torch.where(lev.unknown, u + e, u)
    return _smooth(lev, u, f, cfg, cfg.post_sweeps, post=True)


def mg_cycle(levels: Tuple[Level, ...], u, f,
             cfg: MultigridConfig = MultigridConfig()):
    """One multigrid cycle on the finest level; updates ``u`` in place where
    the path allows and returns the new iterate."""
    return _cycle(levels, u, f, 0, cfg, cfg.cycle)


def fmg(levels: Tuple[Level, ...], f, cfg: MultigridConfig = MultigridConfig(),
        cycles_per_level: int = 1):
    """Full multigrid start: restrict the right-hand side to every level
    (ring injected), solve the coarsest, then prolong and cycle upward."""
    rhs = [f.to(levels[0].dtype)]
    for nxt in levels[1:]:
        rhs.append(transfer.restrict(rhs[-1], nxt.grid.nx, nxt.grid.ny,
                                     method=cfg.restriction,
                                     boundary="inject", dtype=nxt.dtype))
    u = _cycle(levels, levels[-1].zeros(), rhs[-1], len(levels) - 1, cfg,
               "V")
    for lvl in range(len(levels) - 2, -1, -1):
        lev = levels[lvl]
        u = transfer.prolong(u, lev.grid.nx, lev.grid.ny,
                             method=cfg.prolongation, dtype=lev.dtype)
        for _ in range(cycles_per_level):
            u = _cycle(levels, u, rhs[lvl], lvl, cfg, cfg.cycle)
    return u


def outer_iterate(step: Callable[[], torch.Tensor], rnorm0: torch.Tensor,
                  tol_eff: torch.Tensor, fnorm: torch.Tensor,
                  max_iterations: int) -> Dict[str, Any]:
    """Run ``step`` (one outer iteration, returning the new residual norm as
    a 0-d tensor) until the norm is at most ``tol_eff`` or
    ``max_iterations`` is reached. Reads one value back to the host per
    iteration (plus one for the start) and returns the info dict."""
    rnorm, tol, fn = torch.stack([rnorm0, tol_eff, fnorm]).tolist()
    hist = [rnorm]
    while rnorm > tol and len(hist) <= max_iterations:
        rnorm = step().item()
        hist.append(rnorm)
    it = len(hist) - 1
    return _unpack_info(np.array([it, rnorm, hist[0], fn, rnorm <= tol]
                                 + hist, dtype=np.float64))


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


def mg_solve(levels: Tuple[Level, ...], f, u0=None,
             cfg: MultigridConfig = MultigridConfig(), *,
             use_fmg: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Solve A u = f by repeated cycles at the finest level's dtype.

    ``f`` and ``u0`` are (nx, ny) tensors; ``u0`` carries the Dirichlet
    values on its ring. Returns the solution and an info dict (iterations,
    residual history, convergence factor, ...)."""
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
        u = fmg(levels, f, cfg)
    rnorm0 = norms.scaled_l2(st_mod.residual(lev0.stencil, u, f, unknown),
                             hx, hy)
    state = {"u": u}

    def step():
        state["u"] = mg_cycle(levels, state["u"], f, cfg)
        r = st_mod.residual(lev0.stencil, state["u"], f, unknown)
        return norms.scaled_l2(r, hx, hy)

    info = outer_iterate(step, rnorm0, tol_eff, fnorm, cfg.max_iterations)
    return state["u"], info
