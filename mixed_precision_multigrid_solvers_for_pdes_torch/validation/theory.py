"""Theoretical convergence analysis: smoothing factors, two-grid factors,
h-independence.

Counterpart of ``TheoreticalAnalyzer``, ``measure_two_grid_factor`` and
``validate_h_independence`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/validation/theory.py``.
The local Fourier analysis (LFA) is numpy and the same as there. The
measured factor runs the package's own cycles on a level hierarchy, on the
kernels where the configuration and the card allow (``cfg.backend``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops import norms
from ..solvers import multigrid as mg_mod
from ..solvers.multigrid import MultigridConfig


class TheoreticalAnalyzer:
    """LFA smoothing factors for the 5-point Laplacian, evaluated from the
    smoother symbols on a frequency grid."""

    def __init__(self, n_theta: int = 257):
        # full symbol grid over [-pi, pi]^2; high frequencies are the modes
        # NOT representable on the coarse grid: max(|tx|, |ty|) >= pi/2
        t = np.linspace(-np.pi, np.pi, n_theta)
        tx, ty = np.meshgrid(t, t, indexing="ij")
        high = np.maximum(np.abs(tx), np.abs(ty)) >= np.pi / 2
        self.tx, self.ty, self.high = tx, ty, high

    def jacobi_smoothing_factor(self, omega: float = 0.8) -> float:
        """mu = max_high |1 - omega/2 (2 - cos tx - cos ty)| (hx=hy).
        omega=4/5 gives the textbook 3/5."""
        sym = 1.0 - omega * 0.5 * (2.0 - np.cos(self.tx) - np.cos(self.ty))
        return float(np.max(np.abs(sym[self.high])))

    def gs_lex_smoothing_factor(self) -> float:
        """Lexicographic GS: mu = max_high |e^{i tx}+e^{i ty}| / |4 - e^{-i tx} - e^{-i ty}|
        (classical result: 0.5 at (pi/2, arccos(4/5)))."""
        num = np.abs(np.exp(1j * self.tx) + np.exp(1j * self.ty))
        den = np.abs(4.0 - np.exp(-1j * self.tx) - np.exp(-1j * self.ty))
        sym = num / den
        return float(np.max(sym[self.high]))

    def predicted_two_grid_factor(self, smoother: str = "rbgs", nu: int = 2,
                                  omega: Optional[float] = None) -> float:
        """Crude two-grid bound mu^nu (a smoothing-only estimate; RB-GS
        takes the standard value mu ~ 0.25)."""
        if smoother == "jacobi":
            mu = self.jacobi_smoothing_factor(0.8 if omega is None else omega)
        elif smoother in ("rbgs", "sor", "gauss_seidel", "red_black"):
            mu = 0.25  # classical RB-GS smoothing factor for 5-point Poisson
        else:
            raise ValueError(smoother)
        return float(mu**nu)


def _two_grid_history(levels, e0: torch.Tensor, cfg: MultigridConfig,
                      n_cycles: int) -> Dict[str, Any]:
    """Cycle A e = 0 from the start error ``e0`` (zero off the unknowns),
    reading the error's scaled l2 norm back to the host after every cycle;
    the ratios and their geometric tail mean."""
    g = levels[0].grid
    f = levels[0].zeros()
    e = e0.clone()  # the cycles update their iterate in place
    hist = [float(norms.scaled_l2(e, g.hx, g.hy))]
    for _ in range(n_cycles):
        e = mg_mod.mg_cycle(levels, e, f, cfg)
        hist.append(float(norms.scaled_l2(e, g.hx, g.hy)))
    h = np.asarray(hist)
    ratios = h[1:] / np.maximum(h[:-1], 1e-300)
    tail = ratios[len(ratios) // 2:]
    rho = float(np.exp(np.mean(np.log(np.maximum(tail, 1e-300)))))
    return {"history": h, "ratios": ratios, "rho": rho}


def measure_two_grid_factor(
    levels,
    cfg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0),
    *,
    n_cycles: int = 12,
    seed: int = 0,
) -> Dict[str, Any]:
    """Measure the asymptotic error-reduction factor per cycle on A e = 0
    from a random initial error: per-cycle error ratios and their geometric
    tail mean.

    The start is drawn from a ``torch.Generator`` seeded with ``seed`` on
    the CPU in float64, then cast to level 0's dtype and moved to its
    device, so a CPU and a card hierarchy start from the same error."""
    lev0 = levels[0]
    gen = torch.Generator().manual_seed(seed)
    e = torch.randn(lev0.grid.shape, generator=gen, dtype=torch.float64)
    e = e.to(device=lev0.device, dtype=lev0.dtype)
    e = torch.where(lev0.unknown, e, torch.zeros((), dtype=e.dtype,
                                                 device=e.device))
    return _two_grid_history(levels, e, cfg, n_cycles)


def validate_h_independence(
    problem_factory,
    sizes=(33, 65, 129),
    cfg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0),
    *,
    dtype="float64",
    tolerance: float = 0.1,
    device=None,
) -> Dict[str, Any]:
    """Measured cycle factors must not grow with the grid: the spread of
    ``measure_two_grid_factor`` over ``sizes`` at most ``tolerance``.
    Hierarchies are built on ``device`` (the card when None)."""
    rhos = {}
    for n in sizes:
        prob = problem_factory(n)
        levels = mg_mod.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                        lam=prob.lam, dtype=dtype,
                                        device=device, cfg=cfg)
        rhos[n] = measure_two_grid_factor(levels, cfg)["rho"]
    vals = np.array(list(rhos.values()))
    return {
        "rhos": rhos,
        "max_rho": float(vals.max()),
        "spread": float(vals.max() - vals.min()),
        "h_independent": bool(vals.max() - vals.min() <= tolerance),
    }
