"""Convergence-history analysis and live monitoring.

A copy of ``mixed_precision_multigrid_solvers_for_pdes_tpu/analysis/
convergence.py`` (numpy only): ``ConvergenceAnalyzer`` for post-hoc rates,
asymptotics, stagnation and divergence of a residual history, and
``ConvergenceMonitor`` for live, callback-driven tracking with
recommendations. Histories are host sequences (``info["history"]``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ConvergenceReport:
    """Summary statistics of one residual history."""

    iterations: int
    initial_residual: float
    final_residual: float
    reduction: float
    mean_rate: float
    asymptotic_rate: float
    stagnated: bool
    diverged: bool
    stagnation_index: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class ConvergenceAnalyzer:
    """Post-hoc residual-history analysis
    (reference analysis/convergence.py:64-316)."""

    def __init__(self, stagnation_ratio: float = 0.98, window: int = 5,
                 divergence_factor: float = 10.0):
        self.stagnation_ratio = stagnation_ratio
        self.window = window
        self.divergence_factor = divergence_factor

    @staticmethod
    def _clean(history) -> np.ndarray:
        h = np.asarray(history, dtype=np.float64).ravel()
        return h[np.isfinite(h) & (h > 0)]

    def rates(self, history) -> np.ndarray:
        h = self._clean(history)
        return h[1:] / h[:-1] if h.size >= 2 else np.empty(0)

    def asymptotic_rate(self, history) -> float:
        """Geometric mean of the last <=window ratios
        (reference solvers/base.py:47-64 uses the arithmetic mean; geometric
        is the correct average of multiplicative factors)."""
        r = self.rates(history)
        if r.size == 0:
            return float("nan")
        tail = r[-self.window:]
        return float(np.exp(np.mean(np.log(np.maximum(tail, 1e-300)))))

    def detect_stagnation(self, history) -> Optional[int]:
        """First index where the windowed mean ratio exceeds the threshold
        (reference analysis/convergence.py:221-255)."""
        r = self.rates(history)
        if r.size < self.window:
            return None
        means = np.convolve(r, np.ones(self.window) / self.window, "valid")
        idx = np.nonzero(means > self.stagnation_ratio)[0]
        return int(idx[0] + self.window) if idx.size else None

    def detect_divergence(self, history) -> bool:
        """Residual grew by divergence_factor over its running minimum
        (reference analysis/convergence.py:447-455)."""
        h = self._clean(history)
        if h.size < 2:
            return False
        running_min = np.minimum.accumulate(h)
        return bool(np.any(h > self.divergence_factor * running_min))

    def analyze(self, history) -> ConvergenceReport:
        h = self._clean(history)
        if h.size == 0:
            raise ValueError("empty residual history")
        r = self.rates(h)
        stag = self.detect_stagnation(h)
        return ConvergenceReport(
            iterations=int(h.size - 1),
            initial_residual=float(h[0]),
            final_residual=float(h[-1]),
            reduction=float(h[0] / max(h[-1], 1e-300)),
            mean_rate=float(np.exp(np.mean(np.log(np.maximum(r, 1e-300)))))
            if r.size else float("nan"),
            asymptotic_rate=self.asymptotic_rate(h),
            stagnated=stag is not None,
            diverged=self.detect_divergence(h),
            stagnation_index=stag,
        )

    def grid_independence(self, histories: Dict[int, Any],
                          tolerance: float = 0.25) -> Dict[str, Any]:
        """Check h-independent convergence: asymptotic rates across grid sizes
        within ``tolerance`` of their mean (reference
        validation/convergence_analysis.py h-independence validation)."""
        rates = {n: self.asymptotic_rate(h) for n, h in histories.items()}
        vals = np.array([v for v in rates.values() if np.isfinite(v)])
        mean = float(vals.mean()) if vals.size else float("nan")
        spread = float(np.max(np.abs(vals - mean))) if vals.size else float("nan")
        return {
            "rates": rates,
            "mean_rate": mean,
            "max_deviation": spread,
            "h_independent": bool(vals.size and spread <= tolerance * max(mean, 1e-12)),
        }


class ConvergenceMonitor:
    """Live residual tracking with callbacks and recommendations
    (reference analysis/convergence.py:317-581, minus the matplotlib
    real-time plot — visualization.convergence_plots renders offline)."""

    def __init__(self, analyzer: Optional[ConvergenceAnalyzer] = None,
                 check_every: int = 5):
        self.analyzer = analyzer or ConvergenceAnalyzer()
        self.history: List[float] = []
        self.check_every = check_every
        self._callbacks: List[Callable[[str, Dict[str, Any]], None]] = []
        self.events: List[Dict[str, Any]] = []

    def add_callback(self, fn: Callable[[str, Dict[str, Any]], None]) -> None:
        self._callbacks.append(fn)

    def _emit(self, kind: str, **data) -> None:
        event = {"kind": kind, "iteration": len(self.history) - 1, **data}
        self.events.append(event)
        for fn in self._callbacks:
            fn(kind, event)

    def record(self, residual_norm: float) -> None:
        self.history.append(float(residual_norm))
        k = len(self.history) - 1
        if k == 0 or k % self.check_every:
            return
        if self.analyzer.detect_divergence(self.history):
            self._emit("divergence", residual=residual_norm)
        elif self.analyzer.detect_stagnation(self.history) is not None:
            self._emit("stagnation", residual=residual_norm,
                       rate=self.analyzer.asymptotic_rate(self.history))

    def recommendations(self) -> List[str]:
        """Actionable hints (reference analysis/convergence.py:507-560)."""
        recs: List[str] = []
        if not self.history:
            return recs
        rep = self.analyzer.analyze(self.history)
        if rep.diverged:
            recs.append("residual diverging: lower omega, or switch to a "
                        "W-cycle / stronger smoother")
        if rep.stagnated:
            recs.append("residual stagnating: likely at the working-precision "
                        "floor — promote precision or use iterative refinement")
        if np.isfinite(rep.asymptotic_rate) and rep.asymptotic_rate > 0.5:
            recs.append("slow convergence (rate > 0.5): check boundary "
                        "handling and inter-grid transfer orders")
        return recs

    def report(self) -> ConvergenceReport:
        return self.analyzer.analyze(self.history)
