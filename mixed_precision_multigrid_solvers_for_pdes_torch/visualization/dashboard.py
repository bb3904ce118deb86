"""Solver dashboard: convergence and host metrics in four panels.

Counterpart of ``MetricsCollector`` and ``SolverDashboard`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/visualization/
dashboard.py``. Without a display the dashboard renders on demand
(``render()``); with one, ``live()`` drives the same panels with
FuncAnimation. Metrics come from ``analysis.ConvergenceMonitor`` and host
memory and time counters.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np

from ..analysis.convergence import ConvergenceMonitor
from ._backend import finish, get_plt


class MetricsCollector:
    """Host metrics sampler, pull-based: call sample()."""

    def __init__(self, maxlen: int = 2000):
        self.t: Deque[float] = deque(maxlen=maxlen)
        self.rss_mb: Deque[float] = deque(maxlen=maxlen)
        self.t0 = time.perf_counter()

    def sample(self) -> Dict[str, float]:
        now = time.perf_counter() - self.t0
        rss = _rss_mb()
        self.t.append(now)
        self.rss_mb.append(rss)
        return {"t": now, "rss_mb": rss}


def _rss_mb() -> float:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * 4096 / 1e6
    except Exception:
        return float("nan")


class SolverDashboard:
    """Four-panel dashboard: residual history, per-cycle rate, host memory,
    event log."""

    def __init__(self, monitor: Optional[ConvergenceMonitor] = None):
        self.monitor = monitor or ConvergenceMonitor()
        self.metrics = MetricsCollector()

    # feed -------------------------------------------------------------------

    def record(self, residual_norm: float) -> None:
        self.monitor.record(residual_norm)
        self.metrics.sample()

    # render -----------------------------------------------------------------

    def _draw(self, fig, axes) -> None:
        h = np.asarray(self.monitor.history, float)
        ax = axes[0][0]
        ax.clear()
        if h.size:
            ax.semilogy(h, "o-", ms=3)
        ax.set_title("residual history")
        ax.set_xlabel("iteration"); ax.set_ylabel(r"$\|r\|$")
        ax.grid(True, alpha=0.3)

        ax = axes[0][1]
        ax.clear()
        if h.size >= 2:
            good = h > 0
            rates = h[1:] / np.maximum(h[:-1], 1e-300)
            ax.plot(rates[good[1:]], "o-", ms=3)
            ax.axhline(1.0, ls="--", c="r")
        ax.set_title("per-iteration rate")
        ax.set_ylim(0, 1.2)
        ax.grid(True, alpha=0.3)

        ax = axes[1][0]
        ax.clear()
        if self.metrics.t:
            ax.plot(list(self.metrics.t), list(self.metrics.rss_mb))
        ax.set_title("host RSS (MB)")
        ax.set_xlabel("wall time (s)")
        ax.grid(True, alpha=0.3)

        ax = axes[1][1]
        ax.clear()
        ax.axis("off")
        lines = ["events:"]
        for ev in self.monitor.events[-6:]:
            lines.append(f"  iter {ev['iteration']}: {ev['kind']}")
        lines.append("")
        lines.append("recommendations:")
        for r in self.monitor.recommendations()[:4]:
            lines.append("  - " + r)
        ax.text(0.02, 0.98, "\n".join(lines), va="top", family="monospace",
                fontsize=9, transform=ax.transAxes)

    def render(self, *, save=None, show=False):
        plt = get_plt()
        fig, axes = plt.subplots(2, 2, figsize=(11, 7.5), squeeze=False)
        self._draw(fig, axes)
        fig.suptitle("solver dashboard")
        return finish(fig, save, show)

    def live(self, interval_ms: int = 100):
        """FuncAnimation-driven live view (needs an interactive backend)."""
        plt = get_plt()
        from matplotlib.animation import FuncAnimation

        fig, axes = plt.subplots(2, 2, figsize=(11, 7.5), squeeze=False)

        def update(_):
            self._draw(fig, axes)

        anim = FuncAnimation(fig, update, interval=interval_ms,
                             cache_frame_data=False)
        plt.show()
        return anim
