"""Parameter sweeps rendered as figure grids, and composed comparison
panels.

Counterpart of ``InteractivePlotter`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/visualization/
interactive_plots.py``: on a host without a display a sweep is rendered as
a multi-panel figure.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np

from ._backend import finish, get_plt


class InteractivePlotter:
    def parameter_sweep(
        self,
        run: Callable[[Any], Dict[str, Any]],
        values: Sequence[Any],
        *,
        param_name: str = "param",
        metrics: Sequence[str] = ("iterations", "convergence_factor"),
        save=None,
        show=False,
    ):
        """Run ``run(v)`` per value and plot each requested metric vs the
        parameter."""
        plt = get_plt()
        results = [run(v) for v in values]
        fig, axes = plt.subplots(1, len(metrics),
                                 figsize=(4.5 * len(metrics), 3.6),
                                 squeeze=False)
        x = np.arange(len(values))
        for k, m in enumerate(metrics):
            ax = axes[0][k]
            ax.plot(x, [r.get(m, np.nan) for r in results], "o-")
            ax.set_xticks(x)
            ax.set_xticklabels([str(v) for v in values], rotation=30)
            ax.set_xlabel(param_name); ax.set_ylabel(m)
            ax.grid(True, alpha=0.3)
        fig.suptitle(f"sweep over {param_name}")
        finish(fig, save, show)
        return fig, results

    def comparison_dashboard(self, panels: Dict[str, Callable], *,
                             n_cols: int = 2, save=None, show=False):
        """Compose named panel-draw callables (each takes an Axes) into one
        figure — the offline 'comparison dashboard'."""
        plt = get_plt()
        n = len(panels)
        n_rows = (n + n_cols - 1) // n_cols
        fig, axes = plt.subplots(n_rows, n_cols,
                                 figsize=(6 * n_cols, 4 * n_rows),
                                 squeeze=False)
        for k, (name, draw) in enumerate(panels.items()):
            ax = axes[k // n_cols][k % n_cols]
            draw(ax)
            ax.set_title(name)
        for k in range(n, n_rows * n_cols):
            axes[k // n_cols][k % n_cols].axis("off")
        return finish(fig, save, show)
