"""Convergence plots: residual histories, grid-convergence, rate comparisons.

Counterpart of ``ConvergencePlotter`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/visualization/
convergence_plots.py``; histories and studies are host data (``info
["history"]``, ``applications.poisson.convergence_study``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ._backend import finish, get_plt


class ConvergencePlotter:
    def plot_residual_history(self, histories: Dict[str, Sequence[float]], *,
                              tol: Optional[float] = None,
                              title: str = "residual history",
                              save=None, show=False):
        """Semilog residual curves, one per labeled run."""
        plt = get_plt()
        fig, ax = plt.subplots(figsize=(6.5, 4.5))
        for label, h in histories.items():
            h = np.asarray(h, float)
            h = h[np.isfinite(h) & (h > 0)]
            ax.semilogy(np.arange(h.size), h, marker="o", ms=3, label=label)
        if tol is not None:
            ax.axhline(tol, ls="--", c="gray", label=f"tol={tol:g}")
        ax.set_xlabel("iteration"); ax.set_ylabel(r"$\|r\|$")
        ax.set_title(title); ax.grid(True, alpha=0.3); ax.legend()
        return finish(fig, save, show)

    def plot_grid_convergence(self, h, errors, *, expected_order: float = 2.0,
                              label: str = "L2 error",
                              title: str = "grid convergence",
                              save=None, show=False):
        """log-log error vs h with the expected-order guide line."""
        plt = get_plt()
        h = np.asarray(h, float); errors = np.asarray(errors, float)
        fig, ax = plt.subplots(figsize=(6, 4.5))
        ax.loglog(h, errors, "o-", label=label)
        ref = errors[0] * (h / h[0]) ** expected_order
        ax.loglog(h, ref, "--", c="gray",
                  label=f"O(h^{expected_order:g}) guide")
        ax.set_xlabel("h"); ax.set_ylabel("error")
        ax.set_title(title); ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        return finish(fig, save, show)

    def plot_convergence_factors(self, factors: Dict[str, float], *,
                                 target: Optional[float] = 0.15,
                                 title: str = "cycle convergence factors",
                                 save=None, show=False):
        """Bar chart of measured rho per configuration/grid size."""
        plt = get_plt()
        fig, ax = plt.subplots(figsize=(6.5, 4))
        keys = list(factors)
        vals = [factors[k] for k in keys]
        ax.bar(range(len(keys)), vals)
        ax.set_xticks(range(len(keys)))
        ax.set_xticklabels([str(k) for k in keys], rotation=30, ha="right")
        if target is not None:
            ax.axhline(target, ls="--", c="r", label=f"target {target}")
            ax.legend()
        ax.set_ylabel(r"$\rho$ per cycle"); ax.set_title(title)
        return finish(fig, save, show)

    def plot_mms_study(self, study: Dict, *, title: str = "MMS convergence",
                       save=None, show=False):
        """Render an applications.poisson.convergence_study result."""
        return self.plot_grid_convergence(
            study["h"], study["l2"],
            title=f"{title} (observed order {study['order_l2']:.2f})",
            save=save, show=show,
        )
