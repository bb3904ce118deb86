"""Analysis plots: error decomposition, method/precision comparison, spectra.

Counterpart of ``AnalysisVisualizer`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/visualization/
analysis_plots.py``. Fields are numpy arrays or tensors on any device
(moved to the host once); the logical (nx, ny) region is analysed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from ..core.grid import Grid
from ._backend import finish, get_plt, host


class AnalysisVisualizer:
    def plot_error_spectrum(self, grid: Grid, error, *, save=None, show=False):
        """2D DFT magnitude of the error — shows which frequency bands the
        smoother/cycle leaves behind (the picture behind LFA smoothing
        analysis)."""
        plt = get_plt()
        e = host(error)[: grid.nx, : grid.ny]
        spec = np.abs(np.fft.fftshift(np.fft.fft2(e)))
        fig, ax = plt.subplots(figsize=(5.5, 5))
        from matplotlib.colors import LogNorm

        vmin = max(spec[spec > 0].min() if (spec > 0).any() else 1e-16, 1e-16)
        im = ax.imshow(spec.T, origin="lower", cmap="inferno",
                       norm=LogNorm(vmin=vmin, vmax=max(spec.max(), 10 * vmin)))
        ax.set_title("error spectrum |FFT(e)|")
        ax.set_xlabel(r"$\theta_x$"); ax.set_ylabel(r"$\theta_y$")
        fig.colorbar(im, ax=ax)
        return finish(fig, save, show)

    def plot_smoothing_effect(self, grid: Grid, before, after, *,
                              save=None, show=False):
        """Error before/after smoothing + their spectra (2x2 panel)."""
        plt = get_plt()
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        for col, (e, name) in enumerate(((before, "before"), (after, "after"))):
            e = host(e)[: grid.nx, : grid.ny]
            im = axes[0][col].imshow(e.T, origin="lower", cmap="RdBu_r")
            axes[0][col].set_title(f"error {name}")
            fig.colorbar(im, ax=axes[0][col])
            spec = np.abs(np.fft.fftshift(np.fft.fft2(e)))
            im = axes[1][col].imshow(np.log10(spec.T + 1e-16), origin="lower",
                                     cmap="inferno")
            axes[1][col].set_title(f"log10 spectrum {name}")
            fig.colorbar(im, ax=axes[1][col])
        return finish(fig, save, show)

    def plot_precision_tradeoff(self, records: List[Dict[str, Any]], *,
                                save=None, show=False):
        """Error vs time scatter per precision — the accuracy/cost frontier."""
        plt = get_plt()
        fig, ax = plt.subplots(figsize=(6, 4.5))
        for r in records:
            if r.get("error_l2") is None:
                continue
            ax.scatter(r["wall_s"], r["error_l2"], label=f"{r['precision']} n={r['n']}")
        ax.set_xscale("log"); ax.set_yscale("log")
        ax.set_xlabel("wall time (s)"); ax.set_ylabel("L2 error")
        ax.set_title("precision/accuracy trade-off")
        ax.legend(fontsize=7)
        ax.grid(True, which="both", alpha=0.3)
        return finish(fig, save, show)

    def plot_method_comparison(self, histories: Dict[str, Sequence[float]], *,
                               save=None, show=False):
        """Residual curves for different smoothers/cycles on one axes with
        per-method asymptotic rate annotations."""
        plt = get_plt()
        fig, ax = plt.subplots(figsize=(6.5, 4.5))
        for label, h in histories.items():
            h = np.asarray(h, float)
            h = h[np.isfinite(h) & (h > 0)]
            if h.size >= 2:
                rho = (h[-1] / h[max(h.size - 6, 0)]) ** (
                    1.0 / min(5, h.size - 1))
                label = f"{label} (rho~{rho:.2f})"
            ax.semilogy(h, "o-", ms=3, label=label)
        ax.set_xlabel("cycle"); ax.set_ylabel(r"$\|r\|$")
        ax.set_title("method comparison")
        ax.grid(True, alpha=0.3); ax.legend(fontsize=8)
        return finish(fig, save, show)
