"""Solution fields: surfaces, contours, comparisons, error maps, time
series and 3D slices.

Counterpart of ``SolutionVisualizer`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/visualization/
solution_plots.py``. Inputs are fields of a ``Grid`` (or ``Grid3D``) as
numpy arrays or tensors on any device (moved to the host once); the
logical (nx, ny) region is plotted.
"""

from __future__ import annotations

import numpy as np

from ..core.grid import Grid
from ._backend import finish, get_plt, host


class SolutionVisualizer:
    def __init__(self, cmap: str = "viridis"):
        self.cmap = cmap

    def _logical(self, grid: Grid, field) -> np.ndarray:
        return host(field)[: grid.nx, : grid.ny]

    def plot_surface(self, grid: Grid, field, *, title: str = "solution",
                     save=None, show=False):
        """3D surface plot."""
        plt = get_plt()
        X, Y = grid.coordinates()
        Z = self._logical(grid, field)
        fig = plt.figure(figsize=(7, 5))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot_surface(X, Y, Z, cmap=self.cmap, linewidth=0)
        ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_title(title)
        return finish(fig, save, show)

    def plot_contour(self, grid: Grid, field, *, levels: int = 20,
                     title: str = "solution", save=None, show=False):
        plt = get_plt()
        X, Y = grid.coordinates()
        Z = self._logical(grid, field)
        fig, ax = plt.subplots(figsize=(6, 5))
        cs = ax.contourf(X, Y, Z, levels=levels, cmap=self.cmap)
        fig.colorbar(cs, ax=ax)
        ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_title(title)
        ax.set_aspect("equal")
        return finish(fig, save, show)

    def plot_comparison(self, grid: Grid, computed, exact, *,
                        title: str = "computed vs exact", save=None,
                        show=False):
        """Side-by-side computed / exact / error."""
        plt = get_plt()
        X, Y = grid.coordinates()
        U = self._logical(grid, computed)
        E = self._logical(grid, exact)
        err = U - E
        fig, axes = plt.subplots(1, 3, figsize=(15, 4.2))
        for ax, Z, name, cmap in (
            (axes[0], U, "computed", self.cmap),
            (axes[1], E, "exact", self.cmap),
            (axes[2], err, "error", "RdBu_r"),
        ):
            cs = ax.contourf(X, Y, Z, levels=20, cmap=cmap)
            fig.colorbar(cs, ax=ax)
            ax.set_title(name)
            ax.set_aspect("equal")
        fig.suptitle(title)
        return finish(fig, save, show)

    def plot_error_map(self, grid: Grid, computed, exact, *, log: bool = True,
                       save=None, show=False):
        plt = get_plt()
        X, Y = grid.coordinates()
        err = np.abs(self._logical(grid, computed) - self._logical(grid, exact))
        fig, ax = plt.subplots(figsize=(6, 5))
        if log:
            from matplotlib.colors import LogNorm

            vmin = max(err[err > 0].min() if (err > 0).any() else 1e-16, 1e-16)
            cs = ax.pcolormesh(X, Y, err, norm=LogNorm(vmin=vmin,
                                                       vmax=max(err.max(), vmin * 10)),
                               cmap="magma")
        else:
            cs = ax.pcolormesh(X, Y, err, cmap="magma")
        fig.colorbar(cs, ax=ax, label="|error|")
        ax.set_title("pointwise error")
        ax.set_aspect("equal")
        return finish(fig, save, show)

    def plot_time_series(self, grid: Grid, snapshots, *, n_cols: int = 4,
                         save=None, show=False):
        """Grid of (t, field) snapshots from HeatResult.saved."""
        plt = get_plt()
        X, Y = grid.coordinates()
        n = len(snapshots)
        n_cols = min(n_cols, n)
        n_rows = (n + n_cols - 1) // n_cols
        fig, axes = plt.subplots(n_rows, n_cols,
                                 figsize=(3.2 * n_cols, 2.8 * n_rows),
                                 squeeze=False)
        vmax = max(np.abs(self._logical(grid, u)).max() for _, u in snapshots)
        for k, (t, u) in enumerate(snapshots):
            ax = axes[k // n_cols][k % n_cols]
            cs = ax.contourf(X, Y, self._logical(grid, u), levels=15,
                             cmap=self.cmap, vmin=-vmax, vmax=vmax)
            ax.set_title(f"t = {t:.4g}")
            ax.set_aspect("equal")
        for k in range(n, n_rows * n_cols):
            axes[k // n_cols][k % n_cols].axis("off")
        return finish(fig, save, show)

    def plot_slices3d(self, grid3d, field, *, axis: str = "z",
                      positions=(0.25, 0.5, 0.75), save=None, show=False):
        """Orthogonal slice panels through a 3D field of a ``Grid3D``.
        ``axis`` picks the normal ('x'|'y'|'z');
        ``positions`` are fractions of the domain along it."""
        plt = get_plt()
        ax_idx = {"x": 0, "y": 1, "z": 2}[axis]
        n_axis = (grid3d.nx, grid3d.ny, grid3d.nz)[ax_idx]
        f = host(field)[: grid3d.nx, : grid3d.ny, : grid3d.nz]
        n = len(positions)
        fig, axes = plt.subplots(1, n, figsize=(3.6 * n, 3.2), squeeze=False)
        vmax = max(float(np.abs(f).max()), 1e-300)
        planes = "yz xz xy".split()[ax_idx]
        for k, frac in enumerate(positions):
            i = min(n_axis - 1, max(0, int(round(frac * (n_axis - 1)))))
            sl = np.take(f, i, axis=ax_idx)
            ax = axes[0][k]
            im = ax.imshow(sl.T, origin="lower", cmap=self.cmap,
                           vmin=-vmax, vmax=vmax)
            ax.set_title(f"{axis} = {frac:g}")
            ax.set_xlabel(planes[0])
            ax.set_ylabel(planes[1])
        fig.colorbar(im, ax=[a for row in axes for a in row], shrink=0.85)
        return finish(fig, save, show)
