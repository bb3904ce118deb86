"""Grid hierarchy and sharding-layout visualization.

Counterpart of ``GridVisualizer`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/visualization/
grid_visualization.py``: level lattices, the coarsening path, and the block
layout of a level 0 split over a mesh of ranks. The layout drawn is this
package's (``parallel.distributed.make_tilings``), not the JAX package's
padded-array split.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import types

import numpy as np

from ..core.bc import BoundarySpec
from ..core.grid import Grid
from ._backend import finish, get_plt


class GridVisualizer:
    def plot_hierarchy(self, grids: Sequence[Grid], *, max_levels: int = 4,
                       save=None, show=False):
        """Draw the first few levels' point lattices side by side."""
        plt = get_plt()
        shown = list(grids)[:max_levels]
        fig, axes = plt.subplots(1, len(shown),
                                 figsize=(3.2 * len(shown), 3.2),
                                 squeeze=False)
        for k, g in enumerate(shown):
            ax = axes[0][k]
            X, Y = g.coordinates()
            ax.plot(X.ravel(), Y.ravel(), ".", ms=max(1, 6 - k))
            ax.set_title(f"level {k}: {g.nx}x{g.ny}")
            ax.set_aspect("equal")
            ax.set_xticks([]); ax.set_yticks([])
        return finish(fig, save, show)

    def plot_coarsening_path(self, grid: Grid, *, save=None, show=False):
        """Level sizes down the hierarchy (points + memory per level)."""
        plt = get_plt()
        sizes = []
        g = grid
        sizes.append(g.num_points)
        while g.can_coarsen():
            g = g.coarsen()
            sizes.append(g.num_points)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.semilogy(range(len(sizes)), sizes, "o-")
        ax.set_xlabel("level"); ax.set_ylabel("grid points")
        ax.set_title(f"hierarchy from {grid.nx}x{grid.ny} "
                     f"({len(sizes)} levels)")
        ax.grid(True, alpha=0.3)
        return finish(fig, save, show)

    def plot_sharding_layout(self, grid: Grid, mesh_shape: Tuple[int, int], *,
                             min_points_per_device: int = 16,
                             save=None, show=False):
        """Block-ownership map of level 0 of ``grid``'s Dirichlet hierarchy
        on an (mx, my) mesh, as ``parallel.distributed`` lays it out: the levels
        the mesh rule splits share one layout extent along each axis
        (``make_tilings``; 1025^2 on (2, 2) is laid out at 1152^2, the
        logical region at the origin), which level 0's blocks tile; a level
        0 the rule does not split is drawn replicated on its logical
        region. The dashed lines mark the logical region's end. Needs no
        process group."""
        from ..parallel import blocks, distributed, mesh as mesh_mod

        plt = get_plt()
        mx, my = mesh_shape
        mesh = mesh_mod.Mesh((mx, my))
        levels, g = [], grid
        while True:
            levels.append(types.SimpleNamespace(grid=g, spec=BoundarySpec()))
            if not g.can_coarsen():
                break
            g = g.coarsen()
        tilings = distributed.make_tilings(mesh, levels,
                                           min_points_per_device)
        replicated = not tilings
        if replicated:
            owner = np.zeros((grid.nx, grid.ny))
        else:
            t0 = tilings[0]
            cx, cy = (blocks.axis_count(mesh, names) for names in t0.names)
            ex, ey = t0.extent
            owner = (np.arange(ex)[:, None] // (ex // cx) * cy
                     + np.arange(ey)[None, :] // (ey // cy)).astype(float)
        fig, ax = plt.subplots(figsize=(5.5, 5))
        im = ax.imshow(owner.T, origin="lower", cmap="tab20",
                       interpolation="nearest")
        title = (f"{grid.nx}x{grid.ny} on {mx}x{my} mesh"
                 + (" (replicated: below the split threshold)" if replicated
                    else f", laid out at {owner.shape[0]}x{owner.shape[1]}"))
        ax.set_title(title)
        ax.axvline(grid.nx - 0.5, c="k", lw=1, ls="--")
        ax.axhline(grid.ny - 0.5, c="k", lw=1, ls="--")
        fig.colorbar(im, ax=ax, label="block")
        return finish(fig, save, show)
