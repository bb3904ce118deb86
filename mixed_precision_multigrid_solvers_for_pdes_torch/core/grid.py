"""Static grid metadata for vertex-centred 2D grids.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/core/grid.py``.
The grid is pure metadata; fields are separate tensors. Unlike the JAX
package, fields are stored at their logical shape ``(nx, ny)``, row-major and
contiguous, with no tile padding: the boundary ring is part of the array and
only interior nodes are ever updated, so no operator wraps around.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform vertex-centred grid on a rectangle, boundary points included.

    ``nx`` points span [x0, x1], so the spacing is hx = (x1 - x0)/(nx - 1).
    """

    nx: int
    ny: int
    domain: Tuple[float, float, float, float] = (0.0, 1.0, 0.0, 1.0)

    def __post_init__(self):
        if self.nx < 3 or self.ny < 3:
            raise ValueError(f"grid must be at least 3x3, got {self.nx}x{self.ny}")

    @property
    def hx(self) -> float:
        x0, x1, _, _ = self.domain
        return (x1 - x0) / (self.nx - 1)

    @property
    def hy(self) -> float:
        _, _, y0, y1 = self.domain
        return (y1 - y0) / (self.ny - 1)

    @property
    def shape(self) -> Tuple[int, int]:
        """Storage shape of a field on this grid (the logical shape)."""
        return (self.nx, self.ny)

    @property
    def num_interior(self) -> int:
        return (self.nx - 2) * (self.ny - 2)

    def can_coarsen(self) -> bool:
        """True if 2:1 coarsening keeps at least one interior point."""
        return (
            (self.nx - 1) % 2 == 0
            and (self.ny - 1) % 2 == 0
            and (self.nx - 1) // 2 + 1 >= 3
            and (self.ny - 1) // 2 + 1 >= 3
        )

    def coarsen(self) -> "Grid":
        """Return the 2:1-coarsened grid."""
        if not self.can_coarsen():
            raise ValueError(f"cannot coarsen {self.nx}x{self.ny}")
        return Grid((self.nx - 1) // 2 + 1, (self.ny - 1) // 2 + 1, self.domain)

    def coordinates(self):
        """Host-side (numpy) coordinate meshes X, Y of shape (nx, ny).

        Built as ``x0 + hx * arange(nx)`` so the values are bit-identical to
        the JAX package's (padded) meshes on the logical region.
        """
        x0, _, y0, _ = self.domain
        x = x0 + self.hx * np.arange(self.nx)
        y = y0 + self.hy * np.arange(self.ny)
        return np.meshgrid(x, y, indexing="ij")
