"""Static grid metadata for vertex-centred 3D grids.

Counterpart of ``Grid3D`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/core/grid3d.py``. As in 2D,
fields are stored at their logical shape ``(nx, ny, nz)``, row-major and
contiguous (z is the contiguous axis), with no tile padding: the boundary
shell is part of the array and only interior nodes are ever updated.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Uniform vertex-centred grid on a box, boundary points included."""

    nx: int
    ny: int
    nz: int
    domain: Tuple[float, float, float, float, float, float] = (
        0.0, 1.0, 0.0, 1.0, 0.0, 1.0)

    def __post_init__(self):
        if min(self.nx, self.ny, self.nz) < 3:
            raise ValueError(f"grid must be at least 3^3, got "
                             f"{self.nx}x{self.ny}x{self.nz}")

    @property
    def hx(self) -> float:
        return (self.domain[1] - self.domain[0]) / (self.nx - 1)

    @property
    def hy(self) -> float:
        return (self.domain[3] - self.domain[2]) / (self.ny - 1)

    @property
    def hz(self) -> float:
        return (self.domain[5] - self.domain[4]) / (self.nz - 1)

    @property
    def shape(self) -> Tuple[int, int, int]:
        """Storage shape of a field on this grid (the logical shape)."""
        return (self.nx, self.ny, self.nz)

    @property
    def num_interior(self) -> int:
        return (self.nx - 2) * (self.ny - 2) * (self.nz - 2)

    def can_coarsen(self) -> bool:
        """True if 2:1 coarsening keeps at least one interior point."""
        return all((n - 1) % 2 == 0 and (n - 1) // 2 + 1 >= 3
                   for n in self.shape)

    def coarsen(self) -> "Grid3D":
        """Return the 2:1-coarsened grid."""
        if not self.can_coarsen():
            raise ValueError(f"cannot coarsen {self.shape}")
        return Grid3D(*((n - 1) // 2 + 1 for n in self.shape), self.domain)

    def axes(self):
        """Host-side (numpy) node coordinates x, y, z along each axis.

        Built as ``x0 + hx * arange(nx)`` so the values are bit-identical to
        the JAX package's padded meshes on the logical region.
        """
        x0, _, y0, _, z0, _ = self.domain
        return (x0 + self.hx * np.arange(self.nx),
                y0 + self.hy * np.arange(self.ny),
                z0 + self.hz * np.arange(self.nz))

    def coordinates(self):
        """Host-side coordinate meshes X, Y, Z of shape (nx, ny, nz)."""
        return np.meshgrid(*self.axes(), indexing="ij")
