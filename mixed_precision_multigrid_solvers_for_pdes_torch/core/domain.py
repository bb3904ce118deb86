"""Irregular solution domains as node masks.

Counterpart of ``LShapedDomain`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/core/domain.py``. A domain
marks each node as inside (a solver unknown, subject to the outer
``BoundarySpec``) or removed (held at its Dirichlet value, as the outer ring
is). ``Level.unknown`` ANDs the domain's mask into the boundary mask, so the
residuals, smoothers and transfers, all masked by it, need nothing else.
Cuts at grid fractions k/2^m stay on nodes under 2:1 coarsening. No 2D
kernel takes a domain level: every kernel gate in ``ops/dispatch.py`` and
``solvers/plane_solve.py`` refuses one, since the kernels build their
unknowns from the rectangle.
"""

from __future__ import annotations

import dataclasses

import torch

from . import bc as bc_mod
from .grid import Grid

_TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class LShapedDomain:
    """The rectangle minus the closed quadrant [x_cut, x1] x [y_cut, y1],
    with its re-entrant corner at (x_cut, y_cut). The nodes of the removed
    quadrant, its two cut edges included, are fixed."""

    x_cut: float = 0.5
    y_cut: float = 0.5

    def interior_mask(self, grid: Grid, device="cpu") -> torch.Tensor:
        """Bool (nx, ny) mask: True where the node lies in the open
        domain."""
        i = torch.arange(grid.nx, device=device)[:, None]
        j = torch.arange(grid.ny, device=device)[None, :]
        mask = self.interior_mask_at(grid, i, j)
        return mask.expand(grid.nx, grid.ny).contiguous()

    def interior_mask_at(self, grid: Grid, i: torch.Tensor,
                         j: torch.Tensor) -> torch.Tensor:
        """The mask at index tensors ``i``, ``j`` (broadcast together),
        from float64 coordinates."""
        x0, _, y0, _ = grid.domain
        X = x0 + grid.hx * i.to(torch.float64)
        Y = y0 + grid.hy * j.to(torch.float64)
        removed = (X >= self.x_cut - _TOL) & (Y >= self.y_cut - _TOL)
        return ~removed


def unknown_mask(grid: Grid, spec, domain=None, *,
                 device="cpu") -> torch.Tensor:
    """Bool (nx, ny) mask of a level's unknowns: the boundary spec's,
    ANDed with the domain's interior when there is a domain."""
    mask = bc_mod.unknown_mask(grid.nx, grid.ny, spec, device=device)
    if domain is not None:
        mask = mask & domain.interior_mask(grid, device)
    return mask
