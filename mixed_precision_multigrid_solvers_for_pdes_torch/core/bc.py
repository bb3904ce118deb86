"""Boundary-condition specification and the unknown mask (all-Dirichlet).

Counterpart of the all-Dirichlet part of
``mixed_precision_multigrid_solvers_for_pdes_tpu/core/bc.py``: Dirichlet
boundary nodes are fixed (they hold the boundary value, every update is masked
off them, residuals are zero there). Neumann, Robin, periodic and segmented
sides are not ported yet (ROADMAP, modules still to port, item 7) and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

SIDES = ("west", "east", "south", "north")  # i=0, i=nx-1, j=0, j=ny-1

_NOT_PORTED = ("only Dirichlet sides are ported; Neumann/Robin/periodic and "
               "segmented sides are ROADMAP item 7 (the rest of the 2D "
               "operator)")


class BCKind(enum.Enum):
    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"
    ROBIN = "robin"
    PERIODIC = "periodic"


@dataclasses.dataclass(frozen=True)
class BCSide:
    """One side's condition. Only ``BCKind.DIRICHLET`` is supported."""

    kind: BCKind = BCKind.DIRICHLET

    def __post_init__(self):
        if self.kind != BCKind.DIRICHLET:
            raise NotImplementedError(f"{self.kind.value} side: {_NOT_PORTED}")


@dataclasses.dataclass(frozen=True)
class BoundarySpec:
    """Static, hashable BC description for all four sides."""

    west: BCSide = BCSide()
    east: BCSide = BCSide()
    south: BCSide = BCSide()
    north: BCSide = BCSide()

    def side(self, name: str) -> BCSide:
        return getattr(self, name)

    @property
    def all_dirichlet(self) -> bool:
        return all(self.side(s).kind == BCKind.DIRICHLET for s in SIDES)


def dirichlet() -> BoundarySpec:
    """All-Dirichlet spec (the values are supplied per problem)."""
    return BoundarySpec()


def unknown_mask(nx: int, ny: int, spec: BoundarySpec = BoundarySpec(), *,
                 device="cpu") -> torch.Tensor:
    """Boolean (nx, ny) mask: True where the solver owns the node.

    With all four sides Dirichlet that is the strict interior
    ``1..nx-2 x 1..ny-2``.
    """
    if not spec.all_dirichlet:
        raise NotImplementedError(_NOT_PORTED)
    mask = torch.zeros((nx, ny), dtype=torch.bool, device=device)
    mask[1:-1, 1:-1] = True
    return mask
