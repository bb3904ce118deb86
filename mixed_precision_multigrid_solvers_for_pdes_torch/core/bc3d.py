"""3D boundary-condition specification and the unknown mask (all-Dirichlet).

Counterpart of the all-Dirichlet part of
``mixed_precision_multigrid_solvers_for_pdes_tpu/core/bc3d.py``: six faces,
each Dirichlet (fixed nodes holding the boundary value, updates masked off
them, zero residual there). Neumann, Robin and periodic faces are not ported
yet (ROADMAP item 13) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from .bc import BCKind, BCSide

# west/east = x-/x+, south/north = y-/y+, bottom/top = z-/z+
SIDES3D = ("west", "east", "south", "north", "bottom", "top")

NOT_PORTED_3D = ("only all-Dirichlet boxes are ported in 3D; Neumann, Robin "
                 "and periodic faces are ROADMAP item 13")


@dataclasses.dataclass(frozen=True)
class BoundarySpec3D:
    """Static, hashable BC description for all six faces."""

    west: BCSide = BCSide()
    east: BCSide = BCSide()
    south: BCSide = BCSide()
    north: BCSide = BCSide()
    bottom: BCSide = BCSide()
    top: BCSide = BCSide()

    def side(self, name: str) -> BCSide:
        return getattr(self, name)

    @property
    def all_dirichlet(self) -> bool:
        return all(self.side(s).kind == BCKind.DIRICHLET for s in SIDES3D)


def mixed3d(**kinds) -> BoundarySpec3D:
    """Spec from per-face kind names, e.g. ``mixed3d(top='dirichlet')``;
    every face defaults to Dirichlet, the only kind ported."""
    unknown = set(kinds) - set(SIDES3D)
    if unknown:
        raise ValueError(f"unknown faces {sorted(unknown)}; expected "
                         f"{SIDES3D}")
    for name, kind in kinds.items():
        if BCKind(kind) != BCKind.DIRICHLET:
            raise NotImplementedError(f"{kind} face {name!r}: "
                                      f"{NOT_PORTED_3D}")
    return BoundarySpec3D()


def unknown_mask3d(nx: int, ny: int, nz: int,
                   spec: BoundarySpec3D = BoundarySpec3D(), *,
                   device="cpu") -> torch.Tensor:
    """Boolean (nx, ny, nz) mask: True where the solver owns the node, the
    strict interior of an all-Dirichlet box."""
    if not spec.all_dirichlet:
        raise NotImplementedError(NOT_PORTED_3D)
    mask = torch.zeros((nx, ny, nz), dtype=torch.bool, device=device)
    mask[1:-1, 1:-1, 1:-1] = True
    return mask
