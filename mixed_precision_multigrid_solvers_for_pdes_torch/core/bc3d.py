"""3D boundary-condition specification, the unknown and face masks, and the
periodic sync.

Counterpart of ``BoundarySpec3D``, ``mixed3d``, ``neumann3d``,
``unknown_mask3d``, ``side_mask3d`` and ``periodic_sync3d`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/core/bc3d.py``, with the
2D vocabulary of ``core/bc.py`` (``BCKind``, ``BCSide``) on six faces:

- Dirichlet faces: fixed nodes holding the boundary value, updates masked off
  them, zero residual there; a Dirichlet face claims the edges and corners
  it shares with a Neumann/Robin one.
- Neumann / Robin faces: the face's nodes are unknowns; the ghost node is
  eliminated into the face equation (``ops/stencil3d.py``).
- Periodic axes (both faces of an axis together): the unknowns are nodes
  0..n-2 of the axis, and node n-1 duplicates node 0. As in 2D the port
  stores no padding: the operators read the wrap neighbours directly
  (``ops/stencil3d.region``), so the duplicate is only refreshed
  (``periodic_sync3d``) where it is read or handed out.

A 3D face takes no segments (the JAX package's 3D masks read the face's
kind only). Fields have the logical shape (nx, ny, nz).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from .bc import BCKind, BCSide

# west/east = x-/x+, south/north = y-/y+, bottom/top = z-/z+
SIDES3D = ("west", "east", "south", "north", "bottom", "top")
_AXIS = {"west": 0, "east": 0, "south": 1, "north": 1, "bottom": 2, "top": 2}
_LOW = {"west": True, "east": False, "south": True, "north": False,
        "bottom": True, "top": False}
_PAIRS = (("west", "east"), ("south", "north"), ("bottom", "top"))


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

    @property
    def any_periodic(self) -> bool:
        return any(self.side(s).kind == BCKind.PERIODIC for s in SIDES3D)

    @property
    def plain(self) -> bool:
        """Every face Dirichlet or periodic: no face unknowns. Gates the
        constant-coefficient stencil and the 'zero' restriction boundary,
        as in the JAX package."""
        return all(self.side(s).kind in (BCKind.DIRICHLET, BCKind.PERIODIC)
                   for s in SIDES3D)

    @property
    def wrap(self) -> Tuple[bool, bool, bool]:
        """(x, y, z): True where the axis is periodic."""
        return tuple(self.side(lo).kind == BCKind.PERIODIC
                     for lo, _ in _PAIRS)

    def validate(self) -> None:
        """Periodic faces pair up across an axis; no face has segments."""
        for lo, hi in _PAIRS:
            if ((self.side(lo).kind == BCKind.PERIODIC)
                    != (self.side(hi).kind == BCKind.PERIODIC)):
                raise ValueError(
                    f"periodic BC must be set on both {lo} and {hi}")
        if any(self.side(s).segments for s in SIDES3D):
            raise ValueError("a 3D face takes no BC segments")


def mixed3d(**kwargs) -> BoundarySpec3D:
    """Spec from per-face kinds or BCSides, e.g. ``mixed3d(top='neumann')``;
    faces not named are Dirichlet."""
    unknown = set(kwargs) - set(SIDES3D)
    if unknown:
        raise ValueError(f"unknown faces {sorted(unknown)}; expected "
                         f"{SIDES3D}")
    return BoundarySpec3D(**{
        name: val if isinstance(val, BCSide) else BCSide(kind=BCKind(val))
        for name, val in kwargs.items()})


def neumann3d() -> BoundarySpec3D:
    """Neumann on all six faces (singular without a shift)."""
    side = BCSide(kind=BCKind.NEUMANN)
    return BoundarySpec3D(*(side,) * 6)


def _index(n: int, axis: int, device) -> torch.Tensor:
    shape = [1, 1, 1]
    shape[axis] = n
    return torch.arange(n, device=device).reshape(shape)


def unknown_mask3d(nx: int, ny: int, nz: int,
                   spec: BoundarySpec3D = BoundarySpec3D(), *,
                   device="cpu") -> torch.Tensor:
    """Boolean (nx, ny, nz) mask: True where the solver owns the node. Per
    axis: nodes 0..n-2 when periodic, else every node but those of a
    Dirichlet face."""
    dims = (nx, ny, nz)
    mask = torch.ones(dims, dtype=torch.bool, device=device)
    for axis, (lo, hi) in enumerate(_PAIRS):
        n = dims[axis]
        idx = _index(n, axis, device)
        if spec.side(lo).kind == BCKind.PERIODIC:
            mask = mask & (idx < n - 1)
            continue
        if spec.side(lo).kind == BCKind.DIRICHLET:
            mask = mask & (idx > 0)
        if spec.side(hi).kind == BCKind.DIRICHLET:
            mask = mask & (idx < n - 1)
    return mask


def side_mask3d(name: str, nx: int, ny: int, nz: int, *,
                device="cpu") -> torch.Tensor:
    """Boolean (nx, ny, nz) mask of one face's nodes, edges and corners
    included."""
    axis = _AXIS[name]
    n = (nx, ny, nz)[axis]
    idx = _index(n, axis, device)
    face = idx == (0 if _LOW[name] else n - 1)
    return face.expand(nx, ny, nz).contiguous()


def sync_wrap3d(u: torch.Tensor, wrap) -> torch.Tensor:
    """In place: node n-1 of each periodic axis of ``wrap`` (x, y, z) takes
    node 0's value, x first, then y, then z. Returns ``u``."""
    for axis, w in enumerate(wrap):
        if w:
            u.select(axis, -1).copy_(u.select(axis, 0))
    return u


def periodic_sync3d(spec: BoundarySpec3D):
    """In-place refresh of the duplicate nodes of the spec's periodic axes
    (``sync_wrap3d``), or None when no axis is periodic."""
    if not any(spec.wrap):
        return None
    return functools.partial(sync_wrap3d, wrap=spec.wrap)
