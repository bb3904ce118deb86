"""Boundary-condition specification and the unknown mask.

Counterpart of ``BCKind``, ``BCSide``, ``BoundarySpec``, ``dirichlet``,
``neumann``, ``mixed``, ``unknown_mask``, ``side_mask``, ``side_regions``
and ``logical_mask`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/core/bc.py``, for whole
sides:

- Dirichlet sides: boundary nodes are fixed (they hold the boundary value,
  every update is masked off them, residuals are zero there).
- Neumann / Robin sides (``alpha*u + beta*du/dn = g``, outward normal):
  boundary nodes are unknowns; the ghost point is eliminated into the edge
  equation (``ops/stencil.py``). Where a Dirichlet side meets one, Dirichlet
  claims the corner.

Periodic sides and per-segment conditions (``BCSide.segments``, JAX
``BCSegment``) are not ported yet (ROADMAP, modules still to port, item 7)
and raise ``NotImplementedError``. Fields have the logical shape (nx, ny),
so every mask here covers logical nodes only.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

SIDES = ("west", "east", "south", "north")  # i=0, i=nx-1, j=0, j=ny-1

_NOT_PORTED = ("periodic sides and per-segment conditions are ROADMAP item 7 "
               "(the rest of the 2D operator)")


class BCKind(enum.Enum):
    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"
    ROBIN = "robin"
    PERIODIC = "periodic"


@dataclasses.dataclass(frozen=True)
class BCSide:
    """One side's condition: alpha*u + beta*du/dn = g (g supplied per
    problem). Dirichlet: u = g. Neumann: du/dn = g. Robin: beta != 0."""

    kind: BCKind = BCKind.DIRICHLET
    alpha: float = 0.0
    beta: float = 1.0
    segments: tuple = ()

    def __post_init__(self):
        if self.kind == BCKind.PERIODIC:
            raise NotImplementedError(f"periodic side: {_NOT_PORTED}")
        if self.segments:
            raise NotImplementedError(f"BC segments: {_NOT_PORTED}")
        if self.kind == BCKind.ROBIN and self.beta == 0.0:
            raise ValueError("Robin BC requires beta != 0")


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

    @property
    def any_periodic(self) -> bool:
        return any(self.side(s).kind == BCKind.PERIODIC for s in SIDES)

    @property
    def any_segments(self) -> bool:
        return any(self.side(s).segments for s in SIDES)

    @property
    def plain(self) -> bool:
        """No side introduces boundary unknowns. With periodic sides not
        ported this is ``all_dirichlet``; it gates the constant-coefficient
        stencil and the 'zero' restriction boundary, as in the JAX
        package."""
        return self.all_dirichlet

    @property
    def dirichlet_sides(self):
        """(west, east, south, north) flags, True where the side is
        Dirichlet: the ``sides`` argument of the transfer kernels."""
        return tuple(self.side(s).kind == BCKind.DIRICHLET for s in SIDES)


def dirichlet() -> BoundarySpec:
    """All-Dirichlet spec (the values are supplied per problem)."""
    return BoundarySpec()


def neumann() -> BoundarySpec:
    """Neumann on all four sides (singular without a shift)."""
    side = BCSide(kind=BCKind.NEUMANN)
    return BoundarySpec(side, side, side, side)


def mixed(**kwargs) -> BoundarySpec:
    """Spec from per-side kinds or BCSides, e.g. ``mixed(east='neumann')``;
    sides not named are Dirichlet."""
    unknown = set(kwargs) - set(SIDES)
    if unknown:
        raise ValueError(f"unknown sides {sorted(unknown)}; expected {SIDES}")
    return BoundarySpec(**{
        name: val if isinstance(val, BCSide) else BCSide(kind=BCKind(val))
        for name, val in kwargs.items()})


def unknown_rect(nx: int, ny: int, sides=(True,) * 4):
    """(i0, i1, j0, j1): the unknowns are the rectangle [i0:i1, j0:j1].

    ``sides`` holds (west, east, south, north) Dirichlet flags; a Dirichlet
    side's ring is fixed, any other side's ring is unknown."""
    dw, de, ds, dn = sides
    return int(dw), nx - int(de), int(ds), ny - int(dn)


def unknown_mask(nx: int, ny: int, spec: BoundarySpec = BoundarySpec(), *,
                 device="cpu") -> torch.Tensor:
    """Boolean (nx, ny) mask: True where the solver owns the node.

    Dirichlet boundary nodes are fixed (corners included); Neumann/Robin
    boundary nodes are unknowns. All-Dirichlet gives the strict interior
    ``1..nx-2 x 1..ny-2``."""
    return rect_mask(nx, ny, spec.dirichlet_sides, device=device)


def rect_mask(nx: int, ny: int, sides=(True,) * 4, *,
              device="cpu") -> torch.Tensor:
    """Boolean (nx, ny) mask of ``unknown_rect(nx, ny, sides)``."""
    i0, i1, j0, j1 = unknown_rect(nx, ny, sides)
    mask = torch.zeros((nx, ny), dtype=torch.bool, device=device)
    mask[i0:i1, j0:j1] = True
    return mask


def side_mask(name: str, nx: int, ny: int, *, device="cpu") -> torch.Tensor:
    """Boolean (nx, ny) mask of one side's nodes, corners included."""
    mask = torch.zeros((nx, ny), dtype=torch.bool, device=device)
    index = {"west": (0, slice(None)), "east": (nx - 1, slice(None)),
             "south": (slice(None), 0), "north": (slice(None), ny - 1)}
    mask[index[name]] = True
    return mask


def side_regions(name: str, nx: int, ny: int, side: BCSide, *,
                 device="cpu"):
    """(effective BCSide, mask) pairs covering one side's nodes: a single
    pair, since segmented sides are not ported. Consumed by the stencil's
    ghost elimination and ``bc_rhs_correction``, as in the JAX package."""
    return [(side, side_mask(name, nx, ny, device=device))]


def logical_mask(nx: int, ny: int, *, device="cpu") -> torch.Tensor:
    """All logical nodes: every node, since fields carry no padding."""
    return torch.ones((nx, ny), dtype=torch.bool, device=device)
