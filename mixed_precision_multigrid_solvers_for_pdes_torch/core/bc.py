"""Boundary-condition specification and the unknown mask.

Counterpart of ``BCKind``, ``BCSegment``, ``BCSide``, ``BoundarySpec``,
``dirichlet``, ``neumann``, ``mixed``, ``unknown_mask``/``unknown_mask_at``,
``side_mask``, ``side_regions``, ``periodic_sync`` and ``logical_mask`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/core/bc.py``:

- Dirichlet sides: boundary nodes are fixed (they hold the boundary value,
  every update is masked off them, residuals are zero there).
- Neumann / Robin sides (``alpha*u + beta*du/dn = g``, outward normal):
  boundary nodes are unknowns; the ghost point is eliminated into the edge
  equation (``ops/stencil.py``). Where a Dirichlet side meets one, Dirichlet
  claims the corner.
- Segments (``BCSide.segments``): intervals of a side with their own
  condition; a node belongs to the first listed segment whose closed
  interval holds its tangential fraction, else to the side's default.
- Periodic axes (west and east, or south and north, together): the unknowns
  are nodes 0..n-2 of the axis and node n-1 duplicates node 0. The operators
  read the wrap neighbours directly (``ops/stencil.py``), so the duplicate
  is only refreshed (``periodic_sync``, ``sync_wrap``) where it is read or
  handed out.

Fields have the logical shape (nx, ny), so every mask here covers logical
nodes only.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Tuple

import torch

SIDES = ("west", "east", "south", "north")  # i=0, i=nx-1, j=0, j=ny-1


class BCKind(enum.Enum):
    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"
    ROBIN = "robin"
    PERIODIC = "periodic"


@dataclasses.dataclass(frozen=True)
class BCSegment:
    """One interval of a side with its own condition. ``lo``/``hi`` are
    fractions of the side's length in [0, 1]; a boundary node at tangential
    fraction t belongs to the segment when lo <= t <= hi (the first listed
    segment wins where two touch). A segment cannot be periodic."""

    lo: float
    hi: float
    kind: BCKind = BCKind.DIRICHLET
    alpha: float = 0.0
    beta: float = 1.0

    def __post_init__(self):
        if not (0.0 <= self.lo < self.hi <= 1.0):
            raise ValueError(
                f"segment interval must satisfy 0 <= lo < hi <= 1, "
                f"got [{self.lo}, {self.hi}]")
        if self.kind == BCKind.PERIODIC:
            raise ValueError("periodic BC cannot be assigned to a segment")
        if self.kind == BCKind.ROBIN and self.beta == 0.0:
            raise ValueError("Robin BC requires beta != 0")


@dataclasses.dataclass(frozen=True)
class BCSide:
    """One side's condition: alpha*u + beta*du/dn = g (g supplied per
    problem). Dirichlet: u = g. Neumann: du/dn = g. Robin: beta != 0.
    ``segments`` override intervals of the side; ``kind``/``alpha``/``beta``
    apply outside them."""

    kind: BCKind = BCKind.DIRICHLET
    alpha: float = 0.0
    beta: float = 1.0
    segments: Tuple[BCSegment, ...] = ()

    def __post_init__(self):
        if self.kind == BCKind.ROBIN and self.beta == 0.0:
            raise ValueError("Robin BC requires beta != 0")
        if self.segments:
            if self.kind == BCKind.PERIODIC:
                raise ValueError("a periodic side cannot carry BC segments")
            segs = sorted(self.segments, key=lambda s: s.lo)
            for a, b in zip(segs, segs[1:]):
                if b.lo < a.hi:
                    raise ValueError(
                        f"overlapping BC segments [{a.lo},{a.hi}] and "
                        f"[{b.lo},{b.hi}]")

    @property
    def kinds(self) -> frozenset:
        """Every condition kind on this side, the default's always included
        (the gates stay conservative rather than prove that the segments
        cover the whole side)."""
        return frozenset({self.kind} | {s.kind for s in self.segments})


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
        return all(self.side(s).kinds == {BCKind.DIRICHLET} for s in SIDES)

    @property
    def any_periodic(self) -> bool:
        return any(self.side(s).kind == BCKind.PERIODIC for s in SIDES)

    @property
    def any_segments(self) -> bool:
        return any(self.side(s).segments for s in SIDES)

    @property
    def plain(self) -> bool:
        """No side or segment introduces boundary unknowns: every condition
        is Dirichlet or periodic. Gates the constant-coefficient stencil and
        the 'zero' restriction boundary, as in the JAX package."""
        return all(k in (BCKind.DIRICHLET, BCKind.PERIODIC)
                   for s in SIDES for k in self.side(s).kinds)

    @property
    def wrap(self) -> Tuple[bool, bool]:
        """(x, y): True where the axis is periodic."""
        return (self.west.kind == BCKind.PERIODIC,
                self.south.kind == BCKind.PERIODIC)

    @property
    def dirichlet_sides(self):
        """(west, east, south, north) flags, True where the whole side is
        Dirichlet: the ``sides`` argument of the transfer kernels."""
        return tuple(self.side(s).kinds == {BCKind.DIRICHLET} for s in SIDES)

    def validate(self) -> None:
        """Periodic conditions must pair up across an axis."""
        if (self.west.kind == BCKind.PERIODIC) != \
                (self.east.kind == BCKind.PERIODIC):
            raise ValueError("periodic BC must be set on both west and east")
        if (self.south.kind == BCKind.PERIODIC) != \
                (self.north.kind == BCKind.PERIODIC):
            raise ValueError("periodic BC must be set on both south and "
                             "north")


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


def _segment_claims(side: BCSide, t: torch.Tensor, n: int):
    """(segment-or-default BCSide, claim mask over ``t``) pairs of a
    segmented side; ``t`` holds tangential node indices, ``n`` is the side's
    extent. The fraction is computed in float32, as in the JAX package, so
    claims at touching endpoints agree. The first listed segment wins."""
    frac = t.to(torch.float32) / torch.tensor(max(n - 1, 1),
                                              dtype=torch.float32)
    claimed = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for seg in side.segments:
        m = (frac >= seg.lo) & (frac <= seg.hi) & ~claimed
        claimed = claimed | m
        yield BCSide(kind=seg.kind, alpha=seg.alpha, beta=seg.beta), m
    yield BCSide(kind=side.kind, alpha=side.alpha, beta=side.beta), ~claimed


def _side_dirichlet_at(side: BCSide, t: torch.Tensor, n: int):
    """Bool mask over tangential indices ``t``: True where the side's
    effective condition (after segments) is Dirichlet."""
    if not side.segments:
        return torch.full(t.shape, side.kind == BCKind.DIRICHLET,
                          device=t.device)
    out = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for eff, m in _segment_claims(side, t, n):
        if eff.kind == BCKind.DIRICHLET:
            out = out | m
    return out


def unknown_mask_at(spec: BoundarySpec, nx: int, ny: int, gi, gj):
    """True where the solver owns node (gi, gj) (broadcasting index
    tensors). Dirichlet boundary nodes (side default or segment) are fixed,
    Neumann/Robin ones are unknowns, and a periodic axis owns nodes
    0..n-2."""
    mask = (gi >= 0) & (gi < nx) & (gj >= 0) & (gj < ny)
    if spec.west.kind == BCKind.PERIODIC:
        mask = mask & (gi < nx - 1)
    else:
        mask = mask & ~((gi == 0) & _side_dirichlet_at(spec.west, gj, ny))
        mask = mask & ~((gi == nx - 1)
                        & _side_dirichlet_at(spec.east, gj, ny))
    if spec.south.kind == BCKind.PERIODIC:
        mask = mask & (gj < ny - 1)
    else:
        mask = mask & ~((gj == 0) & _side_dirichlet_at(spec.south, gi, nx))
        mask = mask & ~((gj == ny - 1)
                        & _side_dirichlet_at(spec.north, gi, nx))
    return mask


def _indices(nx: int, ny: int, device):
    return (torch.arange(nx, device=device)[:, None],
            torch.arange(ny, device=device)[None, :])


def unknown_mask(nx: int, ny: int, spec: BoundarySpec = BoundarySpec(), *,
                 device="cpu") -> torch.Tensor:
    """Boolean (nx, ny) mask: True where the solver owns the node.

    All-Dirichlet gives the strict interior ``1..nx-2 x 1..ny-2``; with
    segments the mask is no longer a rectangle."""
    if not (spec.any_segments or spec.any_periodic):
        return rect_mask(nx, ny, spec.dirichlet_sides, device=device)
    gi, gj = _indices(nx, ny, device)
    return unknown_mask_at(spec, nx, ny, gi, gj).expand(nx, ny).contiguous()


def unknown_rect(nx: int, ny: int, sides=(True,) * 4):
    """(i0, i1, j0, j1): the unknowns are the rectangle [i0:i1, j0:j1].

    ``sides`` holds (west, east, south, north) Dirichlet flags; a Dirichlet
    side's ring is fixed, any other side's ring is unknown. The kernels'
    rectangles; a segmented or periodic spec never reaches them."""
    dw, de, ds, dn = sides
    return int(dw), nx - int(de), int(ds), ny - int(dn)


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
    """(effective BCSide, mask) pairs covering one side's nodes: one per
    segment plus the default remainder (a single pair for an unsegmented
    side). Consumed by the stencil's ghost elimination and
    ``bc_rhs_correction``, as in the JAX package."""
    base = side_mask(name, nx, ny, device=device)
    if not side.segments:
        return [(side, base)]
    gi, gj = _indices(nx, ny, device)
    t, n = (gj, ny) if name in ("west", "east") else (gi, nx)
    return [(eff, base & m) for eff, m in _segment_claims(side, t, n)]


def sync_wrap(u: torch.Tensor, wrap) -> torch.Tensor:
    """In place: node n-1 of each periodic axis of ``wrap`` (x, y) takes
    node 0's value, x first, then y. Returns ``u``."""
    if wrap[0]:
        u[-1, :] = u[0, :]
    if wrap[1]:
        u[:, -1] = u[:, 0]
    return u


def periodic_sync(spec: BoundarySpec):
    """In-place refresh of the duplicate nodes of the spec's periodic axes
    (``sync_wrap``), or None when no axis is periodic."""
    if not any(spec.wrap):
        return None
    return functools.partial(sync_wrap, wrap=spec.wrap)


def logical_mask(nx: int, ny: int, *, device="cpu") -> torch.Tensor:
    """All logical nodes: every node, since fields carry no padding."""
    return torch.ones((nx, ny), dtype=torch.bool, device=device)
