"""Meshes of ranks and block shardings for spatial domain decomposition.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/parallel/
mesh.py`` over ``torch.distributed``:

- ``Mesh`` lays the ranks of a process group out as a grid (the 2D
  ('x', 'y') mesh, or the graded ('xo', 'xi', 'yo', 'yi') one), row-major
  as the JAX package reshapes its device list, and holds one subgroup per
  mesh axis through this rank (``dist.new_group``, created by every rank in
  the same order), so that sums and gathers run along one axis.
- ``grid_sharding``, ``grid_sharding3d``, ``graded_sharding`` and
  ``replicated`` return a ``BlockSharding``, the counterpart of
  ``NamedSharding``: which mesh axes block-split each array axis.
- The rules are the JAX package's (its mesh.py:32-72, :75-87, :101-153): a
  level is block-split along an axis while every rank keeps at least
  ``min_points_per_device`` logical rows or columns and the blocks tile the
  axis evenly, else it is replicated (coarse-level agglomeration). Blocks
  tile ``block_extent``, the JAX package's tile-padded storage shape (16 x
  128; its ``core/grid.py``), which this package's fields do not carry:
  the port keeps that extent as the layout of a sharded field so that its
  sharding decisions and block shapes are the reference's.

A mesh of one rank needs no process group: ``Mesh((1, 1))`` or
``make_mesh`` without ``torch.distributed`` initialized.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("x", "y")
GRADED_AXES = ("xo", "xi", "yo", "yi")
SUBLANE, LANE = 16, 128  # the JAX package's storage tile (its core/grid.py)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def block_extent(nx: int, ny: int) -> Tuple[int, int]:
    """The extent a sharded 2D field's blocks tile: the JAX package's padded
    shape of an (nx, ny) grid; the logical region sits at the origin."""
    return (_round_up(nx, SUBLANE), _round_up(ny, LANE))


def block_extent3d(nx: int, ny: int, nz: int) -> Tuple[int, int, int]:
    """The 3D counterpart (the JAX package's ``padded_shape3d``)."""
    return (_round_up(nx, 2), _round_up(ny, SUBLANE), _round_up(nz, LANE))


class Mesh:
    """``ranks`` (global ranks of the default process group) laid out as a
    grid of ``shape`` over ``axis_names``, row-major. ``coords`` are this
    process's coordinates (the first rank's when this process is not in the
    mesh or no process group exists). Along each axis of more than one
    rank, the ranks that share every other coordinate form a subgroup
    (``all_gather`` runs on it); ``group`` is the subgroup of the whole mesh
    (None for the default group, or without a process group)."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = AXES,
                 ranks: Optional[Sequence[int]] = None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match its axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        self.ranks = tuple(range(self.size) if ranks is None else ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"mesh shape {shape} needs {self.size} ranks, "
                             f"got {len(self.ranks)}")
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else self.ranks[0]
        here = self.rank if self.rank in self.ranks else self.ranks[0]
        self.coords = dict(zip(self.axis_names, _unravel(
            self.ranks.index(here), shape)))
        self._groups = {}
        self.group = None
        if self.distributed and self.size > 1:
            self._make_groups()

    def _make_groups(self):
        """One subgroup per line of each axis, and one of the whole mesh
        unless it is the default group; every rank creates every group, in
        the same order."""
        world = dist.get_world_size()
        if sorted(self.ranks) != list(range(world)):
            self.group = dist.new_group(sorted(self.ranks))
        for name in self.axis_names:
            if self.shape[name] == 1:
                continue
            for line in self._lines(name):
                group = dist.new_group(sorted(line))
                if self.rank in line:
                    self._groups[name] = (group, tuple(line))

    def _lines(self, name: str):
        """The rank lists of the lines along axis ``name``, each in the
        order of its coordinate."""
        shape = tuple(self.shape[a] for a in self.axis_names)
        k = self.axis_names.index(name)
        lines = {}
        for idx, r in enumerate(self.ranks):
            c = list(_unravel(idx, shape))
            c[k] = 0
            lines.setdefault(tuple(c), []).append(r)
        return list(lines.values())

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's coordinates changed by
        ``coords``."""
        c = dict(self.coords, **coords)
        shape = tuple(self.shape[a] for a in self.axis_names)
        idx = 0
        for a, s in zip(self.axis_names, shape):
            idx = idx * s + c[a]
        return self.ranks[idx]

    def all_gather(self, t: torch.Tensor, name: str, dim: int
                   ) -> torch.Tensor:
        """The blocks of every rank along axis ``name``, concatenated along
        ``dim`` in the order of their coordinate (``all_gather(tiled=True)``
        of the JAX package)."""
        if self.shape[name] == 1:
            return t
        group, line = self._groups[name]
        parts = [torch.empty_like(t) for _ in line]
        dist.all_gather(parts, t.contiguous(), group=group)
        order = sorted(line)  # a group's ranks are numbered in rank order
        return torch.cat([parts[order.index(r)] for r in line], dim=dim)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` (a 0-d tensor) over every rank of the mesh."""
        if self.size == 1:
            return t
        out = t.reshape(1).clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out.reshape(())

    def broadcast(self, obj):
        """The mesh's first rank's ``obj`` (picklable), on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        return box[0]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, ranks={self.ranks}, "
                f"coords={self.coords})")


def _unravel(idx: int, shape: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(idx % s)
        idx //= s
    return tuple(reversed(out))


@dataclasses.dataclass(frozen=True, eq=False)
class BlockSharding:
    """Which mesh axes block-split each array axis (``spec``: per array
    axis None, one axis name, or a tuple of names, major first), the
    counterpart of a ``NamedSharding``."""

    mesh: Mesh
    spec: Tuple

    def _names(self, entry):
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def block_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of an array of ``shape`` (the block extent)."""
        out = []
        for n, entry in zip(shape, tuple(self.spec) + (None,) * len(shape)):
            names = self._names(entry)
            count = math.prod(self.mesh.shape[a] for a in names)
            if n % count:
                raise ValueError(f"extent {n} does not split into {count} "
                                 f"blocks")
            idx = 0
            for a in names:
                idx = idx * self.mesh.shape[a] + self.mesh.coords[a]
            b = n // count
            out.append(slice(idx * b, (idx + 1) * b))
        return tuple(out)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``, an array of the block extent."""
        return x[self.block_slices(x.shape)]


def choose_mesh_shape(n_devices: int, grid=None) -> Tuple[int, int]:
    """A near-square 2D mesh shape; the longer grid dimension gets the
    larger mesh axis (the JAX package's rule)."""
    best = (1, n_devices)
    for mx in range(1, n_devices + 1):
        if n_devices % mx:
            continue
        my = n_devices // mx
        if abs(mx - my) < abs(best[0] - best[1]):
            best = (mx, my)
    mx, my = best
    if grid is not None and grid.nx < grid.ny and mx > my:
        mx, my = my, mx
    return (mx, my)


def _world_ranks() -> Tuple[int, ...]:
    if dist.is_available() and dist.is_initialized():
        return tuple(range(dist.get_world_size()))
    return (0,)


def make_mesh(ranks: Optional[Sequence[int]] = None,
              shape: Optional[Tuple[int, int]] = None,
              grid=None) -> Mesh:
    """A 2D ('x', 'y') mesh over ``ranks`` (every rank of the default
    process group by default); called by every rank of that group."""
    ranks = tuple(_world_ranks() if ranks is None else ranks)
    if shape is None:
        shape = choose_mesh_shape(len(ranks), grid)
    return Mesh(shape, AXES, ranks[:shape[0] * shape[1]])


def _axis_spec(n: int, p: int, m: int, name: str, min_points: int):
    return name if n // m >= min_points and p % m == 0 else None


def grid_sharding(mesh: Mesh, grid, min_points_per_device: int = 16
                  ) -> BlockSharding:
    """A level's sharding: block-split while every rank keeps at least
    ``min_points_per_device`` logical rows or columns and the blocks tile
    the block extent, else replicated (coarse-level agglomeration)."""
    px, py = block_extent(grid.nx, grid.ny)
    return BlockSharding(mesh, (
        _axis_spec(grid.nx, px, mesh.shape["x"], "x", min_points_per_device),
        _axis_spec(grid.ny, py, mesh.shape["y"], "y",
                   min_points_per_device)))


def grid_sharding3d(mesh: Mesh, grid3d, min_points_per_device: int = 16
                    ) -> BlockSharding:
    """A 3D level's sharding: (x, y) as ``grid_sharding``, z (contiguous)
    kept whole on every rank."""
    px, py, _ = block_extent3d(grid3d.nx, grid3d.ny, grid3d.nz)
    return BlockSharding(mesh, (
        _axis_spec(grid3d.nx, px, mesh.shape["x"], "x",
                   min_points_per_device),
        _axis_spec(grid3d.ny, py, mesh.shape["y"], "y",
                   min_points_per_device), None))


def replicated(mesh: Mesh) -> BlockSharding:
    return BlockSharding(mesh, ())


def _factor2(m: int) -> Tuple[int, int]:
    """(outer, inner) factoring of one mesh axis: inner 2 gives one 2-way
    agglomeration step; odd and unit axes get no intermediate tier."""
    return (m // 2, 2) if m % 2 == 0 and m > 1 else (m, 1)


def make_graded_mesh(ranks: Optional[Sequence[int]] = None,
                     shape: Optional[Tuple[int, int, int, int]] = None,
                     grid=None) -> Mesh:
    """A 4-axis ('xo', 'xi', 'yo', 'yi') mesh for graded agglomeration:
    each spatial axis factored into outer x inner. Fine levels split over
    both factors, mid levels over the outer ones (replica groups of the
    inner ones), the coarsest replicate."""
    ranks = tuple(_world_ranks() if ranks is None else ranks)
    if shape is None:
        mx, my = choose_mesh_shape(len(ranks), grid)
        shape = _factor2(mx) + _factor2(my)
    return Mesh(shape, GRADED_AXES, ranks[:math.prod(shape)])


def graded_sharding(mesh: Mesh, grid, min_points_per_device: int = 16
                    ) -> BlockSharding:
    """Three tiers per axis: block over (outer, inner) while every rank
    keeps ``min_points_per_device`` logical rows or columns, else over the
    outer factor only, else replicated. Needs a ``make_graded_mesh``
    mesh."""
    px, py = block_extent(grid.nx, grid.ny)

    def axis_spec(n, p, outer_name, inner_name):
        outer = mesh.shape[outer_name]
        full = outer * mesh.shape[inner_name]
        if n // full >= min_points_per_device and p % full == 0:
            return (outer_name, inner_name)
        if outer > 1 and n // outer >= min_points_per_device \
                and p % outer == 0:
            return outer_name
        return None

    return BlockSharding(mesh, (axis_spec(grid.nx, px, "xo", "xi"),
                                axis_spec(grid.ny, py, "yo", "yi")))


def pad_to_extent(x: torch.Tensor, extent: Sequence[int]) -> torch.Tensor:
    """``x`` (logical shape) at the origin of a zero array of
    ``extent``."""
    out = torch.zeros(tuple(extent), dtype=x.dtype, device=x.device)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def shard_level_arrays(mesh: Mesh, grid, *arrays,
                       min_points_per_device: int = 16):
    """This rank's block of each (nx, ny) array under the level's
    sharding (the arrays placed in the block extent first)."""
    sh = grid_sharding(mesh, grid, min_points_per_device)
    extent = block_extent(grid.nx, grid.ny)
    out = tuple(sh.block(pad_to_extent(a, extent)) for a in arrays)
    return out if len(out) > 1 else out[0]
