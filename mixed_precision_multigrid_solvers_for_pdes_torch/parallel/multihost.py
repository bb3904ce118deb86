"""Multi-process launch: ``torch.distributed`` bring-up, global meshes and
fields that no rank holds whole.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/parallel/
multihost.py``:

- ``initialize_distributed`` brings the process group up (idempotent):
  NCCL when the rank has a card, gloo on the CPU. It reads torchrun's
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``) or explicit arguments, and makes the rank's card
  current. Launched by ``torchrun --nproc-per-node=N``, a script calls it
  with no arguments.
- ``make_global_mesh``: a 2D ('x', 'y') mesh over every rank.
- ``make_sharded_field``: a rank evaluates a field function only on its own
  block's coordinates, so no rank ever builds the global array.
- ``process_summary``: a small per-rank record for launch logs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..ops import stencil as st_mod
from . import blocks as bk, mesh as mesh_mod


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_id: Optional[int] = None, *,
                           backend: Optional[str] = None) -> None:
    """Bring the default process group up, once per process.

    ``coordinator_address`` is an ``init_method`` (``tcp://host:port`` or
    ``file:///path``) or a ``host:port``; by default torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` (the ``env://`` rendezvous).
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``, the card to ``LOCAL_RANK`` (else the process id). The backend
    is NCCL when that card exists, else gloo, unless given. Without a
    coordinator, a world size or torchrun's environment it does nothing:
    a single process runs meshes of one rank with no process group."""
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if local_device_id is None:
        local_device_id = int(env.get("LOCAL_RANK", process_id or 0))
    if coordinator_address is None:
        if "MASTER_ADDR" not in env and num_processes is None:
            return  # one process, no process group
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    has_card = (torch.cuda.is_available()
                and local_device_id < torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if has_card else "gloo"
    device_id = None
    if backend == "nccl":
        torch.cuda.set_device(local_device_id)
        device_id = torch.device("cuda", local_device_id)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes or 1,
                            rank=process_id or 0, device_id=device_id)


def make_global_mesh(shape: Optional[Tuple[int, int]] = None,
                     grid=None) -> mesh_mod.Mesh:
    """A 2D ('x', 'y') mesh over every rank of the default process
    group."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = mesh_mod.choose_mesh_shape(n, grid)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != world size {n}")
    return mesh_mod.make_mesh(shape=shape)


# the torch functions that act on a field block by block: the Krylov
# solvers' vector arithmetic (a 0-d tensor times a field, a tensor plus or
# minus one, zeros_like); anything else on a field raises
_BLOCKWISE = frozenset({"add", "sub", "mul", "div", "zeros_like", "__add__",
                        "__sub__", "__mul__", "__truediv__"})


def _blockwise(func, args, kwargs):
    """``func`` on the blocks of the fields among ``args``, which must share
    one layout; a tensor result is a field of that layout."""
    ref = None

    def unwrap(x):
        nonlocal ref
        if not isinstance(x, ShardedField):
            return x
        if ref is None:
            ref = x
        elif tuple(x.sharding.spec) != tuple(ref.sharding.spec) or \
                x.block.shape != ref.block.shape:
            raise ValueError("fields of different layouts")
        return x.block

    out = func(*[unwrap(a) for a in args],
               **{k: unwrap(v) for k, v in kwargs.items()})
    return ref.like(out) if isinstance(out, torch.Tensor) else out


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedField:
    """This rank's ``block`` of a level-0 field on ``grid`` under
    ``sharding``: the block extent's for ``make_sharded_field``, the
    hierarchy's layout for ``distributed.shard_inputs`` (the logical (nx,
    ny) region at the layout's origin either way).

    A field is also a vector of the Krylov solvers (``solvers.krylov``):
    elementwise arithmetic with fields of its layout and with scalars acts
    on the blocks (``torch.zeros_like`` too); ``dot`` is one ``all_reduce``
    of float64 block sums, the same on every rank; ``apply_stencil``
    exchanges halos. Ranks that hold the same block (an axis no mesh axis
    splits) are replicas: one of them adds its block to a sum. ``level``
    is the hierarchy's level-0 ``blocks.Block`` of a ``shard_inputs``
    field whose level is split (its stencil and unknowns), else None."""

    block: torch.Tensor
    sharding: mesh_mod.BlockSharding
    grid: object
    level: Optional[bk.Block] = None

    def gather(self) -> torch.Tensor:
        """The global (nx, ny) field, on every rank (``all_gather`` along
        each split axis). A periodic axis's layout holds its unique nodes:
        the duplicates come back zero, for the level's sync."""
        x = self.block
        for dim, entry in enumerate(self.sharding.spec):
            for name in reversed(bk.axis_names(entry)):
                x = self.sharding.mesh.all_gather(x, name, dim)
        return bk.from_layout(x, self.grid)

    # -- the field as a vector ------------------------------------------------

    @property
    def dtype(self) -> torch.dtype:
        return self.block.dtype

    @property
    def device(self) -> torch.device:
        return self.block.device

    def like(self, block: torch.Tensor) -> "ShardedField":
        """A field of this layout holding ``block``."""
        return dataclasses.replace(self, block=block)

    def clone(self) -> "ShardedField":
        return self.like(self.block.clone())

    def to(self, *args, **kwargs) -> "ShardedField":
        return self.like(self.block.to(*args, **kwargs))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) not in _BLOCKWISE:
            raise TypeError(f"{getattr(func, '__name__', func)} does not act "
                            "block by block on a ShardedField")
        return _blockwise(func, args, kwargs or {})

    def __add__(self, other):
        return _blockwise(torch.add, (self, other), {})

    def __sub__(self, other):
        return _blockwise(torch.sub, (self, other), {})

    def __mul__(self, other):
        return _blockwise(torch.mul, (self, other), {})

    def __truediv__(self, other):
        return _blockwise(torch.div, (self, other), {})

    def dot(self, other: "ShardedField") -> torch.Tensor:
        """sum(self * other) in float64 over the whole field: the blocks'
        sums added by one ``all_reduce``, the same 0-d tensor on every
        rank."""
        s = torch.sum(self.block.to(torch.float64)
                      * other.block.to(torch.float64))
        if not bk.primary(self.sharding.mesh, [bk.axis_names(e) for e in
                                               self.sharding.spec]):
            s = torch.zeros_like(s)
        return self.sharding.mesh.psum(s)

    def apply_stencil(self, stencil, unknown) -> "ShardedField":
        """where(unknown, A x, 0) of this field (``krylov.stencil_matvec``;
        ``stencil`` and ``unknown`` are the global level-0 ones): on the
        level-0 block of its hierarchy (its own stencil and unknowns, or
        ``stencil``'s cut to the block) after a one-node halo exchange, in
        ``ops.stencil.apply``'s operations; a field holding the whole
        level (nothing split) takes the plain operator."""
        blk = self.level
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        if blk is None:
            if tuple(self.block.shape) != tuple(self.grid.shape):
                raise ValueError("the operator takes a field in a "
                                 "hierarchy's layout: make it with "
                                 "distributed.shard_inputs")
            return self.like(torch.where(unknown, st_mod.apply(
                stencil, self.block), zero))
        lev = blk.lev
        st = (blk.st if stencil is lev.stencil else bk.block_stencil(
            stencil, lev.grid, blk.extent, blk.slices))
        known = (blk.unknown if unknown is lev.unknown else bk.to_layout(
            unknown, lev.grid, blk.extent)[blk.slices])
        uh = bk.with_halo(self.sharding.mesh, self.block, blk.names,
                          lev.spec.wrap)
        return self.like(torch.where(
            known, st.c * self.block - bk.nbsum_ext(st, uh), zero))


def make_sharded_field(mesh: mesh_mod.Mesh, grid,
                       fn: Optional[Callable[[np.ndarray, np.ndarray],
                                             np.ndarray]], *,
                       dtype=torch.float64, min_points_per_device: int = 16,
                       device=None) -> ShardedField:
    """A level-0 field sharded over ``mesh`` (``grid_sharding``) without
    any rank building the global array: ``fn(X, Y)`` is evaluated on this
    rank's block of coordinates only; nodes past the logical region are 0.
    ``fn=None`` gives zeros. The block lies on ``device``, by default this
    rank's card (the current CUDA device, which ``initialize_distributed``
    sets from ``LOCAL_RANK``); without a card that raises, and a CPU
    (gloo) caller passes ``device="cpu"``."""
    device = resolve_device(device)
    sharding = mesh_mod.grid_sharding(mesh, grid, min_points_per_device)
    extent = mesh_mod.block_extent(grid.nx, grid.ny)
    xs, ys = sharding.block_slices(extent)
    ix, iy = np.arange(xs.start, xs.stop), np.arange(ys.start, ys.stop)
    block = np.zeros((len(ix), len(iy)))
    if fn is not None:
        x0, _, y0, _ = grid.domain
        X, Y = np.meshgrid(x0 + grid.hx * ix, y0 + grid.hy * iy,
                           indexing="ij")
        inside = (ix < grid.nx)[:, None] & (iy < grid.ny)[None, :]
        block = np.where(inside, np.asarray(fn(X, Y), np.float64), 0.0)
    return ShardedField(torch.from_numpy(block).to(device=device,
                                                   dtype=dtype),
                        sharding, grid)


def process_summary() -> dict:
    """This rank's record for launch logs."""
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": torch.cuda.device_count(),
        "global_devices": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
    }
