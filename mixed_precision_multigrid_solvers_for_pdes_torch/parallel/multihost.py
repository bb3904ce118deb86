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
from . import mesh as mesh_mod


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


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedField:
    """This rank's ``block`` of a level-0 field on ``grid``, laid out over
    the block extent (the logical (nx, ny) region at its origin) under
    ``sharding``."""

    block: torch.Tensor
    sharding: mesh_mod.BlockSharding
    grid: object

    def gather(self) -> torch.Tensor:
        """The global (nx, ny) field, on every rank (``all_gather`` along
        each split axis)."""
        x = self.block
        for dim, name in enumerate(self.sharding.spec):
            if name is not None:
                x = self.sharding.mesh.all_gather(x, name, dim)
        return x[:self.grid.nx, :self.grid.ny].contiguous()


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
