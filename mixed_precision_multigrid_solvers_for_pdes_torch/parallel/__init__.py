"""Explicit distribution over ``torch.distributed``: meshes of ranks, the
halo-exchange multigrid solve, and multi-process launch (the counterpart of
the JAX package's ``parallel`` package but for its GSPMD ``distributed``
module, which is not ported yet)."""

from . import halo_solve, mesh, multihost  # noqa: F401
from .halo_solve import global_residual_norm, shard_smooth  # noqa: F401
from .mesh import (  # noqa: F401
    choose_mesh_shape,
    graded_sharding,
    grid_sharding,
    make_graded_mesh,
    make_mesh,
    replicated,
)
