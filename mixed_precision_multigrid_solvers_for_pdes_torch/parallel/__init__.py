"""Distribution over ``torch.distributed``: meshes of ranks, the
explicit halo-exchange multigrid solve (``halo_solve``), the GSPMD path
(``distributed``: ``make_constrainer``, ``shard_inputs``,
``sharded_solve``) on the block machinery both share (``blocks``), and
multi-process launch (the counterpart of the JAX package's ``parallel``
package)."""

from . import blocks, distributed, halo_solve, mesh, multihost  # noqa: F401
from .distributed import (  # noqa: F401
    make_constrainer,
    shard_inputs,
    sharded_solve,
)
from .halo_solve import global_residual_norm, shard_smooth  # noqa: F401
from .mesh import (  # noqa: F401
    choose_mesh_shape,
    graded_sharding,
    grid_sharding,
    make_graded_mesh,
    make_mesh,
    replicated,
)
