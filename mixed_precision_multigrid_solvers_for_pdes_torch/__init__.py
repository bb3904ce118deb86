"""PyTorch/CUDA port of the mixed-precision geometric multigrid solvers.

A second package beside the JAX reference
``mixed_precision_multigrid_solvers_for_pdes_tpu``, which it is tested
against. Plain tensor code is PyTorch; the hot operations of the 2D
constant-coefficient, variable-coefficient and Neumann/Robin paths and of
the 3D constant-coefficient Dirichlet path run in hand-written CUDA kernels
for Hopper (``csrc/``, built with nvcc at first use, see
``ops/cuda_kernels/_build.py``); every kernel but K takes bf16 storage
too, so the mixed, bf16 and adaptive precisions run on them in 2D and 3D.
Galerkin coarsening (``coarsening='galerkin'``, 9-point coarse levels on
the plain path), the Krylov solvers (``solvers.krylov``) and their
preconditioners (``preconditioning``) run on top of the same cycles, and
so do the heat equations' implicit steps in 2D and 3D
(``applications.heat``, ``applications.heat3d``, shifted-operator V-cycles
per step, with checkpoint/resume through ``utils.CheckpointManager``). The
whole 2D solve also runs over a mesh of ranks with explicit halos
(``parallel.halo_solve`` over ``torch.distributed``: gloo on the CPU,
NCCL on cards), and so do the 2D entry points (``parallel.distributed``:
``sharded_solve``, ``solve_poisson(mesh=)``, ``constrain=``). Fields are
stored at their logical shape (nx, ny) or (nx, ny, nz), and every function
takes its dtype and device explicitly. This package never imports JAX.
"""

__version__ = "0.1.0"

from . import applications, core, models, ops, parallel, solvers, utils  # noqa: F401
from . import preconditioning  # noqa: F401
from .applications.poisson import (  # noqa: F401
    PoissonResult,
    convergence_study,
    solve_poisson,
)
from .applications.precision_analysis import (  # noqa: F401
    MixedPrecisionAnalyzer,
    autotune,
)
from .applications.poisson3d import (  # noqa: F401
    convergence_study3d,
    solve_poisson3d,
)
from .applications.heat import (  # noqa: F401
    HeatConfig,
    HeatProblem,
    HeatResult,
    heat_problem_from_callables,
    solve_heat,
)
from .applications.heat3d import HeatProblem3D, solve_heat3d  # noqa: F401
from .core.grid import Grid  # noqa: F401
from .core.grid3d import Grid3D  # noqa: F401
from .core.domain import LShapedDomain  # noqa: F401
from .core.precision import (  # noqa: F401
    Precision,
    PrecisionPolicy,
    as_dtype,
    policy,
)
from .models.problems import (  # noqa: F401
    CATALOGUE,
    Problem,
    boundary_layer_problem,
    corner_singularity_problem,
    helmholtz_mms,
    jump_coefficient_problem,
    l_shaped_problem,
    mixed_segment_mms,
    mixed_segment_problem,
    neumann_test_problem,
    periodic_helmholtz_mms,
    poisson_mms_anisotropic,
    poisson_mms_exponential,
    poisson_mms_high_frequency,
    poisson_mms_inhomogeneous,
    poisson_mms_polynomial,
    poisson_mms_sinsin,
    robin_test_problem,
    variable_coefficient_mms,
)
from .models.problems3d import (  # noqa: F401
    CATALOGUE3D,
    Problem3D,
    anisotropic3d_z,
    helmholtz3d_mms,
    jump_coefficient3d,
    neumann3d_test,
    periodic3d_helmholtz,
    poisson3d_mms_polynomial,
    poisson3d_mms_sinsinsin,
    varcoef3d_mms,
)
from .solvers.multigrid import (  # noqa: F401
    Level,
    MultigridConfig,
    build_hierarchy,
    fmg,
    mg_cycle,
    mg_solve,
)
from .solvers.multigrid3d import (  # noqa: F401
    Level3D,
    build_hierarchy3d,
    ir_solve3d,
    mg_cycle3d,
    mg_solve3d,
)
from .solvers.plane_solve import plane_ir_solve  # noqa: F401
from .solvers.refinement import (  # noqa: F401
    adaptive_solve,
    adaptive_solve3d,
    ir_solve,
)
from .utils.checkpoint import CheckpointManager  # noqa: F401
