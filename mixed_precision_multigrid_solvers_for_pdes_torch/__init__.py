"""PyTorch/CUDA port of the mixed-precision geometric multigrid solvers.

A second package beside the JAX reference
``mixed_precision_multigrid_solvers_for_pdes_tpu``, which it is tested
against. Plain tensor code is PyTorch; the hot operations of the 2D
constant-coefficient, variable-coefficient and Neumann/Robin paths and of
the 3D constant-coefficient Dirichlet path run in hand-written CUDA kernels
for Hopper (``csrc/``, built with nvcc at first use, see
``ops/cuda_kernels/_build.py``). Fields are stored at their logical shape
(nx, ny) or (nx, ny, nz), and every function takes its dtype and device
explicitly. This package never imports JAX.
"""

__version__ = "0.1.0"

from . import applications, core, models, ops, solvers  # noqa: F401
from .applications.poisson import (  # noqa: F401
    PoissonResult,
    convergence_study,
    solve_poisson,
)
from .applications.poisson3d import solve_poisson3d  # noqa: F401
from .core.grid import Grid  # noqa: F401
from .core.grid3d import Grid3D  # noqa: F401
from .core.precision import Precision, as_dtype  # noqa: F401
from .models.problems import (  # noqa: F401
    Problem,
    jump_coefficient_problem,
    neumann_test_problem,
    poisson_mms_sinsin,
    robin_test_problem,
    variable_coefficient_mms,
)
from .models.problems3d import Problem3D, poisson3d_mms_sinsinsin  # noqa: F401
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
from .solvers.refinement import ir_solve  # noqa: F401
