"""Preconditioners for the Krylov solvers (``solvers/krylov.py``).

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/
preconditioning``: each preconditioner is a callable z = M(r) on (nx, ny)
(or 3D) tensors, built from a stencil and its unknowns. ILU is a host NumPy
path, kept for parity; the device-native choices are the diagonal, line,
Chebyshev and multigrid preconditioners.
"""

from .base import (  # noqa: F401
    AdaptivePreconditioner,
    composite,
    identity,
)
from .chebyshev import chebyshev  # noqa: F401
from .diagonal import block_line, diagonal, scaled_diagonal  # noqa: F401
from .ilu import ILUKPreconditioner, ILUPreconditioner  # noqa: F401
from .multigrid_preconditioner import (  # noqa: F401
    multigrid_preconditioner,
    multigrid_preconditioner3d,
)
