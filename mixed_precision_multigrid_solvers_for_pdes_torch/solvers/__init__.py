"""Multigrid cycles, mixed-precision iterative refinement, Krylov solvers
and the stand-alone iterative solvers."""

from . import multigrid, multigrid3d, plane_solve, refinement  # noqa: F401
from . import iterative, krylov  # noqa: F401
from .iterative import iterative_solve  # noqa: F401
from .krylov import bicgstab, gmres, pcg, stencil_matvec  # noqa: F401
from .plane_solve import plane_ir_solve  # noqa: F401
from .refinement import ir_solve  # noqa: F401
