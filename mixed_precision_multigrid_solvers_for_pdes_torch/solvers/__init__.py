"""Multigrid cycles and mixed-precision iterative refinement."""

from . import multigrid, multigrid3d, plane_solve, refinement  # noqa: F401
from .plane_solve import plane_ir_solve  # noqa: F401
from .refinement import ir_solve  # noqa: F401
