"""Multigrid cycles and mixed-precision iterative refinement."""

from . import multigrid, multigrid3d, refinement  # noqa: F401
from .refinement import ir_solve  # noqa: F401
