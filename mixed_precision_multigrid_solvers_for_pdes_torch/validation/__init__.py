"""Validation: MMS convergence studies, theoretical factors, baselines.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/validation/``.
Every path here runs real solves of this package.
"""

from .mms import MMSValidator  # noqa: F401
from .theory import TheoreticalAnalyzer, measure_two_grid_factor  # noqa: F401
from .baselines import PerformanceBaselines  # noqa: F401
