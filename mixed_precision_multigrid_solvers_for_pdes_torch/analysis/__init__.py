"""Post-hoc and live convergence analysis."""

from .convergence import (  # noqa: F401
    ConvergenceAnalyzer,
    ConvergenceMonitor,
    ConvergenceReport,
)
