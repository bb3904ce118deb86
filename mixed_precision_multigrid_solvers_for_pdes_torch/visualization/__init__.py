"""Visualization suite (matplotlib, headless-safe).

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/
visualization/`` (8 modules): solution surfaces, contours and error maps,
convergence histories, performance comparisons, grid hierarchies and block
layouts, analysis plots, parameter sweeps, and a solver dashboard. Every
figure function returns the Figure and accepts ``save=path``; fields may be
numpy arrays or tensors on any device (moved to the host once). matplotlib
is imported on first use and forced to Agg when no display is present; the
package's top level does not import this subpackage, so it imports where
matplotlib is absent.
"""

from .solution_plots import SolutionVisualizer  # noqa: F401
from .convergence_plots import ConvergencePlotter  # noqa: F401
from .performance_plots import PerformancePlotter  # noqa: F401
from .grid_visualization import GridVisualizer  # noqa: F401
from .analysis_plots import AnalysisVisualizer  # noqa: F401
from .interactive_plots import InteractivePlotter  # noqa: F401
from .dashboard import SolverDashboard  # noqa: F401
