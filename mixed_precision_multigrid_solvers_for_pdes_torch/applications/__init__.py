"""One-call front ends: a problem in, a checked solution out; and the
heat-equation time steppers."""

from .heat import (  # noqa: F401
    HeatConfig,
    HeatProblem,
    HeatResult,
    heat_problem_from_callables,
    solve_heat,
    stability_limit_dt,
)
from . import heat3d, heat_problems, precision_analysis  # noqa: F401
from .precision_analysis import MixedPrecisionAnalyzer  # noqa: F401
from .heat3d import HeatProblem3D, solve_heat3d  # noqa: F401
from .poisson import (  # noqa: F401
    PoissonResult,
    convergence_study,
    solve_poisson,
)
from . import poisson, poisson3d  # noqa: F401
from .poisson3d import solve_poisson3d  # noqa: F401
