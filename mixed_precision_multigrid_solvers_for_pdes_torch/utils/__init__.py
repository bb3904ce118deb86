"""Utilities: config tree, logging, timing/benchmark helpers, checkpoints."""

from . import checkpoint, timing  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from .config import (  # noqa: F401
    FrameworkConfig,
    GridConfig,
    LoggingConfig,
    PrecisionConfig,
    SolverConfig,
    TimeSteppingConfig,
    create_accuracy_config,
    create_default_config,
    create_performance_config,
)
from .logging_utils import (  # noqa: F401
    LoggingContext,
    ProgressLogger,
    get_logger,
    log_function_call,
    setup_logging,
)
from .timing import (  # noqa: F401
    PerformanceProfiler,
    Timer,
    benchmark_function,
    trace_profile,
)
