"""Measured benchmarking: solver suites, per-stage profiling, reports, and
the kernels' microbenchmark and witnesses.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/
benchmarking/``. ``BenchmarkSuite`` and ``MultigridProfiler`` run on any
device (the card when None); ``kernel_microbench`` needs a card, and the
witnesses (``bf16_start_witness``, ``mixed3d_witness``) run on the CPU.
"""

from .suite import BenchmarkSuite  # noqa: F401
from .profiler import MultigridProfiler  # noqa: F401
