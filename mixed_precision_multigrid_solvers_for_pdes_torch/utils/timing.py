"""Wall-clock timing of a callable, synchronized with the card.

Counterpart of ``benchmark_function`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/utils/timing.py``, which
``applications/precision_analysis.autotune`` needs. The rest of the JAX
package's ``utils/`` is ROADMAP item 15.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch


def _sync(result: Any) -> None:
    """Wait for the card when ``result`` (a tensor, or an object whose
    ``u`` is one) lies on it."""
    t = getattr(result, "u", result)
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def benchmark_function(fn: Callable, *args, warmup: int = 1, runs: int = 5,
                       **kwargs) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)`` over ``runs`` calls after ``warmup``
    calls, each timed to the end of its device work."""
    for _ in range(max(warmup, 0)):
        _sync(fn(*args, **kwargs))
    times: List[float] = []
    for _ in range(runs):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "mean_s": float(arr.mean()),
        "std_s": float(arr.std()),
        "min_s": float(arr.min()),
        "max_s": float(arr.max()),
        "runs": runs,
    }
