"""Timers and benchmarking helpers, synchronized with the card.

Counterpart of ``Timer``, ``PerformanceProfiler``, ``benchmark_function``
and ``trace_profile`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/utils/timing.py``. CUDA
launches return before the card has finished, so every measured region
ends by waiting for the card on every CUDA tensor the measured call
returned, found anywhere in tuples, lists, dicts or a ``.u`` attribute, as
``jax.block_until_ready`` waits on every leaf of a pytree. The warm-up
calls (the kernels' build at first use included) are not timed.

The solve path's spans (``span``, ``spanned``) mark its layers in a
``torch.profiler`` trace while tracing is on (``set_tracing``, or a
``trace_profile`` block): ``mg.solve`` around each call of ``mg_solve``,
``mg_solve3d``, ``ir_solve`` and ``ir_solve3d``; ``mg.outer`` around each
outer step and ``mg.readback`` around each read of its norm in
``solvers/multigrid.outer_iterate``; ``mg.cycle`` around each top-level
``mg_cycle``/``mg_cycle3d``; ``mg.fmg`` around ``fmg``. Each is a
``record_function``, so it shares the profiler's clock with the card's
operations. Tracing is off by default, and then a span costs one test of a
module flag.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List

import numpy as np
import torch


def _tensors(result: Any) -> Iterator[torch.Tensor]:
    """Every tensor inside ``result``: itself, the items of a tuple, list
    or dict, and an object's ``u`` (a ``PoissonResult``, a ``HeatResult``),
    searched to any depth."""
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (tuple, list)):
        for x in result:
            yield from _tensors(x)
    elif isinstance(result, dict):
        for x in result.values():
            yield from _tensors(x)
    elif hasattr(result, "u"):
        yield from _tensors(result.u)


def _sync(result: Any) -> None:
    """Wait for every card that holds a tensor of ``result``."""
    for dev in {t.device for t in _tensors(result) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class Timer:
    """Context-managed wall timer; at exit it waits for the card on the
    tensors of ``sync`` (any value ``_tensors`` searches) when given."""

    def __init__(self, name: str = "", sync: Any = None):
        self.name = name
        self.sync = sync
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            _sync(self.sync)
        self.elapsed = time.perf_counter() - self.t0
        return False


@dataclasses.dataclass
class OpStats:
    count: int = 0
    total: float = 0.0
    best: float = float("inf")
    worst: float = 0.0

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class PerformanceProfiler:
    """Named-region accumulator of wall times."""

    def __init__(self):
        self._stats: Dict[str, OpStats] = defaultdict(OpStats)
        self._open: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def end(self, name: str, sync: Any = None) -> float:
        if sync is not None:
            _sync(sync)
        dt = time.perf_counter() - self._open.pop(name)
        s = self._stats[name]
        s.count += 1
        s.total += dt
        s.best = min(s.best, dt)
        s.worst = max(s.worst, dt)
        return dt

    def region(self, name: str):
        profiler = self

        class _Region:
            def __enter__(self):
                profiler.start(name)
                return self

            def __exit__(self, *exc):
                profiler.end(name)
                return False

        return _Region()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"count": s.count, "total_s": s.total, "mean_s": s.mean,
                "best_s": s.best, "worst_s": s.worst}
            for k, s in sorted(self._stats.items(), key=lambda kv: -kv[1].total)
        }


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


_tracing = False
_OFF = contextlib.nullcontext()


def set_tracing(on: bool) -> bool:
    """Turn the solve path's spans on or off; returns the previous
    setting."""
    global _tracing
    previous, _tracing = _tracing, bool(on)
    return previous


def span(name: str):
    """A context manager that records ``name`` as a
    ``torch.profiler.record_function`` while tracing is on, and does
    nothing while it is off."""
    if not _tracing:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def trace_profile(path: str = "torch_trace.json"):
    """``torch.profiler`` trace of the block, host operations and, where a
    card is present, its kernels (the hand-written ones launched through
    ctypes included), with the solve path's ``mg.*`` spans on for the
    block; the Chrome trace is written to the file ``path`` (open it in
    Perfetto or chrome://tracing) when the block ends. Yields the profiler,
    whose ``key_averages()`` sum the time by operation."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    previous = set_tracing(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        set_tracing(previous)
    prof.export_chrome_trace(str(path))
