"""Reduce a profiler trace of the window to per-solve readings.

The runner synchronises the card before each solve and after it, and marks
each solve with a ``mgbench.solve`` span, so every device operation that a
solve issued starts inside that solve's span, and the right-hand side's
operations lie before it. The reduction works on plain tuples, so that it
can be tested without a card:

- ``device``: (name, start_us, end_us) of every operation that ran on the
  card (kernels, copies, fills);
- ``host``: (name, start_us, end_us) of the host thread's events (aten
  operators, CUDA runtime calls and the runner's spans);
- ``solves``: (start_us, end_us) of each solve's span.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]
SOLVE_SPAN = "mgbench.solve"
RHS_SPAN = "mgbench.rhs"
TOP = 10


def merge(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(device: Sequence[Interval]) -> float:
    return sum(e - s for s, e in merge([(s, e) for _, s, e in device]))


def gaps(device: Sequence[Interval], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """Idle intervals of the card inside [start, end]."""
    out, t = [], start
    for s, e in merge([(s, e) for _, s, e in device]):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def host_at(host: Sequence[Interval], times: Sequence[float]
            ) -> List[Optional[str]]:
    """For each time, the innermost host event running then (the one that
    started last among those that cover it), or None. The host thread's
    events nest, so a stack swept through time finds it."""
    events = sorted(host, key=lambda ev: (ev[1], -ev[2]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out: List[Optional[str]] = [None] * len(times)
    stack: List[Interval] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(events) and events[j][1] <= t:
            while stack and stack[-1][2] < events[j][1]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


@dataclasses.dataclass
class Reduced:
    """What the per-layer readers read from a traced window."""

    solves: int
    window_s: float
    busy_s: float
    ops_in_solves: int = 0
    seconds_by_stage: Dict[str, float] = dataclasses.field(
        default_factory=dict)   # stage -> device s in solves
    plain_seconds: float = 0.0  # device s in solves of unmatched ops
    unmatched: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)   # top operations by device s
    idle_gaps: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)   # top idle seconds by host activity


def reduce(device: Sequence[Interval], host: Sequence[Interval],
           solves: Sequence[Tuple[float, float]], window_s: float,
           kernel_map) -> Reduced:
    """The per-solve readings of a traced window. ``kernel_map`` maps an
    operation name to its kernel file (``spec.KernelMap``) or None."""
    spans = sorted(solves)
    starts = [s for s, _ in spans]
    red = Reduced(solves=len(spans), window_s=window_s,
                  busy_s=busy_us(device) / 1e6)
    by_label: Dict[str, float] = collections.defaultdict(float)
    by_stage: Dict[str, float] = collections.defaultdict(float)
    unmatched: Dict[str, int] = collections.Counter()
    for name, s, e in device:
        k = kernel_map(name)
        label = k.name if k is not None else name[:120]
        by_label[label] += (e - s) / 1e6
        i = bisect.bisect_right(starts, s) - 1
        in_solve = i >= 0 and s <= spans[i][1]
        if k is None:
            unmatched[name] += 1
        if not in_solve:
            continue
        red.ops_in_solves += 1
        if k is None:
            red.plain_seconds += (e - s) / 1e6
        else:
            by_stage[k.stage] += (e - s) / 1e6
    red.seconds_by_stage = dict(by_stage)
    red.unmatched = dict(unmatched)
    red.device_ops = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    if spans:
        idle = gaps(device, spans[0][0], spans[-1][1])
        labels = host_at(host, [s for s, _ in idle])
        by_host: Dict[str, float] = collections.defaultdict(float)
        for (s, e), lab in zip(idle, labels):
            if lab is None or lab in (SOLVE_SPAN, RHS_SPAN):
                lab = f"python in {lab}" if lab else "python"
            by_host[lab] += (e - s) / 1e6
        red.idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return red


def from_profiler(prof) -> Tuple[List[Interval], List[Interval],
                                 List[Tuple[float, float]]]:
    """(device, host, solves) tuples from a stopped ``torch.profiler``
    profile: device events by their device type, host events of the thread
    that opened the solve spans."""
    from torch.autograd import DeviceType

    device, host_all, solves = [], [], []
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            if ev.name not in (SOLVE_SPAN, RHS_SPAN):  # no span's shadow
                device.append((ev.name, s, e))
        elif ev.device_type == DeviceType.CPU:
            host_all.append((ev.name, s, e, ev.thread))
            if ev.name == SOLVE_SPAN:
                solves.append((s, e))
    threads = {t for n, _, _, t in host_all if n == SOLVE_SPAN}
    host = [(n, s, e) for n, s, e, t in host_all if t in threads]
    return device, host, solves
