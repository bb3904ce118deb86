"""Put a traced window's device time and idle time down to the port's own
spans (``mg.*``: ``utils/timing.py`` in the port says where each sits).

Works on plain tuples, as ``trace.py`` does, so that it can be tested
without a card:

- ``device``: (name, start_us, end_us, correlation) of every operation that
  ran on the card;
- ``launches``: {correlation: start_us} of the host's runtime calls
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), which share their
  operation's correlation id;
- ``spans``: (name, start_us, end_us) of the port's spans on the host
  thread that ran the solves;
- ``solves``: (start_us, end_us) of the harness's solve spans.

Each device operation is put down to the innermost span that was open on
the host when the runtime call that launched it began, found by the
correlation id and not by the operation's own start: the host runs ahead of
the card, so an operation may run after its span has closed. Each idle gap
of the card inside a solve span is put down to the innermost span open on
the host at the gap's start.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace

Op = Tuple[str, float, float, int]
SOLVE, OUTER, READBACK = "mg.solve", "mg.outer", "mg.readback"
CYCLE, FMG = "mg.cycle", "mg.fmg"
CYCLES = (CYCLE, FMG)
OUTSIDE_CYCLES = (SOLVE, OUTER, READBACK)


@dataclasses.dataclass
class SpanReduced:
    """What the span readers read from a traced window."""

    solves: int
    outer_step_s: float = 0.0   # device s launched in mg.solve, no cycle
    cycle_plain_s: float = 0.0  # device s of unmatched ops launched in cycles
    unlaunched: int = 0         # operations in solves with no launch record
    idle_in_solves_s: float = 0.0
    idle_by_span: Dict[Optional[str], float] = dataclasses.field(
        default_factory=dict)   # innermost span at a gap's start -> idle s
    host_issue_s: float = 0.0   # mg.solve s outside mg.readback
    host_self_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)   # span -> host s in it outside its children


def _inside(intervals: Sequence[Tuple[float, float]],
            pieces: Sequence[Tuple[float, float]]
            ) -> List[Tuple[float, float]]:
    """The parts of ``pieces`` (sorted, disjoint) that lie inside
    ``intervals`` (sorted, disjoint)."""
    out, j = [], 0
    for s, e in pieces:
        while j < len(intervals) and intervals[j][1] <= s:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < e:
            lo, hi = max(s, intervals[k][0]), min(e, intervals[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out


def reduce(device: Sequence[Op], launches: Dict[int, float],
           spans: Sequence[trace.Interval],
           solves: Sequence[Tuple[float, float]], kernel_map) -> SpanReduced:
    """The span readings of a traced window. ``kernel_map`` maps an
    operation name to its kernel file (``spec.KernelMap``) or None."""
    solves = sorted(solves)
    red = SpanReduced(solves=len(solves))
    starts = [s for s, _ in solves]
    in_solve = []
    for _, s, _, _ in device:
        i = bisect.bisect_right(starts, s) - 1
        in_solve.append(i >= 0 and s <= solves[i][1])
    launched = [launches.get(corr) for _, _, _, corr in device]
    known = [i for i, t in enumerate(launched) if t is not None]
    red.unlaunched = sum(1 for i, t in enumerate(launched)
                         if t is None and in_solve[i])
    times = [launched[i] for i in known]
    solve_spans = [sp for sp in spans if sp[0] == SOLVE]
    for i, lab, solve in zip(known, trace.host_at(spans, times),
                             trace.host_at(solve_spans, times)):
        name, s, e, _ = device[i]
        if lab in OUTSIDE_CYCLES and solve:
            red.outer_step_s += (e - s) / 1e6
        elif lab in CYCLES and kernel_map(name) is None:
            red.cycle_plain_s += (e - s) / 1e6
    if solves:
        idle = _inside(solves, trace.gaps([op[:3] for op in device],
                                          solves[0][0], solves[-1][1]))
        by_span: Dict[Optional[str], float] = collections.defaultdict(float)
        for (s, e), lab in zip(idle, trace.host_at(spans,
                                                    [s for s, _ in idle])):
            by_span[lab] += (e - s) / 1e6
            red.idle_in_solves_s += (e - s) / 1e6
        red.idle_by_span = dict(by_span)
    red.host_self_s = self_seconds(spans)
    readbacks = [sp for sp in spans if sp[0] == READBACK]
    in_port_solve = trace.host_at(solve_spans, [s for _, s, _ in readbacks])
    red.host_issue_s = (sum(e - s for _, s, e in solve_spans)
                        - sum(e - s for (_, s, e), lab in
                              zip(readbacks, in_port_solve) if lab)) / 1e6
    return red


def self_seconds(spans: Sequence[trace.Interval]) -> Dict[str, float]:
    """{span name: host s inside its spans and outside their child spans}
    of nested spans."""
    out: Dict[str, float] = collections.defaultdict(float)
    stack: List[trace.Interval] = []
    for name, s, e in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        while stack and stack[-1][2] <= s:
            stack.pop()
        out[name] += (e - s) / 1e6
        if stack:
            out[stack[-1][0]] -= (e - s) / 1e6
        stack.append((name, s, e))
    return dict(out)


def outer_step_bytes(conf: Dict, iterations: float) -> float:
    """Compulsory bytes of a solve's fp64 outer steps: per level-0 node,
    each step reads f (8) and the correction (the level dtype's size),
    reads and writes u (16) and writes the low-precision residual (the
    level dtype's size); the start reads f and u0 (16) and writes the
    low-precision residual."""
    import torch

    lo = getattr(torch, conf["level_dtype"]).itemsize
    nodes = float(conf["n"]) ** conf["dims"]
    return nodes * ((16 + lo) + (8 + 16 + 2 * lo) * iterations)


def readings(red: SpanReduced, conf: Dict, iterations: float,
             peaks: Optional[Dict]) -> Dict[str, Optional[float]]:
    """The per-solve span readings by metric name; None where the window
    gives nothing to read (no solve, or no ``mg.solve`` span: a port
    without spans, or with tracing off)."""
    names = ("outer_step_device_ms", "outer_step_roofline",
             "cycle_plain_device_ms", "host_issue_ms", "cycle_idle_ms",
             "outer_idle_ms")
    if not red.solves or red.host_issue_s <= 0.0:
        return dict.fromkeys(names)
    per = 1e3 / red.solves
    roofline = None
    if peaks and red.outer_step_s > 0.0:
        bound_s = outer_step_bytes(conf, iterations) / peaks[
            "hbm_bytes_per_s"]
        roofline = bound_s / (red.outer_step_s / red.solves) * 100.0
    idle = red.idle_by_span
    return {
        "outer_step_device_ms": red.outer_step_s * per,
        "outer_step_roofline": roofline,
        "cycle_plain_device_ms": red.cycle_plain_s * per,
        "host_issue_ms": red.host_issue_s * per,
        "cycle_idle_ms": sum(idle.get(k, 0.0) for k in CYCLES) * per,
        "outer_idle_ms": sum(idle.get(k, 0.0)
                             for k in OUTSIDE_CYCLES) * per,
    }


def from_profiler(prof) -> Tuple[List[Op], Dict[int, float],
                                 List[trace.Interval],
                                 List[Tuple[float, float]]]:
    """(device, launches, spans, solves) from a stopped ``torch.profiler``
    profile. The device track's shadows of the host's spans (the port's
    ``mg.*`` and the harness's ``mgbench.*``) are no operations and are
    left out."""
    from torch.autograd import DeviceType

    device, launches, host, solves = [], {}, [], []
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            if not (ev.name.startswith(("mg.", "mgbench."))
                    or getattr(ev, "is_user_annotation", False)):
                device.append((ev.name, s, e, ev.id))
        elif ev.device_type == DeviceType.CPU:
            if ev.name.startswith("cu"):  # a CUDA API call (cudaLaunchKernel)
                launches[ev.id] = s
            elif ev.name.startswith("mg."):
                host.append((ev.name, s, e, ev.thread))
            elif ev.name == trace.SOLVE_SPAN:
                solves.append((s, e, ev.thread))
    threads = {t for _, _, t in solves}
    spans = [(n, s, e) for n, s, e, t in host if t in threads]
    return device, launches, spans, [(s, e) for s, e, _ in solves]
