"""Trace one cell's solves with the port's spans on and off, in turns, and
print the span readings of each traced window as one JSON line:

    python3 mgbench/trace_spans.py --workload poisson3d-513-ir \
        --seed 7 --solves 40 --turns 2 [--out spans.jsonl]

Each window runs ``--solves`` solves of the cell's traffic under
``torch.profiler``, each marked by the harness's ``mgbench.solve`` span
and synchronised before and after, as ``harness/runner.py``'s traced
window does. The windows alternate spans on, off, off, on, ... so that the
spans' cost when on is the difference of the windows' seconds per solve.
A line holds the window's seconds, the readings of ``harness/spans.py``,
the readings of ``harness/trace.py`` on the same operations (the device
track's span shadows left out), the port's readback counter over the
window, and the host's synchronising runtime calls inside ``mg.solve`` by
the span and operator that made them.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from mgbench.harness import runner, spans, spec, trace, traffic  # noqa: E402

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync", "cudaEventSynchronize")


def sync_sites(prof, port_spans, device_ops):
    """{"<innermost mg span> | <operator> | <runtime call> | <its device
    operation>": count} of the runtime calls that can wait for the card
    (``SYNC_CALLS``), made while an ``mg.solve`` span was open."""
    from torch.autograd import DeviceType

    op_of = {corr: name for name, _, _, corr in device_ops}
    calls = [ev for ev in prof.events()
             if ev.device_type == DeviceType.CPU and ev.name in SYNC_CALLS]
    solve_spans = [sp for sp in port_spans if sp[0] == spans.SOLVE]
    starts = [float(ev.time_range.start) for ev in calls]
    in_solve = trace.host_at(solve_spans, starts)
    inner = trace.host_at(port_spans, starts)
    sites = collections.Counter()
    for ev, solve, lab in zip(calls, in_solve, inner):
        if solve:
            op = ev.cpu_parent.name if ev.cpu_parent is not None else "-"
            sites[f"{lab} | {op} | {ev.name} | "
                  f"{op_of.get(ev.id, '-')[:40]}"] += 1
    return dict(sites)


def start_rule_misses(device_ops, launches, port_spans, solve_spans):
    """Where ``harness/trace.py``'s rule (an operation belongs to the solve
    whose span holds its device start) and the launch disagree: the
    operations launched inside ``mg.solve`` that start outside every solve
    span, and those launched outside ``mg.solve`` that start inside one,
    each as [count, device ms]; and the quantiles of device start minus
    host launch (a negative value is a clock offset between the two)."""
    starts = [s for s, _ in solve_spans]
    ops = [op for op in device_ops if op[3] in launches]
    in_port = trace.host_at([sp for sp in port_spans if sp[0] == spans.SOLVE],
                            [launches[op[3]] for op in ops])
    out, into = [0, 0.0], [0, 0.0]
    for (_, s, e, _), launched_in in zip(ops, in_port):
        i = bisect.bisect_right(starts, s) - 1
        by_start = i >= 0 and s <= solve_spans[i][1]
        if launched_in and not by_start:
            out[0] += 1
            out[1] += (e - s) / 1e3
        elif by_start and not launched_in:
            into[0] += 1
            into[1] += (e - s) / 1e3
    lags = sorted(op[1] - launches[op[3]] for op in ops)
    q = {f"p{p:02d}": lags[min(len(lags) - 1, len(lags) * p // 100)]
         for p in (0, 1, 50)} if lags else {}
    return {"launched_in_started_out": out, "launched_out_started_in": into,
            "launch_to_start_us": q}


def window(cell, conf, mix, draws, solves, device, kernel_map, timing,
           outer_iterate, on):
    from torch.profiler import ProfilerActivity, profile

    record = torch.profiler.record_function
    previous = timing.set_tracing(on)
    iterations = []
    readbacks = outer_iterate.readbacks
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(solves):
                k, amp = next(draws)
                with record(trace.RHS_SPAN):
                    f = runner.rhs(conf, k, amp, device)
                runner.sync(device)
                with record(trace.SOLVE_SPAN):
                    u, info = cell.solve(f)
                    runner.sync(device)
                iterations.append(info["iterations"])
                del u, f
            window_s = time.perf_counter() - t0
    finally:
        timing.set_tracing(previous)
    readbacks = outer_iterate.readbacks - readbacks
    device_ops, launches, port_spans, solve_spans = spans.from_profiler(prof)
    red = trace.reduce([op[:3] for op in device_ops], [], solve_spans,
                       window_s, kernel_map)
    sred = spans.reduce(device_ops, launches, port_spans, solve_spans,
                        kernel_map)
    mean_it = sum(iterations) / len(iterations)
    peaks = (spec.load_json(spec.BENCH_DIR / "peaks.json").get(
        torch.cuda.get_device_name(device)) if device.type == "cuda"
        else None)
    n = red.solves
    line = {
        "spans_on": on, "solves": n, "window_s": window_s,
        "s_per_solve": window_s / n, "solver_iterations": mean_it,
        "host_syncs_per_solve": readbacks / n,
        "span_counts": dict(collections.Counter(s[0] for s in port_spans)),
        "plain_ops_device_ms": red.plain_seconds / n * 1e3,
        "device_ops_per_solve": red.ops_in_solves / n,
        "device_idle_share": (1.0 - red.busy_s / window_s) * 100.0,
        "idle_in_solves_ms": sred.idle_in_solves_s / n * 1e3,
        "idle_by_span_ms": {str(k): v / n * 1e3
                            for k, v in sred.idle_by_span.items()},
        "unlaunched_ops_in_solves": sred.unlaunched,
        "unlaunched_names": dict(collections.Counter(
            name[:60] for name, _, _, corr in device_ops
            if corr not in launches).most_common(5)),
        "device_ops_launched": len(launches),
        **spans.readings(sred, conf, mean_it, peaks),
        "host_self_ms": {k: v / n * 1e3
                         for k, v in sred.host_self_s.items()},
        "sync_sites": sync_sites(prof, port_spans, device_ops),
        "start_rule": start_rule_misses(device_ops, launches, port_spans,
                                        sorted(solve_spans)),
    }
    if line["outer_step_device_ms"] is not None:
        line["identity_plain_ms"] = (line["outer_step_device_ms"]
                                     + line["cycle_plain_device_ms"]
                                     - line["plain_ops_device_ms"])
    return line


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--solves", type=int, default=40)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_spans: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    _, conf, mix = spec.cell_files(spec.benchmark(), args.workload)
    port = runner.port_module()
    spec.resolve(port, "ops.cuda_kernels._build").library()
    timing = spec.resolve(port, "utils.timing")
    outer_iterate = spec.resolve(port, "solvers.multigrid.outer_iterate")
    cell = runner.system_under_test(port, conf, mix, device)
    warm = traffic.draws(mix, conf["dims"], args.seed, traffic.WARMUP)
    for _ in range(mix["warmup"]):
        k, amp = next(warm)
        cell.solve(runner.rhs(conf, k, amp, device))
    runner.sync(device)
    draws = traffic.draws(mix, conf["dims"], args.seed, traffic.WINDOW)
    kernel_map = spec.KernelMap(spec.kernels())
    card = runner.card_line()
    out = open(args.out, "a") if args.out else None
    try:
        for turn in range(args.turns):
            for on in ((True, False) if turn % 2 == 0 else (False, True)):
                line = window(cell, conf, mix, draws, args.solves, device,
                              kernel_map, timing, outer_iterate, on)
                line.update(workload=args.workload, seed=args.seed,
                            turn=turn, card=card)
                text = json.dumps(line)
                print(text, flush=True)
                if out:
                    out.write(text + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
