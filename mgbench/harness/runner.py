"""One run of one cell: set-up, the measured window, the check, the result.

The traffic is a closed loop with one caller: each solve gets a fresh
right-hand side, built on the card, and the next is sent when the last has
returned. A solve's latency runs from the call of the mix's entry to the
``torch.cuda.synchronize()`` after it. The window's rate takes every
solve that started in it and all of its time, right-hand sides and the
copies of kept answers included. The mix names the driver
(``drivers/<name>.py``) that sets the system up and makes each call.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import pkgutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, spec, trace as trace_mod, traffic, work

PORT = "mixed_precision_multigrid_solvers_for_pdes_torch"
# Top-level module names that no run may hold once its window has closed:
# JAX and the JAX package beside the port.
FORBIDDEN = ("jax", "jaxlib", "flax",
             "mixed_precision_multigrid_solvers_for_pdes_tpu")
GIB = float(1 << 30)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def port_module():
    if str(spec.ROOT) not in sys.path:
        sys.path.insert(0, str(spec.ROOT))
    return importlib.import_module(PORT)


def launch_counters(port) -> List[Any]:
    """Every kernel wrapper of the port that counts its launches."""
    pkg = importlib.import_module(f"{port.__name__}.ops.cuda_kernels")
    out = []
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for obj in vars(mod).values():
            if callable(obj) and isinstance(getattr(obj, "launches", None),
                                            int):
                if obj not in out:
                    out.append(obj)
    return out


def card_line() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class Ctx:
    """What a per-layer reader reads (``metrics/<name>.py``)."""

    def __init__(self, conf, mix, reduced, iterations, launches, peaks):
        self.conf, self.mix = conf, mix
        self.trace = reduced
        self.iterations = iterations
        self.launches = launches
        self.peaks = peaks

    @property
    def solves(self) -> int:
        return self.trace.solves

    def mean_iterations(self) -> float:
        return float(np.mean(self.iterations))

    def roofline_share(self, stage: str) -> Optional[float]:
        """The stage's compulsory bytes per solve (``work.solve_bytes``)
        over the device time per solve of the kernels mapped to it, at the
        card's HBM bandwidth, in %; None without a reading."""
        seconds = self.trace.seconds_by_stage.get(stage, 0.0)
        if not self.solves or seconds <= 0.0 or not self.peaks:
            return None
        nbytes = work.solve_bytes(self.conf, self.mix,
                                  self.mean_iterations())[stage]
        if nbytes <= 0:
            return None
        bound_s = nbytes / self.peaks["hbm_bytes_per_s"]
        return bound_s / (seconds / self.solves) * 100.0


def system_under_test(port, conf: Dict, mix: Dict, device: torch.device):
    """The mix's driver, set up for ``conf``: its ``solve(f)`` is the
    call that the window makes."""
    return spec.driver(mix["driver"]).setup(port, conf, mix, device)


def rhs(conf: Dict, k, amp, device: torch.device) -> torch.Tensor:
    return traffic.rhs(conf["n"], conf["dims"], k, amp, device)


def run_cell(conf: Dict, mix: Dict, *, seed: int,
             seconds: float, trace: bool, device: torch.device,
             per_layer: List[Dict], end_to_end: List[Dict],
             t_start: float, chips: int = 1) -> Tuple[Dict, List[str]]:
    """One run; returns the result object and the check lines."""
    port = port_module()
    build_s = 0.0
    if device.type == "cuda":
        lib = spec.resolve(port, "ops.cuda_kernels._build").library()
        if lib.built:
            build_s = lib.build_seconds
            print(f"mgbench: built the kernel library in "
                  f"{build_s:.1f} s ({lib.path})", file=sys.stderr)
    cell = system_under_test(port, conf, mix, device)
    dims = conf["dims"]

    warm = traffic.draws(mix, dims, seed, traffic.WARMUP)
    out_dtype = None
    for _ in range(mix["warmup"]):
        k, amp = next(warm)
        u, _ = cell.solve(rhs(conf, k, amp, device))
        out_dtype = u.dtype
        del u
    sync(device)

    points = traffic.sample_points(mix, seed)
    pinned = device.type == "cuda"
    buffers = [torch.empty((conf["n"],) * dims, dtype=out_dtype,
                           pin_memory=pinned) for _ in points]
    kept: List[Tuple[Tuple[int, ...], float]] = []  # (mode, amp)
    counters = launch_counters(port) if trace else []
    for c in counters:
        c.launches = 0
        if hasattr(c, "launches_bf16"):
            c.launches_bf16 = 0
    sync(device)
    setup_s = time.perf_counter() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof_cm = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof_cm = profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
    record = torch.profiler.record_function
    latencies, iterations, converged = [], [], []
    draws = traffic.draws(mix, dims, seed, traffic.WINDOW)
    trace_cap = mix["trace_solves"] if trace else math.inf
    taken = 0  # points of `points` whose answer is kept
    last = None
    with prof_cm as prof:
        t_w0 = time.perf_counter()
        i = 0
        while True:
            k, amp = next(draws)
            with record(trace_mod.RHS_SPAN):
                f = rhs(conf, k, amp, device)
            sync(device)
            t0 = time.perf_counter()
            with record(trace_mod.SOLVE_SPAN):
                u, info = cell.solve(f)
                sync(device)
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            iterations.append(info["iterations"])
            converged.append(bool(info["converged"]))
            i += 1
            # the window's progress: its time, or its solves where a
            # traced window stops at a count
            progress = max((t1 - t_w0) / seconds, i / trace_cap)
            if progress >= 1.0:
                last = (u, f, k)  # judged as the last answer
                break
            if taken < len(points) and progress >= points[taken]:
                buffers[len(kept)].copy_(u)
                kept.append((k, amp))
                while taken < len(points) and progress >= points[taken]:
                    taken += 1
            del u, f
        window_s = time.perf_counter() - t_w0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    launches = sum(c.launches for c in counters)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"mgbench: the run holds {found} once its window "
                         f"has closed; nothing that runs may import JAX or "
                         f"the JAX package")

    attempted = len(latencies)
    failed = sum(not c for c in converged)  # solves that did not converge

    reduced = None
    if trace:
        dev_ev, host_ev, solves = trace_mod.from_profiler(prof)
        reduced = trace_mod.reduce(dev_ev, host_ev, solves, window_s,
                                   spec.KernelMap(spec.kernels()))
        if reduced.unmatched:
            print("mgbench: device operations no kernel file matches: "
                  + json.dumps(reduced.unmatched), file=sys.stderr)
        del prof, dev_ev, host_ev

    # the check: the program's state freed first, the reference after
    u_last, f_last, k_last = last
    del cell, last
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def answers():
        for buf, (k, amp) in zip(buffers, kept):
            yield buf.to(device), rhs(conf, k, amp, device), k
        yield u_last, f_last, k_last

    numbers = check.judge(mix["checks"], answers(), conf)
    numbers["failed_solves"] = (float(failed), 0.0)
    correct = check.passed(numbers)

    result: Dict[str, Any] = {
        "correct": correct, "attempted": attempted, "failed": failed}
    dev_info: Dict[str, Any] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": chips, "memory_peak_bytes": int(peak),
        # nvcc's share of setup_s in a run that built the kernel library
        "build_s": build_s}
    if not trace:
        lat = np.asarray(latencies)
        values = {"solve_ms": window_s / attempted * 1e3,
                  "solve_ms_p95": float(np.percentile(lat, 95)) * 1e3,
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in end_to_end}
    else:
        line = card_line() if device.type == "cuda" else "cpu"
        print(f"mgbench: card {line}", file=sys.stderr)
        peaks = spec.load_json(spec.BENCH_DIR / "peaks.json").get(
            dev_info["kind"])
        ctx = Ctx(conf, mix, reduced, iterations, launches, peaks)
        result["metrics"] = {}
        for m in per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        dev_info["busy_s"] = reduced.busy_s
        dev_info["window_s"] = reduced.window_s
        dev_info["card"] = line
        result["breakdown"] = {"device_ops": reduced.device_ops,
                               "idle_gaps": reduced.idle_gaps}
    result["device"] = dev_info
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in numbers.items()}
    lines = [f"check {name} {v!r} limit {lim!r}"
             for name, (v, lim) in numbers.items()]
    return result, lines


def main(argv: Optional[List[str]] = None, t_start: float = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json"
                                 " and print its result as one JSON line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    w, conf, mix = spec.cell_files(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"mgbench: {args.workload} needs {w['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    # kernel caches at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(spec.ROOT / "build" / sub)
    torch.set_num_threads(1)
    result, lines = run_cell(
        conf, mix, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda", 0),
        per_layer=spec.cell_metrics(bench, args.workload, "per_layer"),
        end_to_end=spec.cell_metrics(bench, args.workload, "end_to_end"),
        t_start=t_start, chips=w["chips"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0
