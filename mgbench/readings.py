"""The readings that set each cell's limits, at the cell's own size.

    python3 mgbench/readings.py --workload poisson3d-513-ir \
        --seeds 11,12,13 --faults 11,12,13 [--all-modes] [--device cuda]

In one process, with one set-up: for each seed, the program's answers to
the draws that a traced run of that seed judges (its kept samples and its
last solve), and the control's: the reference's exact discrete
solution computed in the mix's ``control_dtype``, the precision below the
one the configuration states, put in the program's place. With
``--faults``, the program with its timed path broken underneath, on those
seeds: the multigrid cycle returning its iterate unchanged, and the answer
altered where it is produced (its largest node lost). ``--all-modes``
solves every mode of the mix once and reports the outer iterations and the
number per mode. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mgbench.harness import check, runner, spec, traffic  # noqa: E402
from mgbench.reference import poisson  # noqa: E402


def judged_draws(mix: Dict, dims: int, seed: int):
    """The (k, amp) that a traced run of ``seed`` judges: those kept at
    its sample points, as its window stops at ``trace_solves`` solves,
    and its last solve."""
    cap = mix["trace_solves"]
    want = {max(math.ceil(p * cap) - 1, 0)
            for p in traffic.sample_points(mix, seed)} | {cap - 1}
    out = []
    for i, d in enumerate(traffic.draws(mix, dims, seed, traffic.WINDOW)):
        if i in want:
            out.append(d)
        if i >= max(want):
            return out


def numbers(mix, answers, conf) -> Dict[str, float]:
    return {name: v for name, (v, _) in
            check.judge(mix["checks"], answers, conf).items()}


@contextlib.contextmanager
def unchanged_cycle(port, mix):
    """The fault of a step that returns its state unchanged: every
    multigrid cycle hands its iterate back as it got it."""
    mod_name, fn = mix["cycle_fn"].rsplit(".", 1)
    mod = spec.resolve(port, mod_name)
    saved = getattr(mod, fn)
    setattr(mod, fn, lambda levels, u, f, *a, **kw: u)
    try:
        yield
    finally:
        setattr(mod, fn, saved)


def altered(u: torch.Tensor) -> torch.Tensor:
    """The answer altered where it is produced: its largest node lost."""
    u = u.clone()
    flat = u.view(-1)
    flat[torch.argmax(flat.abs())] = 0
    return u


def collect(conf: Dict, mix: Dict, device: torch.device, seeds: List[int],
            fault_seeds: List[int] = (), all_modes: bool = False) -> Dict:
    """The program's, the control's and the faults' numbers by seed."""
    port = runner.port_module()
    cell = runner.system_under_test(port, conf, mix, device)
    dims = conf["dims"]
    lower = getattr(torch, mix["control_dtype"])
    out: Dict = {"program": {}, "control": {}, "faults": {}}

    def program(draws, fault=None):
        for k, amp in draws:
            f = runner.rhs(conf, k, amp, device)
            u, _ = cell.solve(f)
            yield (altered(u) if fault == "altered" else u), f, k

    for seed in seeds:
        draws = judged_draws(mix, dims, seed)
        out["program"][seed] = numbers(mix, program(draws), conf)
        out["control"][seed] = numbers(mix, (
            (poisson.discrete_solution(f, k, lower), f, k)
            for f, k in ((runner.rhs(conf, k, amp, device), k)
                         for k, amp in draws)), conf)
        print(f"seed {seed}: program {out['program'][seed]} control "
              f"{out['control'][seed]}", file=sys.stderr, flush=True)
    for seed in fault_seeds:
        draws = judged_draws(mix, dims, seed)
        with unchanged_cycle(port, mix):
            out["faults"].setdefault("unchanged", {})[seed] = numbers(
                mix, program(draws), conf)
        out["faults"].setdefault("altered", {})[seed] = numbers(
            mix, program(draws, "altered"), conf)
        print(f"fault seed {seed}: " + json.dumps(
            {k: v[seed] for k, v in out["faults"].items()}),
            file=sys.stderr, flush=True)
    if all_modes:
        per_mode = {}
        for k in traffic.modes(mix, dims):
            f = runner.rhs(conf, k, 1.5, device)
            u, info = cell.solve(f)
            per_mode[str(k)] = [info["iterations"],
                                numbers(mix, [(u, f, k)], conf)]
            del u, f
        out["modes"] = per_mode
        its = [v[0] for v in per_mode.values()]
        out["modes_iterations"] = {str(i): its.count(i)
                                   for i in sorted(set(its))}
    for kind in ("program", "control"):
        for name in (c["number"] for c in mix["checks"]):
            vals = [v[name] for v in out[kind].values()]
            if vals:
                out[f"{kind}_{name}_range"] = [min(vals), max(vals)]
    return out


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--all-modes", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.faults.split(",") if s]

    bench = spec.benchmark()
    _, conf, mix = spec.cell_files(bench, args.workload)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    out = collect(conf, mix, device, seeds, fault_seeds, args.all_modes)
    out["workload"] = args.workload
    out["seconds"] = time.perf_counter() - t0
    out["card"] = runner.card_line() if device.type == "cuda" else "cpu"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
