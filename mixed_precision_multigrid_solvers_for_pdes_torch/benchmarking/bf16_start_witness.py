"""The bf16-start adaptive solve through the kernels' plain twins: the count
that the kernel path should reach, read without the kernels.

Kernels A-D on bf16 storage widen to fp32, compute in fp32 and round once
per call; their twins round at the same points (``_build.round_once``). On
CPU tensors ``backend='auto'`` runs those twins wherever the card runs the
kernels, so this solve rounds as the kernel path does, with no kernel in it.
``backend='torch'`` is the plain path, which rounds after every bf16 op.
``chip_smoke.py``'s phase 23 holds the kernel path's bf16-start solve to
this script's 'auto' reading at the same size (``BF16_START_TWINS``).

The problem and settings are phase 23's: ``poisson_mms_sinsin(n)``,
``MultigridConfig(smoother='rbgs', omega=1.0, tol=1e-9)``,
``refinement.adaptive_solve(start=Precision.BF16)``, float64 right-hand
side and start. Prints one JSON line per backend: iterations, switches,
l2 error, seconds and the residual history.

Usage (CPU only; 1025^2 holds a few hundred MB and takes minutes):
    PYTHONPATH=. python3 -m \\
        mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking.bf16_start_witness \\
        [--n 1025] [--backends auto,torch] [--threads 8]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core.precision import Precision
from ..models.problems import poisson_mms_sinsin
from ..solvers.multigrid import MultigridConfig
from ..solvers.refinement import adaptive_solve


def witness(n: int, backend: str) -> dict:
    """One bf16-start adaptive solve of ``poisson_mms_sinsin(n)`` on the
    CPU through ``backend``; its count, switches, l2 error and history."""
    prob = poisson_mms_sinsin(n)
    cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                          backend=backend)
    f = prob.rhs(torch.float64, "cpu")
    u0 = prob.initial_guess(torch.float64, "cpu")
    t0 = time.perf_counter()
    u, info = adaptive_solve(prob.grid, prob.spec, f, u0, cfg=cfg,
                             start=Precision.BF16, device="cpu")
    seconds = time.perf_counter() - t0
    return {"n": n, "backend": backend, "iterations": info["iterations"],
            "converged": info["converged"],
            "precision_switches": info["precision_switches"],
            "l2": prob.error_norms(u)["l2"], "seconds": seconds,
            "history": [float(h) for h in info["history"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1025)
    ap.add_argument("--backends", default="auto,torch")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch CPU threads (0: torch's default)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    for backend in args.backends.split(","):
        print(json.dumps(witness(args.n, backend)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
