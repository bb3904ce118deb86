"""The bf16 precisions through the kernels' plain twins: the counts that the
kernel path should reach, read without the kernels.

Kernels A-J and L on bf16 storage widen to fp32, compute in fp32 and round
once per call; their twins round at the same points (``_build.round_once``).
On CPU tensors ``backend='auto'`` runs those twins wherever the card runs
the kernels, so these solves round as the kernel path does, with no kernel
in them. ``backend='torch'`` is the plain path, which rounds after every
bf16 op. ``chip_smoke.py``'s phase 23 holds the kernel path's bf16-start
Poisson solve to this script's 'auto' reading (``BF16_START_TWINS``), and
phase 33 its variable-coefficient precisions (``VAR_PRECISION_TWINS``,
also printed by ``scripts/reference_var_precision.py`` beside the JAX
package's values).

The problems: ``poisson_mms_sinsin(n)`` (phase 23) and the three of phase
33, ``variable_coefficient_mms``, ``jump_coefficient_problem(n, 1e3)`` and
``robin_test_problem``. The precisions: 'bf16_start'
(``refinement.adaptive_solve(start=Precision.BF16)``, float64 right-hand
side and start), 'mixed' and 'bf16' (``solve_poisson``; 'bf16' runs
``--bf16-cycles`` cycles, as a uniform bf16 hierarchy cannot reach the
tolerance). Settings: ``MultigridConfig(smoother='rbgs', omega=1.0,
tol=1e-9)``. Prints one JSON line per problem, precision and backend:
iterations, switches, l2 error, seconds and the residual history.

Usage (CPU only; 1025^2 holds a few hundred MB and takes seconds to a
minute per solve):
    PYTHONPATH=. python3 -m \\
        mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking.bf16_start_witness \\
        [--n 1025] [--backends auto,torch] [--problems poisson] \\
        [--precisions bf16_start] [--threads 8]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..applications.poisson import solve_poisson
from ..core.precision import Precision
from ..models import problems as P
from ..solvers.multigrid import MultigridConfig
from ..solvers.refinement import adaptive_solve

PROBLEMS = {
    "poisson": P.poisson_mms_sinsin,
    "varcoef": P.variable_coefficient_mms,
    "jump": lambda n: P.jump_coefficient_problem(n, 1e3),
    "robin": P.robin_test_problem,
}
PRECISIONS = ("bf16_start", "mixed", "bf16")


def witness(n: int, backend: str, problem: str = "poisson",
            precision: str = "bf16_start", bf16_cycles: int = 8) -> dict:
    """One solve of ``problem`` at ``precision`` on the CPU through
    ``backend``; its count, switches, l2 error and history."""
    prob = PROBLEMS[problem](n)
    cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                          backend=backend)
    t0 = time.perf_counter()
    if precision == "bf16_start":
        f = prob.rhs(torch.float64, "cpu")
        u0 = prob.initial_guess(torch.float64, "cpu")
        u, info = adaptive_solve(prob.grid, prob.spec, f, u0, a=prob.a,
                                 lam=prob.lam, cfg=cfg,
                                 start=Precision.BF16, device="cpu")
    else:
        if precision == "bf16":
            cfg = cfg.replace(max_iterations=bf16_cycles)
        res = solve_poisson(prob, precision=precision, cfg=cfg, device="cpu")
        u, info = res.u, res.info
    seconds = time.perf_counter() - t0
    return {"n": n, "problem": problem, "precision": precision,
            "backend": backend, "iterations": info["iterations"],
            "converged": info["converged"],
            "precision_switches": info.get("precision_switches", []),
            "l2": (prob.error_norms(u)["l2"] if prob.exact is not None
                   else None),
            "seconds": seconds,
            "history": [float(h) for h in info["history"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1025)
    ap.add_argument("--backends", default="auto,torch")
    ap.add_argument("--problems", default="poisson")
    ap.add_argument("--precisions", default="bf16_start")
    ap.add_argument("--bf16-cycles", type=int, default=8)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch CPU threads (0: torch's default)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    for problem in args.problems.split(","):
        for precision in args.precisions.split(","):
            for backend in args.backends.split(","):
                print(json.dumps(witness(args.n, backend, problem, precision,
                                         args.bf16_cycles)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
