"""The 3D 'mixed' solve through the kernels' plain twins: the outer-step
count that the kernel path should reach, read without the kernels.

Kernels E, F and G on bf16 storage widen to fp32, compute in fp32 and round
once per call; their twins round at the same points
(``_build.round_once``). On CPU tensors ``backend='auto'`` runs those twins
wherever the card runs the kernels, so this solve rounds as the kernel path
does, with no kernel in it. ``backend='torch'`` is the plain path, which
rounds after every bf16 op. ``chip_smoke.py``'s phase 30 holds the kernel
path's 513^3 'mixed' solve to this script's 'auto' reading at the same size
(``MIXED3D_TWINS``).

The problem and settings are phase 30's: ``poisson3d_mms_sinsinsin(n)``,
``solve_poisson3d(precision='mixed', cfg=MultigridConfig(smoother='rbgs',
omega=1.0, tol=1e-9))``: fp32 levels above bf16 ones
(``PrecisionPolicy.level_dtypes``) under float64 iterative refinement, two
cycles per outer step. Prints one JSON line per backend: outer steps, l2
error, seconds and the residual history.

Usage (CPU only; 513^3 holds ~10 GB and takes minutes on 8 cores):
    PYTHONPATH=. python3 -m \\
        mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking.mixed3d_witness \\
        [--n 513] [--backends auto] [--threads 8]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..applications.poisson3d import solve_poisson3d
from ..models.problems3d import poisson3d_mms_sinsinsin
from ..solvers.multigrid import MultigridConfig


def witness(n: int, backend: str) -> dict:
    """One 'mixed' solve of ``poisson3d_mms_sinsinsin(n)`` on the CPU
    through ``backend``; its count, l2 error and history."""
    cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                          backend=backend)
    t0 = time.perf_counter()
    res = solve_poisson3d(poisson3d_mms_sinsinsin(n), precision="mixed",
                          cfg=cfg, device="cpu")
    seconds = time.perf_counter() - t0
    return {"n": n, "backend": backend, "iterations": res.iterations,
            "converged": res.converged, "l2": res.errors["l2"],
            "seconds": seconds,
            "history": [float(h) for h in res.info["history"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=513)
    ap.add_argument("--backends", default="auto")
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
