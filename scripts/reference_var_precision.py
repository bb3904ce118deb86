"""Reference values of chip_smoke.py's phase 33, the 2D variable-coefficient
precisions, from the JAX package on the CPU, beside the PyTorch port's plain
path and its kernels' twins on the CPU.

For each case (problem x precision) it prints one JSON line: the JAX
package's outer-step count (cycles for 'bf16', iterations for the
bf16-start adaptive solve), l2 error against the exact solution (None
without one) and precision switches; the port's with ``backend='torch'``
(the plain path, which rounds bf16 levels after every op, as the JAX XLA
path does) and with ``backend='auto'`` (on the CPU the kernels' plain
twins, which round once per kernel call as kernels H, I, J, C and the rest
do: the count the kernel path should reach), and the seconds each took.
chip_smoke.py pins its phase 33 references (``VAR_PRECISION_REF``,
``VAR_PRECISION_TWINS``) to these numbers.

The problems are those of chip_smoke.py's ``var_problems``:
``variable_coefficient_mms``, ``jump_coefficient_problem(n, 1e3)`` and
``robin_test_problem``; the settings phase 23's: MultigridConfig(
smoother='rbgs', omega=1.0, tol=1e-9), with max_iterations=BF16_CYCLES for
the uniform 'bf16' hierarchy, which cannot reach that tolerance.

Usage (JAX on the CPU; a 1025^2 case takes one to a few minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/reference_var_precision.py \\
        [--n 1025] [CASE ...]

with CASE among ``PROBLEMS`` x ``PRECISIONS`` as 'problem:precision' (all
of them by default).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import jax.numpy as jnp

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (
    poisson as japp,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (
    precision as jprec,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (
    problems as JP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (
    multigrid as jmg,
    refinement as jref,
)
import mixed_precision_multigrid_solvers_for_pdes_torch as T

MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
BF16_CYCLES = 8
PROBLEMS = {
    "varcoef": (JP.variable_coefficient_mms, T.variable_coefficient_mms),
    "jump": (lambda n: JP.jump_coefficient_problem(n, 1e3),
             lambda n: T.jump_coefficient_problem(n, 1e3)),
    "robin": (JP.robin_test_problem, T.robin_test_problem),
}
PRECISIONS = ("mixed", "bf16", "bf16_start")


def _switches(info):
    return [list(s) for s in info.get("precision_switches", [])]


def jax_run(jp, precision):
    """(steps, l2, switches) of the JAX package's solve."""
    changes = {"max_iterations": BF16_CYCLES} if precision == "bf16" else {}
    cfg = jmg.MultigridConfig(backend="xla", **MAIN, **changes)
    if precision == "bf16_start":
        u, info = jref.adaptive_solve(
            jp.grid, jp.spec, jp.rhs(jnp.float64),
            jp.initial_guess(jnp.float64), a=jp.a, lam=jp.lam, cfg=cfg,
            start=jprec.Precision.BF16)
        l2 = jp.error_norms(u)["l2"] if jp.exact is not None else None
        return info["iterations"], l2, _switches(info)
    res = japp.solve_poisson(jp, precision=precision, cfg=cfg)
    return res.iterations, (res.errors or {}).get("l2"), _switches(res.info)


def port_run(prob, precision, backend):
    """(steps, l2, switches) of the port's solve on the CPU."""
    changes = {"max_iterations": BF16_CYCLES} if precision == "bf16" else {}
    cfg = T.MultigridConfig(backend=backend, **MAIN, **changes)
    if precision == "bf16_start":
        u, info = T.adaptive_solve(
            prob.grid, prob.spec, prob.rhs(torch.float64, "cpu"),
            prob.initial_guess(torch.float64, "cpu"), a=prob.a, lam=prob.lam,
            cfg=cfg, start=T.Precision.BF16, device="cpu")
        l2 = prob.error_norms(u)["l2"] if prob.exact is not None else None
        return info["iterations"], l2, _switches(info)
    res = T.solve_poisson(prob, precision=precision, cfg=cfg, device="cpu")
    return res.iterations, (res.errors or {}).get("l2"), _switches(res.info)


def run_case(name: str, n: int) -> dict:
    problem, precision = name.split(":")
    jfac, tfac = PROBLEMS[problem]
    out = {"case": name, "n": n}
    t0 = time.perf_counter()
    out["jax"] = jax_run(jfac(n), precision)
    out["jax_s"] = time.perf_counter() - t0
    prob = tfac(n)
    for backend in ("torch", "auto"):
        t0 = time.perf_counter()
        out[backend] = port_run(prob, precision, backend)
        out[f"{backend}_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1025)
    ap.add_argument("cases", nargs="*",
                    default=[f"{p}:{q}" for p in PROBLEMS for q in PRECISIONS])
    args = ap.parse_args(argv)
    for name in args.cases:
        print(json.dumps(run_case(name, args.n), default=float), flush=True)
    return 0


if __name__ == "__main__":
    np.set_printoptions(precision=17)
    raise SystemExit(main())
