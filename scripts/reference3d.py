"""Reference values of chip_smoke.py's 3D phases 30 and 31, from the JAX
package on the CPU, beside the PyTorch port's plain path and its kernels'
twins on the CPU.

For each case it prints one JSON line: the JAX package's outer-step count
(iterations for the adaptive solve, steps for the heat run), l2 error
against the exact solution (None without one) and precision switches, the
port's with ``backend='torch'`` (the plain path) and ``backend='auto'``
(on the CPU the kernels' plain twins, which round once per call as the
kernels do), and the seconds each took. chip_smoke.py pins its phase 30
and 31 references (``PRECISION3D_REF``, ``OPERATOR3D_REF``) to these
numbers.

The Galerkin case runs the JAX package's ir_solve3d on Galerkin levels
whose float64 RAP the port computed (cast to float32 as the JAX package
casts its own): the JAX package's RAP program batches its 27 comb phases in
one vmap, which at 257^3 holds 27 fine float64 fields per intermediate,
beyond this script's memory; the two RAPs agree within 1e-12 at 9^3
(tests/unit/test_torch_3d_operator.py).

Usage (JAX on the CPU; each 257^3 case takes one to a few minutes and a
few GB of memory):

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/reference3d.py [CASE ...]

with CASE among the names of ``CASES`` (all of them by default).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

import jax.numpy as jnp

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (
    heat as JH,
    heat3d as JH3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson3d \
    import solve_poisson3d as jsolve
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (
    problems3d as JP3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (
    stencil3d as jst3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (
    multigrid3d as jmg3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
    MultigridConfig as JConfig,
)
import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch import interop
from mixed_precision_multigrid_solvers_for_pdes_torch.applications import (
    heat3d as P3,
)

MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
# name: (problem factory, n, precision, config changes)
CASES = {
    "mixed_129": ("poisson3d_mms_sinsinsin", 129, "mixed", {}),
    "mixed_257": ("poisson3d_mms_sinsinsin", 257, "mixed", {}),
    "adaptive_257": ("poisson3d_mms_sinsinsin", 257, "adaptive", {}),
    "jump_65": ("jump_coefficient3d", 65, "fp32", {}),
    "jump_129": ("jump_coefficient3d", 129, "fp32", {}),
    "jump_257": ("jump_coefficient3d", 257, "fp32", {}),
    "neumann_257": ("neumann3d_test", 257, "fp32", {}),
    "periodic_257": ("periodic3d_helmholtz", 257, "fp32", {}),
    "line_z_257": ("anisotropic3d_z", 257, "fp32", {"smoother": "line_z"}),
    "w_257": ("poisson3d_mms_sinsinsin", 257, "fp32", {"cycle": "W"}),
    "galerkin_257": ("jump_coefficient3d", 257, "fp32",
                     {"coarsening": "galerkin"}),
    "heat_a_257": ("pure_diffusion3d", 257, "crank_nicolson", {}),
}
HEAT_STEPS, HEAT_DT = 5, 1e-3


def _summary(iterations, errors, info, seconds):
    return {"iterations": int(iterations),
            "l2": None if errors is None else float(errors["l2"]),
            "switches": [list(s) for s in info.get("precision_switches",
                                                   [])],
            "s": round(seconds, 1)}


def _jax_galerkin(jp, cfg):
    """The JAX package's fp32-under-IR solve on Galerkin levels whose
    float64 RAP the port computed (level 0 is the JAX package's own)."""
    tp = interop.problem3d_from_jax(jp)
    tl = T.build_hierarchy3d(tp.grid, tp.spec, a=tp.a, dtype="float32",
                             cfg=T.MultigridConfig(**cfg), device="cpu")
    rediscretized = dict(cfg, coarsening="rediscretize")  # no JAX RAP
    jl = jmg3.build_hierarchy3d(jp.grid, jp.spec, a=jp.a, lam=jp.lam,
                                dtype="float32",
                                cfg=JConfig(backend="xla", **rediscretized))
    levels = [jl[0]]
    for jlev, tlev in zip(jl[1:], tl[1:]):
        pad = jlev.grid.shape_padded

        def padded(t, lead=()):
            a = np.zeros(lead + pad, np.float32)
            a[(Ellipsis,) + tuple(slice(0, m) for m in t.shape[-3:])] = \
                t.numpy()
            return jnp.asarray(a)

        st = jst3.Stencil27(c=padded(tlev.stencil.c),
                            off=padded(tlev.stencil.off, (26,)))
        levels.append(dataclasses.replace(jlev, stencil=st))
    return jmg3.ir_solve3d(tuple(levels), jp.rhs(jnp.float64),
                           jp.initial_guess(jnp.float64),
                           JConfig(backend="xla", **cfg), inner_cycles=2)


def _heat(n):
    """CN with a = 1 + x + y + z on pure_diffusion3d(n), fp64: (JAX, port)
    problems and configs."""
    jp = JH3.pure_diffusion3d(n)
    X, Y, Z = jp.grid.coordinates(padded=True)
    a = 1.0 + X + Y + Z
    a[n:], a[:, n:], a[:, :, n:] = 0.0, 0.0, 0.0  # the padding
    jp = dataclasses.replace(jp, a=jnp.asarray(a))
    jc = JH.HeatConfig(dtype="float64", mg=JConfig(backend="xla", **MAIN))
    return jp, jc


def run(case: str) -> dict:
    name, n, precision, changes = CASES[case]
    cfg = dict(MAIN, **changes)
    out = {"case": case, "problem": name, "n": n, "precision": precision,
           "config": changes}
    if name == "pure_diffusion3d":
        jp, jc = _heat(n)
        t0 = time.perf_counter()
        jr = JH3.solve_heat3d(jp, HEAT_STEPS * HEAT_DT, HEAT_DT, jc)
        out["jax"] = {"steps": jr["steps"], "l2": jr["errors"]["l2"],
                      "s": round(time.perf_counter() - t0, 1)}
        tp = interop.heat_problem3d_from_jax(jp)
        tc = interop.heat_config_from_jax(jc)
        for backend in ("torch", "auto"):
            t0 = time.perf_counter()
            tr = P3.solve_heat3d(tp, HEAT_STEPS * HEAT_DT, HEAT_DT,
                                 dataclasses.replace(tc, mg=tc.mg.replace(
                                     backend=backend)), device="cpu")
            out[backend] = {"steps": tr["steps"], "l2": tr["errors"]["l2"],
                            "s": round(time.perf_counter() - t0, 1)}
        return out
    jp = getattr(JP3, name)(n)
    t0 = time.perf_counter()
    if changes.get("coarsening") == "galerkin":
        _, info = _jax_galerkin(jp, cfg)
        out["jax"] = _summary(info["iterations"], None, info,
                              time.perf_counter() - t0)
    else:
        jr = jsolve(jp, precision=precision,
                    cfg=JConfig(backend="xla", **cfg))
        out["jax"] = _summary(jr.iterations, jr.errors, jr.info,
                              time.perf_counter() - t0)
        del jr
    tp = getattr(T, name)(n)
    for backend in ("torch", "auto"):
        t0 = time.perf_counter()
        tr = T.solve_poisson3d(tp, precision=precision, cfg=T.MultigridConfig(
            backend=backend, **cfg), device="cpu")
        out[backend] = _summary(tr.iterations, tr.errors, tr.info,
                                time.perf_counter() - t0)
    return out


def main(argv) -> int:
    for case in argv or list(CASES):
        print(json.dumps(run(case)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
