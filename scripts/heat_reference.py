"""Reference values of chip_smoke.py's heat phases (27 and 28), from the
JAX package on the CPU, beside the PyTorch port's plain path on the CPU.

For each run of the phases it prints the JAX package's step count and l2
error against the exact solution, the port's (``device="cpu"``, the
kernels' plain twins), the largest difference of the two final states
relative to max|u|, and the seconds each took. chip_smoke.py pins the fp64
runs' l2 and step counts (``HEAT_REF``) and bounds the fp32 runs' l2
(``HEAT_L2_BOUND``) by these numbers.

Usage (JAX on the CPU; the 2D runs take a few minutes, the 3D runs at
257^3 several more and a few GB of memory):

    JAX_PLATFORMS=cpu python scripts/heat_reference.py [2d] [3d] [noise]
        [reciprocal]

``noise`` runs the JAX package alone: fp32 against fp64 at dt 2e-3 and the
fp32 and fp64 adaptive controllers. ``reciprocal`` runs the port alone: the
fp32 CN runs (1025^2, and 129^3 with 8 cycles per step) with its smoothers
dividing by c and multiplying by 1/c.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

import jax.numpy as jnp

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (
    heat as JH,
    heat3d as J3,
    heat_problems as JHP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_torch import interop
from mixed_precision_multigrid_solvers_for_pdes_torch.applications import (
    heat as PH,
    heat3d as P3,
    heat_problems as PHP,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.core.grid import Grid

PI = np.pi


def varcoef_jax(n):
    """a = 1 + x + y, u = sin(pi x) sin(pi y) e^{-t}:
    q = u_t - div(a grad u) = e^{-t} [(2 pi^2 a - 1) sin sin
        - pi (cos(pi x) sin(pi y) + sin(pi x) cos(pi y))]."""

    def exact(X, Y, t):
        return jnp.sin(PI * X) * jnp.sin(PI * Y) * jnp.exp(-t)

    def q(X, Y, t):
        s = ((2 * PI**2 * (1.0 + X + Y) - 1.0) * jnp.sin(PI * X)
             * jnp.sin(PI * Y)
             - PI * (jnp.cos(PI * X) * jnp.sin(PI * Y)
                     + jnp.sin(PI * X) * jnp.cos(PI * Y)))
        return s * jnp.exp(-t)

    return JH.heat_problem_from_callables(
        "heat_varcoef", JGrid(n, n), exact=exact, q=q,
        a=lambda X, Y: 1.0 + X + Y)


def varcoef_port(n):
    """The same problem in torch ops (chip_smoke.py's ``varcoef_heat``)."""

    def exact(X, Y, t):
        e = torch.exp(-t)
        return PHP._up(torch.sin(PI * X) * torch.sin(PI * Y), e) * e

    def q(X, Y, t):
        e = torch.exp(-t)
        s = ((2 * PI**2 * (1.0 + X + Y) - 1.0) * torch.sin(PI * X)
             * torch.sin(PI * Y)
             - PI * (torch.cos(PI * X) * torch.sin(PI * Y)
                     + torch.sin(PI * X) * torch.cos(PI * Y)))
        return PHP._up(s, e) * e

    return PH.heat_problem_from_callables(
        "heat_varcoef", Grid(n, n), exact=exact, q=q,
        a=lambda X, Y: 1.0 + X + Y)


N = 1025
# name: (problem, n, scheme, dtype, t_final, dt, n_steps, extra config)
RUNS_2D = {
    "cn": ("pure_diffusion", N, "crank_nicolson", "float32", 1e-3, 1e-4,
           None, {}),
    "bdf2": ("pure_diffusion", N, "bdf2", "float32", 1e-3, 1e-4, None, {}),
    "be": ("pure_diffusion", N, "backward_euler", "float32", 5e-4, 1e-4,
           None, {}),
    "explicit": ("pure_diffusion", N, "explicit", "float32", None, None, 10,
                 {}),
    "neumann": ("neumann_heat", N, "crank_nicolson", "float32", 5e-4, 1e-4,
                None, {}),
    "varcoef": ("varcoef", N, "crank_nicolson", "float32", 5e-4, 1e-4,
                None, {}),
    "cn_fp64": ("pure_diffusion", N, "crank_nicolson", "float64", 2e-2,
                2e-3, None, {}),
    "adaptive_fp64": ("pure_diffusion", 257, "crank_nicolson", "float64",
                      0.05, 0.005, None, {"adaptive_dt": True,
                                          "dt_tol": 1e-5}),
}
# name: (problem, n, scheme, t_final, dt), fp32, cycles_per_step=2
RUNS_3D = {
    "cn_257": ("oscillating3d", 257, "crank_nicolson", 1e-2, 1e-3),
    "bdf2_257": ("oscillating3d", 257, "bdf2", 1e-2, 1e-3),
}


def explicit_t_final(n):
    """10 explicit steps at 0.9 x the stability limit."""
    return 10 * 0.9 * PH.stability_limit_dt(Grid(n, n), 1.0)


def problems(name, n):
    if name == "varcoef":
        return varcoef_jax(n), varcoef_port(n)
    return JHP.CATALOGUE[name](n), PHP.CATALOGUE[name](n)


def run_2d(key):
    name, n, scheme, dtype, t_final, dt, n_steps, extra = RUNS_2D[key]
    if scheme == "explicit":
        t_final = explicit_t_final(n)
    jp, pp = problems(name, n)
    kw = dict(scheme=scheme, dtype=dtype, **extra)
    t0 = time.perf_counter()
    jr = JH.solve_heat(jp, t_final, dt, JH.HeatConfig(**kw), n_steps=n_steps)
    jr.u.block_until_ready()
    t1 = time.perf_counter()
    pr = PH.solve_heat(pp, t_final, dt, PH.HeatConfig(**kw),
                       n_steps=n_steps, device="cpu")
    t2 = time.perf_counter()
    ju = interop.field_from_jax(np.asarray(jr.u), pp.grid).double()
    du = (pr.u.double() - ju).abs().max().item() / ju.abs().max().item()
    print(f"2d {key}: {name} {n}^2 {scheme} {dtype}: JAX steps {jr.steps} "
          f"l2 {jr.errors['l2']:.6e} ({t1 - t0:.1f} s); port steps "
          f"{pr.steps} l2 {pr.errors['l2']:.6e} ({t2 - t1:.1f} s); "
          f"max|du|/max|u| {du:.3e}; port/JAX l2 "
          f"{pr.errors['l2'] / jr.errors['l2']:.4f}", flush=True)


def run_3d(key):
    name, n, scheme, t_final, dt = RUNS_3D[key]
    jp, pp = getattr(J3, name)(n), getattr(P3, name)(n)
    kw = dict(scheme=scheme, dtype="float32", cycles_per_step=2)
    t0 = time.perf_counter()
    jr = J3.solve_heat3d(jp, t_final, dt, JH.HeatConfig(**kw))
    t1 = time.perf_counter()
    print(f"3d {key}: {name} {n}^3 {scheme} float32: JAX steps "
          f"{jr['steps']} l2 {jr['errors']['l2']:.6e} ({t1 - t0:.1f} s)",
          flush=True)
    ju = interop.field3d_from_jax(np.asarray(jr["u"]), pp.grid).double()
    del jr
    pr = P3.solve_heat3d(pp, t_final, dt, PH.HeatConfig(**kw), device="cpu")
    t2 = time.perf_counter()
    du = (pr["u"].double() - ju).abs().max().item() / ju.abs().max().item()
    print(f"3d {key}: port l2 {pr['errors']['l2']:.6e} ({t2 - t1:.1f} s); "
          f"max|du|/max|u| {du:.3e}", flush=True)


def noise():
    """fp32 against fp64 in the JAX package: CN on pure_diffusion(1025) at
    dt 2e-3 (10 steps), and the adaptive controller on
    pure_diffusion(257) in both dtypes."""
    states = {}
    for dtype in ("float32", "float64"):
        res = JH.solve_heat(JHP.pure_diffusion(N), 2e-2, 2e-3,
                            JH.HeatConfig(dtype=dtype))
        states[dtype] = np.asarray(res.u, np.float64)[:N, :N]
        print(f"noise CN {N}^2 dt 2e-3 {dtype}: l2 {res.errors['l2']:.6e}",
              flush=True)
    print(f"noise CN {N}^2 dt 2e-3: max|u_fp32 - u_fp64| "
          f"{np.max(np.abs(states['float32'] - states['float64'])):.3e}")
    for dtype in ("float32", "float64"):
        res = JH.solve_heat(JHP.pure_diffusion(257), 0.05, 0.005,
                            JH.HeatConfig(dtype=dtype, adaptive_dt=True,
                                          dt_tol=1e-5))
        print(f"noise adaptive 257^2 {dtype}: steps {res.steps} l2 "
              f"{res.errors['l2']:.6e} dt_history "
              f"{np.round(res.dt_history, 5).tolist()}", flush=True)


def reciprocal():
    """The port's plain path on the CPU for the 1025^2 fp32 CN run, its
    smoothers dividing by c (as the port does) and multiplying by 1/c
    rounded to fp32 (as the Pallas kernels do, and as PyTorch's CUDA
    division by a Python number does): the reciprocal's error biases the
    fp32 solution when c = 4/h^2 + lam is no power of two."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (
        smooth3d as sm3,
        stencil as st_mod,
    )

    divide = st_mod.divide

    def times_reciprocal(x, c):
        if isinstance(c, torch.Tensor):
            return x / c
        inv = (torch.tensor(1.0, dtype=x.dtype)
               / torch.tensor(c, dtype=x.dtype)).item()
        return x * inv

    name, n, scheme, dtype, t_final, dt, n_steps, _ = RUNS_2D["cn"]
    cfg = PH.HeatConfig(scheme=scheme, dtype=dtype, mg=PH.MultigridConfig(
        smoother="rbgs", omega=1.0, backend="torch"))
    # 3D: CN at 129^3 with 8 cycles per step, where the fp32 solve converges
    cfg3 = PH.HeatConfig(cycles_per_step=8, mg=cfg.mg)
    for label, fn in (("divide", divide), ("times fp32 1/c", times_reciprocal)):
        st_mod.divide = sm3.divide = fn
        try:
            res = PH.solve_heat(PHP.CATALOGUE[name](n), t_final, dt, cfg,
                                device="cpu")
            res3 = P3.solve_heat3d(P3.oscillating3d(129), 1e-2, 1e-3, cfg3,
                                   device="cpu")
        finally:
            st_mod.divide = sm3.divide = divide
        print(f"reciprocal {name} {n}^2 {scheme} {dtype}, smoother {label}: "
              f"l2 {res.errors['l2']:.6e} linf {res.errors['linf']:.6e}; "
              f"oscillating3d 129^3 CN fp32, 8 cycles per step: l2 "
              f"{res3['errors']['l2']:.6e}", flush=True)


def main(argv):
    which = set(argv) or {"2d"}
    if "2d" in which:
        for key in RUNS_2D:
            run_2d(key)
    if "3d" in which:
        for key in RUNS_3D:
            run_3d(key)
    if "noise" in which:
        noise()
    if "reciprocal" in which:
        reciprocal()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
