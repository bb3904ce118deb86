#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths once on one GPU and check them.

The 2D path is the solve bench.py times for the JAX package: the 2D Poisson
problem u = sin(pi x) sin(pi y) on a 1025^2 grid, an fp32 level hierarchy
smoothed by red-black Gauss-Seidel V(2,2) cycles, and mixed-precision
iterative refinement (fp64 outer residual, two fp32 cycles per outer step)
from a full-multigrid start, to 1e-9 relative residual. The 3D path is
solve_poisson3d(precision='fp32') on u = sin(pi x) sin(pi y) sin(pi z) at
513^3: the same refinement around fp32 RB-GS V(2,2) cycles on nine levels,
from a zero start, to 1e-9 relative residual. The variable-coefficient and
Robin path is solve_poisson(precision='fp32') at 1025^2 on three problems:
-div(a grad u) = f with a = 1 + x + y, a 1000:1 coefficient jump at x = 0.5,
and Poisson with a Robin east side; the same refinement, from a zero start.

Phases, each of which must pass:
  1. print the card (nvidia-smi name and power limit) and the host's tools;
  2. build the CUDA kernels from csrc/ with nvcc and print the build time;
  3. hold each 2D kernel (A-D) against its plain PyTorch twin on the card at
     the 2D path's shapes, and time both with CUDA events;
  4. solve the 2D path with backend='auto' (the kernels), from launch
     counts reset to zero, and check the iteration count, the error against
     the exact solution and that every kernel launched;
  5. solve it again with backend='torch' (the plain path on the card) and
     check that both paths agree;
  6. time both 2D paths over 16 frequency-swept right-hand sides as bench.py
     does, and print per-solve ms and DoF/s;
  7. hold each 3D kernel (E-G) against its twin at 513^3, 257^3, 129^3 and
     5^3 (E also reversed and with omega != 1), and time both;
  8. solve the 3D path at 257^3 and at 513^3 with backend='auto', the
     513^3 run from launch counts reset to zero, and check convergence, the
     outer-step count of the JAX reference, the l2 error against the closed
     form and that E, F and G launched; print the peak device memory;
  9. solve it at 513^3 with backend='torch' and check that both paths agree;
 10. time both 3D paths over frequency-swept right-hand sides, print ms and
     DoF/s, and profile one kernel-path solve with torch.profiler;
 11. hold each coefficient-plane kernel against its twin at the path's
     shapes (H at 1025^2, 513^2, 257^2 on both coefficient fields; I from
     1025^2, 513^2, 257^2 on three side sets; C with the Robin sides; J
     from 129^2 on both fields), and time both;
 12. solve the three problems with backend='auto', each from launch counts
     reset to zero, and check the outer-step count and the l2 error of the
     JAX reference and which kernels launched;
 13. solve them with backend='torch' and check that both paths agree;
 14. time both paths per solve, and profile the jump solve.
The parity paths (after phase 5): the parity-plane solve plane_ir_solve at
1025^2 (level 0 held as four parity planes, smoothed by kernel K; levels
>= 1 on kernels A-D) and the main path with the parity layout of kernel A
(kernel L) switched on; and the microbenchmark probes (kernel M):
 15. hold K (1025^2 and 513^2 planes, 2 sweeps, omega 1 and 1.3), L (1025^2,
     513^2, 257^2; 1, 2, 3 sweeps and omega 1.3) and the probes, the copy
     and the c = 4 parity probe (513^2, 1025^2) against their twins, bit for
     bit, and L against A; time A, K and L per 2-sweep call at 1025^2 in
     turns, and the copy's bandwidth at 1025^2 and 8192^2;
 16. solve the 1025^2 main path (FMG, IR) with PARITY_DEFAULT on, from
     launch counts reset to zero: L launches, A's RB-GS does not, 3 outer
     steps, u equal to the direct layout's bit for bit; time it;
 17. run the microbenchmark (benchmarking/kernel_microbench.run at 513^2 and
     1025^2) from launch counts reset to zero: the probe and copy launch;
 18. solve plane_ir_solve at 1025^2 with backend='auto', from launch counts
     reset to zero: the JAX reference's 4 outer steps, l2 within 2% of
     3.92e-7, K launched and A-D launched on levels >= 1; then with
     backend='torch' and against the standard ir_solve(use_fmg=False) on the
     same levels: the same count and u within 1e-8;
 19. time the plane solve against the standard no-FMG solve, in turns, and
     profile one plane solve.
The kernels' JSON record gives each kernel's bound: its compulsory bytes
(each input read once, each output written once) over the H100's published
3.35 TB/s, or its fp32 operations over 67 TFLOP/s, whichever is larger.
The second-to-last line is the kernels' JSON record, the last line the
device record. Any failure exits non-zero.

Usage: python3 chip_smoke.py     (needs one CUDA card; imports no JAX)
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

N = 1025
K = 16                    # right-hand sides per timed batch (bench.py)
REPEATS = 5
ITERS_EXPECTED = 3        # outer steps of the JAX reference at 1025^2
L2_EXPECTED = 3.92e-7     # its l2 error against the exact solution
L2_RTOL = 0.02
PATH_ATOL = 1e-8          # max|u_kernels - u_plain| after the solve
# Kernel vs plain twin, relative to max|twin|: both compute in fp32, but the
# kernels multiply by 1/c where the twin divides by c, nvcc contracts
# multiply-adds into FMAs, and the tail chains ~100 dependent phases.
KERNEL_RTOL = 1e-5
FREQS = [(1, 1), (2, 1), (1, 3), (3, 2), (2, 5), (5, 1), (4, 3), (1, 7)]
N3 = 513
# Outer steps of the JAX reference's solve_poisson3d(fp32, tol 1e-9) on the
# CPU: 5 at 129^3 and at 257^3 (histories agree to 1%); the card is held to
# it at 257^3 and at 513^3.
ITERS3D_EXPECTED = 5
# l2 error of the 7-point solution: |3 pi^2 / lambda_h - 1| / sqrt(8) with
# lambda_h = (12/h^2) sin^2(pi h / 2)
L2_3D_EXPECTED = {257: 4.4371e-6, 513: 1.1093e-6}
# max|u_kernels - u_plain| after the 3D solve: both paths stop at 1e-9
# relative residual, which bounds their distance to the discrete solution
# far below this
PATH3D_ATOL = 1e-8
N3_REF = 257             # the largest size the JAX reference ran
SIZES3 = (N3, N3_REF, 129, 5)   # where E, F and G meet their twins
K3, K3_PLAIN, REPEATS3 = 4, 2, 3   # 3D right-hand sides and repeats
FREQS3 = [(1, 1, 1), (2, 1, 1), (1, 3, 2), (3, 2, 1)]
# The variable-coefficient and Robin path at 1025^2. The references are the
# JAX package's solve_poisson(precision='fp32', cfg=MultigridConfig(
# smoother='rbgs', omega=1.0, tol=1e-9)) on the CPU at 1025^2: varcoef 4
# outer steps, l2 4.2673e-6; jump 15 steps; Robin 3 steps, l2 1.2164e-8.
N_VAR = 1025
VAR_STEPS = {"varcoef": 4, "jump": 15, "robin": 3}
VAR_STEPS_SLACK = {"varcoef": 0, "jump": 1, "robin": 1}
VAR_L2 = {"varcoef": 4.2673e-6, "robin": 1.2164e-8}
ROBIN_L2_FACTOR = 1.5     # Robin: l2 <= this * the reference (the
                          # tolerance, not the grid, sets that l2)
VAR_PATH_RTOL = 1e-8      # max|u_auto - u_torch| <= this * max|u|
# The parity paths. plane_ir_solve at 1025^2 without FMG: the JAX
# package's plane A/B reached 4 outer steps on both arms
# (reports/plane_ab.json); its l2 is the main path's.
PLANE_ITERS_EXPECTED = 4
PLANE_PATH_ATOL = 1e-8    # max|du| plane path vs plain path and standard IR
N_COPY_HBM = 8192         # copy at 2 x 268 MB, far beyond the 50 MB L2
# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth
# and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
PKG = "mixed_precision_multigrid_solvers_for_pdes_torch"
TPU_PKG = "mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def host_report() -> str:
    """The card line from nvidia-smi, after printing the host's tools."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}")
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc} ({ver})")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")
    print(f"ninja: {shutil.which('ninja')}")
    cutlass = "/usr/local/cutlass/include"
    print(f"cutlass headers: {cutlass if os.path.isdir(cutlass) else None}")
    return card


def compare(name, shape_label, kernel_fn, plain_fn, make_inputs, errs,
            exact=False):
    """Run kernel and twin on identical inputs; record and check the
    difference (zero when ``exact``)."""
    import torch

    out_k = kernel_fn(*make_inputs())
    out_p = plain_fn(*make_inputs())
    torch.cuda.synchronize()
    if out_k.shape != out_p.shape or not torch.isfinite(out_k).all():
        fail(f"{name} {shape_label}: non-finite or misshapen output")
    err = (out_k - out_p).abs().max().item()
    scale = out_p.abs().max().item()
    print(f"check {name} {shape_label}: max_abs_err {err:.3e} "
          f"max_rel_err {err / max(scale, 1e-30):.3e}")
    if err > KERNEL_RTOL * max(scale, 1e-30) or (exact and err != 0.0):
        fail(f"{name} {shape_label}: kernel disagrees with its plain twin "
             f"({err:.3e}, allowed {0.0 if exact else KERNEL_RTOL} * "
             f"{scale:.3e})")
    errs[name] = max(errs.get(name, 0.0), err)


def time_ms(fn, reps: int = 20) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(levels, cfg, dev):
    """Phase 3: each kernel against its twin at the main path's shapes."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, tail as kt, transfer as kx

    rng = np.random.default_rng(1234)

    def field(shape, scale=1.0):
        a = np.zeros(shape, np.float32)
        a[1:-1, 1:-1] = scale * rng.standard_normal(
            (shape[0] - 2, shape[1] - 2))
        return torch.from_numpy(a).to(dev)

    by_n = {lev.grid.nx: lev for lev in levels}
    errs, times = {}, {}
    sm = dict(method="rbgs", sweeps=cfg.pre_sweeps, omega=cfg.omega)
    for n in (1025, 513, 257):
        st = by_n[n].stencil
        u, f = field((n, n)), field((n, n), st.c)
        compare("smooth_multisweep", f"{n}^2", lambda a, b: ks.multisweep(
            st, a, b, **sm), lambda a, b: ks.multisweep_plain(st, a, b, **sm),
            lambda: (u.clone(), f), errs)
        times[("smooth_multisweep", n)] = (
            time_ms(lambda: ks.multisweep(st, u, f, **sm)),
            time_ms(lambda: ks.multisweep_plain(st, u, f, **sm)))
    for n in (1025, 513, 257):
        st, nc = by_n[n].stencil, (n - 1) // 2 + 1
        u, f = field((n, n)), field((n, n), st.c)
        compare("residual_restrict", f"{n}->{nc}",
                lambda a, b: kx.residual_restrict(st, a, b),
                lambda a, b: kx.residual_restrict_plain(st, a, b),
                lambda: (u, f), errs)
        times[("residual_restrict", n)] = (
            time_ms(lambda: kx.residual_restrict(st, u, f)),
            time_ms(lambda: kx.residual_restrict_plain(st, u, f)))
        ec = field((nc, nc))
        ec[0, :] = 0.5  # a non-zero ring must interpolate too
        compare("prolong_correct", f"{nc}->{n}", kx.prolong_correct,
                kx.prolong_correct_plain, lambda: (ec, u.clone()), errs)
        times[("prolong_correct", n)] = (
            time_ms(lambda: kx.prolong_correct(ec, u)),
            time_ms(lambda: kx.prolong_correct_plain(ec, u)))
    tail_kw = dict(pre=cfg.pre_sweeps, post=cfg.post_sweeps, omega=cfg.omega,
                   method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
                   symmetric=cfg.symmetric)
    for entry in (129, 3):
        tail = [lev for lev in levels if lev.grid.nx <= entry]
        sts = [lev.stencil for lev in tail]
        shapes = [lev.grid.shape for lev in tail]
        f = field(shapes[0], sts[0].c)
        u0 = torch.zeros(shapes[0], device=dev)
        compare("tail_vcycle", f"{entry}^2 L={len(tail)}",
                lambda a, b: kt.tail_vcycle(sts, a, b, shapes=shapes,
                                            **tail_kw),
                lambda a, b: kt.tail_vcycle_plain(sts, a, b, shapes=shapes,
                                                  **tail_kw),
                lambda: (u0.clone(), f), errs)
        times[("tail_vcycle", entry)] = (
            time_ms(lambda: kt.tail_vcycle(sts, u0.clone(), f, shapes=shapes,
                                           **tail_kw)),
            time_ms(lambda: kt.tail_vcycle_plain(sts, u0.clone(), f,
                                                 shapes=shapes, **tail_kw)))
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^2: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return errs, times


def solve(mg, levels, prob, cfg, f, dev):
    import torch

    u0 = prob.initial_guess(torch.float64, dev)
    return mg.ir_solve(levels, f, u0, cfg, inner_cycles=2, max_outer=100,
                       use_fmg=True)


def timed_solves(mg, levels, prob, cfg, dev) -> float:
    """bench.py's protocol: K frequency-swept right-hand sides, each solved
    from a zero guess; min over REPEATS of the mean per-solve wall time."""
    import torch

    g = prob.grid
    X, Y = np.meshgrid(np.arange(N) * g.hx, np.arange(N) * g.hy,
                       indexing="ij")

    def batch(r):
        out = []
        for i in range(K):
            kx, ky = FREQS[i % len(FREQS)]
            amp = 1.0 + (i + r * K) / (K * 8.0)
            out.append(torch.from_numpy(
                amp * (kx**2 + ky**2) * np.pi**2 * np.sin(kx * np.pi * X)
                * np.sin(ky * np.pi * Y)).to(dev))
        return out

    best = float("inf")
    for r in range(REPEATS + 1):  # r = 0 is the warm-up
        fs = batch(r)
        torch.cuda.synchronize()
        total = 0.0
        for fk in fs:
            t0 = time.perf_counter()
            _, info = solve(mg, levels, prob, cfg, fk, dev)
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
            if not info["converged"]:
                fail(f"timed solve (backend={cfg.backend}) did not converge")
        if r > 0:
            best = min(best, total / K)
    return best


def kernel_phase3d(dev):
    """Phase 7: kernels E, F, G against their twins at 513^3, 257^3, 129^3
    and 5^3; inputs from a seeded generator on the card."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch import Grid3D
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import stencil3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth3d as ks3, transfer3d as kx3

    gen = torch.Generator(device=dev).manual_seed(4321)

    def field(shape, scale=1.0, shell=False):
        a = scale * torch.randn(shape, generator=gen, device=dev)
        if not shell:
            inner = a[1:-1, 1:-1, 1:-1].clone()
            a.zero_()
            a[1:-1, 1:-1, 1:-1] = inner
        return a

    errs, times = {}, {}
    for n in SIZES3:
        st = stencil3d.make_stencil3d(Grid3D(n, n, n))
        u, f = field((n,) * 3), field((n,) * 3, st.c)
        for sweeps, omega, reverse in ((2, 1.0, False), (1, 1.3, False),
                                       (2, 1.0, True)):
            kw = dict(sweeps=sweeps, omega=omega, reverse=reverse)
            compare("rbgs3d", f"{n}^3 {kw}",
                    lambda a, b: ks3.rbgs3d(st, a, b, **kw),
                    lambda a, b: ks3.rbgs3d_plain(st, a, b, **kw),
                    lambda: (u.clone(), f), errs)
        times[("rbgs3d", n)] = (
            time_ms(lambda: ks3.rbgs3d(st, u, f, sweeps=2), reps=10),
            time_ms(lambda: ks3.rbgs3d_plain(st, u, f, sweeps=2), reps=10))
        nc = (n - 1) // 2 + 1
        compare("residual_restrict3d", f"{n}->{nc}",
                lambda a, b: kx3.residual_restrict3d(st, a, b),
                lambda a, b: kx3.residual_restrict3d_plain(st, a, b),
                lambda: (u, f), errs)
        times[("residual_restrict3d", n)] = (
            time_ms(lambda: kx3.residual_restrict3d(st, u, f), reps=10),
            time_ms(lambda: kx3.residual_restrict3d_plain(st, u, f),
                    reps=10))
        ec = field((nc,) * 3, shell=True)  # a non-zero coarse shell too
        compare("prolong_correct3d", f"{nc}->{n}", kx3.prolong_correct3d,
                kx3.prolong_correct3d_plain, lambda: (ec, u.clone()), errs)
        times[("prolong_correct3d", n)] = (
            time_ms(lambda: kx3.prolong_correct3d(ec, u), reps=10),
            time_ms(lambda: kx3.prolong_correct3d_plain(ec, u), reps=10))
        del u, f, ec
        torch.cuda.empty_cache()
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^3: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return errs, times


def solve3d(mg, n, backend, dev):
    """solve_poisson3d(precision='fp32', tol 1e-9) at n^3; returns the
    result and the peak device memory of the solve in bytes."""
    import torch

    prob = mg.poisson3d_mms_sinsinsin(n)
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend=backend)
    torch.cuda.reset_peak_memory_stats(dev)
    res = mg.solve_poisson3d(prob, precision="fp32", cfg=cfg, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"solve3d {n}^3 {backend}: iterations {res.iterations} converged "
          f"{res.converged} history {res.info['history'].tolist()} "
          f"errors {res.errors} solve {res.solve_time * 1e3:.3f} ms "
          f"(first call, set-up included) peak memory {peak / 2**30:.3f} GiB")
    if tuple(res.u.shape) != (n,) * 3 or not torch.isfinite(res.u).all():
        fail(f"3D solution at {n}^3 is misshapen or not finite")
    if not res.converged or res.iterations != ITERS3D_EXPECTED:
        fail(f"3D {n}^3 {backend}: expected convergence in "
             f"{ITERS3D_EXPECTED} outer steps")
    if abs(res.errors["l2"] / L2_3D_EXPECTED[n] - 1) > L2_RTOL:
        fail(f"3D {n}^3 l2 error {res.errors['l2']:.4e} not within "
             f"{L2_RTOL:.0%} of {L2_3D_EXPECTED[n]:.4e}")
    return res, peak


def rhs3d(levels, i, r, k, dev):
    """Frequency-swept right-hand side number i of repeat r, on the card."""
    import torch

    g = levels[0].grid
    x = torch.arange(g.nx, dtype=torch.float64, device=dev) * g.hx
    kx, ky, kz = FREQS3[i % len(FREQS3)]
    amp = 1.0 + (i + r * k) / (k * 8.0)
    sx, sy, sz = (torch.sin(m * np.pi * x) for m in (kx, ky, kz))
    return (amp * (kx**2 + ky**2 + kz**2) * np.pi**2
            * sx[:, None, None] * sy[None, :, None] * sz[None, None, :])


def timed_solves3d(mg, levels, cfg, k, dev) -> float:
    """k frequency-swept right-hand sides, each solved by ir_solve3d from a
    zero guess; min over REPEATS3 of the mean per-solve wall time."""
    import torch

    u0 = torch.zeros(levels[0].grid.shape, dtype=torch.float64, device=dev)
    best = float("inf")
    for r in range(REPEATS3 + 1):  # r = 0 is the warm-up
        total = 0.0
        for i in range(k):
            f = rhs3d(levels, i, r, k, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = mg.ir_solve3d(levels, f, u0, cfg, inner_cycles=2)
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
            if not info["converged"]:
                fail(f"timed 3D solve (backend={cfg.backend}) did not "
                     "converge")
        if r > 0:
            best = min(best, total / k)
    return best


def profile_solve(label, run, wrappers) -> None:
    """Profile one kernel-path solve (``run``): device-busy share against
    the same solve unprofiled, top kernels, launches per solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed()
    wall = timed()
    for w in wrappers.values():
        w.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = timed()
    launches = {name: w.launches for name, w in wrappers.items()}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_ops = sum(e.count for e in kernels)
    print(f"profile {label} kernel path: device time {dev_us / 1e3:.3f} ms "
          f"in {wall_prof * 1e3:.3f} ms profiled wall; unprofiled solve "
          f"{wall * 1e3:.3f} ms; device busy {dev_us / 1e6 / wall:.1%} of "
          f"the unprofiled solve; {n_ops} device ops per solve; custom "
          f"launches {launches}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  top kernel {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / max(dev_us, 1e-9):6.1%} "
              f"x{e.count:5d} {e.key[:90]}")


def var_problems(mg):
    """The three problems of the variable-coefficient and Robin path."""
    return {"varcoef": mg.variable_coefficient_mms(N_VAR),
            "jump": mg.jump_coefficient_problem(N_VAR, 1e3),
            "robin": mg.robin_test_problem(N_VAR)}


def kernel_phase_var(mg, cfg, dev):
    """Phase 11: H, I, C with sides and J against their twins at the
    path's shapes; inputs from a seeded generator on the card."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_var as ksv, tail as kt, transfer as kx

    gen = torch.Generator(device=dev).manual_seed(2468)

    def field(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    robin = bc.BCSide(bc.BCKind.ROBIN, alpha=1.0, beta=1.0)
    side_sets = {"dirichlet": bc.dirichlet(),
                 "east_robin": bc.BoundarySpec(east=robin),
                 "west_north_neumann": bc.mixed(west="neumann",
                                                north="neumann")}
    probs = var_problems(mg)
    grid = probs["varcoef"].grid
    hier = {name: mg.build_hierarchy(grid, spec, a=probs[coef].a,
                                     device=dev, cfg=cfg)
            for name, spec, coef in (
                ("varcoef", bc.dirichlet(), "varcoef"),
                ("jump", bc.dirichlet(), "jump"),
                ("east_robin", side_sets["east_robin"], "varcoef"),
                ("west_north_neumann", side_sets["west_north_neumann"],
                 "jump"))}
    errs, times = {}, {}
    smooth_cases = (("rbgs", 2, 1.0), ("rbgs_rev", 2, 1.0), ("sor", 1, 1.3),
                    ("jacobi", 2, 0.8))
    for coef in ("varcoef", "jump"):
        for lev in hier[coef][:3]:
            n, st = lev.grid.nx, lev.stencil
            u, f = field((n, n)), field((n, n), 1e3)
            for method, sweeps, omega in smooth_cases:
                kw = dict(method=method, sweeps=sweeps, omega=omega)
                compare("smooth_var", f"{coef} {n}^2 {kw}",
                        lambda a, b: ksv.multisweep_var(st, a, b, **kw),
                        lambda a, b: ks.multisweep_plain(st, a, b, **kw),
                        lambda: (u.clone(), f), errs)
            if coef == "varcoef":
                kw = dict(method="rbgs", sweeps=cfg.pre_sweeps, omega=1.0)
                times[("smooth_var", n)] = (
                    time_ms(lambda: ksv.multisweep_var(st, u, f, **kw)),
                    time_ms(lambda: ks.multisweep_plain(st, u, f, **kw)))
    for name in ("varcoef", "east_robin", "west_north_neumann"):
        levels = hier[name]
        sides = levels[0].spec.dirichlet_sides
        for lev in levels[:3]:
            n, st, nc = lev.grid.nx, lev.stencil, (lev.grid.nx - 1) // 2 + 1
            u, f = field((n, n)), field((n, n), 1e3)
            compare("residual_restrict_var", f"{name} {n}->{nc}",
                    lambda a, b: kx.residual_restrict_var(st, a, b,
                                                          sides=sides),
                    lambda a, b: kx.residual_restrict_plain(st, a, b,
                                                            sides=sides),
                    lambda: (u, f), errs)
            if name == "varcoef":
                times[("residual_restrict_var", n)] = (
                    time_ms(lambda: kx.residual_restrict_var(st, u, f)),
                    time_ms(lambda: kx.residual_restrict_plain(st, u, f)))
            if name == "east_robin":
                ec = field((nc, nc))
                compare("prolong_correct", f"east_robin sides {nc}->{n}",
                        lambda a, b: kx.prolong_correct(a, b, sides=sides),
                        lambda a, b: kx.prolong_correct_plain(a, b,
                                                              sides=sides),
                        lambda: (ec, u.clone()), errs)
                times[("prolong_correct_sides", n)] = (
                    time_ms(lambda: kx.prolong_correct(ec, u, sides=sides)),
                    time_ms(lambda: kx.prolong_correct_plain(ec, u,
                                                             sides=sides)))
    tail_kw = dict(pre=cfg.pre_sweeps, post=cfg.post_sweeps, omega=cfg.omega,
                   method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
                   symmetric=cfg.symmetric)
    for coef in ("varcoef", "jump"):
        tail = [lev for lev in hier[coef] if lev.grid.nx <= 129]
        sts = [lev.stencil for lev in tail]
        shapes = [lev.grid.shape for lev in tail]
        f = field(shapes[0], 1e3)
        u0 = torch.zeros(shapes[0], device=dev)
        compare("tail_vcycle_var", f"{coef} 129^2 L={len(tail)}",
                lambda a, b: kt.tail_vcycle_var(sts, a, b, shapes=shapes,
                                                **tail_kw),
                lambda a, b: kt.tail_vcycle_plain(sts, a, b, shapes=shapes,
                                                  **tail_kw),
                lambda: (u0.clone(), f), errs)
        if coef == "varcoef":
            times[("tail_vcycle_var", 129)] = (
                time_ms(lambda: kt.tail_vcycle_var(
                    sts, u0.clone(), f, shapes=shapes, **tail_kw)),
                time_ms(lambda: kt.tail_vcycle_plain(
                    sts, u0.clone(), f, shapes=shapes, **tail_kw)))
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^2: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return errs, times


def solve_var(mg, name, prob, backend, dev):
    """solve_poisson(precision='fp32', tol 1e-9) on one problem; checks
    the JAX reference's outer-step count and l2 error."""
    import torch

    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend=backend)
    res = mg.solve_poisson(prob, precision="fp32", cfg=cfg, device=dev)
    print(f"solve_var {name} {N_VAR}^2 {backend}: iterations "
          f"{res.iterations} converged {res.converged} history "
          f"{res.info['history'].tolist()} errors {res.errors} solve "
          f"{res.solve_time * 1e3:.3f} ms (first call)")
    if tuple(res.u.shape) != (N_VAR, N_VAR) or \
            not torch.isfinite(res.u).all():
        fail(f"{name} solution is misshapen or not finite")
    if not res.converged or abs(res.iterations - VAR_STEPS[name]) > \
            VAR_STEPS_SLACK[name]:
        fail(f"{name} {backend}: expected convergence in {VAR_STEPS[name]} "
             f"+- {VAR_STEPS_SLACK[name]} outer steps")
    if name == "varcoef" and abs(res.errors["l2"] / VAR_L2[name] - 1) > \
            L2_RTOL:
        fail(f"varcoef l2 error {res.errors['l2']:.4e} not within "
             f"{L2_RTOL:.0%} of {VAR_L2[name]:.4e}")
    if name == "robin" and res.errors["l2"] > ROBIN_L2_FACTOR * VAR_L2[name]:
        fail(f"robin l2 error {res.errors['l2']:.4e} above "
             f"{ROBIN_L2_FACTOR} x {VAR_L2[name]:.4e}")
    return res


def timed_solves_var(mg, prob, backend, dev) -> float:
    """Min over REPEATS of one solve_poisson call's wall time (the
    hierarchy set-up included), after a warm-up."""
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend=backend)
    best = float("inf")
    for r in range(REPEATS + 1):  # r = 0 is the warm-up
        res = mg.solve_poisson(prob, precision="fp32", cfg=cfg, device=dev)
        if not res.converged:
            fail(f"timed {prob.name} solve (backend={backend}) did not "
                 "converge")
        if r > 0:
            best = min(best, res.solve_time)
    return best


def var_path(mg, card, dev):
    """Phases 11-14; returns the kernels' errors, times and launch counts
    (H, I, J summed over the three kernel-path solves)."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth_var as ksv, tail as kt, transfer as kx

    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    errs, times = kernel_phase_var(mg, cfg, dev)
    wrappers = {"smooth_var": ksv.multisweep_var,
                "residual_restrict_var": kx.residual_restrict_var,
                "prolong_correct": kx.prolong_correct,
                "tail_vcycle_var": kt.tail_vcycle_var}
    expected = {"varcoef": set(wrappers), "jump": set(wrappers),
                "robin": {"residual_restrict_var", "prolong_correct"}}
    launches = dict.fromkeys(("smooth_var", "residual_restrict_var",
                              "tail_vcycle_var"), 0)
    results = {}
    for name, prob in var_problems(mg).items():
        for w in wrappers.values():
            w.launches = 0
        results[name] = solve_var(mg, name, prob, "auto", dev)
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"solve_var {name} auto launches {counts}")
        missing = [k for k in expected[name] if counts[k] <= 0]
        if missing:
            fail(f"kernels never launched on the {name} solve: {missing}")
        for k in launches:
            launches[k] += counts[k]
    for name, prob in var_problems(mg).items():
        res_p = solve_var(mg, name, prob, "torch", dev)
        u_k = results[name].u
        du = (u_k - res_p.u).abs().max().item()
        scale = res_p.u.abs().max().item()
        print(f"solve_var {name}: max|u_auto - u_torch| {du:.3e} "
              f"(max|u| {scale:.3e})")
        if res_p.iterations != results[name].iterations or \
                du > VAR_PATH_RTOL * scale:
            fail(f"{name}: kernel and plain paths disagree (iterations "
                 f"{results[name].iterations} vs {res_p.iterations}, max "
                 f"diff {du:.3e} > {VAR_PATH_RTOL} * {scale:.3e})")
    del results
    torch.cuda.empty_cache()
    dofs = (N_VAR - 2) ** 2
    for name, prob in var_problems(mg).items():
        t_k = timed_solves_var(mg, prob, "auto", dev)
        t_p = timed_solves_var(mg, prob, "torch", dev)
        for label, t in (("kernels (auto)", t_k), ("plain (torch)", t_p)):
            print(f"solve_var time {name} {N_VAR}^2 {label}: "
                  f"{t * 1e3:.3f} ms per solve, {dofs / t:.6e} DoF/s "
                  f"[{card}]")
    jump = var_problems(mg)["jump"]
    profile_solve(f"{jump.name} {N_VAR}^2", lambda: mg.solve_poisson(
        jump, precision="fp32", cfg=cfg, device=dev), wrappers)
    return errs, times, launches


def kernel_phase_parity(levels, card, dev):
    """Phase 15: K, L and M against their twins; A, K and L in turns at
    1025^2; the copy's bandwidth. Returns errors, times, library times."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking \
        import kernel_microbench as kb
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import \
        planes as pln
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_planes as kp

    rng = np.random.default_rng(97531)

    def field(n, scale=1.0):
        a = np.zeros((n, n), np.float32)
        a[1:-1, 1:-1] = scale * rng.standard_normal((n - 2, n - 2))
        return torch.from_numpy(a).to(dev)

    by_n = {lev.grid.nx: lev for lev in levels}
    errs, times, library = {}, {}, {}
    for n in (1025, 513):
        st = by_n[n].stencil
        up, fp = pln.split_field(field(n)), pln.split_field(field(n, st.c))
        for omega in (1.0, 1.3):
            kw = dict(nx=n, ny=n, sweeps=2, omega=omega)
            compare("smooth_planes", f"{n}^2 planes omega {omega}",
                    lambda a, b: kp.multisweep_planes(st, a, b, **kw),
                    lambda a, b: kp.multisweep_planes_plain(st, a, b, **kw),
                    lambda: (up.clone(), fp), errs, exact=True)
        kw = dict(nx=n, ny=n, sweeps=2)
        times[("smooth_planes", n)] = (
            time_ms(lambda: kp.multisweep_planes(st, up, fp, **kw)),
            time_ms(lambda: kp.multisweep_planes_plain(st, up, fp, **kw)))
    for n in (1025, 513, 257):
        st = by_n[n].stencil
        u, f = field(n), field(n, st.c)
        for sweeps, omega in ((1, 1.0), (2, 1.0), (3, 1.0), (2, 1.3)):
            kw = dict(sweeps=sweeps, omega=omega)
            compare("smooth_parity", f"{n}^2 {kw}",
                    lambda a, b: ks.multisweep_parity(st, a, b, **kw),
                    lambda a, b: ks.multisweep_parity_plain(st, a, b, **kw),
                    lambda: (u.clone(), f), errs, exact=True)
            compare("smooth_parity_vs_A", f"{n}^2 {kw}",
                    lambda a, b: ks.multisweep_parity(st, a, b, **kw),
                    lambda a, b: ks.multisweep(st, a, b, layout="direct",
                                               **kw),
                    lambda: (u.clone(), f), errs, exact=True)
        times[("smooth_parity", n)] = (
            time_ms(lambda: ks.multisweep_parity(st, u, f)),
            time_ms(lambda: ks.multisweep_parity_plain(st, u, f)))
    for n in (513, 1025):
        u, f = field(n), field(n)
        for mode in kb.MODES:
            compare("probe", f"{mode} {n}^2",
                    lambda a, b: kb.probe(a, b, mode=mode),
                    lambda a, b: kb.probe_plain(a, b, mode=mode),
                    lambda: (u, f), errs, exact=True)
            times[(f"probe_{mode}", n)] = (
                time_ms(lambda: kb.probe(u, f, mode=mode)),
                time_ms(lambda: kb.probe_plain(u, f, mode=mode)))
        compare("copy", f"{n}^2", kb.copy2x, kb.copy2x_plain, lambda: (u,),
                errs, exact=True)
        times[("copy", n)] = (time_ms(lambda: kb.copy2x(u)),
                              time_ms(lambda: kb.copy2x_plain(u)))
        library[("copy", n)] = time_ms(lambda: torch.mul(u, 2.0))
        up, fp = pln.split_field(u), pln.split_field(f)
        compare("smooth_planes", f"parity probe (c = 4) {n}^2",
                lambda a, b: kb.parity(a, b, nx=n, ny=n),
                lambda a, b: kp.multisweep_planes_plain(
                    kb.PROBE_STENCIL, a, b, nx=n, ny=n),
                lambda: (up.clone(), fp), errs, exact=True)
        times[("parity_probe", n)] = (
            time_ms(lambda: kb.parity(up, fp, nx=n, ny=n)),
            time_ms(lambda: kp.multisweep_planes_plain(
                kb.PROBE_STENCIL, up, fp, nx=n, ny=n)))
    # A, K and L per 2-sweep call at 1025^2, in turns (A K L L K A)
    st = by_n[N].stencil
    u, f = field(N), field(N, st.c)
    up, fp = pln.split_field(u), pln.split_field(f)
    calls = {"A": lambda: ks.multisweep(st, u, f, layout="direct"),
             "K": lambda: kp.multisweep_planes(st, up, fp, nx=N, ny=N),
             "L": lambda: ks.multisweep_parity(st, u, f)}
    turns = {name: [] for name in calls}
    for name in ("A", "K", "L", "L", "K", "A"):
        turns[name].append(time_ms(calls[name], reps=50))
    print("turns at 1025^2, ms per 2-sweep call: " + ", ".join(
        f"{name} {np.mean(t):.4f} ({t[0]:.4f}, {t[1]:.4f})"
        for name, t in turns.items()) + f" [{card}]")
    big = torch.randn(N_COPY_HBM, N_COPY_HBM, device=dev)
    rates = {}
    for label, arr in ((f"{N}^2", u), (f"{N_COPY_HBM}^2", big)):
        t_k = time_ms(lambda: kb.copy2x(arr), reps=50)
        t_l = time_ms(lambda: torch.mul(arr, 2.0), reps=50)
        nbytes = 2 * arr.numel() * 4
        rates[label] = nbytes / (t_k * 1e-3)
        print(f"copy bandwidth {label} fp32 (read + write {nbytes / 1e6:.1f}"
              f" MB): kernel M {t_k:.4f} ms, {rates[label] / 1e9:.1f} GB/s; "
              f"torch.mul {t_l:.4f} ms, {nbytes / t_l / 1e6:.1f} GB/s "
              f"[{card}]")
    del big
    torch.cuda.empty_cache()
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^2: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
              + (f", library {library[(name, n)]:.4f} ms"
                 if (name, n) in library else ""))
    return errs, times, library, rates[f"{N_COPY_HBM}^2"]


def parity_main_path(mg, levels, prob, cfg, f, u_direct, card, dev):
    """Phase 16: the main path with PARITY_DEFAULT on; returns L's
    launches."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, tail as kt, transfer as kx

    wrappers = {"smooth_multisweep": ks.multisweep,
                "smooth_parity": ks.multisweep_parity,
                "residual_restrict": kx.residual_restrict,
                "prolong_correct": kx.prolong_correct,
                "tail_vcycle": kt.tail_vcycle}
    ks.PARITY_DEFAULT = True
    try:
        for w in wrappers.values():
            w.launches = 0
        u, info = solve(mg, levels, prob, cfg, f, dev)
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrappers.items()}
        t = timed_solves(mg, levels, prob, cfg, dev)
    finally:
        ks.PARITY_DEFAULT = False
    du = (u - u_direct).abs().max().item()
    print(f"solve auto, parity layout: iterations {info['iterations']} "
          f"history {info['history'].tolist()} launches {launches} "
          f"max|u_parity - u_direct| {du:.3e}; {t * 1e3:.3f} ms per solve, "
          f"{(N - 2) ** 2 / t:.6e} DoF/s [{card}]")
    if launches["smooth_parity"] <= 0 or launches["smooth_multisweep"] != 0:
        fail("the parity-layout main path must launch L and not A")
    if not info["converged"] or info["iterations"] != ITERS_EXPECTED:
        fail(f"parity main path: expected convergence in {ITERS_EXPECTED} "
             "outer steps")
    if du != 0.0:
        fail(f"parity main path differs from the direct layout ({du:.3e}): "
             "L and A round every operation alike, so they must agree")
    return launches["smooth_parity"]


def microbench_path(card):
    """Phase 17: the microbenchmark, from launch counts reset to zero;
    returns the probe's and the copy's launches."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking \
        import kernel_microbench as kb

    kb.probe.launches = kb.copy2x.launches = 0
    rows = kb.run(sizes=(513, 1025), sweeps=2, reps=20)
    launches = {"probe": kb.probe.launches, "copy": kb.copy2x.launches}
    for n, row in rows.items():
        print(f"microbench {n}^2 (us per sweep; copy us per call) "
              + ", ".join(f"{k} {v:.3f}" for k, v in row.items())
              + f" [{card}]")
    print(f"microbench launches {launches}")
    if min(launches.values()) <= 0:
        fail(f"the microbenchmark did not launch kernel M: {launches}")
    return launches


def plane_path(mg, card, dev):
    """Phases 18-19: plane_ir_solve at 1025^2; returns K's launches."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_planes as kp, tail as kt, \
        transfer as kx

    prob = mg.poisson_mms_sinsin(N)
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend="auto")
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                                device=dev, cfg=cfg)
    f = prob.rhs(torch.float64, dev)
    u0 = prob.initial_guess(torch.float64, dev)
    wrappers = {"smooth_planes": kp.multisweep_planes,
                "smooth_multisweep": ks.multisweep,
                "residual_restrict": kx.residual_restrict,
                "prolong_correct": kx.prolong_correct,
                "tail_vcycle": kt.tail_vcycle}
    for w in wrappers.values():
        w.launches = 0
    u, info = mg.plane_ir_solve(levels, f, u0, cfg, inner_cycles=2)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    err = prob.error_norms(u)
    print(f"plane solve auto: iterations {info['iterations']} converged "
          f"{info['converged']} history {info['history'].tolist()} l2 "
          f"{err['l2']:.6e} linf {err['linf']:.6e} launches {launches}")
    if tuple(u.shape) != (N, N) or not torch.isfinite(u).all():
        fail("plane solve: solution is misshapen or not finite")
    if not info["converged"] or info["iterations"] != PLANE_ITERS_EXPECTED:
        fail(f"plane solve: expected convergence in {PLANE_ITERS_EXPECTED} "
             "outer steps (the JAX reference's count)")
    if abs(err["l2"] / L2_EXPECTED - 1) > L2_RTOL:
        fail(f"plane solve: l2 error {err['l2']:.4e} not within "
             f"{L2_RTOL:.0%} of {L2_EXPECTED:.3e}")
    missing = [name for name, c in launches.items() if c <= 0]
    if missing:
        fail(f"kernels never launched on the plane solve: {missing}")
    u_p, info_p = mg.plane_ir_solve(levels, f, u0, cfg.replace(
        backend="torch"), inner_cycles=2)
    u_s, info_s = mg.ir_solve(levels, f, u0, cfg, inner_cycles=2,
                              use_fmg=False)
    torch.cuda.synchronize()
    for label, (u_o, info_o) in (("plane torch", (u_p, info_p)),
                                 ("standard ir_solve no FMG",
                                  (u_s, info_s))):
        du = (u - u_o).abs().max().item()
        print(f"plane solve vs {label}: iterations {info_o['iterations']} "
              f"history {info_o['history'].tolist()} max|du| {du:.3e}")
        if info_o["iterations"] != info["iterations"] or \
                du > PLANE_PATH_ATOL:
            fail(f"plane solve disagrees with the {label} solve "
                 f"(iterations {info['iterations']} vs "
                 f"{info_o['iterations']}, max|du| {du:.3e} > "
                 f"{PLANE_PATH_ATOL})")
    del u_p, u_s
    runs = {"plane": lambda: mg.plane_ir_solve(levels, f, u0, cfg,
                                               inner_cycles=2),
            "standard": lambda: mg.ir_solve(levels, f, u0, cfg,
                                            inner_cycles=2, use_fmg=False)}
    best = dict.fromkeys(runs, float("inf"))
    for r in range(REPEATS + 1):  # r = 0 is the warm-up
        for name in (("plane", "standard") if r % 2 else
                     ("standard", "plane")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            if r > 0:
                best[name] = min(best[name], time.perf_counter() - t0)
    dofs = (N - 2) ** 2
    for name, t in best.items():
        print(f"solve time {name} no-FMG IR {N}^2: {t * 1e3:.3f} ms per "
              f"solve, {dofs / t:.6e} DoF/s [{card}]")
    k_planes = launches["smooth_planes"]
    profile_solve(f"plane solve {N}^2", runs["plane"], wrappers)
    return k_planes


def vcycle_flops(sizes, pre=2, post=2, coarse=32, update=12):
    """fp32 operations of one V(pre, post) cycle over square levels
    ``sizes``: ``update`` per smoothing update, 10 per fine residual, 12 per
    restricted node, 3 per prolonged node, ``coarse`` sweeps at the
    coarsest."""
    ops = coarse * update * (sizes[-1] - 2) ** 2
    for n, nc in zip(sizes, sizes[1:]):
        ops += ((pre + post) * update + 10 + 3) * (n - 2) ** 2 \
            + 12 * (nc - 2) ** 2
    return ops


def work(name):
    """(compulsory bytes, fp32 operations) of one call of kernel ``name``
    at its main-path shapes: each input read once, each output written
    once; the operations this call's data needs."""
    n, nc = N, (N - 1) // 2 + 1
    m, mc = N3, (N3 - 1) // 2 + 1
    tail = [129]
    while tail[-1] > 3:
        tail.append((tail[-1] - 1) // 2 + 1)
    hx = (N + 1) // 2
    return {
        "smooth_multisweep": (12 * n * n, 12 * 2 * (n - 2) ** 2),
        "residual_restrict": (8 * n * n + 4 * nc * nc,
                              10 * (n - 2) ** 2 + 12 * (nc - 2) ** 2),
        "prolong_correct": (4 * nc * nc + 8 * n * n, 3 * (n - 2) ** 2),
        "tail_vcycle": (12 * 129 ** 2, vcycle_flops(tail)),
        "smooth_var": (32 * n * n, 12 * 2 * (n - 2) ** 2),
        "residual_restrict_var": (28 * n * n + 4 * nc * nc,
                                  10 * (n - 2) ** 2 + 12 * (nc - 2) ** 2),
        "tail_vcycle_var": (12 * 129 ** 2 + 20 * sum(k * k for k in tail),
                            vcycle_flops(tail)),
        "rbgs3d": (12 * m ** 3, 16 * 2 * (m - 2) ** 3),
        "residual_restrict3d": (8 * m ** 3 + 4 * mc ** 3,
                                14 * (m - 2) ** 3 + 30 * (mc - 2) ** 3),
        "prolong_correct3d": (4 * mc ** 3 + 8 * m ** 3, 4 * (m - 2) ** 3),
        "smooth_planes": (12 * 4 * hx * hx, 12 * 2 * (n - 2) ** 2),
        "smooth_parity": (12 * n * n, 12 * 2 * (n - 2) ** 2),
        "probe": (12 * n * n, 5 * 2 * (n - 2) ** 2),
        "copy": (8 * n * n, n * n),
    }[name]


def bound(name):
    """(least ms for kernel ``name``'s call at the published peaks, what
    bounds it)."""
    nbytes, flops = work(name)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import mixed_precision_multigrid_solvers_for_pdes_torch as mg
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build, smooth as ks, smooth3d as ks3, tail as kt, \
        transfer as kx, transfer3d as kx3

    card = host_report()
    print(card)

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {'nvcc' if lib.built else 'reused'} "
          f"{lib.build_seconds:.2f} s (first use {time.perf_counter() - t0:.2f}"
          f" s incl. load) -> {lib.path}")
    print(lib.log.strip())

    dev = torch.device("cuda", 0)
    prob = mg.poisson_mms_sinsin(N)
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             max_iterations=40, backend="auto")
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                                device=dev, cfg=cfg)
    errs, times = kernel_phase(levels, cfg, dev)

    wrappers = {"smooth_multisweep": ks.multisweep,
                "residual_restrict": kx.residual_restrict,
                "prolong_correct": kx.prolong_correct,
                "tail_vcycle": kt.tail_vcycle}
    f = prob.rhs(torch.float64, dev)
    for w in wrappers.values():
        w.launches = 0
    u_k, info_k = solve(mg, levels, prob, cfg, f, dev)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    err_k = prob.error_norms(u_k)
    print(f"solve auto: iterations {info_k['iterations']} converged "
          f"{info_k['converged']} history {info_k['history'].tolist()} "
          f"l2 {err_k['l2']:.6e} linf {err_k['linf']:.6e} "
          f"launches {launches}")
    if tuple(u_k.shape) != (N, N) or not torch.isfinite(u_k).all():
        fail("solution is misshapen or not finite")
    if not info_k["converged"] or info_k["iterations"] != ITERS_EXPECTED:
        fail(f"expected convergence in {ITERS_EXPECTED} outer steps")
    if abs(err_k["l2"] / L2_EXPECTED - 1) > L2_RTOL:
        fail(f"l2 error {err_k['l2']:.4e} not within {L2_RTOL:.0%} of "
             f"{L2_EXPECTED:.3e}")
    missing = [name for name, c in launches.items() if c <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    cfg_plain = cfg.replace(backend="torch")
    u_p, info_p = solve(mg, levels, prob, cfg_plain, f, dev)
    torch.cuda.synchronize()
    du = (u_k - u_p).abs().max().item()
    print(f"solve torch: iterations {info_p['iterations']} history "
          f"{info_p['history'].tolist()} max|u_auto - u_torch| {du:.3e}")
    if info_p["iterations"] != info_k["iterations"] or du > PATH_ATOL:
        fail(f"kernel and plain paths disagree (iterations "
             f"{info_k['iterations']} vs {info_p['iterations']}, "
             f"max diff {du:.3e} > {PATH_ATOL})")

    dofs = (N - 2) ** 2
    t_k = timed_solves(mg, levels, prob, cfg, dev)
    t_p = timed_solves(mg, levels, prob, cfg_plain, dev)
    for label, t in (("kernels (auto)", t_k), ("plain (torch)", t_p)):
        print(f"solve time {label}: {t * 1e3:.3f} ms per solve, "
              f"{dofs / t:.6e} DoF/s [{card}]")

    # ---- parity paths: kernels K, L and M -------------------------------
    errs_par, times_par, library, copy_rate = kernel_phase_parity(
        levels, card, dev)
    errs.update(errs_par)
    times.update(times_par)
    launches["smooth_parity"] = parity_main_path(mg, levels, prob, cfg, f,
                                                 u_k, card, dev)
    del u_k, u_p, f, levels
    torch.cuda.empty_cache()
    launches.update(microbench_path(card))
    launches["smooth_planes"] = plane_path(mg, card, dev)
    torch.cuda.empty_cache()

    # ---- variable-coefficient and Robin path -----------------------------
    errs_var, times_var, launches_var = var_path(mg, card, dev)
    for name, err in errs_var.items():
        errs[name] = max(errs.get(name, 0.0), err)
    times.update(times_var)
    launches.update(launches_var)
    torch.cuda.empty_cache()

    # ---- 3D path ----------------------------------------------------------
    errs3, times3 = kernel_phase3d(dev)
    errs.update(errs3)
    times.update(times3)
    wrappers3 = {"rbgs3d": ks3.rbgs3d,
                 "residual_restrict3d": kx3.residual_restrict3d,
                 "prolong_correct3d": kx3.prolong_correct3d}
    solve3d(mg, N3_REF, "auto", dev)
    for w in wrappers3.values():
        w.launches = 0
    res_k, peak_k = solve3d(mg, N3, "auto", dev)
    launches3 = {name: w.launches for name, w in wrappers3.items()}
    print(f"solve3d {N3}^3 auto launches {launches3}")
    missing = [name for name, c in launches3.items() if c <= 0]
    if missing:
        fail(f"kernels never launched on the 3D path: {missing}")
    launches.update(launches3)
    res_p, peak_p = solve3d(mg, N3, "torch", dev)
    du = (res_k.u - res_p.u).abs().max().item()
    print(f"solve3d {N3}^3: max|u_auto - u_torch| {du:.3e}; peak memory "
          f"kernel path {peak_k / 2**30:.3f} GiB, plain path "
          f"{peak_p / 2**30:.3f} GiB")
    if res_p.iterations != res_k.iterations or du > PATH3D_ATOL:
        fail(f"3D kernel and plain paths disagree (iterations "
             f"{res_k.iterations} vs {res_p.iterations}, max diff "
             f"{du:.3e} > {PATH3D_ATOL})")
    del res_k, res_p
    torch.cuda.empty_cache()

    cfg3 = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                              backend="auto")
    levels3 = mg.build_hierarchy3d(mg.Grid3D(N3, N3, N3), dtype="float32",
                                   device=dev, cfg=cfg3)
    dofs3 = (N3 - 2) ** 3
    t3_k = timed_solves3d(mg, levels3, cfg3, K3, dev)
    t3_p = timed_solves3d(mg, levels3, cfg3.replace(backend="torch"),
                          K3_PLAIN, dev)
    for label, t in (("kernels (auto)", t3_k), ("plain (torch)", t3_p)):
        print(f"solve3d time {N3}^3 {label}: {t * 1e3:.3f} ms per solve, "
              f"{dofs3 / t:.6e} DoF/s [{card}]")
    f3 = rhs3d(levels3, 0, 0, 1, dev)
    u03 = torch.zeros_like(f3)
    profile_solve(f"3D {N3}^3", lambda: mg.ir_solve3d(
        levels3, f3, u03, cfg3, inner_cycles=2), wrappers3)

    sources = {"smooth_multisweep": ("csrc/smooth.cu", "smooth.py:290"),
               "residual_restrict": ("csrc/transfer.cu", "transfer.py:262"),
               "prolong_correct": ("csrc/transfer.cu", "transfer.py:488"),
               "tail_vcycle": ("csrc/tail.cu", "tail.py:170"),
               "smooth_var": ("csrc/smooth_var.cu", "smooth.py:290"),
               "residual_restrict_var": ("csrc/transfer_var.cu",
                                         "transfer.py:262"),
               "tail_vcycle_var": ("csrc/tail_var.cu", "tail.py:122"),
               "rbgs3d": ("csrc/smooth3d.cu", "smooth3d.py:178"),
               "residual_restrict3d": ("csrc/transfer3d.cu",
                                       "transfer3d.py:194"),
               "prolong_correct3d": ("csrc/transfer3d.cu",
                                     "transfer3d.py:342"),
               "smooth_planes": ("csrc/smooth_planes.cu",
                                 "smooth_planes.py:225"),
               "smooth_parity": ("csrc/smooth_parity.cu", "smooth.py:119"),
               "probe": ("csrc/probes.cu",
                         "scripts/kernel_microbench.py:108"),
               "copy": ("csrc/probes.cu", "scripts/kernel_microbench.py:123")}
    main_n = {"smooth_multisweep": 1025, "residual_restrict": 1025,
              "prolong_correct": 1025, "tail_vcycle": 129,
              "smooth_var": N_VAR, "residual_restrict_var": N_VAR,
              "tail_vcycle_var": 129, "rbgs3d": N3,
              "residual_restrict3d": N3, "prolong_correct3d": N3,
              "smooth_planes": N, "smooth_parity": N, "probe": N, "copy": N}
    timed = {"probe": "probe_roll"}  # the record times the 5-point probe
    record = []
    for name, (src, rep) in sources.items():
        key = (timed.get(name, name), main_n[name])
        bound_ms, bound_by = bound(name)
        ms = times[key][0]
        record.append({
            "name": name, "route": "cuda", "source": f"{PKG}/{src}",
            "replaces": rep if rep.startswith("scripts/")
            else f"{TPU_PKG}/{rep}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": times[key][1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library.get(key)})
        nbytes = work(name)[0]
        print(f"bound {name}: {nbytes / 1e6:.3f} MB, {bound_ms:.5f} ms at "
              f"3.35 TB/s ({bound_by}), {nbytes / copy_rate * 1e3:.5f} ms at "
              f"the measured copy rate; kernel {ms:.4f} ms, the bound is "
              f"{bound_ms / ms:.1%} of it [{card}]")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
