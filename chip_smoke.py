#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

The main path is the solve bench.py times for the JAX package: the 2D
Poisson problem u = sin(pi x) sin(pi y) on a 1025^2 grid, an fp32 level
hierarchy smoothed by red-black Gauss-Seidel V(2,2) cycles, and
mixed-precision iterative refinement (fp64 outer residual, two fp32 cycles
per outer step) from a full-multigrid start, to 1e-9 relative residual.

Phases, each of which must pass:
  1. print the card (nvidia-smi name and power limit) and the host's tools;
  2. build the CUDA kernels from csrc/ with nvcc and print the build time;
  3. hold each kernel against its plain PyTorch twin on the card at the main
     path's shapes, and time both with CUDA events;
  4. solve the main path with backend='auto' (the kernels), from launch
     counts reset to zero, and check the iteration count, the error against
     the exact solution and that every kernel launched;
  5. solve it again with backend='torch' (the plain path on the card) and
     check that both paths agree;
  6. time both paths over 16 frequency-swept right-hand sides as bench.py
     does, and print per-solve ms and DoF/s.
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


def compare(name, shape_label, kernel_fn, plain_fn, make_inputs, errs):
    """Run kernel and twin on identical inputs; record and check the
    difference."""
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
    if err > KERNEL_RTOL * max(scale, 1e-30):
        fail(f"{name} {shape_label}: kernel disagrees with its plain twin "
             f"({err:.3e} > {KERNEL_RTOL} * {scale:.3e})")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import mixed_precision_multigrid_solvers_for_pdes_torch as mg
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build, smooth as ks, tail as kt, transfer as kx

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

    sources = {"smooth_multisweep": ("csrc/smooth.cu", "smooth.py:290"),
               "residual_restrict": ("csrc/transfer.cu", "transfer.py:262"),
               "prolong_correct": ("csrc/transfer.cu", "transfer.py:488"),
               "tail_vcycle": ("csrc/tail.cu", "tail.py:170")}
    main_n = {"smooth_multisweep": 1025, "residual_restrict": 1025,
              "prolong_correct": 1025, "tail_vcycle": 129}
    record = [{"name": name, "route": "cuda",
               "source": f"{PKG}/{src}", "replaces": f"{TPU_PKG}/{rep}",
               "launches": launches[name], "max_abs_err": errs[name],
               "ms": times[(name, main_n[name])][0],
               "plain_ms": times[(name, main_n[name])][1]}
              for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
