"""Kernel N (the 3D float64 refinement step) against its twin and against
the plain step it replaces, for one tree of the port.

Builds the tree's kernel library and prints the ptxas report (registers,
spills) of N's instantiations. With ``--checks`` it holds N against its
twin at 33^3, 65^3, 129^3, 513^3 and 33 x 65 x 17, fp32 and bf16 level
storage, step and start: u_out and r_lo bit for bit, the norms to 1e-13
relative. Then, at 513^3 on fp32 level storage, it times with CUDA events
(20 back-to-back calls after a warm-up, the minimum of 3 loops): N's step
and start, the plain step N replaces (``u[1:-1, 1:-1, 1:-1] += e``, the
fp64 residual, its norm and its cast, as ``ir_solve3d`` ran it), and M's
copy of a 1.08 GB fp32 field (``mg_copy2x``, the card's copy rate). It
prints one JSON line with the card's name and power limit.

Usage, on a host with a CUDA card (run the trees to compare one after
another, one process per tree):

    python3 scripts/refine3d_probe.py TREE [--checks]
"""

import json
import os
import re
import subprocess
import sys

KERNEL = "refine_step3d_kernel"
SHAPES = ((33, 33, 33), (65, 65, 65), (129, 129, 129), (513, 513, 513),
          (33, 65, 17))
NORM_RTOL = 1e-13  # N sums the squares in another order than torch.sum


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main(argv) -> int:
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    import torch

    import mixed_precision_multigrid_solvers_for_pdes_torch as mg
    from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking \
        import kernel_microbench as kmicro
    from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import \
        norms, stencil3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build, refine3d as kr3

    if not torch.cuda.is_available():
        print("refine3d_probe: needs a CUDA card", file=sys.stderr)
        return 1
    lib = _build.library()
    print(f"[{tree}] build {lib.build_seconds:.1f} s")
    ptxas, name = {}, None
    for line in lib.log.splitlines():
        if "Compiling entry" in line:
            name = re.sub(r".*(_Z\w+).*", r"\1", line) if KERNEL in line \
                else None
        elif name and ("registers" in line or "spill" in line):
            ptxas.setdefault(name, []).append(line.strip())
    for k, lines in ptxas.items():
        print(f"  {k}")
        for line in lines:
            print(f"    {line}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(26)

    def inputs(shape, lo):
        g = mg.Grid3D(*shape, (0.0, 1.3, 0.0, 0.7, 0.0, 1.1))
        st = stencil3d.make_stencil3d(g, dtype=lo).astype(torch.float64)
        u = torch.randn(shape, dtype=torch.float64, device=dev,
                        generator=gen)
        e = (1e-3 * torch.randn(shape, device=dev, generator=gen)).to(lo)
        f = st.c * torch.randn(shape, dtype=torch.float64, device=dev,
                               generator=gen)
        return st, (g.hx, g.hy, g.hz), u, e, f

    bad = []
    if "--checks" in argv:
        for shape in SHAPES:
            for lo in (torch.float32, torch.bfloat16):
                st, h, u, e, f = inputs(shape, lo)
                r_lo = torch.empty(shape, dtype=lo, device=dev)
                for mode in ("step", "start"):
                    ee = e if mode == "step" else None
                    got = kr3.refine_step3d(st, u, ee, f, h=h, r_lo=r_lo)
                    ref = kr3.refine_step3d_plain(
                        st, u, ee, f, h=h, r_lo=torch.empty_like(r_lo))
                    torch.cuda.synchronize()
                    same = torch.equal(got[1], ref[1]) and (
                        mode == "start" or torch.equal(got[0], ref[0]))
                    rel = [abs(a.item() - b.item()) / abs(b.item())
                           for a, b in zip(got[2:], ref[2:])
                           if a is not None]
                    ok = same and max(rel) <= NORM_RTOL
                    print(f"N {shape} {lo} {mode}: bit for bit {same}, "
                          f"norms rel {['%.2e' % x for x in rel]}")
                    bad += [] if ok else [(shape, str(lo), mode)]
                del st, u, e, f, r_lo, got, ref
                torch.cuda.empty_cache()

    shape = (513,) * 3
    st, h, u, e, f = inputs(shape, torch.float32)
    out = torch.empty_like(u)
    r_lo = torch.empty(shape, device=dev)
    unknown = bc3d.unknown_mask3d(*shape, device=dev)
    w = u.clone()

    def plain_step():
        w[1:-1, 1:-1, 1:-1] += e[1:-1, 1:-1, 1:-1]
        r = stencil3d.residual(st, w, f, unknown)
        norms.scaled_l2(r, *h)
        r.to(torch.float32)

    def timed(fn, reps=20, loops=3):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(loops):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b) / reps)
        return best

    big = torch.randn(shape, device=dev, generator=gen)
    res = {
        "card": card_line(),
        "N_step_ms": timed(lambda: kr3.refine_step3d(st, u, e, f, h=h,
                                                     out=out, r_lo=r_lo)),
        "N_start_ms": timed(lambda: kr3.refine_step3d(st, u, None, f, h=h,
                                                      r_lo=r_lo)),
        "plain_step_ms": timed(plain_step, reps=5),
        "copy_fp32_513_ms": timed(lambda: kmicro.copy2x(big)),
        "ptxas": ptxas,
        "checks_failed": bad,
    }
    nodes = 513 ** 3
    res["N_step_TBps"] = 32 * nodes / res["N_step_ms"] / 1e9
    res["N_start_TBps"] = 20 * nodes / res["N_start_ms"] / 1e9
    res["copy_TBps"] = 8 * nodes / res["copy_fp32_513_ms"] / 1e9
    print(json.dumps(res))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
