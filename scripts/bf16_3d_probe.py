"""Kernels E and F on bf16 storage against fp32, for one tree of the port.

Builds the kernel library of the tree given (the root of a checkout, or an
unpacked commit: ``git archive <commit> | tar -x -C DIR``), prints the ptxas
report (registers, spills) of E's 2-sweep wave kernel and of F, and with
``--checks`` holds E and F on bf16 storage against their twins bit for bit:
nz even and odd, 513^3, u and f views at storage offsets 0 and 1 (a field
that starts in the upper half of a 4-byte word), E's multi-launch storages
and an fp32 u with a bf16 f, F's fp32 -> bf16 and bf16 -> fp32 crossings.
Then it times E's 2-sweep call and F's 513^3 -> 257^3 call on bf16 and on
fp32 storage at 513^3: CUDA events over 20 back-to-back calls after a
warm-up, the minimum of 3 such loops, printed as one JSON line with the
card's name and power limit. With ``--sass FILE`` it writes the SASS of
those kernels (cuobjdump) to FILE. Run it on the trees to compare one after
another in one process per tree (parent, change, change, parent), on one
card.

With ``--2d`` it prints the ptxas report (and with ``--sass FILE`` writes
the SASS) of the 2D kernels H and L as the 1025^2 paths launch them, and
stops: H's RB-GS kernel at its 32 x 64 tiles (1025^2, 513^2) and 8 x 64
tiles (257^2), L's 2-sweep kernel at 64 x 64, 32 x 64 and 8 x 64, each on
fp32 and on bf16 storage. Their checks and times are ``chip_smoke.py``'s
(phase 32, ``--against``).

Usage, on a host with a CUDA card:

    python3 scripts/bf16_3d_probe.py TREE [--checks] [--sass FILE]
    python3 scripts/bf16_3d_probe.py TREE --2d [--sass FILE]
"""

import json
import os
import re
import subprocess
import sys

KERNELS = ("rbgs3d_wave_kernelILi2ELb1E", "residual_restrict3d_kernel")
# --2d: H's smooth_var_kernel<TX, 64, RB-GS, ...> and L's parity_kernel<TX,
# 64, 2 sweeps, pow2 c, ...>
KERNELS_2D = ("smooth_var_kernelILi32ELi64ELb0E",
              "smooth_var_kernelILi8ELi64ELb0E",
              "parity_kernelILi64ELi64ELi2ELb1E",
              "parity_kernelILi32ELi64ELi2ELb1E",
              "parity_kernelILi8ELi64ELi2ELb1E")


def write_sass(lib, kernels, path) -> None:
    """The SASS of ``kernels`` in the built library (cuobjdump) to path."""
    sass = subprocess.run(
        [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                      "bin", "cuobjdump"), "-sass", str(lib.path)],
        capture_output=True, text=True).stdout
    keep, lines = False, []
    for line in sass.splitlines():
        if "Function : " in line:
            keep = any(k in line for k in kernels)
        if keep:
            lines.append(line)
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def main(argv) -> int:
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    import torch

    import mixed_precision_multigrid_solvers_for_pdes_torch as mg
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import \
        stencil3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build, smooth3d as ks3, transfer3d as kx3

    if not torch.cuda.is_available():
        print("bf16_3d_probe: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(mg.__file__)))
    if os.path.realpath(root) != os.path.realpath(tree):
        print(f"bf16_3d_probe: imported {root}, not {tree}", file=sys.stderr)
        return 1
    lib = _build.library()
    print(f"[{tree}] build {lib.build_seconds:.1f} s")
    kernels = KERNELS_2D if "--2d" in argv else KERNELS
    name = None
    for line in lib.log.splitlines():
        if "Compiling entry" in line:
            name = next((k for k in kernels if k in line), None)
            if name:
                print(re.sub(r".*(_Z\w+).*", r"  \1", line))
        elif name and ("registers" in line or "spill" in line):
            print("   " + line.strip())
    if "--sass" in argv:
        write_sass(lib, kernels, argv[argv.index("--sass") + 1])
    if "--2d" in argv:
        return 0
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(19)

    def field(shape, scale=1.0, dtype=bf, offset=0):
        a = (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)
        buf = torch.empty(a.numel() + offset, dtype=dtype, device=dev)
        v = buf[offset:].view(shape)
        v.copy_(a)
        return v

    bad = []
    if "--checks" in argv:
        for shape in ((37, 66, 70), (33, 34, 131), (513, 513, 513)):
            st = stencil3d.make_stencil3d(mg.Grid3D(*shape))
            for (ou, of), sweeps, ud in (((0, 0), 2, bf), ((1, 0), 2, bf),
                                         ((0, 1), 2, bf), ((1, 1), 5, bf),
                                         ((0, 1), 2, torch.float32)):
                if shape[0] == 513 and sweeps != 2:
                    continue
                u = field(shape, dtype=ud, offset=ou)
                f = field(shape, st.c, offset=of)
                got = ks3.rbgs3d(st, u, f, sweeps=sweeps, omega=1.3)
                ref = ks3.rbgs3d_plain(st, u.clone(), f, sweeps=sweeps,
                                       omega=1.3)
                ok = torch.equal(got, ref)
                print(f"E {shape} u {ud} at {ou}, f at {of}, {sweeps} "
                      f"sweeps: equal {ok}")
                bad += [] if ok else [("E", shape, ou, of, sweeps)]
        for shape in ((37, 69, 131), (11, 9, 7), (513, 513, 513)):
            st = stencil3d.make_stencil3d(mg.Grid3D(*shape))
            for off in (0, 1):
                for tin, tout in ((bf, bf), (bf, torch.float32),
                                  (torch.float32, bf)):
                    u = field(shape, dtype=tin, offset=off)
                    f = field(shape, st.c, dtype=tin, offset=1 - off)
                    ok = torch.equal(
                        kx3.residual_restrict3d(st, u, f, out_dtype=tout),
                        kx3.residual_restrict3d_plain(st, u, f,
                                                      out_dtype=tout))
                    print(f"F {shape} {tin} -> {tout}, u at {off}: "
                          f"equal {ok}")
                    bad += [] if ok else [("F", shape, off, tin, tout)]
            torch.cuda.empty_cache()

    def events_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(3):
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / reps)
        return best

    n = 513
    st = stencil3d.make_stencil3d(mg.Grid3D(n, n, n))
    out = {}
    for label, dt in (("bf16", bf), ("fp32", torch.float32)):
        u, f = field((n,) * 3, dtype=dt), field((n,) * 3, st.c, dtype=dt)
        out[f"E_{label}_ms"] = events_ms(
            lambda: ks3.rbgs3d(st, u, f, sweeps=2))
        out[f"F_{label}_ms"] = events_ms(
            lambda: kx3.residual_restrict3d(st, u, f))
        del u, f
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"tree": tree, "card": card, **out}))
    if bad:
        print(f"bf16_3d_probe: kernel and twin differ: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
