"""chip_smoke.py's phase 35 alone: the GSPMD path (``sharded_solve``,
``solve_poisson(mesh=)``, MG-preconditioned CG on ``shard_inputs``
vectors) over NCCL, one spawned rank per visible card, on the mesh of the
whole world, at 1025^2.

On a host of one card the world is one rank and no level is split, so the
phase checks only the launch, the NCCL bring-up and the plumbing of every
entry point. On four cards the mesh is (2, 2) and the rule splits six
levels (1025^2 to 33^2) along both axes; the script adds the Poisson fp64
``sharded_solve`` on the graded mesh (xo, xi, yo, yi) = (2, 2, 1, 1)
(1025^2 to 65^2 over four blocks along x, 33^2 over two, each held by a
pair of cards). The solves run on backend 'auto' (kernel A smooths the
fp32 and bf16 levels, the split ones on haloed windows), and each is held
on every rank to the same call on a one-rank mesh, the single-device solve
under the hook (iterations, solutions, launches of A and H). The script
prints the card line, the phase's own lines (the sharded depth and tiers,
the iterations, the largest differences, the launches, rank 0's first call
and the minimum of three more calls, set-up included, beside the one-rank,
single-device plain and kernel paths') and its wall seconds; it exits
non-zero if any check or rank fails.

Usage, from the root of the repository, on a host with CUDA cards:

    python3 scripts/sharded_cards.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    t0 = time.perf_counter()
    card = cs.host_report()
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build

    lib = _build.library()  # built once here, loaded by every rank
    print(f"kernels built {lib.built} in {lib.build_seconds:.1f} s")
    cs.sharded_path(card, graded=True, repeats=3)
    print(f"phase 35 alone on {torch.cuda.device_count()} card(s): "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
