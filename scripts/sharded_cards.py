"""chip_smoke.py's phases 35 and 36 alone, over NCCL, one spawned rank per
visible card, on the mesh of the whole world.

Phase 35 is the 2D GSPMD path at 1025^2 (``sharded_solve``,
``solve_poisson(mesh=)``, MG-preconditioned CG on ``shard_inputs``
vectors); phase 36 the 3D hook and sharded time stepping (513^3 'mixed'
and 257^3 'adaptive' ``solve_poisson3d(mesh=)``, the 513^3 'mixed'
``ir_solve3d`` under ``make_constrainer3d`` on a hierarchy, hook and
``shard_inputs`` blocks made once, a 1025^2 fp32 CN
``solve_heat(mesh=)`` and a 257^3 fp32 CN ``solve_heat3d(mesh=)``).

On a host of one card the world is one rank and no level is split, so the
phases check only the launch, the NCCL bring-up and the plumbing of every
entry point. On four cards the mesh is (2, 2): phase 35 splits six 1025^2
levels (1025^2 to 33^2) along both axes and adds the Poisson fp64
``sharded_solve`` on the graded mesh (xo, xi, yo, yi) = (2, 2, 1, 1);
phase 36 splits five 513^3 levels (513 to 33 along x and y, z whole) and
four 257^3 ones. The runs are on backend 'auto' (kernel A smooths the 2D
fp32 and bf16 levels, kernel E the 3D ones, the split levels on haloed
windows), and each is held on every rank to the same call on a one-rank
mesh, the single-device solve under the hook (counts, solutions, launches
of A, H and E), and in phase 36 to the unhooked single-device kernel path.
The script prints the card line, the phases' own lines (the sharded depth
and tiers, the counts, the largest differences, the launches, rank 0's
first call and the minimum of three more calls, set-up included but in
the 513^3 ``ir_solve3d``, beside
the one-rank, single-device plain and kernel paths') and its wall seconds;
it exits non-zero if any check or rank fails.

Usage, from the root of the repository, on a host with CUDA cards:

    python3 scripts/sharded_cards.py          # phases 35 and 36
    python3 scripts/sharded_cards.py 36       # phase 36 alone
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch

    phases = sys.argv[1:] or ["35", "36"]
    if set(phases) - {"35", "36"}:
        cs.fail(f"unknown phases {phases}; expected 35 and/or 36")
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    t0 = time.perf_counter()
    card = cs.host_report()
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build

    lib = _build.library()  # built once here, loaded by every rank
    print(f"kernels built {lib.built} in {lib.build_seconds:.1f} s")
    if "35" in phases:
        cs.sharded_path(card, graded=True, repeats=3)
    if "36" in phases:
        cs.sharded3d_path(card, repeats=3)
    print(f"phases {', '.join(phases)} alone on {torch.cuda.device_count()} "
          f"card(s): {time.perf_counter() - t0:.1f} s [{card}]")
