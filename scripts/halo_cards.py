"""chip_smoke.py's phase 34 alone: ``halo_solve`` over NCCL, one spawned
rank per visible card, on the mesh of the whole world.

On a host of one card the world is one rank and the plan splits no level
(S = 0), so ``halo_solve`` is the single-device ``mg_solve`` and the phase
checks only the launch, the NCCL bring-up and the sharded-field plumbing.
Halos cross cards only on a host of several cards: on four, the mesh is
(2, 2) and the 1025^2 solves split six levels (1025^2 to 33^2). The script
prints the card line, the phase's own lines (world size, mesh, sharded
depth S, iterations against ``mg_solve``, the largest difference from its
solution, ``shard_smooth``, ``global_residual_norm``,
``make_sharded_field``) and its wall seconds; it exits non-zero if any
check or rank fails.

Usage, from the root of the repository, on a host with CUDA cards:

    python3 scripts/halo_cards.py
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
    cs.halo_path(card)
    print(f"phase 34 alone on {torch.cuda.device_count()} card(s): "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
