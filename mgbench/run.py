"""Run one cell of the port's benchmark and print its result.

    python3 mgbench/run.py --workload poisson3d-513-ir --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; ``breakdown`` with
``--trace 1``; ``checks`` last); the last lines of standard error give
each number that decided ``correct`` beside its limit. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mgbench.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(t_start=T_START))
