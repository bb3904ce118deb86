"""A short run of every cell on the card (skips without one):

    python3 -m pytest --noconftest -q mgbench/tests/test_mgbench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mgbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "mgbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    want = spec.cell_metrics(spec.benchmark(), cell,
                             "per_layer" if trace else "end_to_end")
    assert {m["name"] for m in want} == set(res["metrics"])
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"]


def test_no_card_no_result():
    """Without the cards a cell asks for, a run exits non-zero and prints
    no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "mgbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
