"""Solver-state checkpoint/resume.

Counterpart of ``CheckpointManager`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/utils/checkpoint.py``, a
copy of it rather than an import (that module imports JAX): the same file
names (``ckpt_{step:012d}.npz``), atomic writes through a dotfile temp and
a rename, keep-last-k retention and a JSON metadata record stored in the
archive. Each tensor is copied to the host once per save, so the card is
fenced only at checkpoint boundaries.

The port stores fields at their logical shape ((nx, ny), (nx, ny, nz)) and
the JAX package pads them to its tiles, so a checkpoint written by one
package cannot be resumed by the other.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CheckpointManager:
    """Directory of numbered checkpoints: ``ckpt_{step:012d}.npz`` (+ meta)."""

    def __init__(self, directory, *, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:012d}.npz"

    def all_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("ckpt_*.npz"):
            # a name whose tail is not an integer (a stray file) is skipped
            tail = p.stem.split("_", 1)[1]
            if tail.isdigit():
                steps.append(int(tail))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, arrays: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None) -> Path:
        """Atomic save of named arrays (tensors on any device, or numpy)
        and JSON-able metadata."""
        host = {k: _host(v) for k, v in arrays.items()}
        meta = dict(metadata or {})
        meta.setdefault("step", step)
        meta.setdefault("saved_at", time.time())
        path = self._path(step)
        # the dotfile temp never matches the ckpt_*.npz glob, so a crash
        # between write and rename leaves all_steps() intact; np.savez
        # appends ".npz" to bare paths, so it writes through a file handle
        tmp = self.dir / f".ckpt_{step:012d}.npz.tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **host, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8))
        os.replace(tmp, path)
        self._retain()
        return path

    def restore(self, step: Optional[int] = None):
        """Returns (arrays: dict[str, np.ndarray], metadata: dict)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self._path(step)) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = json.loads(bytes(z["__meta__"]).decode()) \
                if "__meta__" in z.files else {}
        return arrays, meta

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            self._path(s).unlink(missing_ok=True)
