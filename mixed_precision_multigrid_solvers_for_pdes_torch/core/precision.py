"""Precision tiers and dtype names.

Counterpart of ``Precision`` and ``as_dtype`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/core/precision.py``. The port
has no global dtype switch: every function takes its dtype explicitly, and
float64 is native on the GPU. ``PrecisionPolicy`` and adaptive staging are
ROADMAP item 9.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class Precision(enum.Enum):
    """Named precision tiers."""

    BF16 = "bf16"
    FP32 = "fp32"
    FP64 = "fp64"
    MIXED = "mixed"        # fp32 fine levels, bf16 coarse levels
    ADAPTIVE = "adaptive"  # staged promotion bf16/fp32 -> fp32/fp64

    @property
    def dtype(self) -> torch.dtype:
        return {
            Precision.BF16: torch.bfloat16,
            Precision.FP32: torch.float32,
            Precision.FP64: torch.float64,
        }.get(self, torch.float32)


_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "float32": torch.float32,
    "single": torch.float32,
    "fp64": torch.float64,
    "float64": torch.float64,
    "double": torch.float64,
}


def as_dtype(p) -> torch.dtype:
    """Map a Precision, a dtype name, a numpy dtype or a torch dtype to a
    torch dtype."""
    if isinstance(p, Precision):
        return p.dtype
    if isinstance(p, torch.dtype):
        return p
    if isinstance(p, str):
        return _DTYPES[p.lower()]
    return _DTYPES[np.dtype(p).name]
