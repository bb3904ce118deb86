"""Precision tiers and dtype names.

Counterpart of ``Precision``, ``as_dtype``, ``PrecisionPolicy`` and
``policy`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/core/precision.py``. The port
has no global dtype switch: every function takes its dtype explicitly, and
float64 is native on the GPU. A ``PrecisionPolicy`` gives each level of a
hierarchy its dtype and holds the thresholds with which
``solvers/refinement.adaptive_solve`` decides, between chunks of cycles,
when to move to a higher precision.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

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


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-level dtypes and the adaptive stages' thresholds (hashable).

    ``mode``: FP64, FP32 or BF16 give every level that dtype; MIXED gives
    the fine half of the hierarchy ``fine`` and the coarse half ``coarse``;
    ADAPTIVE hierarchies are built per stage by ``adaptive_solve``."""

    mode: Precision = Precision.FP32
    fine: Precision = Precision.FP32
    coarse: Precision = Precision.BF16
    # residual thresholds of the upgrade and downgrade tests
    downgrade_factor: float = 100.0
    upgrade_factor: float = 10.0
    convergence_threshold: float = 1e-6
    # stagnation, plateau and growth over the last `stagnation_window` ratios
    stagnation_window: int = 5
    stagnation_ratio: float = 0.9
    plateau_rel_change: float = 1e-3

    def level_dtypes(self, num_levels: int) -> Tuple[torch.dtype, ...]:
        """The dtype of each level, 0 = finest: under MIXED levels below
        max(1, num_levels // 2) take ``fine`` and the rest ``coarse``."""
        if self.mode in (Precision.FP64, Precision.FP32, Precision.BF16):
            return (self.mode.dtype,) * num_levels
        if self.mode == Precision.MIXED:
            half = max(1, num_levels // 2)
            return tuple(self.fine.dtype if lvl < half else self.coarse.dtype
                         for lvl in range(num_levels))
        return (self.fine.dtype,) * num_levels

    def should_promote(self, history: Sequence[float]) -> bool:
        """True on stagnation (mean of the last ``stagnation_window``
        residual ratios above ``stagnation_ratio``), a plateau (relative
        change over the window below ``plateau_rel_change``) or growth
        (every step of the window up)."""
        w = self.stagnation_window
        h = np.asarray(history, dtype=np.float64)
        if h.size < w + 1:
            return False
        recent = h[-(w + 1):]
        ratios = recent[1:] / np.maximum(recent[:-1], 1e-300)
        if np.mean(ratios) > self.stagnation_ratio:
            return True
        rel_change = abs(recent[-1] - recent[0]) / max(recent[0], 1e-300)
        if rel_change < self.plateau_rel_change:
            return True
        return bool(np.all(np.diff(recent) > 0))

    def should_upgrade(self, residual_norm: float) -> bool:
        """Near convergence: move to a higher precision."""
        return residual_norm < self.upgrade_factor * self.convergence_threshold

    def should_downgrade(self, residual_norm: float) -> bool:
        """Far from convergence: a lower precision is safe."""
        return residual_norm > (self.downgrade_factor
                                * self.convergence_threshold)


def policy(mode="fp32", **kwargs) -> PrecisionPolicy:
    """``policy('mixed')``, ``policy(Precision.FP64)``, ..."""
    if isinstance(mode, str):
        mode = Precision(mode)
    return PrecisionPolicy(mode=mode, **kwargs)
