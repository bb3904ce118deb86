"""Preconditioner combinators: identity, composite and the adaptive
switcher.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/
preconditioning/base.py``: preconditioners are plain callables z = M(r).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


def identity() -> Callable:
    """M = I."""

    def apply(r):
        return r

    return apply


def composite(*ms: Callable) -> Callable:
    """Multiplicative composition z = M_k(...M_1(r)): each stage refines
    the previous stage's output."""

    def apply(r):
        z = r
        for m in ms:
            z = m(z)
        return z

    return apply


class AdaptivePreconditioner:
    """Host-side switcher: watches the convergence rate of recent
    iterations and moves to the next candidate when progress stalls. Use it
    between Krylov runs; the active preconditioner is fixed within one."""

    def __init__(self, candidates: Sequence[Callable], window: int = 5,
                 stall_ratio: float = 0.9):
        if not candidates:
            raise ValueError("need at least one candidate")
        self.candidates: List[Callable] = list(candidates)
        self.active = 0
        self.window = window
        self.stall_ratio = stall_ratio
        self.switches: List[int] = []

    @property
    def current(self) -> Callable:
        return self.candidates[self.active]

    def observe(self, history) -> bool:
        """Feed a residual history; returns True when the active
        preconditioner was switched."""
        h = np.asarray(history, dtype=float)
        h = h[np.isfinite(h) & (h > 0)]
        if h.size < self.window + 1:
            return False
        ratios = h[-self.window:] / h[-self.window - 1: -1]
        if (np.mean(ratios) > self.stall_ratio
                and self.active + 1 < len(self.candidates)):
            self.active += 1
            self.switches.append(self.active)
            return True
        return False
