"""The right-hand sides of a traffic mix, drawn from ``--seed``.

Every solve gets a manufactured source that is one sine mode of the grid,

    f = amp * pi^2 * |k|^2 * prod_a sin(k_a pi x_a),

built on the card in float64. Each k_a lies in ``freq`` (inclusive) and
``amp`` in [amp[0], amp[1]). The modes are dealt in blocks: each block is
a permutation, drawn from the seed, of every mode of the mix, so that
every seed sends the same modes in the long run, in another order; the
amplitude is drawn afresh for each solve. The warm-up draws from a stream
of its own, so the window's inputs do not depend on how many warm-up
solves ran.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

WINDOW, WARMUP = 0, 1


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """A numpy seed sequence for any whole ``seed`` (negative too)."""
    return np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])


def modes(mix: Dict, dims: int) -> Tuple[Tuple[int, ...], ...]:
    lo, hi = mix["freq"]
    return tuple(itertools.product(range(lo, hi + 1), repeat=dims))


def draws(mix: Dict, dims: int, seed: int, stream: int = WINDOW
          ) -> Iterator[Tuple[Tuple[int, ...], float]]:
    """(k, amp) for solve 0, 1, 2, ... of the window (or the warm-up)."""
    rng = np.random.default_rng(seed_sequence(seed, stream))
    every = modes(mix, dims)
    lo, hi = mix["amp"]
    while True:
        for j in rng.permutation(len(every)):
            yield every[int(j)], float(rng.uniform(lo, hi))


def sample_points(mix: Dict, seed: int) -> Tuple[float, ...]:
    """Where in the window the answers kept for the check lie (besides
    the last one): ``samples`` points of the window's progress in [0, 1),
    one drawn from the seed in each of ``samples`` equal strata, so that
    the kept answers spread over the whole window, whatever its length."""
    rng = np.random.default_rng(seed_sequence(seed, 2))
    n = mix["samples"]
    return tuple((j + float(rng.uniform())) / n for j in range(n))


def rhs(n: int, dims: int, k: Sequence[int], amp: float,
        device) -> torch.Tensor:
    """The source of mode ``k`` on n nodes per axis, float64, on
    ``device``."""
    x = torch.arange(n, dtype=torch.float64, device=device) / (n - 1)
    scale = amp * math.pi ** 2 * sum(m * m for m in k)
    f = None
    for axis, m in enumerate(k):
        s = torch.sin((m * math.pi) * x)
        s = s.reshape([n if a == axis else 1 for a in range(dims)])
        f = scale * s if f is None else f * s
    return f
