"""Multigrid as a preconditioner for the Krylov solvers.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/
preconditioning/multigrid_preconditioner.py``: z = M(r) is ``cycles``
cycles of the port's ``mg_cycle`` (``mg_cycle3d``) from a zero start. With
a symmetric cycle (equal pre and post sweeps, ``cfg.symmetric=True``) M is
symmetric positive definite, so CG may use it.

The iterate starts in the Krylov vector's dtype and the right-hand side is
cast to level 0's, as in the JAX package: under an fp64 Krylov loop over
fp32 levels, level 0 smooths, takes its residual and adds its correction in
fp64 on the plain path (the kernel gates look at the fields), and the
levels below run their kernels (A-D in 2D, E-G in 3D on the card). The
cycles update the iterate in place where they can and return it; the
preconditioner always takes the returned tensor.

``constrain`` (``parallel.distributed.make_constrainer``) runs the 2D
cycles on this rank's blocks: the Krylov vectors are then level-0
``ShardedField`` blocks (``parallel.distributed.shard_inputs``), and so is
z. In 3D (``make_constrainer3d``) the Krylov vectors are global tensors,
as in the JAX package: each application cuts r into this rank's (x, y)
blocks of whole z-lines, runs the cycles there and gathers z.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..solvers import multigrid as mg_mod, multigrid3d as mg3
from ..solvers.multigrid import Level, MultigridConfig


def multigrid_preconditioner(
        levels: Tuple[Level, ...],
        cfg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0),
        *, cycles: int = 1, constrain=None) -> Callable:
    """z = (approximately A^-1) r by ``cycles`` cycles from zero;
    ``constrain`` runs them on the blocks of a sharded ``r``."""
    lev0 = levels[0]

    def apply(r):
        # r's dtype and device (a sharded field: its zero blocks)
        z = torch.zeros_like(r, memory_format=torch.contiguous_format)
        rl = r.to(lev0.dtype)
        for _ in range(cycles):
            z = mg_mod.mg_cycle(levels, z, rl, cfg, constrain)
        return z.to(r.dtype)

    return apply


def multigrid_preconditioner3d(
        levels,
        cfg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0),
        *, cycles: int = 1, constrain=None) -> Callable:
    """3D analogue of :func:`multigrid_preconditioner` (pair it with
    ``solvers.krylov.stencil_matvec3d``); ``constrain`` runs the cycles on
    the blocks of ``make_constrainer3d``'s mesh."""
    lev0 = levels[0]

    def apply(r):
        z = torch.zeros(lev0.grid.shape, dtype=r.dtype, device=r.device)
        rl = r.to(lev0.dtype)
        for _ in range(cycles):
            z = mg3.mg_cycle3d(levels, z, rl, cfg, constrain)
        return z.to(r.dtype)

    return apply
