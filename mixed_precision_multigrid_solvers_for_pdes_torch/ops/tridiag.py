"""Batched tridiagonal solves by parallel cyclic reduction (PCR).

Counterpart of ``pcr_solve``, ``cyclic_tridiagonal_solve`` and
``tridiagonal_solve`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/tridiag.py``. Solves
``dl_i x_{i-1} + d_i x_i + du_i x_{i+1} = b_i`` along ``axis`` for every
line of the other axis at once; dl[0] and du[n-1] are ignored. PyTorch has
no batched tridiagonal solver, so ``tridiagonal_solve`` is PCR on every
device (the JAX package calls LAPACK off the TPU): ceil(log2(n)) rounds of
whole-array elementwise work.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _zshift(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """``x`` shifted by ``k`` along ``axis`` with zero fill: out[i] =
    x[i - k], zero where i - k is outside."""
    return _shifts(x, abs(k), axis)[0 if k > 0 else 1]


def _shifts(x: torch.Tensor, k: int, axis: int):
    """(x shifted by +k, by -k) along ``axis`` with zero fill: two views of
    one zero-padded copy, so a PCR round pays one op per array, not two
    shifts of two ops each."""
    n = x.shape[axis]
    k = min(k, n)
    pad = [0, 0] * (x.ndim - axis)
    pad[-2:] = [k, k]
    xp = F.pad(x, pad)
    return xp.narrow(axis, 0, n), xp.narrow(axis, 2 * k, n)


def _edge(shape, axis: int, index: int, device) -> torch.Tensor:
    """Bool mask of the lines at ``index`` along ``axis`` (broadcastable)."""
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return (torch.arange(shape[axis], device=device) == index).view(view)


def pcr_factor(dl, d, du, axis: int) -> tuple:
    """The right-hand-side-independent part of a PCR solve of the batched
    lines with diagonals ``dl``, ``d``, ``du`` (one shape and dtype) along
    ``axis``: each round's (k, alpha, gamma) and the reduced diagonal.
    ``pcr_apply`` finishes a solve with it, so lines whose matrix repeats
    (the line smoothers' sweeps) reduce it once."""
    n = d.shape[axis]
    dev = d.device
    zero = torch.zeros((), dtype=d.dtype, device=dev)
    one = torch.ones((), dtype=d.dtype, device=dev)
    a = torch.where(_edge(d.shape, axis, 0, dev), zero, dl)
    c = torch.where(_edge(d.shape, axis, n - 1, dev), zero, du)
    bb = d
    rounds = []
    for s in range(max(1, math.ceil(math.log2(max(n, 2))))):
        k = 1 << s
        b_up, b_dn = _shifts(bb, k, axis)
        a_up, a_dn = _shifts(a, k, axis)
        c_up, c_dn = _shifts(c, k, axis)
        # alpha eliminates x_{i-k}, gamma x_{i+k}; rows outside the line
        # have zero b and zero couplings, so the guard only avoids 0/0
        alpha = -a / torch.where(b_up != 0, b_up, one)
        gamma = -c / torch.where(b_dn != 0, b_dn, one)
        bb = bb + alpha * c_up + gamma * a_dn
        a = alpha * a_up
        c = gamma * c_dn
        rounds.append((k, alpha, gamma))
    return axis, rounds, bb


def pcr_apply(factor: tuple, b: torch.Tensor) -> torch.Tensor:
    """Solve for the right-hand side ``b`` with a ``pcr_factor``."""
    axis, rounds, bb = factor
    rhs = b
    for k, alpha, gamma in rounds:
        r_up, r_dn = _shifts(rhs, k, axis)
        rhs = rhs + alpha * r_up + gamma * r_dn
    return rhs / bb


def _lines(dl, d, du, b):
    return (torch.broadcast_to(x, b.shape).to(b.dtype) for x in (dl, d, du))


def pcr_solve(dl, d, du, b, axis: int = -1) -> torch.Tensor:
    """Parallel-cyclic-reduction tridiagonal solve, batched over the other
    axes. ``dl``, ``d``, ``du`` broadcast to ``b``'s shape."""
    return pcr_apply(pcr_factor(*_lines(dl, d, du, b), axis % b.ndim), b)


def cyclic_factor(dl, d, du, axis: int) -> tuple:
    """The right-hand-side-independent part of a periodic solve (one shape
    and dtype): indices run mod n, dl[0] couples x_0 to x_{n-1} and
    du[n-1] couples x_{n-1} to x_0. The cyclic matrix is a tridiagonal one
    plus a rank-1 update (Sherman-Morrison): the tridiagonal part's PCR
    factor, and its solve for the update's vector."""
    n = d.shape[axis]
    first = _edge(d.shape, axis, 0, d.device)
    last = _edge(d.shape, axis, n - 1, d.device)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)

    alpha = dl.narrow(axis, 0, 1)      # x_0 <- x_{n-1} coupling
    beta = du.narrow(axis, n - 1, 1)   # x_{n-1} <- x_0 coupling
    gamma = -d.narrow(axis, 0, 1)      # any nonzero shift; -d_0 is usual
    gamma = torch.where(gamma.abs() < 1e-30, torch.ones_like(gamma), gamma)

    d_mod = torch.where(first, d - gamma, d)
    d_mod = torch.where(last, d_mod - alpha * beta / gamma, d_mod)
    uvec = torch.where(first, gamma, zero)
    uvec = torch.where(last, uvec + beta, uvec)
    factor = pcr_factor(dl, d_mod, du, axis)
    z = pcr_apply(factor, uvec)
    ratio = alpha / gamma
    return factor, z, ratio, _line_sum(z, ratio, axis)


def _line_sum(y, ratio, axis):
    """y[0] + ratio * y[n-1] along ``axis``: v . y of Sherman-Morrison."""
    return y.narrow(axis, 0, 1) + ratio * y.narrow(axis, y.shape[axis] - 1, 1)


def cyclic_apply(cfactor: tuple, b: torch.Tensor) -> torch.Tensor:
    """Solve for the right-hand side ``b`` with a ``cyclic_factor``."""
    factor, z, ratio, vz = cfactor
    y = pcr_apply(factor, b)
    vy = _line_sum(y, ratio, factor[0])
    return y - (vy / (1.0 + vz)) * z


def cyclic_tridiagonal_solve(dl, d, du, b, axis: int = -1) -> torch.Tensor:
    """Periodic batched tridiagonal solve by Sherman-Morrison over PCR
    (``cyclic_factor``); ``dl``, ``d``, ``du`` broadcast to ``b``'s
    shape."""
    return cyclic_apply(cyclic_factor(*_lines(dl, d, du, b), axis % b.ndim),
                        b)


def tridiagonal_solve(dl, d, du, b, axis: int = -1) -> torch.Tensor:
    """The batched tridiagonal solve of the line smoothers: PCR."""
    return pcr_solve(dl, d, du, b, axis)
