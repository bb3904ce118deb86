"""Diagonal (Jacobi) and line (block-tridiagonal) preconditioners.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/
preconditioning/diagonal.py``. The line solves run on the port's batched
PCR (``ops/tridiag.py``), where the JAX package calls its tridiagonal
solver.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import tridiag


def diagonal(st, unknown, *, regularization: float = 0.0) -> Callable:
    """Jacobi preconditioner z = r / (diag(A) + regularization) on
    unknowns, zero elsewhere."""

    def apply(r):
        z = r / (st.c + regularization)
        return torch.where(unknown, z, torch.zeros((), dtype=r.dtype,
                                                   device=r.device))

    return apply


def scaled_diagonal(st, unknown, *, scale: float = 1.0) -> Callable:
    """scale * D^-1."""
    base = diagonal(st, unknown)

    def apply(r):
        return scale * base(r)

    return apply


def block_line(st, unknown, *, axis: int = 0) -> Callable:
    """Line preconditioner: an exact tridiagonal solve along ``axis`` with
    the couplings across it dropped (block-diagonal by lines); strong for
    anisotropic problems when the lines follow the strong coupling.
    axis=0 solves x-lines (w/e kept), axis=1 y-lines (s/n kept). Rows off
    the unknowns are identity rows."""

    def apply(r):
        ones = torch.ones_like(r)
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        c = st.c * ones
        if axis == 0:
            dl, du = -(st.w * ones), -(st.e * ones)
        else:
            dl, du = -(st.s * ones), -(st.n * ones)
        b = torch.where(unknown, r, zero)
        dl = torch.where(unknown, dl, zero)
        du = torch.where(unknown, du, zero)
        d = torch.where(unknown, c, torch.ones((), dtype=r.dtype,
                                               device=r.device))
        z = tridiag.tridiagonal_solve(dl, d, du, b, axis=axis)
        return torch.where(unknown, z, zero)

    return apply
