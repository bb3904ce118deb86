"""Plain PyTorch smoothers: weighted Jacobi, red-black Gauss-Seidel, SOR.

Counterpart of ``jacobi_sweep``, ``rb_color_update``, ``rbgs_sweep`` and
``smooth`` in ``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/smooth.py``.
These are the plain twins that the smoothing kernels
(``ops/cuda_kernels/smooth.py`` and ``smooth_var.py``) are held against, and
the path every configuration the kernels do not take runs on.

Every smoother updates ``u`` IN PLACE on its unknown nodes (it saves one
full-size copy per colour update) and returns it. A scalar stencil acts on
the interior; a tensor stencil acts on every node, so Neumann/Robin ring
unknowns are smoothed too (``ops/stencil.region``). Updates divide by ``c``
as the JAX package's XLA smoothers do. The colour of node (i, j) is that of
its global index: red where (i + j) is even. Line/ADI and Chebyshev
smoothers are ROADMAP item 7.
"""

from __future__ import annotations

import torch

from . import stencil as st_mod
from .stencil import Stencil, region

RBGS_METHODS = ("rbgs", "gauss_seidel", "red_black", "sor")


def _red(st: Stencil, u: torch.Tensor) -> torch.Tensor:
    """Red (i + j even) mask over ``region(st, u)``."""
    nx, ny = u.shape
    i = region(st, torch.arange(nx, device=u.device)[:, None].expand(nx, ny))
    j = region(st, torch.arange(ny, device=u.device)[None, :].expand(nx, ny))
    return (i + j) % 2 == 0


def jacobi_sweep(st: Stencil, u, f, unknown, omega):
    """One weighted-Jacobi sweep, u += omega * (f - A u) / c on unknowns."""
    ui = region(st, u)
    r = region(st, f) - (st.c * ui - st_mod.neighbor_sum(st, u))
    new = ui + omega * r / st.c
    ui[...] = torch.where(region(st, unknown), new, ui)
    return u


def rb_color_update(st: Stencil, u, f, unknown, color_mask, omega):
    """Gauss-Seidel update of one colour, u = u + omega*((f + nbsum)/c - u).

    ``color_mask`` covers ``region(st, u)``."""
    ui = region(st, u)
    u_gs = (region(st, f) + st_mod.neighbor_sum(st, u)) / st.c
    new = ui + omega * (u_gs - ui)
    ui[...] = torch.where(color_mask & region(st, unknown), new, ui)
    return u


def rbgs_sweep(st: Stencil, u, f, unknown, omega=1.0, reverse: bool = False):
    """One red-black Gauss-Seidel sweep: red then black, or black then red
    with ``reverse`` (the adjoint order that makes a cycle symmetric)."""
    red = _red(st, u)
    first, second = (~red, red) if reverse else (red, ~red)
    rb_color_update(st, u, f, unknown, first, omega)
    rb_color_update(st, u, f, unknown, second, omega)
    return u


def smooth(st: Stencil, u, f, unknown, *, method: str = "jacobi",
           sweeps: int = 2, omega: float = 0.8):
    """Run ``sweeps`` sweeps of ``method`` in place on ``u``.

    ``method``: 'jacobi', one of the RB-GS names ('rbgs', 'gauss_seidel',
    'red_black', 'sor'), or 'rbgs_rev' for the reversed colour order."""
    if method == "jacobi":
        for _ in range(sweeps):
            jacobi_sweep(st, u, f, unknown, omega)
    elif method in RBGS_METHODS or method == "rbgs_rev":
        for _ in range(sweeps):
            rbgs_sweep(st, u, f, unknown, omega, reverse=method == "rbgs_rev")
    elif method in ("line_x", "line_y", "adi", "chebyshev"):
        raise NotImplementedError(
            f"smoother {method!r} is not ported yet (ROADMAP item 7)")
    else:
        raise ValueError(f"unknown smoother {method!r}")
    return u
