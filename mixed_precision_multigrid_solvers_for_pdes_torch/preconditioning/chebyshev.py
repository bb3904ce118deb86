"""Chebyshev polynomial preconditioner.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/
preconditioning/chebyshev.py``: z = p_k(D^-1 A) D^-1 r, the Chebyshev
iteration for A z = r from a zero start over [lmin, lmax] estimates of the
spectrum of D^-1 A. Stencil applications only, and symmetric whenever A is.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops import stencil as st_mod


def laplacian_eig_bounds(nx: int, ny: int, hx: float,
                         hy: float) -> Tuple[float, float]:
    """Extreme eigenvalues of D^-1 A for the 5-point Dirichlet Laplacian on
    an (nx, ny) grid."""
    sx = np.sin(np.pi / (2 * (nx - 1))) ** 2
    sy = np.sin(np.pi / (2 * (ny - 1))) ** 2
    wx, wy = 1.0 / hx**2, 1.0 / hy**2
    denom = 2 * wx + 2 * wy
    lmin = (4 * wx * sx + 4 * wy * sy) / denom
    lmax = (4 * wx * (1 - sx) + 4 * wy * (1 - sy)) / denom
    return float(lmin), float(lmax)


def chebyshev(st, unknown, *, degree: int = 4,
              bounds: Optional[Tuple[float, float]] = None,
              grid=None) -> Callable:
    """Degree-``degree`` Chebyshev approximation of (D^-1 A)^-1 D^-1.

    ``bounds``: (lmin, lmax) of D^-1 A. By default the smoothing range
    [lmax/30, lmax], with the Laplacian's exact lmax when ``grid`` is given
    (and lmin no lower than lmax/30), else [2/30, 2]."""
    if bounds is None:
        if grid is not None:
            lmin, lmax = laplacian_eig_bounds(grid.nx, grid.ny, grid.hx,
                                              grid.hy)
            lmin = max(lmin, lmax / 30.0)
        else:
            lmin, lmax = 2.0 / 30.0, 2.0
    else:
        lmin, lmax = bounds
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def apply(r):
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        rm = torch.where(unknown, r, zero)

        def dinv_a(x):
            return torch.where(unknown, st_mod.apply(st, x) / st.c, zero)

        dinv_r = rm / st.c
        rho_old = 1.0 / sigma
        z = (1.0 / theta) * dinv_r
        d = z
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * (dinv_r
                                                             - dinv_a(z))
            z = z + d
            rho_old = rho
        return torch.where(unknown, z, zero)

    return apply
