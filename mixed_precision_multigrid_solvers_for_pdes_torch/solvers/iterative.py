"""Stand-alone iterative solvers: the smoothers run as solvers (Jacobi,
weighted Jacobi, Gauss-Seidel, SOR, the line smoothers and Chebyshev),
and the spectral helpers of the 5-point Laplacian.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/
iterative.py``. One driver covers every method: it runs ``check_every``
sweeps of the plain smoother (``ops/smooth.py``, no kernel dispatch, as in
the JAX package) between residual checks, in a Python loop that reads the
norm back to the host at each check. These are baselines that document
the smoother-alone rates; multigrid is the production path.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..ops import norms, smooth as smooth_mod, stencil as st_mod
from .multigrid import Level, convergence_factor


def jacobi_spectral_radius(nx: int, ny: int) -> float:
    """rho(Jacobi) = (cos(pi/(nx-1)) + cos(pi/(ny-1))) / 2 for the 5-point
    Laplacian with hx = hy."""
    return 0.5 * (math.cos(math.pi / (nx - 1)) + math.cos(math.pi / (ny - 1)))


def optimal_weighted_jacobi_omega(nx: int, ny: int) -> float:
    """omega* = 2 / (1 + sqrt(1 - rho^2)), fastest as a solver (not as a
    smoother)."""
    rho = jacobi_spectral_radius(nx, ny)
    return 2.0 / (1.0 + math.sqrt(max(1.0 - rho * rho, 0.0)))


def laplacian_eigenvalues_1d(n: int, h: float) -> np.ndarray:
    """Eigenvalues (4/h^2) sin^2(pi k / (2(n-1))), k = 1..n-2, of the 1D
    Dirichlet 3-point Laplacian."""
    k = np.arange(1, n - 1)
    return (4.0 / h**2) * np.sin(np.pi * k / (2 * (n - 1))) ** 2


def laplacian_condition_number(nx: int, ny: int, hx: float,
                               hy: float) -> float:
    """The 2-norm condition number lambda_max / lambda_min of the 2D
    Dirichlet 5-point Laplacian (a tensor-sum spectrum)."""
    ex = laplacian_eigenvalues_1d(nx, hx)
    ey = laplacian_eigenvalues_1d(ny, hy)
    return float((ex[-1] + ey[-1]) / (ex[0] + ey[0]))


def _default_omega(method: str, nx: int, ny: int) -> float:
    return {
        "jacobi": 2.0 / 3.0,
        "weighted_jacobi": optimal_weighted_jacobi_omega(nx, ny),
        "rbgs": 1.0,
        "gauss_seidel": 1.0,
        "red_black": 1.0,
        "sor": smooth_mod.optimal_sor_omega(nx, ny),
        "line_x": 1.0,
        "line_y": 1.0,
        "adi": 1.0,
        "chebyshev": 1.0,
    }[method]


def iterative_solve(lev: Level, f, u0=None, *, method: str = "jacobi",
                    omega: float = None, tol: float = 1e-8,
                    max_sweeps: int = 10_000, check_every: int = 10
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Smoother-as-solver until ||r|| <= tol * ||f|| on ``lev``, in the
    level's dtype on its device.

    ``method``: 'jacobi' (omega 2/3 by default), 'weighted_jacobi' (the
    optimal omega), 'rbgs'/'gauss_seidel'/'red_black' (omega 1), 'sor' (the
    optimal 2/(1 + sin(pi h))), 'line_x', 'line_y', 'adi' or 'chebyshev'.
    omega is rounded to float32, as the JAX package passes it."""
    g = lev.grid
    if omega is None:
        omega = _default_omega(method, g.nx, g.ny)
    omega_run = float(np.float32(omega))
    kernel = "jacobi" if method == "weighted_jacobi" else method
    unknown = lev.unknown
    f = f.to(device=lev.device, dtype=lev.dtype)
    u = (lev.zeros() if u0 is None
         else u0.to(device=lev.device, dtype=lev.dtype, copy=True))
    fnorm = norms.masked_scaled_l2(f, unknown, g.hx, g.hy)
    rnorm0 = norms.scaled_l2(st_mod.residual(lev.stencil, u, f, unknown),
                             g.hx, g.hy)
    rnorm, fn = torch.stack([rnorm0, fnorm]).tolist()
    tol_eff = tol * max(fn, 1e-300)
    hist = [rnorm]
    n_checks = max_sweeps // check_every
    while hist[-1] > tol_eff and len(hist) <= n_checks:
        u = smooth_mod.smooth(lev.stencil, u, f, unknown, method=kernel,
                              sweeps=check_every, omega=omega_run)
        r = st_mod.residual(lev.stencil, u, f, unknown)
        hist.append(norms.scaled_l2(r, g.hx, g.hy).item())
    k = len(hist) - 1
    hist_np = np.asarray(hist, dtype=np.float64)
    return u, {
        "iterations": k * check_every,
        "sweeps": k * check_every,
        "residual_norm": hist[-1],
        "history": hist_np,
        "converged": hist[-1] <= tol_eff,
        "convergence_factor": (float(convergence_factor(hist_np)
                                     ** (1.0 / check_every))
                               if k > 0 else float("nan")),
        "method": method,
        "omega": float(omega),
    }
