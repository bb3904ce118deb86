"""The 5- and 7-point Dirichlet Poisson operators, from n and h alone.

On the unit square or cube with n nodes per axis (h = 1 / (n - 1)) and the
solution held at zero on the boundary nodes, the operator at an interior
node is

    (A u)_i = sum_axes (2 u_i - u_{i-e} - u_{i+e}) / h^2.

The benchmark's right-hand sides are single sine modes,
f = amp * pi^2 * |k|^2 * prod_a sin(k_a pi x_a), and a sine mode that
vanishes on the boundary is an eigenvector of A with the eigenvalue

    lambda_h(k) = sum_a (4 / h^2) sin^2(k_a pi h / 2),

so the discrete solution is u_h = f / lambda_h(k), exactly. ``residual``
checks an answer against the operator; ``discrete_solution`` gives u_h.
Every function works on the interior nodes only and in the dtype it is
given, so the same code computes the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def interior(x: torch.Tensor) -> torch.Tensor:
    """The interior nodes of a 2D or 3D field, as a view."""
    return x[(slice(1, -1),) * x.dim()]


def apply(u: torch.Tensor) -> torch.Tensor:
    """A u on the interior nodes of ``u`` (boundary values read as given),
    in u's dtype. The centre term and the neighbour sum are formed as
    c * u - (w * u_w + e * u_e + ...), axis by axis, lower neighbour first."""
    n = u.shape[0]
    if any(m != n for m in u.shape):
        raise ValueError(f"the reference takes a square or cube, got "
                         f"{tuple(u.shape)}")
    ih2 = float((n - 1) ** 2)  # 1 / h^2, exact
    d = u.dim()
    centre = interior(u)
    nb = None
    for axis in range(d):
        for shift in (0, 2):
            sl = [slice(1, -1)] * d
            sl[axis] = slice(shift, n - 2 + shift)
            term = ih2 * u[tuple(sl)]
            nb = term if nb is None else nb + term
    return (2 * d * ih2) * centre - nb


def residual(u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """f - A u on the interior nodes, in float64."""
    u64 = u.to(torch.float64)
    return interior(f.to(torch.float64)) - apply(u64)


def relative_residual(u: torch.Tensor, f: torch.Tensor) -> float:
    """||f - A u|| / ||f|| over the interior nodes, in float64."""
    r = residual(u, f)
    fi = interior(f.to(torch.float64))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(fi))


def eigenvalue(n: int, k: Sequence[int]) -> float:
    """lambda_h(k) of the operator on n nodes per axis."""
    h = 1.0 / (n - 1)
    return sum(4.0 / (h * h) * math.sin(m * math.pi * h / 2) ** 2 for m in k)


def discrete_solution(f: torch.Tensor, k: Sequence[int],
                      dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """u_h = f / lambda_h(k): the exact solution of A u = f for a single
    sine mode f, computed in ``dtype`` (boundary nodes zero)."""
    lam = eigenvalue(f.shape[0], k)
    fd = f.to(dtype)
    u = torch.zeros_like(fd)
    interior(u).copy_(interior(fd) / torch.tensor(lam, dtype=dtype,
                                                  device=f.device))
    return u
