"""The constant-coefficient 7-point operator ``A u = -lap(u) + lam*u`` in 3D.

Counterpart of ``Stencil3D``, ``make_stencil3d`` (constant-coefficient
branch on a Dirichlet box), ``neighbor_sum``, ``apply`` and ``residual`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/stencil3d.py``:

    A u[i,j,k] = c*u - w*u[i-1] - e*u[i+1] - s*u[j-1] - n*u[j+1]
                     - b*u[k-1] - t*u[k+1]

with 1/h^2 folded into the coefficients. Fields have the logical shape
(nx, ny, nz); neighbour reads are slices of the interior, so nothing wraps.
Variable coefficients, array ``lam``, the Neumann/Robin ghost folds and the
27-point Galerkin stencil are ROADMAP item 13.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.bc3d import NOT_PORTED_3D, BoundarySpec3D
from ..core.grid3d import Grid3D
from ..core.precision import as_dtype
from .stencil import _round


@dataclasses.dataclass(frozen=True)
class Stencil3D:
    """7-point stencil with scalar leaves (Python floats holding values
    already rounded to the level's dtype)."""

    c: float  # centre (diagonal)
    w: float  # coupling to u[i-1, j, k]
    e: float  # coupling to u[i+1, j, k]
    s: float  # coupling to u[i, j-1, k]
    n: float  # coupling to u[i, j+1, k]
    b: float  # coupling to u[i, j, k-1]
    t: float  # coupling to u[i, j, k+1]

    def astype(self, dtype) -> "Stencil3D":
        """Round every coefficient to ``dtype`` (exact when widening)."""
        dtype = as_dtype(dtype)
        return Stencil3D(*(_round(x, dtype) for x in self.coefs))

    @property
    def coefs(self):
        return (self.c, self.w, self.e, self.s, self.n, self.b, self.t)


class Stencil27:
    """27-point stencil of Galerkin coarsening: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the 27-point Galerkin stencil is ROADMAP "
                                  "item 13 (ops/galerkin.py)")


def interior(u: torch.Tensor, dx: int = 0, dy: int = 0, dz: int = 0):
    """u[i+dx, j+dy, k+dz] over the interior nodes (i, j, k)."""
    nx, ny, nz = u.shape
    return u[1 + dx: nx - 1 + dx, 1 + dy: ny - 1 + dy, 1 + dz: nz - 1 + dz]


def neighbor_sum(st: Stencil3D, u: torch.Tensor) -> torch.Tensor:
    """w*u[i-1] + e*u[i+1] + s*u[j-1] + n*u[j+1] + b*u[k-1] + t*u[k+1] on
    the interior nodes, summed in the JAX package's order; shape
    (nx-2, ny-2, nz-2)."""
    return (st.w * interior(u, -1) + st.e * interior(u, 1)
            + st.s * interior(u, 0, -1) + st.n * interior(u, 0, 1)
            + st.b * interior(u, 0, 0, -1) + st.t * interior(u, 0, 0, 1))


def apply(st: Stencil3D, u: torch.Tensor) -> torch.Tensor:
    """A u, shape (nx, ny, nz). Valid on interior nodes; the shell holds
    zero."""
    out = torch.zeros_like(u)
    out[1:-1, 1:-1, 1:-1] = st.c * interior(u) - neighbor_sum(st, u)
    return out


def residual(st: Stencil3D, u: torch.Tensor, f: torch.Tensor,
             unknown: torch.Tensor) -> torch.Tensor:
    """r = f - A u on unknown nodes, zero on fixed nodes; shape
    (nx, ny, nz)."""
    r = torch.zeros_like(f)
    r[1:-1, 1:-1, 1:-1] = interior(f) - (st.c * interior(u)
                                          - neighbor_sum(st, u))
    return torch.where(unknown, r, torch.zeros((), dtype=r.dtype,
                                               device=r.device))


def make_stencil3d(grid: Grid3D, spec: BoundarySpec3D = BoundarySpec3D(), *,
                   a=None, lam: float = 0.0, dtype=torch.float32) -> Stencil3D:
    """Stencil of ``-lap(u) + lam*u`` on ``grid``, coefficients in ``dtype``.

    The centre is summed in ``dtype`` as the JAX package sums it
    (``c = w + e + s + n + b + t + lam``), so both packages hold the same
    values.
    """
    if a is not None or torch.as_tensor(lam).dim() != 0:
        raise NotImplementedError("variable coefficients and array lam are "
                                  "ROADMAP item 13 (3D operator)")
    if not spec.all_dirichlet:
        raise NotImplementedError(NOT_PORTED_3D)
    dtype = as_dtype(dtype)
    w = e = torch.tensor(1.0 / (grid.hx * grid.hx), dtype=dtype)
    s = n = torch.tensor(1.0 / (grid.hy * grid.hy), dtype=dtype)
    b = t = torch.tensor(1.0 / (grid.hz * grid.hz), dtype=dtype)
    c = w + e + s + n + b + t + torch.tensor(float(lam), dtype=dtype)
    return Stencil3D(*(x.item() for x in (c, w, e, s, n, b, t)))
