"""The constant-coefficient 5-point operator ``A u = -lap(u) + lam*u``.

Counterpart of ``Stencil``, ``make_stencil`` (constant-coefficient branch),
``neighbor_sum``, ``apply`` and ``residual`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/stencil.py``:

    A u[i,j] = c*u - w*u[i-1,j] - e*u[i+1,j] - s*u[i,j-1] - n*u[i,j+1]

with 1/h^2 folded into the coefficients. Fields have the logical shape
(nx, ny); neighbour reads are slices of the interior, so nothing wraps.
Variable coefficients, array ``lam``, Neumann/Robin ghost elimination and the
9-point stencil are ROADMAP item 7.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.bc import BoundarySpec
from ..core.grid import Grid
from ..core.precision import as_dtype


def _round(x: float, dtype: torch.dtype) -> float:
    return torch.tensor(x, dtype=dtype).item()


@dataclasses.dataclass(frozen=True)
class Stencil:
    """5-point stencil with scalar leaves (Python floats holding values
    already rounded to the level's dtype)."""

    c: float  # centre (diagonal)
    w: float  # coupling to u[i-1, j]
    e: float  # coupling to u[i+1, j]
    s: float  # coupling to u[i, j-1]
    n: float  # coupling to u[i, j+1]

    def astype(self, dtype) -> "Stencil":
        """Round every coefficient to ``dtype`` (exact when widening)."""
        dtype = as_dtype(dtype)
        return Stencil(*(_round(x, dtype) for x in self.coefs))

    @property
    def coefs(self):
        return (self.c, self.w, self.e, self.s, self.n)


def neighbor_sum(st: Stencil, u: torch.Tensor) -> torch.Tensor:
    """w*u[i-1,j] + e*u[i+1,j] + s*u[i,j-1] + n*u[i,j+1] on the interior
    nodes; shape (nx-2, ny-2)."""
    return (st.w * u[:-2, 1:-1] + st.e * u[2:, 1:-1]
            + st.s * u[1:-1, :-2] + st.n * u[1:-1, 2:])


def apply(st: Stencil, u: torch.Tensor) -> torch.Tensor:
    """A u, shape (nx, ny). Valid on interior nodes; the ring holds zero."""
    out = torch.zeros_like(u)
    out[1:-1, 1:-1] = st.c * u[1:-1, 1:-1] - neighbor_sum(st, u)
    return out


def residual(st: Stencil, u: torch.Tensor, f: torch.Tensor,
             unknown: torch.Tensor) -> torch.Tensor:
    """r = f - A u on unknown nodes, zero on fixed nodes; shape (nx, ny)."""
    r = torch.zeros_like(f)
    r[1:-1, 1:-1] = f[1:-1, 1:-1] - (st.c * u[1:-1, 1:-1]
                                     - neighbor_sum(st, u))
    return torch.where(unknown, r, torch.zeros((), dtype=r.dtype,
                                               device=r.device))


def make_stencil(grid: Grid, spec: BoundarySpec = BoundarySpec(), *,
                 lam: float = 0.0, dtype=torch.float32) -> Stencil:
    """Stencil of ``-lap(u) + lam*u`` on ``grid``, coefficients in ``dtype``.

    The centre is summed in ``dtype`` as the JAX package sums it
    (``c = w + e + s + n + lam``), so both packages hold the same values.
    """
    if not spec.all_dirichlet:
        raise NotImplementedError(
            "only all-Dirichlet stencils are ported (ROADMAP item 7)")
    dtype = as_dtype(dtype)
    w = e = torch.tensor(1.0 / (grid.hx * grid.hx), dtype=dtype)
    s = n = torch.tensor(1.0 / (grid.hy * grid.hy), dtype=dtype)
    c = w + e + s + n + torch.tensor(lam, dtype=dtype)
    return Stencil(c=c.item(), w=w.item(), e=e.item(), s=s.item(),
                   n=n.item())
