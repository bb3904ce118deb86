"""3D problem definitions and the manufactured-solution Poisson problem.

Counterpart of ``Problem3D``, ``from_callables3`` and
``poisson3d_mms_sinsinsin`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/models/problems3d.py``.
Field data are host (numpy float64) arrays of the logical shape
(nx, ny, nz); ``rhs`` and ``initial_guess`` put them on a device in a given
dtype. Coefficient fields, Neumann/Robin data and the rest of the 3D
catalogue are ROADMAP item 13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import bc3d
from ..core.bc3d import BoundarySpec3D
from ..core.grid3d import Grid3D
from ..ops import norms

PI = np.pi


def eval_on_grid3(grid: Grid3D, fn: Callable) -> np.ndarray:
    """fn(X, Y, Z) on the grid's nodes as a float64 (nx, ny, nz) array.

    ``fn`` gets broadcastable (nx,1,1), (1,ny,1), (1,1,nz) coordinate arrays:
    numpy computes each node's value with the same operations as on full
    meshes, so the values are those of the JAX package, and a 513^3
    evaluation builds one full-size array instead of three more."""
    X, Y, Z = np.ix_(*grid.axes())
    vals = np.asarray(fn(X, Y, Z), dtype=np.float64)
    return np.broadcast_to(vals, grid.shape).copy()


@dataclasses.dataclass
class Problem3D:
    """A discretized 3D problem -lap(u) + lam*u = f with Dirichlet data."""

    name: str
    grid: Grid3D
    spec: BoundarySpec3D = BoundarySpec3D()
    f: Any = None                 # (nx, ny, nz) right-hand side
    lam: float = 0.0
    exact: Any = None             # (nx, ny, nz) exact solution, or None
    dirichlet_values: Any = None  # (nx, ny, nz) array holding g on the shell

    def rhs(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        return torch.as_tensor(self.f, dtype=dtype, device=device)

    def initial_guess(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """Zero on unknowns, Dirichlet values on every fixed node."""
        g = self.grid
        u0 = torch.zeros(g.shape, dtype=dtype, device=device)
        if self.dirichlet_values is not None:
            fixed = ~bc3d.unknown_mask3d(*g.shape, self.spec, device=device)
            vals = torch.as_tensor(self.dirichlet_values, dtype=dtype,
                                   device=device)
            u0 = torch.where(fixed, vals, u0)
        return u0

    def error_norms(self, u: torch.Tensor) -> Dict[str, float]:
        """Grid-scaled L2, max-norm and discrete H1-seminorm error against
        the exact solution, in float64."""
        if self.exact is None:
            raise ValueError(f"problem {self.name!r} has no exact solution")
        g = self.grid
        diff = u.to(torch.float64) - torch.as_tensor(
            self.exact, dtype=torch.float64, device=u.device)
        every = torch.ones(g.shape, dtype=torch.bool, device=u.device)
        return {
            "l2": norms.scaled_l2(diff, g.hx, g.hy, g.hz).item(),
            "linf": diff.abs().max().item(),
            "h1": norms.h1_seminorm3d(diff, every, g.hx, g.hy, g.hz).item(),
        }


def from_callables3(name: str, grid: Grid3D, *, f: Callable,
                    u_exact: Optional[Callable] = None, lam: float = 0.0,
                    spec: BoundarySpec3D = BoundarySpec3D()) -> Problem3D:
    """Assemble a Problem3D from host callables of (X, Y, Z)."""
    exact = eval_on_grid3(grid, u_exact) if u_exact is not None else None
    return Problem3D(name=name, grid=grid, spec=spec,
                     f=eval_on_grid3(grid, f), lam=lam, exact=exact,
                     dirichlet_values=exact)


def poisson3d_mms_sinsinsin(n: int) -> Problem3D:
    """u = sin(pi x) sin(pi y) sin(pi z), f = 3 pi^2 u, homogeneous
    Dirichlet, on the unit cube with n points per axis."""
    return from_callables3(
        "poisson3d_sinsinsin", Grid3D(n, n, n),
        u_exact=lambda X, Y, Z: (np.sin(PI * X) * np.sin(PI * Y)
                                 * np.sin(PI * Z)),
        f=lambda X, Y, Z: (3 * PI**2 * np.sin(PI * X) * np.sin(PI * Y)
                           * np.sin(PI * Z)),
    )
