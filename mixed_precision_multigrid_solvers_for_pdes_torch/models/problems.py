"""Problem definitions and the manufactured-solution Poisson problem.

Counterpart of ``Problem``, ``from_callables`` and ``poisson_mms_sinsin`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/models/problems.py``. Field
data are host (numpy float64) arrays of the logical shape (nx, ny); ``rhs``
and ``initial_guess`` put them on a device in a given dtype. Coefficient
fields, Neumann/Robin data, irregular domains and the rest of the catalogue
are ROADMAP item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import bc as bc_mod
from ..core.bc import BoundarySpec
from ..core.grid import Grid
from ..ops import norms


def eval_on_grid(grid: Grid, fn: Callable) -> np.ndarray:
    """fn(X, Y) on the grid's nodes as a float64 (nx, ny) array."""
    X, Y = grid.coordinates()
    vals = np.asarray(fn(X, Y), dtype=np.float64)
    return np.broadcast_to(vals, X.shape).copy()


@dataclasses.dataclass
class Problem:
    """A discretized Poisson problem A u = f with Dirichlet data."""

    name: str
    grid: Grid
    spec: BoundarySpec = BoundarySpec()
    f: Any = None                 # (nx, ny) right-hand side
    dirichlet_values: Any = None  # (nx, ny) array holding g on the ring
    exact: Any = None             # (nx, ny) exact solution, or None

    def rhs(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        return torch.as_tensor(self.f, dtype=dtype, device=device)

    def initial_guess(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """Zero on unknowns, Dirichlet values on every fixed node."""
        g = self.grid
        u0 = torch.zeros(g.shape, dtype=dtype, device=device)
        if self.dirichlet_values is not None:
            fixed = ~bc_mod.unknown_mask(g.nx, g.ny, self.spec, device=device)
            vals = torch.as_tensor(self.dirichlet_values, dtype=dtype,
                                   device=device)
            u0 = torch.where(fixed, vals, u0)
        return u0

    def error_norms(self, u: torch.Tensor) -> Dict[str, float]:
        """Grid-scaled L2 and max-norm error against the exact solution."""
        if self.exact is None:
            raise ValueError(f"problem {self.name!r} has no exact solution")
        exact = torch.as_tensor(self.exact, dtype=torch.float64,
                                device=u.device)
        diff = u.to(torch.float64) - exact
        return {
            "l2": norms.scaled_l2(diff, self.grid.hx, self.grid.hy).item(),
            "linf": diff.abs().max().item(),
        }


def from_callables(name: str, grid: Grid, *, f: Callable,
                   u_exact: Optional[Callable] = None,
                   spec: BoundarySpec = BoundarySpec()) -> Problem:
    """Assemble a Problem from host callables of (X, Y)."""
    exact = eval_on_grid(grid, u_exact) if u_exact is not None else None
    return Problem(name=name, grid=grid, spec=spec, f=eval_on_grid(grid, f),
                   dirichlet_values=exact, exact=exact)


def poisson_mms_sinsin(n: int, domain=(0.0, 1.0, 0.0, 1.0)) -> Problem:
    """u = sin(pi x) sin(pi y), f = 2 pi^2 u, homogeneous Dirichlet."""
    grid = Grid(n, n, domain)
    pi = np.pi
    return from_callables(
        "poisson_sinsin", grid,
        u_exact=lambda X, Y: np.sin(pi * X) * np.sin(pi * Y),
        f=lambda X, Y: 2 * pi**2 * np.sin(pi * X) * np.sin(pi * Y),
    )
