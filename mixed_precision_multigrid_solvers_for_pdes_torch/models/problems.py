"""Problem definitions and the 2D problems of the port.

Counterpart of ``Problem``, ``from_callables``, ``poisson_mms_sinsin``,
``neumann_test_problem``, ``robin_test_problem``,
``variable_coefficient_mms`` and ``jump_coefficient_problem`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/models/problems.py``. Field
data are host (numpy float64) arrays of the logical shape (nx, ny); ``rhs``
and ``initial_guess`` put them on a device in a given dtype. Irregular
domains and the rest of the catalogue are ROADMAP item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import bc as bc_mod
from ..core.bc import BCKind, BoundarySpec
from ..core.grid import Grid
from ..ops import norms
from ..ops import stencil as st_mod


def eval_on_grid(grid: Grid, fn: Callable) -> np.ndarray:
    """fn(X, Y) on the grid's nodes as a float64 (nx, ny) array."""
    X, Y = grid.coordinates()
    vals = np.asarray(fn(X, Y), dtype=np.float64)
    return np.broadcast_to(vals, X.shape).copy()


@dataclasses.dataclass
class Problem:
    """A discretized elliptic problem -div(a grad u) + lam*u = f with its
    boundary data."""

    name: str
    grid: Grid
    spec: BoundarySpec = BoundarySpec()
    f: Any = None                 # (nx, ny) right-hand side (no BC terms)
    a: Any = None                 # (nx, ny) coefficient field, or None
    lam: Any = 0.0                # scalar or (nx, ny) array
    dirichlet_values: Any = None  # (nx, ny) array holding g on the ring
    bc_values: Optional[Dict[str, Any]] = None  # Neumann/Robin g per side
    exact: Any = None             # (nx, ny) exact solution, or None

    def rhs(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """The right-hand side with the Neumann/Robin terms added."""
        f = torch.as_tensor(self.f, dtype=dtype, device=device)
        if self.bc_values:
            f = f + st_mod.bc_rhs_correction(self.grid, self.spec,
                                             self.bc_values, dtype, device)
        return f

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
        """Grid-scaled L2, max-norm and discrete H1-seminorm error against
        the exact solution, in float64."""
        if self.exact is None:
            raise ValueError(f"problem {self.name!r} has no exact solution")
        g = self.grid
        diff = u.to(torch.float64) - torch.as_tensor(
            self.exact, dtype=torch.float64, device=u.device)
        every = bc_mod.logical_mask(g.nx, g.ny, device=u.device)
        return {
            "l2": norms.scaled_l2(diff, g.hx, g.hy).item(),
            "linf": diff.abs().max().item(),
            "h1": norms.h1_seminorm(diff, every, g.hx, g.hy).item(),
        }


def from_callables(name: str, grid: Grid, *, f: Callable,
                   u_exact: Optional[Callable] = None,
                   spec: BoundarySpec = BoundarySpec(),
                   a: Optional[Callable] = None, lam: Any = 0.0,
                   bc_values: Optional[Dict[str, Any]] = None) -> Problem:
    """Assemble a Problem from host callables of (X, Y)."""
    exact = eval_on_grid(grid, u_exact) if u_exact is not None else None
    return Problem(name=name, grid=grid, spec=spec, f=eval_on_grid(grid, f),
                   a=eval_on_grid(grid, a) if a is not None else None,
                   lam=lam, dirichlet_values=exact, bc_values=bc_values,
                   exact=exact)


def poisson_mms_sinsin(n: int, domain=(0.0, 1.0, 0.0, 1.0)) -> Problem:
    """u = sin(pi x) sin(pi y), f = 2 pi^2 u, homogeneous Dirichlet."""
    grid = Grid(n, n, domain)
    pi = np.pi
    return from_callables(
        "poisson_sinsin", grid,
        u_exact=lambda X, Y: np.sin(pi * X) * np.sin(pi * Y),
        f=lambda X, Y: 2 * pi**2 * np.sin(pi * X) * np.sin(pi * Y),
    )


def neumann_test_problem(n: int) -> Problem:
    """u = x^2 + y^2, f = -4; Neumann (du/dn = 2 at x = 1) on east,
    Dirichlet elsewhere."""
    return from_callables(
        "poisson_neumann_east", Grid(n, n),
        u_exact=lambda X, Y: X**2 + Y**2,
        f=lambda X, Y: -4.0 + 0.0 * X,
        spec=bc_mod.mixed(east="neumann"),
        bc_values={"east": 2.0},
    )


def robin_test_problem(n: int, alpha: float = 1.0,
                       beta: float = 1.0) -> Problem:
    """u = x^2 + y^2, f = -4; Robin (alpha*u + beta*du/dn = g) on east,
    Dirichlet elsewhere: g = alpha*(1 + y^2) + 2*beta at x = 1. The
    discretization is exact for this quadratic u."""
    grid = Grid(n, n)
    _, Y = grid.coordinates()
    return from_callables(
        "poisson_robin_east", grid,
        u_exact=lambda X, Y: X**2 + Y**2,
        f=lambda X, Y: -4.0 + 0.0 * X,
        spec=BoundarySpec(east=bc_mod.BCSide(kind=BCKind.ROBIN, alpha=alpha,
                                             beta=beta)),
        bc_values={"east": alpha * (1.0 + Y**2) + 2.0 * beta},
    )


def variable_coefficient_mms(n: int) -> Problem:
    """-div(a grad u) = f with a = 1 + x + y and u = sin(pi x) sin(pi y):
    f = a * 2 pi^2 sin sin - pi (cos sin + sin cos), homogeneous Dirichlet."""
    pi = np.pi

    def f(X, Y):
        a = 1.0 + X + Y
        sx, cx = np.sin(pi * X), np.cos(pi * X)
        sy, cy = np.sin(pi * Y), np.cos(pi * Y)
        return a * 2 * pi**2 * sx * sy - pi * (cx * sy + sx * cy)

    return from_callables(
        "varcoef_linear", Grid(n, n),
        u_exact=lambda X, Y: np.sin(pi * X) * np.sin(pi * Y),
        f=f,
        a=lambda X, Y: 1.0 + X + Y,
    )


def jump_coefficient_problem(n: int, ratio: float = 1e3) -> Problem:
    """Piecewise-constant coefficient with a ratio:1 jump at x = 0.5, f = 1,
    homogeneous Dirichlet; no closed-form solution."""
    return from_callables(
        f"jumpcoef_{ratio:g}", Grid(n, n),
        f=lambda X, Y: 1.0 + 0.0 * X,
        a=lambda X, Y: np.where(X < 0.5, 1.0, ratio),
    )
