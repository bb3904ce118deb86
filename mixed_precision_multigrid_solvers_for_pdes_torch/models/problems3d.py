"""3D problem definitions and the catalogue of 3D problems.

Counterpart of ``Problem3D``, ``from_callables3``, the problems
``poisson3d_mms_sinsinsin``, ``poisson3d_mms_polynomial``,
``helmholtz3d_mms``, ``varcoef3d_mms``, ``jump_coefficient3d``,
``neumann3d_test``, ``periodic3d_helmholtz`` and ``anisotropic3d_z``, and
``CATALOGUE3D`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/models/problems3d.py``.
Field data are host (numpy float64) arrays of the logical shape
(nx, ny, nz); ``rhs`` and ``initial_guess`` put them on a device in a given
dtype. A problem may carry a coefficient field ``a``, an array ``lam``, a
spec with Neumann/Robin or periodic faces and the Neumann/Robin data
``bc_values``, which ``rhs`` folds in (``ops/stencil3d.bc_rhs_correction3d``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import bc3d
from ..core.bc import BCKind, BCSide
from ..core.bc3d import SIDES3D, BoundarySpec3D
from ..core.grid3d import Grid3D
from ..ops import norms
from ..ops import stencil3d as st3

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
    """A discretized 3D problem -div(a grad u) + lam*u = f with its
    boundary data."""

    name: str
    grid: Grid3D
    spec: BoundarySpec3D = BoundarySpec3D()
    f: Any = None                 # (nx, ny, nz) right-hand side
    lam: Any = 0.0                # scalar or (nx, ny, nz) array
    exact: Any = None             # (nx, ny, nz) exact solution, or None
    dirichlet_values: Any = None  # (nx, ny, nz) array holding g on the shell
    a: Any = None                 # (nx, ny, nz) coefficient field, or None
    bc_values: Optional[Dict[str, Any]] = None  # Neumann/Robin g per face

    def rhs(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """f in ``dtype`` on ``device``, plus the Neumann/Robin data term."""
        f = torch.as_tensor(self.f, dtype=dtype, device=device)
        if self.bc_values:
            f = f + st3.bc_rhs_correction3d(self.grid, self.spec,
                                            self.bc_values, dtype, device)
        return f

    def initial_guess(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """Zero on unknowns, the Dirichlet values on every fixed node (when
        a face is Dirichlet)."""
        g = self.grid
        u0 = torch.zeros(g.shape, dtype=dtype, device=device)
        has_dirichlet = any(self.spec.side(s).kind == BCKind.DIRICHLET
                            for s in SIDES3D)
        if self.dirichlet_values is not None and has_dirichlet:
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
                    u_exact: Optional[Callable] = None,
                    a: Optional[Callable] = None, lam: Any = 0.0,
                    spec: BoundarySpec3D = BoundarySpec3D(),
                    bc_values=None) -> Problem3D:
    """Assemble a Problem3D from host callables of (X, Y, Z)."""
    exact = eval_on_grid3(grid, u_exact) if u_exact is not None else None
    return Problem3D(name=name, grid=grid, spec=spec,
                     f=eval_on_grid3(grid, f), lam=lam, exact=exact,
                     dirichlet_values=exact,
                     a=eval_on_grid3(grid, a) if a is not None else None,
                     bc_values=bc_values)


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


def poisson3d_mms_polynomial(n: int) -> Problem3D:
    """u = x(1-x) y(1-y) z(1-z),
    f = 2 [y(1-y) z(1-z) + x(1-x) z(1-z) + x(1-x) y(1-y)]."""

    def u(X, Y, Z):
        return X * (1 - X) * Y * (1 - Y) * Z * (1 - Z)

    def f(X, Y, Z):
        return 2 * (Y * (1 - Y) * Z * (1 - Z) + X * (1 - X) * Z * (1 - Z)
                    + X * (1 - X) * Y * (1 - Y))

    return from_callables3("poisson3d_polynomial", Grid3D(n, n, n),
                           u_exact=u, f=f)


def helmholtz3d_mms(n: int, k: float = 2.0) -> Problem3D:
    """-lap(u) - k^2 u = f with u = sin(pi x) sin(pi y) sin(pi z)."""
    return from_callables3(
        f"helmholtz3d_k{k}", Grid3D(n, n, n),
        u_exact=lambda X, Y, Z: (np.sin(PI * X) * np.sin(PI * Y)
                                 * np.sin(PI * Z)),
        f=lambda X, Y, Z: ((3 * PI**2 - k**2) * np.sin(PI * X)
                           * np.sin(PI * Y) * np.sin(PI * Z)),
        lam=-float(k) ** 2,
    )


def varcoef3d_mms(n: int) -> Problem3D:
    """-div(a grad u) = f with a = 1 + x + y + z, u = sin sin sin:
    f = a * 3 pi^2 u - grad a . grad u, grad a = (1, 1, 1)."""

    def f(X, Y, Z):
        a = 1.0 + X + Y + Z
        sx, cx = np.sin(PI * X), np.cos(PI * X)
        sy, cy = np.sin(PI * Y), np.cos(PI * Y)
        sz, cz = np.sin(PI * Z), np.cos(PI * Z)
        grad_dot = PI * (cx * sy * sz + sx * cy * sz + sx * sy * cz)
        return a * 3 * PI**2 * sx * sy * sz - grad_dot

    return from_callables3(
        "varcoef3d", Grid3D(n, n, n),
        u_exact=lambda X, Y, Z: (np.sin(PI * X) * np.sin(PI * Y)
                                 * np.sin(PI * Z)),
        f=f, a=lambda X, Y, Z: 1.0 + X + Y + Z)


def jump_coefficient3d(n: int, ratio: float = 1e3) -> Problem3D:
    """A piecewise-constant coefficient with a ratio:1 jump at x = 0.5,
    f = 1, homogeneous Dirichlet; no exact solution."""
    return from_callables3(
        f"jumpcoef3d_{ratio:g}", Grid3D(n, n, n),
        f=lambda X, Y, Z: 1.0 + 0.0 * X,
        a=lambda X, Y, Z: np.where(X < 0.5, 1.0, ratio))


CATALOGUE3D = {
    "trigonometric": poisson3d_mms_sinsinsin,
    "polynomial": poisson3d_mms_polynomial,
    "helmholtz": helmholtz3d_mms,
    "variable_coefficient": varcoef3d_mms,
    "jump_coefficient": jump_coefficient3d,
}


def neumann3d_test(n: int) -> Problem3D:
    """A mixed box: u = sin(pi x) sin(pi y) cos(pi z) has du/dz = 0 at
    z = 0 and z = 1, so bottom and top are homogeneous Neumann faces and the
    four lateral faces carry Dirichlet data from the exact solution."""
    return from_callables3(
        "neumann3d_test", Grid3D(n, n, n),
        u_exact=lambda X, Y, Z: (np.sin(PI * X) * np.sin(PI * Y)
                                 * np.cos(PI * Z)),
        f=lambda X, Y, Z: (3 * PI**2 * np.sin(PI * X) * np.sin(PI * Y)
                           * np.cos(PI * Z)),
        spec=bc3d.mixed3d(bottom="neumann", top="neumann"),
        bc_values={"bottom": 0.0, "top": 0.0})


def periodic3d_helmholtz(n: int) -> Problem3D:
    """A fully periodic box, the definite Helmholtz operator -lap + 1:
    u = sin(2 pi x) sin(2 pi y) sin(2 pi z), f = (12 pi^2 + 1) u."""
    side = BCSide(kind=BCKind.PERIODIC)
    return from_callables3(
        "periodic3d_helmholtz", Grid3D(n, n, n),
        u_exact=lambda X, Y, Z: (np.sin(2 * PI * X) * np.sin(2 * PI * Y)
                                 * np.sin(2 * PI * Z)),
        f=lambda X, Y, Z: ((12 * PI**2 + 1.0) * np.sin(2 * PI * X)
                           * np.sin(2 * PI * Y) * np.sin(2 * PI * Z)),
        lam=1.0, spec=BoundarySpec3D(*(side,) * 6))


def anisotropic3d_z(n: int, aspect: float = 0.1) -> Problem3D:
    """A z-stretched box (hz = aspect * hx): point smoothers stall on the
    strong z coupling, the zebra 'line_z' smoother does not."""
    kz = 1.0 / aspect

    def u(X, Y, Z):
        return np.sin(PI * X) * np.sin(PI * Y) * np.sin(PI * kz * Z)

    def f(X, Y, Z):
        return (2 + kz**2) * PI**2 * u(X, Y, Z)

    return from_callables3(f"anisotropic3d_z{aspect:g}",
                           Grid3D(n, n, n, domain=(0, 1, 0, 1, 0, aspect)),
                           u_exact=u, f=f)
