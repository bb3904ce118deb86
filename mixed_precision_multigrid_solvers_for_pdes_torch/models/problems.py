"""Problem definitions and the 2D problems of the port.

Counterpart of ``Problem``, ``from_callables`` and the problems of
``mixed_precision_multigrid_solvers_for_pdes_tpu/models/problems.py``: the
Poisson MMS problems (sinsin, polynomial, high frequency, inhomogeneous,
exponential, anisotropic), Helmholtz, Neumann and Robin sides, per-segment
mixed sides, the periodic Helmholtz problem, variable and jump
coefficients, the boundary layer, the corner singularity and the L-shaped
domain, and ``CATALOGUE`` of all of them by name. Field data are host
(numpy float64) arrays of the logical shape (nx, ny); ``rhs`` and
``initial_guess`` put them on a device in a given dtype. A problem on an
irregular domain (``core/domain.py``) fixes the removed nodes at their
Dirichlet values and measures its error on the domain's nodes only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import bc as bc_mod
from ..core.bc import BCKind, BoundarySpec
from ..core.domain import LShapedDomain
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
    domain: Any = None            # irregular domain (core/domain.py)
    expected_order: float = 2.0   # MMS order (lower for singular solutions)

    def rhs(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """The right-hand side with the Neumann/Robin terms added."""
        f = torch.as_tensor(self.f, dtype=dtype, device=device)
        if self.bc_values:
            f = f + st_mod.bc_rhs_correction(self.grid, self.spec,
                                             self.bc_values, dtype, device)
        return f

    def initial_guess(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """Zero on unknowns, Dirichlet values on every fixed node (the
        duplicate nodes of a periodic axis and the nodes an irregular domain
        removes included) when any side or segment is Dirichlet; zero
        everywhere otherwise."""
        g = self.grid
        u0 = torch.zeros(g.shape, dtype=dtype, device=device)
        if self.dirichlet_values is not None and not _no_dirichlet(self.spec):
            unknown = bc_mod.unknown_mask(g.nx, g.ny, self.spec, device=device)
            if self.domain is not None:
                unknown = unknown & self.domain.interior_mask(g, device)
            fixed = ~unknown
            vals = torch.as_tensor(self.dirichlet_values, dtype=dtype,
                                   device=device)
            u0 = torch.where(fixed, vals, u0)
        return u0

    def error_norms(self, u: torch.Tensor) -> Dict[str, float]:
        """Grid-scaled L2, max-norm and discrete H1-seminorm error against
        the exact solution, in float64; on an irregular domain over the
        domain's nodes only."""
        if self.exact is None:
            raise ValueError(f"problem {self.name!r} has no exact solution")
        g = self.grid
        mask = bc_mod.logical_mask(g.nx, g.ny, device=u.device)
        if self.domain is not None:
            mask = mask & self.domain.interior_mask(g, u.device)
        diff = torch.where(mask, u.to(torch.float64) - torch.as_tensor(
            self.exact, dtype=torch.float64, device=u.device), 0.0)
        return {
            "l2": norms.scaled_l2(diff, g.hx, g.hy).item(),
            "linf": diff.abs().max().item(),
            "h1": norms.h1_seminorm(diff, mask, g.hx, g.hy).item(),
        }


def _no_dirichlet(spec: BoundarySpec) -> bool:
    return all(BCKind.DIRICHLET not in spec.side(s).kinds
               for s in bc_mod.SIDES)


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


def poisson_mms_polynomial(n: int) -> Problem:
    """u = x(1-x)y(1-y), f = 2[x(1-x) + y(1-y)], homogeneous Dirichlet."""
    return from_callables(
        "poisson_polynomial", Grid(n, n),
        u_exact=lambda X, Y: X * (1 - X) * Y * (1 - Y),
        f=lambda X, Y: 2 * (X * (1 - X) + Y * (1 - Y)),
    )


def poisson_mms_high_frequency(n: int, k: int = 4) -> Problem:
    """u = sin(k pi x) sin(k pi y), f = 2 (k pi)^2 u."""
    pi = np.pi
    return from_callables(
        f"poisson_highfreq_k{k}", Grid(n, n),
        u_exact=lambda X, Y: np.sin(k * pi * X) * np.sin(k * pi * Y),
        f=lambda X, Y: 2 * (k * pi) ** 2 * np.sin(k * pi * X)
        * np.sin(k * pi * Y),
    )


def poisson_mms_inhomogeneous(n: int) -> Problem:
    """u = x^2 + y^2 (inhomogeneous Dirichlet), f = -4."""
    return from_callables(
        "poisson_inhomogeneous", Grid(n, n),
        u_exact=lambda X, Y: X**2 + Y**2,
        f=lambda X, Y: -4.0 + 0.0 * X,
    )


def poisson_mms_exponential(n: int) -> Problem:
    """u = exp(x+y) sin(pi x) sin(pi y), f = -lap(u) with
    lap(u) = e^{x+y}[2 sin sin + 2 pi (cos sin + sin cos) - 2 pi^2 sin sin].
    """
    pi = np.pi

    def u(X, Y):
        return np.exp(X + Y) * np.sin(pi * X) * np.sin(pi * Y)

    def f(X, Y):
        E = np.exp(X + Y)
        sx, cx = np.sin(pi * X), np.cos(pi * X)
        sy, cy = np.sin(pi * Y), np.cos(pi * Y)
        lap = E * (2 * sx * sy + 2 * pi * (cx * sy + sx * cy)
                   - 2 * pi**2 * sx * sy)
        return -lap

    return from_callables("poisson_exponential", Grid(n, n), u_exact=u, f=f)


def poisson_mms_anisotropic(n: int, ax: float = 1.0,
                            ay: float = 0.01) -> Problem:
    """Anisotropy by unequal spacings: the y-domain is [0, sqrt(ay/ax)], so
    hy/hx = sqrt(ay/ax) and the y coupling is ax/ay times the x coupling;
    u = sin(pi x) sin(ky y) with ky = pi/sqrt(ay/ax), homogeneous
    Dirichlet. Point smoothers lose here; line smoothers along y do not."""
    aspect = float(np.sqrt(ay / ax))
    pi = np.pi
    ky = pi / aspect
    return from_callables(
        "poisson_anisotropic", Grid(n, n, (0.0, 1.0, 0.0, aspect)),
        u_exact=lambda X, Y: np.sin(pi * X) * np.sin(ky * Y),
        f=lambda X, Y: (pi**2 + ky**2) * np.sin(pi * X) * np.sin(ky * Y),
    )


def helmholtz_mms(n: int, k: float = 2.0) -> Problem:
    """-lap(u) - k^2 u = f with u = sin(pi x) sin(pi y):
    f = (2 pi^2 - k^2) u, a negative scalar lam; definite while
    k^2 < 2 pi^2."""
    pi = np.pi
    return from_callables(
        f"helmholtz_k{k}", Grid(n, n),
        u_exact=lambda X, Y: np.sin(pi * X) * np.sin(pi * Y),
        f=lambda X, Y: (2 * pi**2 - k**2) * np.sin(pi * X) * np.sin(pi * Y),
        lam=-float(k) ** 2,
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


def mixed_segment_problem(n: int) -> Problem:
    """Per-segment mixed sides: u = x^2 + y^2, f = -4; the east side is
    Dirichlet on y in [0, 0.5) and Robin (u + du/dn = g) on y in [0.5, 1],
    the north side Neumann (du/dn = 2) on x in [0, 0.5] and Dirichlet
    elsewhere. The quadratic u makes every ghost elimination exact."""
    grid = Grid(n, n)
    spec = BoundarySpec(
        east=bc_mod.BCSide(
            kind=BCKind.DIRICHLET,
            segments=(bc_mod.BCSegment(0.5, 1.0, kind=BCKind.ROBIN,
                                       alpha=1.0, beta=1.0),)),
        north=bc_mod.BCSide(
            kind=BCKind.DIRICHLET,
            segments=(bc_mod.BCSegment(0.0, 0.5, kind=BCKind.NEUMANN),)),
    )
    _, Y = grid.coordinates()
    return from_callables(
        "poisson_mixed_segments", grid,
        u_exact=lambda X, Y: X**2 + Y**2,
        f=lambda X, Y: -4.0 + 0.0 * X,
        spec=spec,
        bc_values={"east": (1.0 + Y**2) + 2.0, "north": 2.0},
    )


def mixed_segment_mms(n: int) -> Problem:
    """u = exp(x + y), f = -2 exp(x + y); the west side is Neumann
    (du/dn = -exp(y)) on y in [0.25, 0.75] and Dirichlet elsewhere. The data
    satisfy both conditions at the junctions, so second order holds."""
    grid = Grid(n, n)
    spec = BoundarySpec(
        west=bc_mod.BCSide(
            kind=BCKind.DIRICHLET,
            segments=(bc_mod.BCSegment(0.25, 0.75, kind=BCKind.NEUMANN),)),
    )
    X, Y = grid.coordinates()
    return from_callables(
        "poisson_mixed_segment_mms", grid,
        u_exact=lambda X, Y: np.exp(X + Y),
        f=lambda X, Y: -2.0 * np.exp(X + Y),
        spec=spec,
        bc_values={"west": -np.exp(X + Y)},
    )


def periodic_helmholtz_mms(n: int) -> Problem:
    """-lap(u) + u = f, periodic on [0, 1]^2: u = sin(2 pi x) cos(2 pi y),
    f = (8 pi^2 + 1) u. The shift makes the periodic operator nonsingular."""
    pi = np.pi
    side = bc_mod.BCSide(kind=BCKind.PERIODIC)
    return from_callables(
        "periodic_helmholtz", Grid(n, n),
        u_exact=lambda X, Y: np.sin(2 * pi * X) * np.cos(2 * pi * Y),
        f=lambda X, Y: (8 * pi**2 + 1) * np.sin(2 * pi * X)
        * np.cos(2 * pi * Y),
        spec=BoundarySpec(side, side, side, side),
        lam=1.0,
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


def boundary_layer_problem(n: int, eps: float = 0.05) -> Problem:
    """Exponential boundary layer of width eps at x = 0: u = g(x) sin(pi y)
    with g(x) = (1 - e^{-x/eps}) - x (1 - e^{-1/eps}) (homogeneous
    Dirichlet) and f = (pi^2 g - g'') sin(pi y), g'' = -e^{-x/eps}/eps^2.
    Second order holds once h < eps."""
    pi = np.pi
    c1 = 1.0 - np.exp(-1.0 / eps)

    def g(X):
        return (1.0 - np.exp(-X / eps)) - X * c1

    def f(X, Y):
        gpp = -(1.0 / eps**2) * np.exp(-X / eps)
        return (pi**2 * g(X) - gpp) * np.sin(pi * Y)

    return from_callables(f"boundary_layer_eps{eps:g}", Grid(n, n),
                          u_exact=lambda X, Y: g(X) * np.sin(pi * Y), f=f)


def _corner_uexact(xc: float, yc: float, clockwise: bool):
    """r^(2/3) sin(2 theta / 3) around (xc, yc)."""

    def u(X, Y):
        dx = X - xc
        dy = Y - yc
        r = np.sqrt(dx * dx + dy * dy)
        if clockwise:  # re-entrant corner: theta in [0, 3 pi/2], cw from +x
            phi = np.arctan2(-dy, dx)
            theta = np.where(phi >= 0.0, phi, phi + 2.0 * np.pi)
        else:          # convex corner at the origin: theta in [0, pi/2]
            theta = np.arctan2(dy, dx)
        return r ** (2.0 / 3.0) * np.sin(2.0 * theta / 3.0)

    return u


def corner_singularity_problem(n: int) -> Problem:
    """Harmonic u = r^(2/3) sin(2 theta/3) around the (0, 0) corner of the
    unit square: f = 0, inhomogeneous Dirichlet data from u. The gradient's
    singularity at the corner (u is only in H^(1+2/3)) lowers the expected
    L2 order to 4/3."""
    prob = from_callables(
        "corner_singularity", Grid(n, n),
        u_exact=_corner_uexact(0.0, 0.0, clockwise=False),
        f=lambda X, Y: 0.0 * X)
    return dataclasses.replace(prob, expected_order=4.0 / 3.0)


def l_shaped_problem(n: int) -> Problem:
    """The L-shaped domain: the unit square minus the [1/2, 1]^2 quadrant,
    u = r^(2/3) sin(2 theta/3) around the re-entrant corner, theta measured
    clockwise from the cut edge {y = 1/2, x > 1/2}, so that u vanishes on
    both cut edges (theta = 0 and 3 pi/2); f = 0 and the outer Dirichlet
    data come from u. Expected L2 order ~4/3."""
    domain = LShapedDomain(0.5, 0.5)
    u_fn = _corner_uexact(0.5, 0.5, clockwise=True)

    def u_masked(X, Y):
        # zero strictly inside the removed quadrant, which no solve reads
        removed_open = (X > 0.5 + 1e-12) & (Y > 0.5 + 1e-12)
        return np.where(removed_open, 0.0, u_fn(X, Y))

    prob = from_callables("l_shaped", Grid(n, n), u_exact=u_masked,
                          f=lambda X, Y: 0.0 * X)
    return dataclasses.replace(prob, domain=domain, expected_order=4.0 / 3.0)


CATALOGUE = {
    "trigonometric": poisson_mms_sinsin,
    "polynomial": poisson_mms_polynomial,
    "high_frequency": poisson_mms_high_frequency,
    "mixed": poisson_mms_inhomogeneous,
    "exponential": poisson_mms_exponential,
    "anisotropic": poisson_mms_anisotropic,
    "neumann_test": neumann_test_problem,
    "helmholtz": helmholtz_mms,
    "variable_coefficient": variable_coefficient_mms,
    "jump_coefficient": jump_coefficient_problem,
    "periodic_helmholtz": periodic_helmholtz_mms,
    "robin_test": robin_test_problem,
    "mixed_segments": mixed_segment_problem,
    "mixed_segments_mms": mixed_segment_mms,
    "boundary_layer": boundary_layer_problem,
    "corner_singularity": corner_singularity_problem,
    "l_shaped": l_shaped_problem,
}
