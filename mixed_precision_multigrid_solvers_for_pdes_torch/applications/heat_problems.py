"""Heat-equation MMS test problems.

Counterpart of the twelve factories and ``CATALOGUE`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/applications/heat_problems.py``
(``separable`` returns ``pure_diffusion``'s problem). Exact solutions and
sources are the same hand-derived formulas, written in torch ops on (X, Y)
tensors of the state's device.

They reproduce the JAX package's dtypes. There the time ``t`` is a strong
float64 scalar, so a float32 spatial factor times a time factor is a
float64 product (rounded to float32 only by the caller), while torch would
keep float32 when a 0-d float64 tensor meets a float32 tensor. ``_up``
promotes a spatial factor to the time factor's dtype first, as JAX does;
Python numbers combine as JAX's weak scalars do, in the tensor's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import bc as bc_mod
from ..core.grid import Grid
from .heat import HeatProblem, heat_problem_from_callables

PI = np.pi


def _up(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype JAX gives ``x`` op ``t`` for a strong 0-d ``t``."""
    return x.to(torch.promote_types(x.dtype, t.dtype))


def _sin_sin(X, Y, k: float = 1.0):
    return torch.sin(k * PI * X) * torch.sin(k * PI * Y)


def pure_diffusion(n: int, alpha: float = 1.0) -> HeatProblem:
    """u = sin(pi x) sin(pi y) exp(-2 pi^2 alpha t); q = 0."""

    def exact(X, Y, t):
        e = torch.exp(-2 * PI**2 * alpha * t)
        return _up(_sin_sin(X, Y), e) * e

    return heat_problem_from_callables(
        "heat_pure_diffusion", Grid(n, n), alpha=alpha, exact=exact
    )


def heat_source(n: int, alpha: float = 1.0) -> HeatProblem:
    """Steady-in-time manufactured state u = sin(pi x) sin(pi y) (u_t = 0):
    q = -alpha lap u = 2 pi^2 alpha u."""

    def exact(X, Y, t):
        z = 0.0 * t
        return _up(_sin_sin(X, Y), z) + z

    def q(X, Y, t):
        z = 0.0 * t
        s = 2 * PI**2 * alpha * torch.sin(PI * X) * torch.sin(PI * Y)
        return _up(s, z) + z

    return heat_problem_from_callables(
        "heat_source", Grid(n, n), alpha=alpha, exact=exact, q=q
    )


def exponential_decay(n: int, alpha: float = 1.0, rate: float = 1.0) -> HeatProblem:
    """u = sin(pi x) sin(pi y) e^{-rate t} with compensating source:
    q = u_t - alpha lap u = (-rate + 2 pi^2 alpha) u."""

    k = -rate + 2 * PI**2 * alpha

    def exact(X, Y, t):
        e = torch.exp(-rate * t)
        return _up(_sin_sin(X, Y), e) * e

    def q(X, Y, t):
        e = torch.exp(-rate * t)
        return _up(k * torch.sin(PI * X) * torch.sin(PI * Y), e) * e

    return heat_problem_from_callables(
        "heat_exponential", Grid(n, n), alpha=alpha, exact=exact, q=q
    )


def polynomial_time(n: int, alpha: float = 1.0) -> HeatProblem:
    """u = (1 + t + t^2) x(1-x) y(1-y):
    q = (1+2t) x(1-x)y(1-y) + 2 alpha (1+t+t^2)(x(1-x)+y(1-y))."""

    def s(X, Y):
        return X * (1 - X) * Y * (1 - Y)

    def exact(X, Y, t):
        p = 1 + t + t * t
        return p * _up(s(X, Y), p)

    def q(X, Y, t):
        a = 1 + 2 * t
        b = 2 * alpha * (1 + t + t * t)
        return a * _up(s(X, Y), a) + b * _up(X * (1 - X) + Y * (1 - Y), b)

    return heat_problem_from_callables(
        "heat_polynomial_time", Grid(n, n), alpha=alpha, exact=exact, q=q
    )


def oscillating(n: int, alpha: float = 1.0, omega: float = 2 * PI) -> HeatProblem:
    """u = sin(pi x) sin(pi y) cos(omega t):
    q = (-omega sin(omega t) + 2 pi^2 alpha cos(omega t)) sin(pi x) sin(pi y)."""

    def exact(X, Y, t):
        c = torch.cos(omega * t)
        return _up(_sin_sin(X, Y), c) * c

    def q(X, Y, t):
        f = (-omega * torch.sin(omega * t)
             + 2 * PI**2 * alpha * torch.cos(omega * t))
        return _up(_sin_sin(X, Y), f) * f

    return heat_problem_from_callables(
        "heat_oscillating", Grid(n, n), alpha=alpha, exact=exact, q=q
    )


def spatially_exact_oscillating(n: int, alpha: float = 1.0,
                                omega: float = 2 * PI) -> HeatProblem:
    """u = (x^2 + y^2) cos(omega t): quadratic in space, so the 5-point
    stencil has ZERO spatial error and the measured error is temporal.
    q = -(x^2+y^2) omega sin(omega t) - 4 alpha cos(omega t)."""

    def exact(X, Y, t):
        c = torch.cos(omega * t)
        return _up(X**2 + Y**2, c) * c

    def q(X, Y, t):
        s = torch.sin(omega * t)
        c = 4 * alpha * torch.cos(omega * t)
        return _up(-(X**2 + Y**2) * omega, s) * s - c

    return heat_problem_from_callables(
        "heat_spatially_exact_osc", Grid(n, n), alpha=alpha, exact=exact, q=q
    )


def gaussian_diffusion(n: int, alpha: float = 1.0, t0: float = 0.01) -> HeatProblem:
    """Free-space Gaussian, valid while mass stays far from the boundary:
    u = 1/(4 pi alpha (t+t0)) exp(-r^2/(4 alpha (t+t0))), q = 0. The
    Dirichlet ring tracks the exact (tiny) boundary values."""

    def exact(X, Y, t):
        tau = 4 * alpha * (t + t0)
        r2 = (X - 0.5) ** 2 + (Y - 0.5) ** 2
        return torch.exp(-_up(r2, tau) / tau) / (PI * tau)

    return heat_problem_from_callables(
        "heat_gaussian", Grid(n, n), alpha=alpha, exact=exact
    )


def multiple_frequencies(n: int, alpha: float = 1.0) -> HeatProblem:
    """u = sum_k sin(k pi x) sin(k pi y) e^{-2 k^2 pi^2 alpha t}, k in
    {1,2,3}; q = 0: each mode decays at its own rate."""

    def exact(X, Y, t):
        u = 0.0
        for k in (1, 2, 3):
            e = torch.exp(-2 * k * k * PI**2 * alpha * t)
            u = u + _up(_sin_sin(X, Y, k), e) * e
        return u

    return heat_problem_from_callables(
        "heat_multifreq", Grid(n, n), alpha=alpha, exact=exact
    )


def traveling_wave(n: int, alpha: float = 1.0, c: float = 1.0) -> HeatProblem:
    """u = exp(-(x - c t)): u_x = -u, u_xx = u, u_t = c u, so
    q = (c - alpha) u."""

    def exact(X, Y, t):
        ct = c * t
        u = torch.exp(-(_up(X, ct) - ct))
        return u + _up(0.0 * Y, u)

    def q(X, Y, t):
        return (c - alpha) * exact(X, Y, t)

    return heat_problem_from_callables(
        "heat_traveling_wave", Grid(n, n), alpha=alpha, exact=exact, q=q
    )


def time_dependent_bc(n: int, alpha: float = 1.0) -> HeatProblem:
    """u = (x^2 + y^2) (1 + t): time-dependent inhomogeneous Dirichlet data;
    q = (x^2+y^2) - 4 alpha (1+t)."""

    def exact(X, Y, t):
        p = 1 + t
        return _up(X**2 + Y**2, p) * p

    def q(X, Y, t):
        p = 4 * alpha * (1 + t)
        return _up(X**2 + Y**2, p) - p

    return heat_problem_from_callables(
        "heat_time_dependent_bc", Grid(n, n), alpha=alpha, exact=exact, q=q
    )


def separable(n: int, alpha: float = 1.0) -> HeatProblem:
    """u = e^{-alpha pi^2 t} sin(pi x) * e^{-alpha pi^2 t} sin(pi y): the
    pure-diffusion mode written as a separable product; q = 0."""
    return pure_diffusion(n, alpha)


def neumann_heat(n: int, alpha: float = 1.0) -> HeatProblem:
    """u = cos(pi x) cos(pi y) e^{-2 pi^2 alpha t}: du/dn = 0 on all sides,
    q = 0. The implicit operator A_sp + lam is nonsingular for lam > 0, so
    pure Neumann is well posed per step."""

    def exact(X, Y, t):
        e = torch.exp(-2 * PI**2 * alpha * t)
        return _up(torch.cos(PI * X) * torch.cos(PI * Y), e) * e

    return heat_problem_from_callables(
        "heat_neumann", Grid(n, n), alpha=alpha, spec=bc_mod.neumann(),
        exact=exact
    )


CATALOGUE = {
    "spatially_exact_oscillating": spatially_exact_oscillating,
    "pure_diffusion": pure_diffusion,
    "heat_source": heat_source,
    "exponential_decay": exponential_decay,
    "polynomial_time": polynomial_time,
    "oscillating": oscillating,
    "gaussian_diffusion": gaussian_diffusion,
    "multiple_frequencies": multiple_frequencies,
    "traveling_wave": traveling_wave,
    "time_dependent_bc": time_dependent_bc,
    "separable": separable,
    "neumann_heat": neumann_heat,
}

# HeatProblem.name -> CATALOGUE key ('separable' builds pure_diffusion's)
BY_NAME = {
    "heat_spatially_exact_osc": "spatially_exact_oscillating",
    "heat_pure_diffusion": "pure_diffusion",
    "heat_source": "heat_source",
    "heat_exponential": "exponential_decay",
    "heat_polynomial_time": "polynomial_time",
    "heat_oscillating": "oscillating",
    "heat_gaussian": "gaussian_diffusion",
    "heat_multifreq": "multiple_frequencies",
    "heat_traveling_wave": "traveling_wave",
    "heat_time_dependent_bc": "time_dependent_bc",
    "heat_neumann": "neumann_heat",
}
