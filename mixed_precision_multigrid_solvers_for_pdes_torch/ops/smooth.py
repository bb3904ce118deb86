"""Plain PyTorch smoothers: weighted Jacobi, red-black Gauss-Seidel, SOR,
zebra line Gauss-Seidel (x, y and ADI) and Chebyshev.

Counterpart of ``optimal_sor_omega``, ``optimal_jacobi_omega``,
``jacobi_sweep``, ``rb_color_update``, ``rbgs_sweep``,
``_line_update``, ``line_sweep``, ``chebyshev_smooth`` and ``smooth`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/smooth.py``. These are
the plain twins that the smoothing kernels (``ops/cuda_kernels/smooth.py``
and ``smooth_var.py``) are held against, and the path every configuration
the kernels do not take runs on: periodic and segmented levels, and the
line, ADI and Chebyshev smoothers everywhere.

Every smoother updates ``u`` IN PLACE on its unknown nodes (it saves one
full-size copy per colour update) and returns it. A scalar stencil acts on
the interior; a tensor stencil acts on every node, so Neumann/Robin ring
unknowns are smoothed too; a periodic axis (``Stencil.wrap``) acts on nodes
0..n-2 with wrap neighbours (``ops/stencil.region``), and the line
smoothers solve the cyclic system along it. No update reads the duplicate
nodes (n-1) of a periodic axis, so the smoothers leave them as they are:
the cycle refreshes them where a prolongation reads them, and the solvers
at their end. The JAX smoothers take ``sync`` and ``cyclic_axes``
arguments because its stencils read the duplicates and do not know their
periodic axes; the port's stencils know their axes. Updates divide by
``c`` as the JAX package's XLA smoothers do. The colour of node (i, j) is
that of its global index: red where (i + j) is even. A ``Stencil9`` (a
Galerkin level) smooths through the same code: its neighbour sum has the
corners, so a colour update reads the pre-colour field at all eight
neighbours, as the JAX package's whole-array update does, and the line
smoothers keep the line pair in the tridiagonal and lag the rest, corners
included.
"""

from __future__ import annotations

import math

import torch

from . import stencil as st_mod
from .stencil import Stencil, coef, region
from . import tridiag
from .tridiag import _zshift

RBGS_METHODS = ("rbgs", "gauss_seidel", "red_black", "sor")
LINE_METHODS = ("line_x", "line_y", "adi")
METHODS = ("jacobi", "rbgs_rev", "chebyshev") + RBGS_METHODS + LINE_METHODS


def optimal_sor_omega(nx: int, ny: int) -> float:
    """omega* = 2 / (1 + sin(pi h)) for the 5-point Laplacian."""
    h = 1.0 / (max(nx, ny) - 1)
    return 2.0 / (1.0 + math.sin(math.pi * h))


def optimal_jacobi_omega() -> float:
    """Damped-Jacobi smoothing optimum for the 2D 5-point Laplacian
    (4/5)."""
    return 0.8


def _red(st: Stencil, u: torch.Tensor) -> torch.Tensor:
    """Red (i + j even) mask over ``region(st, u)``."""
    nx, ny = u.shape
    i = region(st, torch.arange(nx, device=u.device)[:, None].expand(nx, ny))
    j = region(st, torch.arange(ny, device=u.device)[None, :].expand(nx, ny))
    return (i + j) % 2 == 0


def jacobi_sweep(st: Stencil, u, f, unknown, omega):
    """One weighted-Jacobi sweep, u += omega * (f - A u) / c on unknowns."""
    ui, c = region(st, u), coef(st, st.c)
    r = region(st, f) - (c * ui - st_mod.neighbor_sum(st, u))
    new = ui + st_mod.divide(omega * r, c)
    ui[...] = torch.where(region(st, unknown), new, ui)
    return u


def rb_color_update(st: Stencil, u, f, unknown, color_mask, omega):
    """Gauss-Seidel update of one colour, u = u + omega*((f + nbsum)/c - u).

    ``color_mask`` covers ``region(st, u)``."""
    ui = region(st, u)
    u_gs = st_mod.divide(region(st, f) + st_mod.neighbor_sum(st, u),
                         coef(st, st.c))
    new = ui + omega * (u_gs - ui)
    ui[...] = torch.where(color_mask & region(st, unknown), new, ui)
    return u


def rbgs_sweep(st: Stencil, u, f, unknown, omega=1.0,
               reverse: bool = False):
    """One red-black Gauss-Seidel sweep: red then black, or black then red
    with ``reverse`` (the adjoint order that makes a cycle symmetric). On a
    periodic axis of odd unique extent the colours meet at the seam, where
    the update is Jacobi-like, as in the JAX package."""
    red = _red(st, u)
    first, second = (~red, red) if reverse else (red, ~red)
    rb_color_update(st, u, f, unknown, first, omega)
    rb_color_update(st, u, f, unknown, second, omega)
    return u


def _full(st: Stencil, u, x) -> torch.Tensor:
    """(nx, ny) tensor holding ``x`` (given over ``region(st, u)``) on the
    region and zero elsewhere; off-region values are never used."""
    out = torch.zeros_like(u)
    region(st, out)[...] = x
    return out


def _line_system(st: Stencil, unknown, axis: int, u) -> tuple:
    """What a line update along ``axis`` takes from the stencil and the
    unknowns alone, the same for every sweep and colour: the line couplings
    and the factored solve. Along a periodic axis the solve is the cyclic
    one on the n-1 unique nodes; otherwise a coupling to a fixed line
    neighbour leaves the matrix (it moves to the right-hand side) and the
    rows off the unknowns are identity rows."""
    ones = torch.ones_like(u)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    c = st.c * ones
    lo_c, hi_c = ((st.s * ones, st.n * ones) if axis == 1
                  else (st.w * ones, st.e * ones))
    if st.wrap[axis]:
        m = u.shape[axis] - 1
        core = [x.narrow(axis, 0, m) for x in (lo_c, c, hi_c)]
        return lo_c, hi_c, None, None, tridiag.cyclic_factor(
            -core[0], core[1], -core[2], axis)
    # the line neighbours outside the array read zero, the JAX padding
    lo_unknown = _zshift(unknown, 1, axis)
    hi_unknown = _zshift(unknown, -1, axis)
    dl = torch.where(unknown, torch.where(lo_unknown, -lo_c, zero), zero)
    du = torch.where(unknown, torch.where(hi_unknown, -hi_c, zero), zero)
    d = torch.where(unknown, c, torch.ones((), dtype=u.dtype,
                                           device=u.device))
    return lo_c, hi_c, lo_unknown, hi_unknown, tridiag.pcr_factor(dl, d, du,
                                                                  axis)


def _line_update(st: Stencil, u, f, unknown, axis: int, color_mask, system):
    """Zebra line relaxation: an exact tridiagonal solve along ``axis`` for
    the lines picked by ``color_mask`` ((nx, ny)), the cross-direction
    couplings lagged; ``system`` is the axis's ``_line_system``."""
    lo_c, hi_c, lo_unknown, hi_unknown, factor = system
    rhs = f + _full(st, u, st_mod.neighbor_sum(st, u))
    if st.wrap[axis]:
        def core(x):  # the unique nodes 0..n-2 of the line axis
            return x.narrow(axis, 0, u.shape[axis] - 1)

        uc = core(u)
        rhs = (core(rhs) - core(lo_c) * torch.roll(uc, 1, axis)
               - core(hi_c) * torch.roll(uc, -1, axis))
        z = torch.zeros_like(u)
        core(z).copy_(tridiag.cyclic_apply(factor, rhs))
        return u.copy_(torch.where(color_mask & unknown, z, u))

    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    lo_val, hi_val = _zshift(u, 1, axis), _zshift(u, -1, axis)
    rhs = rhs - lo_c * lo_val - hi_c * hi_val
    rhs = rhs + torch.where(lo_unknown, zero, lo_c * lo_val)
    rhs = rhs + torch.where(hi_unknown, zero, hi_c * hi_val)
    rhs = torch.where(unknown, rhs, zero)
    z = tridiag.pcr_apply(factor, rhs)
    return u.copy_(torch.where(color_mask & unknown, z, u))


def line_sweep(st: Stencil, u, f, unknown, axis: int, system=None):
    """One zebra line-GS sweep along ``axis``: the lines of even index
    across it, then the odd ones. ``system`` (``_line_system``) is built
    when not given."""
    if system is None:
        system = _line_system(st, unknown, axis, u)
    idx = torch.arange(u.shape[1 - axis], device=u.device)
    even = (idx % 2 == 0)[None, :] if axis == 0 else (idx % 2 == 0)[:, None]
    even = even.expand(u.shape)
    _line_update(st, u, f, unknown, axis, even, system)
    _line_update(st, u, f, unknown, axis, ~even, system)
    return u


def chebyshev_smooth(st: Stencil, u, f, unknown, *, degree: int = 3,
                     spectrum_fraction: float = 0.25):
    """Degree-``degree`` Chebyshev polynomial smoother on the Jacobi-scaled
    operator D^-1 A, aimed at its upper spectrum [fraction*lmax, lmax] with
    lmax = 2 (a Gershgorin bound whenever c >= the sum of the couplings).
    Colourless, so a periodic seam needs nothing special."""
    lmax = 2.0
    lmin = spectrum_fraction * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    zero = torch.zeros((), dtype=u.dtype, device=u.device)

    def dinv_a(x):
        return torch.where(unknown, st_mod.apply(st, x) / st.c, zero)

    r = torch.where(unknown, f - st_mod.apply(st, u), zero)
    dinv_r = r / st.c
    rho_old = 1.0 / sigma
    z = (1.0 / theta) * dinv_r
    d = z
    for _ in range(degree - 1):
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = (rho * rho_old) * d + (2.0 * rho / delta) * (dinv_r - dinv_a(z))
        z = z + d
        rho_old = rho
    return u.copy_(torch.where(unknown, u + z, u))


def smooth(st: Stencil, u, f, unknown, *, method: str = "jacobi",
           sweeps: int = 2, omega: float = 0.8):
    """Run ``sweeps`` sweeps of ``method`` in place on ``u``.

    ``method``: 'jacobi', one of the RB-GS names ('rbgs', 'gauss_seidel',
    'red_black', 'sor'), 'rbgs_rev' for the reversed colour order,
    'line_x', 'line_y', 'adi' (line_y then line_x) or 'chebyshev' (one
    polynomial of degree 2*sweeps, as many stencil applications as
    ``sweeps`` RB-GS sweeps)."""
    if method not in METHODS:
        raise ValueError(f"unknown smoother {method!r}")
    if method == "chebyshev":
        return chebyshev_smooth(st, u, f, unknown, degree=2 * sweeps)
    if method in LINE_METHODS:
        # ADI: along y, then along x; each axis's system is built once
        axes = {"line_x": (0,), "line_y": (1,), "adi": (1, 0)}[method]
        systems = [_line_system(st, unknown, axis, u) for axis in axes]
    for _ in range(sweeps):
        if method == "jacobi":
            jacobi_sweep(st, u, f, unknown, omega)
        elif method in RBGS_METHODS or method == "rbgs_rev":
            rbgs_sweep(st, u, f, unknown, omega,
                       reverse=method == "rbgs_rev")
        else:
            for axis, system in zip(axes, systems):
                line_sweep(st, u, f, unknown, axis, system)
    return u
