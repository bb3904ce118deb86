"""Plain PyTorch 3D smoothers: weighted Jacobi, red-black Gauss-Seidel and
the zebra line smoother along z.

Counterpart of ``smooth3d`` (methods 'jacobi', the RB-GS names, 'rbgs_rev'
and 'line_z'/'zebra_z') in ``mixed_precision_multigrid_solvers_for_pdes_tpu/
solvers/multigrid3d.py``, which the port's ``solvers/multigrid3d.py``
re-exports. It lives under ``ops`` beside the 2D smoothers so that the
smoothing kernel's wrapper (``ops/cuda_kernels/smooth3d.py``), which holds
kernel E against it, need not import the solvers.

Every smoother updates ``u`` IN PLACE on its unknown nodes and returns it.
The stencil acts on ``ops/stencil3d.region``: the interior for a scalar
stencil, every node for a tensor stencil or a ``Stencil27`` (Neumann/Robin
face unknowns are smoothed too), nodes 0..n-2 with wrap neighbours on a
periodic axis. The colour of node (i, j, k) is that of its global index:
red where (i + j + k) is even. 'line_z' relaxes the lines along z of even
(i + j), then the odd ones, with an exact tridiagonal solve per line
(``ops/tridiag.py``) and every other coupling lagged; along a periodic z
axis a line holds the unique nodes 0..n-2, and its two couplings across the
seam are lagged as well, as in the JAX package. ``sync`` (the level's
``periodic_sync3d``), when given, refreshes the duplicate nodes before each
update, as the JAX smoothers do; the port's operators never read them, so
the cycle passes none and syncs where a duplicate is read.
"""

from __future__ import annotations

import torch

from . import stencil3d as st3
from . import tridiag
from .smooth import RBGS_METHODS
from .stencil import divide
from .stencil3d import coef, region
from .tridiag import _zshift

LINE_METHODS = ("line_z", "zebra_z")


def _red3(st, u: torch.Tensor) -> torch.Tensor:
    """Red ((i + j + k) even) mask over ``region(st, u)``, built from the
    three axes' parities (no full-size index field)."""
    odd = [(torch.arange(n, device=u.device) % 2 == 1)[sl].reshape(
        [-1 if a == ax else 1 for a in range(3)])
        for ax, (n, sl) in enumerate(zip(u.shape, st3.region_slices(st)))]
    return ~(odd[0] ^ odd[1] ^ odd[2])


def jacobi_sweep3d(st, u, f, unknown, omega):
    """One weighted-Jacobi sweep, u += omega * (f - A u) / c on unknowns."""
    ui, c = region(st, u), coef(st, st.c)
    r = region(st, f) - (c * ui - st3.neighbor_sum(st, u))
    new = ui + divide(omega * r, c)
    ui.copy_(torch.where(region(st, unknown), new, ui))
    return u


def rb_color_update3d(st, u, f, unknown, color_mask, omega):
    """Gauss-Seidel update of one colour, u = u + omega*((f + nbsum)/c - u).

    ``color_mask`` covers ``region(st, u)``."""
    ui = region(st, u)
    u_gs = divide(region(st, f) + st3.neighbor_sum(st, u), coef(st, st.c))
    new = ui + omega * (u_gs - ui)
    ui.copy_(torch.where(color_mask & region(st, unknown), new, ui))
    return u


def rbgs_sweep3d(st, u, f, unknown, omega=1.0, reverse: bool = False,
                 sync=None):
    """One red-black Gauss-Seidel sweep: red then black, or black then red
    with ``reverse``."""
    red = _red3(st, u)
    for mask in ((~red, red) if reverse else (red, ~red)):
        if sync is not None:
            sync(u)
        rb_color_update3d(st, u, f, unknown, mask, omega)
    return u


def _full(leaf, u) -> torch.Tensor:
    """A coupling leaf as an (nx, ny, nz) field."""
    return leaf * torch.ones_like(u)


def _line_z_system(st, unknown, u) -> tuple:
    """What a z-line update takes from the stencil and the unknowns alone,
    the same for every sweep and colour: the z couplings and the factored
    solve. A coupling to a fixed z neighbour (or one across a periodic
    seam) leaves the matrix and moves to the right-hand side; rows off the
    unknowns are identity rows."""
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    lo_c = _full(st3.coupling(st, (0, 0, -1)), u)
    hi_c = _full(st3.coupling(st, (0, 0, 1)), u)
    lo_unknown = _zshift(unknown, 1, 2)
    hi_unknown = _zshift(unknown, -1, 2)
    dl = torch.where(unknown & lo_unknown, -lo_c, zero)
    du = torch.where(unknown & hi_unknown, -hi_c, zero)
    d = torch.where(unknown, _full(st.c, u),
                    torch.ones((), dtype=u.dtype, device=u.device))
    return lo_c, hi_c, lo_unknown, hi_unknown, tridiag.pcr_factor(dl, d, du,
                                                                  2)


def _z_neighbours(st, u):
    """(u[k-1], u[k+1]) as (nx, ny, nz) fields: zero outside the array, the
    wrap neighbours across a periodic z seam (node n-2 below node 0, node 0
    above node n-2)."""
    lo, hi = _zshift(u, 1, 2), _zshift(u, -1, 2)
    if st.wrap[2]:
        lo[:, :, 0] = u[:, :, -2]
        hi[:, :, -2] = u[:, :, 0]
    return lo, hi


def _line_z_update(st, u, f, unknown, color_mask, system, nb=None):
    """Zebra line relaxation along z for the lines picked by ``color_mask``
    ((nx, ny, nz)): the x/y couplings (and a ``Stencil27``'s edges and
    corners) lagged, the b/t couplings in the tridiagonal. ``nb``, the
    neighbour sum on the unknowns, is computed from ``u`` when not given
    (``parallel.blocks3d`` gives a block's, taken across its halo)."""
    lo_c, hi_c, lo_unknown, hi_unknown, factor = system
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    if nb is None:
        nb = torch.zeros_like(u)
        region(st, nb)[...] = st3.neighbor_sum(st, u)
    lo_val, hi_val = _z_neighbours(st, u)
    rhs = f + nb - lo_c * lo_val - hi_c * hi_val
    rhs = rhs + torch.where(lo_unknown, zero, lo_c * lo_val)
    rhs = rhs + torch.where(hi_unknown, zero, hi_c * hi_val)
    rhs = torch.where(unknown, rhs, zero)
    z = tridiag.pcr_apply(factor, rhs)
    return u.copy_(torch.where(color_mask & unknown, z, u))


def line_z_sweep3d(st, u, f, unknown, system=None, sync=None):
    """One zebra line-GS sweep along z: the lines of even (i + j), then the
    odd ones. ``system`` (``_line_z_system``) is built when not given."""
    if system is None:
        system = _line_z_system(st, unknown, u)
    nx, ny, _ = u.shape
    ij = (torch.arange(nx, device=u.device)[:, None]
          + torch.arange(ny, device=u.device)[None, :])
    even = (ij % 2 == 0)[:, :, None].expand(u.shape)
    for mask in (even, ~even):
        if sync is not None:
            sync(u)
        _line_z_update(st, u, f, unknown, mask, system)
    return u


def smooth3d(st, u, f, unknown, *, method: str = "rbgs", sweeps: int = 2,
             omega: float = 1.0, reverse: bool = False, sync=None):
    """Run ``sweeps`` sweeps of ``method`` in place on ``u``.

    ``method``: 'jacobi', one of the RB-GS names ('rbgs', 'gauss_seidel',
    'red_black', 'sor'), 'rbgs_rev', or 'line_z'/'zebra_z'; ``reverse``
    (or 'rbgs_rev') runs black before red. ``sync`` refreshes the periodic
    duplicates before each update (see the module docstring)."""
    if method == "jacobi":
        for _ in range(sweeps):
            if sync is not None:
                sync(u)
            jacobi_sweep3d(st, u, f, unknown, omega)
    elif method in RBGS_METHODS or method == "rbgs_rev":
        rev = reverse or method == "rbgs_rev"
        for _ in range(sweeps):
            rbgs_sweep3d(st, u, f, unknown, omega, reverse=rev, sync=sync)
    elif method in LINE_METHODS:
        system = _line_z_system(st, unknown, u)
        for _ in range(sweeps):
            line_z_sweep3d(st, u, f, unknown, system, sync=sync)
    else:
        raise ValueError(f"unknown 3D smoother {method!r}")
    return u
