"""Plain PyTorch 3D smoothers: weighted Jacobi and red-black Gauss-Seidel.

Counterpart of ``smooth3d`` (methods 'jacobi', the RB-GS names and
'rbgs_rev') in ``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/
multigrid3d.py``, which the port's ``solvers/multigrid3d.py`` re-exports. It
lives under ``ops`` beside the 2D smoothers so that the smoothing kernel's
wrapper (``ops/cuda_kernels/smooth3d.py``), which holds kernel E against it,
need not import the solvers.

Every smoother updates ``u`` IN PLACE on its unknown interior nodes and
returns it. The colour of node (i, j, k) is that of its global index: red
where (i + j + k) is even. The zebra line smoother 'line_z' is ROADMAP
item 13.
"""

from __future__ import annotations

import torch

from . import stencil3d as st3
from .smooth import RBGS_METHODS
from .stencil import divide
from .stencil3d import Stencil3D, interior


def _red_interior3(u: torch.Tensor) -> torch.Tensor:
    """Red ((i + j + k) even) mask over the interior nodes of ``u``."""
    odd = [torch.arange(1, n - 1, device=u.device) % 2 == 1 for n in u.shape]
    return ~(odd[0][:, None, None] ^ odd[1][None, :, None]
             ^ odd[2][None, None, :])


def jacobi_sweep3d(st: Stencil3D, u, f, unknown, omega):
    """One weighted-Jacobi sweep, u += omega * (f - A u) / c on unknowns."""
    ui = interior(u)
    r = interior(f) - (st.c * ui - st3.neighbor_sum(st, u))
    new = ui + divide(omega * r, st.c)
    ui.copy_(torch.where(interior(unknown), new, ui))
    return u


def rb_color_update3d(st: Stencil3D, u, f, unknown, color_mask, omega):
    """Gauss-Seidel update of one colour, u = u + omega*((f + nbsum)/c - u).

    ``color_mask`` covers the interior nodes, shape (nx-2, ny-2, nz-2)."""
    ui = interior(u)
    u_gs = divide(interior(f) + st3.neighbor_sum(st, u), st.c)
    new = ui + omega * (u_gs - ui)
    ui.copy_(torch.where(color_mask & interior(unknown), new, ui))
    return u


def rbgs_sweep3d(st: Stencil3D, u, f, unknown, omega=1.0,
                 reverse: bool = False):
    """One red-black Gauss-Seidel sweep: red then black, or black then red
    with ``reverse``."""
    red = _red_interior3(u)
    first, second = (~red, red) if reverse else (red, ~red)
    rb_color_update3d(st, u, f, unknown, first, omega)
    rb_color_update3d(st, u, f, unknown, second, omega)
    return u


def smooth3d(st: Stencil3D, u, f, unknown, *, method: str = "rbgs",
             sweeps: int = 2, omega: float = 1.0, reverse: bool = False):
    """Run ``sweeps`` sweeps of ``method`` in place on ``u``.

    ``method``: 'jacobi', one of the RB-GS names ('rbgs', 'gauss_seidel',
    'red_black', 'sor'), or 'rbgs_rev'; ``reverse`` (or 'rbgs_rev') runs
    black before red."""
    if method == "jacobi":
        for _ in range(sweeps):
            jacobi_sweep3d(st, u, f, unknown, omega)
    elif method in RBGS_METHODS or method == "rbgs_rev":
        rev = reverse or method == "rbgs_rev"
        for _ in range(sweeps):
            rbgs_sweep3d(st, u, f, unknown, omega, reverse=rev)
    elif method in ("line_z", "zebra_z"):
        raise NotImplementedError(
            f"3D smoother {method!r} is not ported yet (ROADMAP item 13)")
    else:
        raise ValueError(f"unknown 3D smoother {method!r}")
    return u
