"""Kernel E: 3D red-black Gauss-Seidel sweeps (``csrc/smooth3d.cu``) and
their plain twin.

Replaces the Pallas ``rbgs_planes`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth3d.py``
(:178) for constant-coefficient 7-point stencils on all-Dirichlet boxes in
fp32. The source note in ``csrc/smooth3d.cu`` gives the design and what
bounds it. Like the Pallas kernel it runs the RB-GS family only; weighted
Jacobi stays on the plain path (``ops/dispatch.py``).

On a CPU tensor ``rbgs3d`` runs the plain twin; on a CUDA tensor it launches
the kernel or raises. ``rbgs3d.launches`` counts kernel launches (one per
colour half-sweep).
"""

from __future__ import annotations

from ...core import bc3d
from .. import smooth3d as smooth3d_mod
from ..stencil3d import Stencil3D
from . import _build


def rbgs3d_plain(st: Stencil3D, u, f, *, sweeps: int = 2, omega: float = 1.0,
                 reverse: bool = False):
    """Plain twin: ``ops.smooth3d.smooth3d`` (RB-GS) in place on u."""
    unknown = bc3d.unknown_mask3d(*u.shape, device=u.device)
    return smooth3d_mod.smooth3d(st, u, f, unknown, method="rbgs",
                                 sweeps=sweeps, omega=omega, reverse=reverse)


def rbgs3d(st: Stencil3D, u, f, *, sweeps: int = 2, omega: float = 1.0,
           reverse: bool = False):
    """``sweeps`` RB-GS/SOR sweeps in place on ``u`` (red then black, or
    black then red with ``reverse``); returns ``u``."""
    if u.device.type == "cpu":
        return rbgs3d_plain(st, u, f, sweeps=sweeps, omega=omega,
                            reverse=reverse)
    _build.check_cuda_fp32("rbgs3d", u, f, ndim=3)
    if f.shape != u.shape:
        raise ValueError(f"rbgs3d: f {tuple(f.shape)} != u {tuple(u.shape)}")
    dev, stream = u.device.index, _build.stream_of(u)
    for _ in range(sweeps):
        for color in ((1, 0) if reverse else (0, 1)):
            _build.launch("mg_rbgs3d_color", u.data_ptr(), f.data_ptr(),
                          *u.shape, *st.coefs, omega, color, dev, stream)
            rbgs3d.launches += 1
    return u


rbgs3d.launches = 0
