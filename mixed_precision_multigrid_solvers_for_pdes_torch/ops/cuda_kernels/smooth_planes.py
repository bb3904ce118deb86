"""Kernel K: RB-GS/SOR sweeps on parity planes (``csrc/smooth_parity.cu``)
and its plain twin.

Replaces the Pallas ``multisweep_planes`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth_planes.py``
(:225) for constant-coefficient 5-point stencils on all-Dirichlet rectangles
in fp32. The planes are the (4, hx, hy) layout of ``ops/planes.py``. K is
kernel L's body with its window loaded from, and its tile stored to, the
planes; the source note in ``csrc/smooth_parity.cu`` gives the design and
what bounds it.

On a CPU tensor ``multisweep_planes`` runs the plain twin in place and
returns ``up``; on a CUDA tensor it launches the kernel or raises: up to
``smooth.MAX_SWEEPS`` sweeps per launch into new planes, which it returns,
leaving ``up`` untouched. ``multisweep_planes.launches`` counts the
launches.
"""

from __future__ import annotations

from .. import planes as pln
from ..stencil import Stencil
from . import _build
from .smooth import launch_passes


def multisweep_planes_plain(st: Stencil, up, fp, *, nx: int, ny: int,
                            sweeps: int = 2, omega: float = 1.0):
    """Plain twin of K: ``ops.planes.plane_sweeps`` with the all-Dirichlet
    masks of the (nx, ny) grid, in place on ``up``."""
    masks = pln.masks_for(nx, ny, *up.shape[1:], device=up.device)
    return pln.plane_sweeps(st.coefs, up, fp, masks, sweeps=sweeps,
                            omega=omega)


def multisweep_planes(st: Stencil, up, fp, *, nx: int, ny: int,
                      sweeps: int = 2, omega: float = 1.0):
    """``sweeps`` RB-GS/SOR sweeps (red then black) of the (4, hx, hy)
    parity planes ``up`` of an (nx, ny) all-Dirichlet grid; returns the
    smoothed planes: ``up`` itself, updated in place, on the CPU, new
    planes from kernel K (``up`` untouched)."""
    _build.check_five_point("multisweep_planes", st)
    if not st.scalar:
        raise ValueError("multisweep_planes: takes a constant-coefficient "
                         "stencil")
    _build.check_unwrapped("multisweep_planes", st)
    if tuple(up.shape[1:]) != pln.plane_shape((nx, ny)) or up.shape[0] != 4:
        raise ValueError(f"multisweep_planes: planes {tuple(up.shape)} are "
                         f"not the (4, hx, hy) planes of a ({nx}, {ny}) grid")
    if up.device.type == "cpu":
        return multisweep_planes_plain(st, up, fp, nx=nx, ny=ny,
                                       sweeps=sweeps, omega=omega)
    _build.check_cuda("multisweep_planes", up, fp, ndim=3)
    if fp.shape != up.shape:
        raise ValueError(f"multisweep_planes: fp {tuple(fp.shape)} != up "
                         f"{tuple(up.shape)}")
    return launch_passes("mg_planes_rbgs", multisweep_planes, up, fp, nx, ny,
                         st.coefs, omega, sweeps)


multisweep_planes.launches = 0
