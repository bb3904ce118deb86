"""Kernel A: multi-sweep smoothing (``csrc/smooth.cu``) and its plain twin.

Replaces the Pallas ``multisweep`` and ``multisweep_strips`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py``
(:290, :507) for constant-coefficient 5-point stencils on all-Dirichlet
rectangles in fp32. The source note in ``csrc/smooth.cu`` gives the design
and what bounds it.

On a CPU tensor ``multisweep`` runs the plain twin; on a CUDA tensor it
launches the kernel or raises. ``multisweep.launches`` counts kernel
launches (one per colour half-sweep, one per Jacobi sweep).
"""

from __future__ import annotations

import torch

from ...core import bc
from .. import smooth as smooth_mod
from ..stencil import Stencil
from . import _build

RBGS = smooth_mod.RBGS_METHODS + ("rbgs_rev",)


def multisweep_plain(st: Stencil, u, f, *, method: str = "rbgs",
                     sweeps: int = 2, omega: float = 1.0):
    """Plain twin of A and H: ``ops.smooth.smooth`` on the interior of an
    all-Dirichlet level, in place on u."""
    unknown = bc.unknown_mask(*u.shape, device=u.device)
    return smooth_mod.smooth(st, u, f, unknown, method=method, sweeps=sweeps,
                             omega=omega)


def multisweep(st: Stencil, u, f, *, method: str = "rbgs", sweeps: int = 2,
               omega: float = 1.0):
    """``sweeps`` sweeps of ``method`` in place on ``u``; returns ``u``.

    ``method``: 'jacobi', an RB-GS name ('rbgs', 'gauss_seidel', 'red_black',
    'sor'), or 'rbgs_rev' (black before red)."""
    if method != "jacobi" and method not in RBGS:
        raise ValueError(f"multisweep: unsupported method {method!r}")
    if u.device.type == "cpu":
        return multisweep_plain(st, u, f, method=method, sweeps=sweeps,
                                omega=omega)
    _build.check_cuda_fp32("multisweep", u, f)
    if f.shape != u.shape:
        raise ValueError(f"multisweep: f {tuple(f.shape)} != u "
                         f"{tuple(u.shape)}")
    nx, ny = u.shape
    dev, stream = u.device.index, _build.stream_of(u)
    if method == "jacobi":
        scratch = torch.empty_like(u)
        src, dst = u, scratch
        for _ in range(sweeps):
            _build.launch("mg_jacobi", src.data_ptr(), dst.data_ptr(),
                          f.data_ptr(), nx, ny, *st.coefs, omega, dev, stream)
            multisweep.launches += 1
            src, dst = dst, src
        if src is not u:
            u.copy_(src)
        return u
    colors = (1, 0) if method == "rbgs_rev" else (0, 1)
    for _ in range(sweeps):
        for color in colors:
            _build.launch("mg_rbgs_color", u.data_ptr(), f.data_ptr(), nx, ny,
                          *st.coefs, omega, color, dev, stream)
            multisweep.launches += 1
    return u


multisweep.launches = 0
