"""Kernel H: multi-sweep smoothing with coefficient planes
(``csrc/smooth_var.cu``); its plain twin is ``smooth.multisweep_plain``.

Replaces the variable-coefficient branches of the Pallas ``multisweep`` and
``multisweep_strips`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py``
(:290, :507) for tensor-leaf 5-point stencils on all-Dirichlet rectangles in
fp32. The source note in ``csrc/smooth_var.cu`` gives the design and what
bounds it.

On a CPU tensor ``multisweep_var`` runs the plain twin; on a CUDA tensor it
launches the kernel or raises. ``multisweep_var.launches`` counts kernel
launches (one per colour half-sweep, one per Jacobi sweep).
"""

from __future__ import annotations

import torch

from ..stencil import Stencil
from . import _build
from .smooth import RBGS, multisweep_plain


def multisweep_var(st: Stencil, u, f, *, method: str = "rbgs",
                   sweeps: int = 2, omega: float = 1.0):
    """``sweeps`` sweeps of ``method`` in place on ``u`` with the (nx, ny)
    coefficient planes of ``st``; returns ``u``.

    ``method``: 'jacobi', an RB-GS name ('rbgs', 'gauss_seidel', 'red_black',
    'sor'), or 'rbgs_rev' (black before red)."""
    if method != "jacobi" and method not in RBGS:
        raise ValueError(f"multisweep_var: unsupported method {method!r}")
    if st.scalar:
        raise ValueError("multisweep_var: takes a stencil with (nx, ny) "
                         "coefficient planes")
    if u.device.type == "cpu":
        return multisweep_plain(st, u, f, method=method, sweeps=sweeps,
                                omega=omega)
    _build.check_cuda_fp32("multisweep_var", u, f, *st.coefs)
    if any(t.shape != u.shape for t in (f, *st.coefs)):
        raise ValueError(f"multisweep_var: f and the planes must have u's "
                         f"shape {tuple(u.shape)}")
    nx, ny = u.shape
    planes = [x.data_ptr() for x in st.coefs]
    dev, stream = u.device.index, _build.stream_of(u)
    if method == "jacobi":
        scratch = torch.empty_like(u)
        src, dst = u, scratch
        for _ in range(sweeps):
            _build.launch("mg_jacobi_var", src.data_ptr(), dst.data_ptr(),
                          f.data_ptr(), *planes, nx, ny, omega, dev, stream)
            multisweep_var.launches += 1
            src, dst = dst, src
        if src is not u:
            u.copy_(src)
        return u
    colors = (1, 0) if method == "rbgs_rev" else (0, 1)
    for _ in range(sweeps):
        for color in colors:
            _build.launch("mg_rbgs_var_color", u.data_ptr(), f.data_ptr(),
                          *planes, nx, ny, omega, color, dev, stream)
            multisweep_var.launches += 1
    return u


multisweep_var.launches = 0
