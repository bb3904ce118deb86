"""Kernels B and C: fused residual+restriction and prolongation+correction
(``csrc/transfer.cu``) and their plain twins.

B replaces the Pallas ``residual_restrict`` and C the Pallas
``prolong_correct`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/transfer.py``
(:262, :488) for constant-coefficient 5-point stencils on all-Dirichlet
rectangles in fp32. The source note in ``csrc/transfer.cu`` gives the design
and what bounds it.

On a CPU tensor each wrapper runs its plain twin; on a CUDA tensor it
launches its kernel or raises. ``residual_restrict.launches`` and
``prolong_correct.launches`` count kernel launches.
"""

from __future__ import annotations

import torch

from ...core import bc
from .. import stencil as st_mod, transfer as transfer_mod
from ..stencil import Stencil
from . import _build


def coarse_shape(nxf: int, nyf: int):
    """(ncx, ncy) of the 2:1 coarsening of a fine (nxf, nyf) grid."""
    if (nxf - 1) % 2 or (nyf - 1) % 2 or nxf < 5 or nyf < 5:
        raise ValueError(f"fine shape ({nxf}, {nyf}) does not coarsen 2:1")
    return (nxf - 1) // 2 + 1, (nyf - 1) // 2 + 1


def residual_restrict_plain(st: Stencil, u, f, *, out_dtype=None):
    """Plain twin: ``restrict(residual(st, u, f), boundary='zero')``."""
    ncx, ncy = coarse_shape(*u.shape)
    unknown = bc.unknown_mask(*u.shape, device=u.device)
    r = st_mod.residual(st, u, f, unknown)
    return transfer_mod.restrict(r, ncx, ncy, boundary="zero",
                                 dtype=out_dtype or u.dtype)


def residual_restrict(st: Stencil, u, f, *, out_dtype=None):
    """fc = R_fw(f - A u) on the coarse grid; coarse ring zero."""
    if u.device.type == "cpu":
        return residual_restrict_plain(st, u, f, out_dtype=out_dtype)
    _build.check_cuda_fp32("residual_restrict", u, f)
    if f.shape != u.shape:
        raise ValueError(f"residual_restrict: f {tuple(f.shape)} != u "
                         f"{tuple(u.shape)}")
    if out_dtype not in (None, torch.float32):
        raise TypeError(f"residual_restrict: the kernel writes float32, "
                        f"asked for {out_dtype}")
    ncx, ncy = coarse_shape(*u.shape)
    fc = torch.empty((ncx, ncy), dtype=torch.float32, device=u.device)
    _build.launch("mg_residual_restrict", u.data_ptr(), f.data_ptr(),
                  fc.data_ptr(), u.shape[1], ncx, ncy, *st.coefs,
                  u.device.index, _build.stream_of(u))
    residual_restrict.launches += 1
    return fc


residual_restrict.launches = 0


def prolong_correct_plain(ec, u):
    """Plain twin: u += prolong(ec) on the interior, in place."""
    e = transfer_mod.prolong(ec, *u.shape, dtype=u.dtype)
    u[1:-1, 1:-1] += e[1:-1, 1:-1]
    return u


def prolong_correct(ec, u):
    """u <- u + P_bilinear(ec) on fine interior nodes, in place; returns u."""
    if u.device.type == "cpu":
        return prolong_correct_plain(ec, u)
    _build.check_cuda_fp32("prolong_correct", ec, u)
    if tuple(ec.shape) != coarse_shape(*u.shape):
        raise ValueError(f"prolong_correct: ec {tuple(ec.shape)} is not the "
                         f"coarse grid of u {tuple(u.shape)}")
    _build.launch("mg_prolong_correct", ec.data_ptr(), u.data_ptr(),
                  ec.shape[1], u.shape[0], u.shape[1], u.device.index,
                  _build.stream_of(u))
    prolong_correct.launches += 1
    return u


prolong_correct.launches = 0
