"""Kernels F and G: fused 3D residual+restriction and prolongation+correction
(``csrc/transfer3d.cu``) and their plain twins.

F replaces the Pallas ``residual_restrict3d`` and G the Pallas
``prolong_correct3d`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/transfer3d.py``
(:194, :342) for constant-coefficient 7-point stencils on all-Dirichlet boxes,
on fp32 or bf16 storage (``STORAGE``) as the Pallas kernels take it (:223,
:363): F loads u and f in their dtype and writes fc in ``out_dtype``, G
loads ec and u each in its dtype and stores into u's; both compute in fp32
and round once. The source note in ``csrc/transfer3d.cu`` gives the design and what
bounds it: F streams fine x-planes of a coarse tile through shared memory
and computes each fine residual once; G gives a thread one k of a fine row
pair over two coarse x-steps. Both equal their twins bit for bit. Each call is one launch,
whose tiles and x-chunks the C entry point plans (from the card's
multiprocessor count); the kernels' geometry lives in the source, which the
CPU test of their schedules reads.

On a CPU tensor each wrapper runs its plain twin; on a CUDA tensor it
launches its kernel or raises. ``residual_restrict3d.launches`` and
``prolong_correct3d.launches`` count kernel launches, ``launches_bf16``
those with a bf16 operand. F takes bf16 views at any storage offset: it
reads each row's place in its 16-byte words from the tensor's address.
"""

from __future__ import annotations

import torch

from ...core import bc3d
from .. import stencil3d as st3, transfer3d as transfer3d_mod
from ..stencil3d import Stencil3D
from . import _build
from .smooth3d import check_scalar7

STORAGE = _build.STORAGE


def coarse_shape3d(nxf: int, nyf: int, nzf: int):
    """(ncx, ncy, ncz) of the 2:1 coarsening of a fine (nxf, nyf, nzf)
    grid."""
    if any((n - 1) % 2 or n < 5 for n in (nxf, nyf, nzf)):
        raise ValueError(f"fine shape ({nxf}, {nyf}, {nzf}) does not coarsen "
                         "2:1")
    return tuple((n - 1) // 2 + 1 for n in (nxf, nyf, nzf))


def residual_restrict3d_plain(st: Stencil3D, u, f, *, out_dtype=None):
    """Plain twin: ``restrict3d(residual(st, u, f), boundary='zero')``.
    With a bf16 operand it rounds where F does: u and f widened to fp32,
    the residual and its restriction in fp32, one rounding into
    ``out_dtype``."""
    dtype = out_dtype or u.dtype
    if torch.bfloat16 in (u.dtype, f.dtype, dtype):
        return _build.round_once(residual_restrict3d_plain, dtype, st, u, f)
    unknown = bc3d.unknown_mask3d(*u.shape, device=u.device)
    r = st3.residual(st, u, f, unknown)
    return transfer3d_mod.restrict3d(r, *coarse_shape3d(*u.shape),
                                     dtype=out_dtype or u.dtype)


def residual_restrict3d(st: Stencil3D, u, f, *, out_dtype=None):
    """fc = R_fw(f - A u) on the coarse grid; coarse shell zero. u and f
    fp32 or bf16 (one dtype), fc in ``out_dtype`` (u's by default), fp32
    or bf16."""
    check_scalar7("residual_restrict3d", st)
    if u.device.type == "cpu":
        return residual_restrict3d_plain(st, u, f, out_dtype=out_dtype)
    _build.check_cuda("residual_restrict3d", u, f, ndim=3, dtypes=STORAGE)
    if f.shape != u.shape or f.dtype != u.dtype:
        raise ValueError(f"residual_restrict3d: f {tuple(f.shape)} {f.dtype} "
                         f"!= u {tuple(u.shape)} {u.dtype}")
    dtype = out_dtype or u.dtype
    if dtype not in STORAGE:
        raise TypeError(f"residual_restrict3d: the kernel writes {STORAGE}, "
                        f"asked for {dtype}")
    nc = coarse_shape3d(*u.shape)
    fc = torch.empty(nc, dtype=dtype, device=u.device)
    _build.launch("mg_residual_restrict3d", u.data_ptr(), f.data_ptr(),
                  fc.data_ptr(), u.shape[1], u.shape[2], *nc, *st.coefs,
                  _build.bf16(u), _build.bf16(fc), u.device.index,
                  _build.stream_of(u))
    residual_restrict3d.launches += 1
    if torch.bfloat16 in (u.dtype, dtype):
        residual_restrict3d.launches_bf16 += 1
    return fc


residual_restrict3d.launches = residual_restrict3d.launches_bf16 = 0


def prolong_correct3d_plain(ec, u):
    """Plain twin: u += prolong3d(ec) on the interior, in place. With a
    bf16 operand it rounds where G does: ec and u widened to fp32, the
    interpolation and the sum in fp32, one rounding back into u."""
    if torch.bfloat16 in (ec.dtype, u.dtype):
        return _build.round_once(prolong_correct3d_plain, u, ec, u)
    e = transfer3d_mod.prolong3d(ec, *u.shape, dtype=u.dtype)
    u[1:-1, 1:-1, 1:-1] += e[1:-1, 1:-1, 1:-1]
    return u


def prolong_correct3d(ec, u):
    """u <- u + P_trilinear(ec) on fine interior nodes, in place; returns
    u. ec and u each fp32 or bf16."""
    if u.device.type == "cpu":
        return prolong_correct3d_plain(ec, u)
    _build.check_cuda("prolong_correct3d", ec, u, ndim=3, dtypes=STORAGE)
    if tuple(ec.shape) != coarse_shape3d(*u.shape):
        raise ValueError(f"prolong_correct3d: ec {tuple(ec.shape)} is not the "
                         f"coarse grid of u {tuple(u.shape)}")
    _build.launch("mg_prolong_correct3d", ec.data_ptr(), u.data_ptr(),
                  ec.shape[1], ec.shape[2], *u.shape, _build.bf16(ec),
                  _build.bf16(u), u.device.index, _build.stream_of(u))
    prolong_correct3d.launches += 1
    if torch.bfloat16 in (ec.dtype, u.dtype):
        prolong_correct3d.launches_bf16 += 1
    return u


prolong_correct3d.launches = prolong_correct3d.launches_bf16 = 0
