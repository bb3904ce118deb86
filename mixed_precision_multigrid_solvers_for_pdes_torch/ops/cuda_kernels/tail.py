"""Kernels D and J: the whole coarse tail of a V-cycle in one launch
(``csrc/tail.cu``, ``csrc/tail_var.cu``) and their plain twin, the recursive
V-cycle.

D replaces the Pallas ``tail_vcycle`` and J the Pallas ``tail_vcycle_var`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/tail.py``
(:170, :122) for all-Dirichlet hierarchies in fp32: D for
constant-coefficient stencils, J for stencils with (nx, ny) coefficient
planes on every level. The source notes in ``csrc/`` give the design and
what bounds each kernel.

On a CPU tensor ``tail_vcycle`` and ``tail_vcycle_var`` run the plain twin;
on a CUDA tensor they launch their kernel or raise. ``tail_vcycle.launches``
and ``tail_vcycle_var.launches`` count launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ...core import bc
from .. import smooth as smooth_mod
from ..stencil import Stencil
from . import _build
from .transfer import coarse_shape, prolong_correct_plain, \
    residual_restrict_plain

MAX_LEVELS = 16  # kTailMaxLevels in csrc/tail.cu and csrc/tail_var.cu


def _check_shapes(shapes: Sequence[Tuple[int, int]], stencils, u) -> None:
    if not 1 <= len(shapes) <= MAX_LEVELS or len(shapes) != len(stencils):
        raise ValueError(f"tail_vcycle: need 1..{MAX_LEVELS} levels with one "
                         f"stencil each, got {len(shapes)} shapes and "
                         f"{len(stencils)} stencils")
    if tuple(shapes[0]) != tuple(u.shape):
        raise ValueError(f"tail_vcycle: entry shape {tuple(shapes[0])} != u "
                         f"{tuple(u.shape)}")
    for fine, coarse in zip(shapes, shapes[1:]):
        if tuple(coarse) != coarse_shape(*fine):
            raise ValueError(f"tail_vcycle: {tuple(coarse)} is not the 2:1 "
                             f"coarsening of {tuple(fine)}")


def _check_method(name: str, method: str) -> None:
    if method != "jacobi" and method not in smooth_mod.RBGS_METHODS:
        raise ValueError(f"{name}: unsupported method {method!r}")


def _check_cuda(name: str, stencils, u, f, shapes) -> None:
    _build.check_cuda_fp32(name, u, f)
    _check_shapes(shapes, stencils, u)
    if f.shape != u.shape:
        raise ValueError(f"{name}: f {tuple(f.shape)} != u {tuple(u.shape)}")


def _workspace(shapes, u):
    """(nx, ny) ctypes arrays and the workspace tensor of a tail launch."""
    L = len(shapes)
    nx = (ctypes.c_int * L)(*(s[0] for s in shapes))
    ny = (ctypes.c_int * L)(*(s[1] for s in shapes))
    n = _build.library().lib.mg_tail_workspace_floats(L, nx, ny)
    return nx, ny, torch.empty(n, dtype=torch.float32, device=u.device)


def tail_vcycle_plain(stencils: Sequence[Stencil], u, f, *,
                      shapes: Sequence[Tuple[int, int]], pre: int, post: int,
                      omega: float, method: str = "rbgs",
                      coarse_sweeps: int = 32, symmetric: bool = False):
    """Plain twin of D and J: the recursive V(pre, post) cycle over the tail
    levels, composed of the plain smoother and the plain transfer twins; the
    coarsest level takes ``coarse_sweeps`` RB-GS sweeps with omega = 1.
    Updates ``u`` in place and returns it."""
    _check_shapes(shapes, stencils, u)
    post_method = ("rbgs_rev" if symmetric and method != "jacobi"
                   else method)

    def vcycle(lvl, u, f):
        st = stencils[lvl]
        unknown = bc.unknown_mask(*u.shape, device=u.device)
        if lvl == len(stencils) - 1:
            return smooth_mod.smooth(st, u, f, unknown, method="rbgs",
                                     sweeps=coarse_sweeps, omega=1.0)
        smooth_mod.smooth(st, u, f, unknown, method=method, sweeps=pre,
                          omega=omega)
        fc = residual_restrict_plain(st, u, f)
        ec = vcycle(lvl + 1, torch.zeros_like(fc), fc)
        prolong_correct_plain(ec, u)
        return smooth_mod.smooth(st, u, f, unknown, method=post_method,
                                 sweeps=post, omega=omega)

    return vcycle(0, u, f)


def tail_vcycle(stencils: Sequence[Stencil], u, f, *,
                shapes: Sequence[Tuple[int, int]], pre: int, post: int,
                omega: float, method: str = "rbgs", coarse_sweeps: int = 32,
                symmetric: bool = False):
    """One V(pre, post) cycle from the entry level ``shapes[0]`` down to
    ``shapes[-1]``, in place on ``u``; returns ``u``.

    ``method`` is 'jacobi' or an RB-GS name (all RB-GS names smooth alike).
    ``shapes`` lists (nx, ny) per level, finest first; one level (L = 1)
    runs only the coarsest-level sweeps."""
    _check_method("tail_vcycle", method)
    if u.device.type == "cpu":
        return tail_vcycle_plain(stencils, u, f, shapes=shapes, pre=pre,
                                 post=post, omega=omega, method=method,
                                 coarse_sweeps=coarse_sweeps,
                                 symmetric=symmetric)
    _check_cuda("tail_vcycle", stencils, u, f, shapes)
    L = len(shapes)
    nx, ny, work = _workspace(shapes, u)
    coefs = (ctypes.c_float * (5 * L))(*(x for st in stencils
                                         for x in st.coefs))
    _build.launch("mg_tail_vcycle", u.data_ptr(), f.data_ptr(),
                  work.data_ptr(), L, nx, ny, coefs, pre, post, omega,
                  int(method == "jacobi"), coarse_sweeps, int(symmetric),
                  u.device.index, _build.stream_of(u))
    tail_vcycle.launches += 1
    return u


tail_vcycle.launches = 0


def tail_vcycle_var(stencils: Sequence[Stencil], u, f, *,
                    shapes: Sequence[Tuple[int, int]], pre: int, post: int,
                    omega: float, method: str = "rbgs",
                    coarse_sweeps: int = 32, symmetric: bool = False):
    """J: ``tail_vcycle`` for stencils whose leaves are (nx, ny) coefficient
    planes on every level, in place on ``u``; returns ``u``."""
    _check_method("tail_vcycle_var", method)
    if any(st.scalar for st in stencils):
        raise ValueError("tail_vcycle_var: every level needs a stencil with "
                         "(nx, ny) coefficient planes")
    if u.device.type == "cpu":
        return tail_vcycle_plain(stencils, u, f, shapes=shapes, pre=pre,
                                 post=post, omega=omega, method=method,
                                 coarse_sweeps=coarse_sweeps,
                                 symmetric=symmetric)
    _check_cuda("tail_vcycle_var", stencils, u, f, shapes)
    for st, shape in zip(stencils, shapes):
        _build.check_cuda_fp32("tail_vcycle_var", u, *st.coefs)
        if any(tuple(x.shape) != tuple(shape) for x in st.coefs):
            raise ValueError(f"tail_vcycle_var: planes must have their "
                             f"level's shape {tuple(shape)}")
    L = len(shapes)
    nx, ny, work = _workspace(shapes, u)
    planes = (ctypes.c_void_p * (5 * L))(*(x.data_ptr() for st in stencils
                                           for x in st.coefs))
    _build.launch("mg_tail_var_vcycle", u.data_ptr(), f.data_ptr(),
                  work.data_ptr(), L, nx, ny, planes, pre, post, omega,
                  int(method == "jacobi"), coarse_sweeps, int(symmetric),
                  u.device.index, _build.stream_of(u))
    tail_vcycle_var.launches += 1
    return u


tail_vcycle_var.launches = 0
