"""Kernel N: the float64 step of the 3D iterative refinement
(``csrc/refine3d.cu``) and its plain twin.

N replaces no Pallas kernel: the JAX package's ``_ir3_jit``
(``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/multigrid3d.py``)
leaves this step to XLA. On a constant-coefficient 7-point stencil on an
all-Dirichlet box, one launch of N does what ``ir_solve3d``'s outer step
did in ~30 eager passes over fp64 fields:

- step mode (``e`` given): ``u_out = u_in + e`` on the interior and
  ``u_in`` on the shell, written to ``out`` (never ``u_in``: the caller
  ping-pongs the iterate between two fp64 buffers); ``r = f - A u_out``;
  ``r_lo``, r in the level's dtype (fp32 or bf16, ``STORAGE``), zero on
  the shell; and ``||r||``;
- start mode (``e`` None): ``r_lo`` and ``||r||`` from ``u_in``, and the
  masked ``||f||`` over the same unknowns.

The fp64 r is never stored. ``u_out`` and ``r_lo`` equal the twin's bit for
bit (every operation rounded in the twin's order); the norms are sums over
the interior reduced in a fixed two-level order (per block, then the last
block over the blocks' partials), so they differ from ``torch.sum`` in the
order of summation only, and reruns give the same bits. The source note in
``csrc/refine3d.cu`` gives the design and what bounds it.

On a CPU tensor ``refine_step3d`` runs the twin; on a CUDA tensor it
launches N or raises. ``refine_step3d.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...core import bc3d
from .. import norms, stencil3d as st3
from ..stencil3d import Stencil3D
from . import _build
from .smooth3d import check_scalar7

STORAGE = _build.STORAGE


def refine_step3d_plain(st: Stencil3D, u_in, e, f, *, h, out=None,
                        r_lo=None, unknown=None):
    """Plain twin: the plain outer step of ``ir_solve3d`` on a box, in its
    order: ``u_in`` copied to ``out`` (in place where ``out`` is ``u_in``)
    and ``u[1:-1, 1:-1, 1:-1] += e[1:-1, 1:-1, 1:-1]``, ``r = residual(st,
    u, f)``, ``r_lo`` its cast, ``scaled_l2(r)``; with ``e`` None,
    ``masked_scaled_l2(f)`` and the residual of ``u_in``. ``unknown`` is
    the box's interior mask (made when not given). Returns ``(u, r_lo,
    rnorm, fnorm)`` as ``refine_step3d``."""
    if unknown is None:
        unknown = bc3d.unknown_mask3d(*u_in.shape, device=u_in.device)
    fnorm = None
    if e is None:
        u = u_in
        fnorm = norms.masked_scaled_l2(f, unknown, *h)
    else:
        u = torch.empty_like(u_in) if out is None else out
        if u is not u_in:
            u.copy_(u_in)
        u[1:-1, 1:-1, 1:-1] += e[1:-1, 1:-1, 1:-1]
    r = st3.residual(st, u, f, unknown)
    r_lo = r.to(e.dtype) if r_lo is None else r_lo.copy_(r)
    return u, r_lo, norms.scaled_l2(r, *h), fnorm


@functools.cache
def blocks(shape, index: int) -> int:
    """N's blocks on a field of ``shape`` on CUDA device ``index`` (the
    kernel's plan, from the card's multiprocessor count)."""
    got = ctypes.c_int()
    _build.launch("mg_refine3d_blocks", *shape, index, ctypes.byref(got))
    return got.value


def new_scratch(shape, device):
    """N's zeroed scratch for fields of ``shape`` on a CUDA ``device``: the
    blocks' partial sums and the ticket, which each launch leaves 0, so one
    scratch serves every launch of a solve on one stream. None on the CPU,
    where ``refine_step3d`` runs the twin."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    nb = blocks(tuple(shape), device.index)
    return torch.zeros(2 * nb + 1, dtype=torch.float64, device=device)


def refine_step3d(st: Stencil3D, u_in, e, f, *, h, out=None, r_lo=None,
                  scratch=None):
    """One refinement step (``e`` given) or the start (``e`` None) on an
    all-Dirichlet box; ``st`` is the float64 stencil and ``h`` the
    spacings (hx, hy, hz). ``u_in``, ``f`` and ``out`` are fp64, ``e`` and
    ``r_lo`` in the level's dtype (``r_lo`` is required at the start, which
    has no ``e`` to take the dtype from). ``out`` and ``r_lo`` are written
    when given, else allocated; ``scratch`` (``new_scratch``'s) is made for
    the call when not given. Returns ``(u, r_lo, rnorm, fnorm)``: the
    step's ``u`` is ``out`` and its ``fnorm`` None; the start's ``u`` is
    ``u_in``; each norm a 0-d fp64 tensor."""
    check_scalar7("refine_step3d", st)
    if e is None and r_lo is None:
        raise ValueError("refine_step3d: the start takes r_lo, which gives "
                         "the level's dtype")
    if u_in.device.type == "cpu":
        return refine_step3d_plain(st, u_in, e, f, h=h, out=out, r_lo=r_lo)
    f64 = (torch.float64,)
    shape = tuple(u_in.shape)
    if r_lo is None:
        r_lo = torch.empty(shape, dtype=e.dtype, device=u_in.device)
    if e is not None and out is None:
        out = torch.empty_like(u_in)
    wide = (u_in, f) if e is None else (u_in, f, out)
    lo = (r_lo,) if e is None else (e, r_lo)
    _build.check_cuda("refine_step3d", *wide, ndim=3, dtypes=f64)
    _build.check_cuda("refine_step3d", u_in, *lo, ndim=3,
                      dtypes=f64 + STORAGE)
    if any(x.dtype not in STORAGE or x.dtype != r_lo.dtype for x in lo):
        raise TypeError(f"refine_step3d: e and r_lo take one dtype of "
                        f"{STORAGE}, got {[x.dtype for x in lo]}")
    if any(tuple(x.shape) != shape for x in wide + lo):
        raise ValueError(f"refine_step3d: every field takes u_in's shape "
                         f"{shape}")
    if e is not None and out.data_ptr() == u_in.data_ptr():
        raise ValueError("refine_step3d: out must not alias u_in (a "
                         "block's halo is another block's interior)")
    if scratch is None:
        scratch = new_scratch(shape, u_in.device)
    elif (scratch.dtype != torch.float64 or scratch.device != u_in.device
          or scratch.numel() != 2 * blocks(shape, u_in.device.index) + 1):
        raise ValueError("refine_step3d: scratch is new_scratch's for "
                         "u_in's shape and device")
    got = torch.empty(2, dtype=torch.float64, device=u_in.device)
    _build.launch("mg_refine_step3d", u_in.data_ptr(),
                  None if e is None else e.data_ptr(), f.data_ptr(),
                  None if e is None else out.data_ptr(), r_lo.data_ptr(),
                  got.data_ptr(), scratch.data_ptr(), *shape, *st.coefs,
                  math.prod(h), _build.bf16(r_lo), u_in.device.index,
                  _build.stream_of(u_in))
    refine_step3d.launches += 1
    if e is None:
        return u_in, r_lo, got[0], got[1]
    return out, r_lo, got[0], None


refine_step3d.launches = 0
