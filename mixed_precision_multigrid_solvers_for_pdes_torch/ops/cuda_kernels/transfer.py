"""Kernels B, C and I: fused residual+restriction and prolongation+correction
(``csrc/transfer.cu``, ``csrc/transfer_var.cu``) and their plain twins.

B and I replace the Pallas ``residual_restrict`` and C the Pallas
``prolong_correct`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/transfer.py``
(:262, :488). B takes a constant-coefficient stencil on an all-Dirichlet
rectangle; I takes the (nx, ny) coefficient planes of a tensor-leaf stencil
and per-side boundary kinds; C takes the same side flags. B, I and C take
fp32 or bf16 storage on each side (``STORAGE``; I's planes in the fine
level's dtype) and compute in fp32, as the Pallas kernels do (:193-249,
:431-476): B and I write the coarse dtype asked for, C stores into u's
dtype, each rounding once. The source notes in ``csrc/`` give the design
and what bounds each kernel.

``sides`` is a (west, east, south, north) tuple of Dirichlet flags, as the
Pallas kernels take it (``BoundarySpec.dirichlet_sides``): a Dirichlet
side's ring is fixed, a Neumann/Robin side's ring holds unknowns.

On a CPU tensor each wrapper runs its plain twin; on a CUDA tensor it
launches its kernel or raises. I's plan (a tile of its source's table,
or the direct plan) is chosen per level from the level's size, its
storage and the card's SM count (``var_plan``); ``check_var_geometry``
holds this module's copy of the plans against the built library before
the first launch, and the CPU tests hold it against the source.
``residual_restrict.launches``, ``residual_restrict_var.launches`` and
``prolong_correct.launches`` count kernel launches, and ``launches_bf16``
of B, I and C those with a bf16 side.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core import bc
from .. import stencil as st_mod, transfer as transfer_mod
from ..stencil import Stencil
from . import _build

DIRICHLET = (True, True, True, True)
STORAGE = _build.STORAGE

# csrc/transfer_var.cu's plans for I: kVarTiles, (coarse rows, coarse
# columns, threads) of a block, kVarMinBlocksPerSm and
# kVarDirectMinNodesPerSm (check_var_geometry holds them against the
# library); plan len(VAR_TILES) is the direct plan, one thread per coarse
# node.
VAR_TILES = ((8, 16, 128), (4, 16, 128), (4, 8, 128))
VAR_MIN_BLOCKS_PER_SM = 8
VAR_DIRECT_MIN_NODES_PER_SM = 1024
VAR_DIRECT = len(VAR_TILES)


def coarse_shape(nxf: int, nyf: int):
    """(ncx, ncy) of the 2:1 coarsening of a fine (nxf, nyf) grid."""
    if (nxf - 1) % 2 or (nyf - 1) % 2 or nxf < 5 or nyf < 5:
        raise ValueError(f"fine shape ({nxf}, {nyf}) does not coarsen 2:1")
    return (nxf - 1) // 2 + 1, (nyf - 1) // 2 + 1


def side_bits(sides) -> int:
    """The kernels' 4-bit side mask: bit k set where side k is Dirichlet."""
    if len(sides) != 4:
        raise ValueError(f"sides must hold 4 flags, got {sides!r}")
    return sum(1 << k for k, d in enumerate(sides) if d)


def residual_restrict_plain(st: Stencil, u, f, *, sides=DIRICHLET,
                            out_dtype=None):
    """Plain twin of B and I: the fine residual on the unknowns, restricted
    with the 'zero' boundary when every side is Dirichlet, else with the
    'reflect' boundary and zeroed off the coarse unknowns. With a bf16 side
    it rounds where B and I do: u, f and I's planes widened to fp32, the
    residual and its restriction in fp32, one rounding into
    ``out_dtype``."""
    dtype = out_dtype or u.dtype
    if torch.bfloat16 in (u.dtype, dtype):
        wide = st if st.scalar else st.astype(torch.float32)
        return _build.round_once(residual_restrict_plain, dtype, wide, u, f,
                                 sides=sides)
    ncx, ncy = coarse_shape(*u.shape)
    r = st_mod.residual(st, u, f, bc.rect_mask(*u.shape, sides,
                                               device=u.device))
    if all(sides):
        return transfer_mod.restrict(r, ncx, ncy, boundary="zero",
                                     dtype=dtype)
    fc = transfer_mod.restrict(r, ncx, ncy, boundary="reflect", dtype=dtype)
    return torch.where(bc.rect_mask(ncx, ncy, sides, device=u.device), fc,
                       torch.zeros((), dtype=dtype, device=u.device))


def _check_restrict(name, u, f, out_dtype, *planes,
                    storage=(torch.float32,)):
    """Check B's or I's operands; returns the coarse shape and dtype."""
    _build.check_cuda(name, u, f, *planes, dtypes=storage)
    if any(t.shape != u.shape for t in (f, *planes)) or f.dtype != u.dtype:
        raise ValueError(f"{name}: f and the planes must have u's shape "
                         f"{tuple(u.shape)} (and f its dtype {u.dtype})")
    dtype = out_dtype or u.dtype
    if dtype not in storage:
        raise TypeError(f"{name}: the kernel writes {storage}, asked for "
                        f"{dtype}")
    return coarse_shape(*u.shape), dtype


def residual_restrict(st: Stencil, u, f, *, out_dtype=None):
    """B: fc = R_fw(f - A u) on the coarse grid of an all-Dirichlet level
    with a constant stencil; coarse ring zero. u and f fp32 or bf16, fc in
    ``out_dtype`` (u's by default), fp32 or bf16."""
    _build.check_unwrapped("residual_restrict", st)
    _build.check_five_point("residual_restrict", st)
    if u.device.type == "cpu":
        return residual_restrict_plain(st, u, f, out_dtype=out_dtype)
    (ncx, ncy), dtype = _check_restrict("residual_restrict", u, f, out_dtype,
                                        storage=STORAGE)
    fc = torch.empty((ncx, ncy), dtype=dtype, device=u.device)
    _build.launch("mg_residual_restrict", u.data_ptr(), f.data_ptr(),
                  fc.data_ptr(), u.shape[1], ncx, ncy, *st.coefs,
                  _build.bf16(u), _build.bf16(fc), u.device.index,
                  _build.stream_of(u))
    residual_restrict.launches += 1
    if torch.bfloat16 in (u.dtype, dtype):
        residual_restrict.launches_bf16 += 1
    return fc


residual_restrict.launches = residual_restrict.launches_bf16 = 0


def var_blocks(ncx: int, ncy: int, tile) -> int:
    """Blocks of I's grid over a (ncx, ncy) coarse level with ``tile``."""
    return -(-ncx // tile[0]) * -(-ncy // tile[1])


def var_plan(ncx: int, ncy: int, sms: int, bf16_in: bool) -> int:
    """I's plan for a (ncx, ncy) coarse level on a card of ``sms``
    multiprocessors: VAR_DIRECT for bf16 fields whose coarse grid holds at
    least VAR_DIRECT_MIN_NODES_PER_SM nodes per SM, else the index in
    VAR_TILES of the largest tile whose grid gives each SM at least
    VAR_MIN_BLOCKS_PER_SM blocks, else of the smallest."""
    if bf16_in and ncx * ncy >= VAR_DIRECT_MIN_NODES_PER_SM * sms:
        return VAR_DIRECT
    for k, tile in enumerate(VAR_TILES):
        if var_blocks(ncx, ncy, tile) >= VAR_MIN_BLOCKS_PER_SM * sms:
            return k
    return len(VAR_TILES) - 1


@functools.cache
def check_var_geometry() -> None:
    """Raise unless the built kernel I reports this module's plans (once
    per process)."""
    got = (ctypes.c_int * (3 + 3 * len(VAR_TILES)))()
    _build.launch("mg_residual_restrict_var_geometry", got)
    want = (len(VAR_TILES), VAR_MIN_BLOCKS_PER_SM,
            VAR_DIRECT_MIN_NODES_PER_SM, *(x for t in VAR_TILES for x in t))
    if tuple(got) != want:
        raise RuntimeError(f"residual_restrict_var: the kernel reports "
                           f"{tuple(got)}, this module plans with {want}")


def residual_restrict_var(st: Stencil, u, f, *, sides=DIRICHLET,
                          out_dtype=None):
    """I: fc = R_fw(f - A u) with the (nx, ny) coefficient planes of ``st``;
    Neumann/Robin rings are unknowns and restrict with the reflect fold;
    coarse nodes off the coarse unknowns are zero. u, f and the planes fp32
    or bf16 (one dtype), fc in ``out_dtype`` (u's by default), fp32 or
    bf16."""
    _build.check_five_point("residual_restrict_var", st)
    if st.scalar:
        raise ValueError("residual_restrict_var: takes a stencil with "
                         "(nx, ny) coefficient planes")
    _build.check_unwrapped("residual_restrict_var", st)
    if u.device.type == "cpu":
        return residual_restrict_plain(st, u, f, sides=sides,
                                       out_dtype=out_dtype)
    (ncx, ncy), dtype = _check_restrict("residual_restrict_var", u, f,
                                        out_dtype, *st.coefs,
                                        storage=STORAGE)
    if any(x.dtype != u.dtype for x in st.coefs):
        raise ValueError(f"residual_restrict_var: the planes must have u's "
                         f"dtype {u.dtype}")
    check_var_geometry()
    dev = u.device.index
    fc = torch.empty((ncx, ncy), dtype=dtype, device=u.device)
    _build.launch("mg_residual_restrict_var", u.data_ptr(), f.data_ptr(),
                  *(x.data_ptr() for x in st.coefs), fc.data_ptr(),
                  *u.shape, ncx, ncy, side_bits(sides), _build.bf16(u),
                  _build.bf16(fc),
                  var_plan(ncx, ncy, _build.sm_count(dev), _build.bf16(u)),
                  dev, _build.stream_of(u))
    residual_restrict_var.launches += 1
    if torch.bfloat16 in (u.dtype, dtype):
        residual_restrict_var.launches_bf16 += 1
    return fc


residual_restrict_var.launches = residual_restrict_var.launches_bf16 = 0


def prolong_correct_plain(ec, u, *, sides=DIRICHLET):
    """Plain twin of C: u += prolong(ec) on the unknowns, in place. With a
    bf16 side it rounds where C does: ec and u widened to fp32, the
    interpolation and the sum in fp32, one rounding back into u."""
    if torch.bfloat16 in (ec.dtype, u.dtype):
        return _build.round_once(prolong_correct_plain, u, ec, u,
                                 sides=sides)
    e = transfer_mod.prolong(ec, *u.shape, dtype=u.dtype)
    i0, i1, j0, j1 = bc.unknown_rect(*u.shape, sides)
    u[i0:i1, j0:j1] += e[i0:i1, j0:j1]
    return u


def prolong_correct(ec, u, *, sides=DIRICHLET):
    """C: u <- u + P_bilinear(ec) on fine unknowns, in place; returns u.
    ec and u each fp32 or bf16."""
    if u.device.type == "cpu":
        return prolong_correct_plain(ec, u, sides=sides)
    _build.check_cuda("prolong_correct", ec, u, dtypes=STORAGE)
    if tuple(ec.shape) != coarse_shape(*u.shape):
        raise ValueError(f"prolong_correct: ec {tuple(ec.shape)} is not the "
                         f"coarse grid of u {tuple(u.shape)}")
    _build.launch("mg_prolong_correct", ec.data_ptr(), u.data_ptr(),
                  ec.shape[1], u.shape[0], u.shape[1], side_bits(sides),
                  _build.bf16(ec), _build.bf16(u), u.device.index,
                  _build.stream_of(u))
    prolong_correct.launches += 1
    if torch.bfloat16 in (ec.dtype, u.dtype):
        prolong_correct.launches_bf16 += 1
    return u


prolong_correct.launches = prolong_correct.launches_bf16 = 0
