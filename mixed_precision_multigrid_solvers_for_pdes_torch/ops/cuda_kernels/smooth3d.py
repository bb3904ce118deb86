"""Kernel E: 3D red-black Gauss-Seidel sweeps (``csrc/smooth3d.cu``) and
their plain twin.

Replaces the Pallas ``rbgs_planes`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth3d.py``
(:178) for constant-coefficient 7-point stencils on all-Dirichlet boxes, on
fp32 or bf16 storage (``STORAGE``): the Pallas kernel casts u and f on load
(:217); E loads each of u, f in its dtype, sweeps in fp32 and rounds to
u's dtype once per call, so a call of several launches keeps its passes
before the last in an fp32 scratch field. The source note in
``csrc/smooth3d.cu`` gives the design and what bounds it. Like the Pallas
kernel it runs the RB-GS family only; weighted Jacobi stays on the plain
path (``ops/dispatch.py``). A tensor-leaf, periodic or 27-point stencil is
refused on any device (``check_scalar7``).

The kernel works out of place, as the Pallas kernel does: ``rbgs3d``
returns a new tensor and leaves ``u`` untouched, on the CPU too, where it
runs the plain twin on a copy of ``u``. On a CUDA tensor it launches the
kernel or raises. Levels whose u and f fit one block (``ONE_BLOCK_MAX_BYTES``)
take every sweep of a call in one launch; larger levels take up to
``MAX_WAVE_SWEEPS`` sweeps per launch, so the multigrid cycle's 2-sweep calls
are one launch each, and longer calls run in passes that alternate between
the output and fp32 scratch fields. ``rbgs3d.launches`` counts kernel
launches, ``rbgs3d.launches_bf16`` those of a call on bf16 storage. A bf16
field may be a view at any storage offset: the kernel reads each row's
shift within its 4-byte words from the tensor's address.

The geometry the kernel is launched with (passes, tiles, x-chunks) is
computed here, so the CPU tests can emulate the kernel's schedule with it.
The kernel's source owns the constants: ``check_geometry`` holds this
module's copy against the built library before the first launch, and the
CPU tests hold it against the source.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...core import bc3d
from .. import smooth3d as smooth3d_mod
from ..stencil3d import Stencil3D
from . import _build

STORAGE = _build.STORAGE

# csrc/smooth3d.cu's kTileJ x kTileK, kMaxWaveSweeps, kAhead,
# kOneBlockMaxBytes (check_geometry holds them against the library).
WAVE_TILE = (32, 64)
MAX_WAVE_SWEEPS = 2
WAVE_AHEAD = 2
ONE_BLOCK_MAX_BYTES = 64 * 1024
# The fewest x-planes a chunk takes when small levels are cut into chunks
# to fill the card.
MIN_CHUNK_PLANES = 8


def one_block(shape) -> bool:
    """True when u and f of ``shape`` fit the one-block kernel."""
    return 8 * math.prod(shape) <= ONE_BLOCK_MAX_BYTES


def plan_passes(shape, sweeps: int) -> list:
    """Sweeps of each launch of a ``sweeps``-sweep call on ``shape``."""
    if sweeps <= 0:
        return []
    if one_block(shape):
        return [sweeps]
    full, rest = divmod(sweeps, MAX_WAVE_SWEEPS)
    return [MAX_WAVE_SWEEPS] * full + ([rest] if rest else [])


def wave_tiles(shape, tile=WAVE_TILE):
    """(tiles along j, tiles along k) over the interior of ``shape``."""
    _, ny, nz = shape
    return -(-(ny - 2) // tile[0]), -(-(nz - 2) // tile[1])


def chunk_planes(shape, sms: int, tile=WAVE_TILE) -> int:
    """x-planes per chunk of the wave kernel: the field is cut into as many
    chunks as fill ``sms`` multiprocessors with one block each (one chunk
    when the tiles alone do), no chunk under MIN_CHUNK_PLANES planes."""
    nx = shape[0]
    tj, tk = wave_tiles(shape, tile)
    chunks = max(1, min(sms // (tj * tk), nx // MIN_CHUNK_PLANES))
    return -(-nx // chunks)


def ring_planes(sweeps: int):
    """(u planes, f planes) of the wave kernel's shared-memory rings: the
    planes step s reads (s-2S-1 .. s of u, s-2S .. s-1 of f), the WAVE_AHEAD
    planes in flight, and one more, since the next step's load may land
    while slower threads still run step s."""
    return (2 * sweeps + 3 + WAVE_AHEAD, 2 * sweeps + 2 + WAVE_AHEAD)


def geometry(sweeps: int) -> tuple:
    """The wave kernel's geometry for ``sweeps`` sweeps per launch, as this
    module plans with it, in the order ``mg_rbgs3d_geometry`` reports it:
    tile rows, tile columns, MAX_WAVE_SWEEPS, WAVE_AHEAD,
    ONE_BLOCK_MAX_BYTES, u ring planes, f ring planes."""
    return (*WAVE_TILE, MAX_WAVE_SWEEPS, WAVE_AHEAD, ONE_BLOCK_MAX_BYTES,
            *ring_planes(sweeps))


@functools.cache
def check_geometry() -> None:
    """Raise unless the built kernel reports this module's geometry for
    every sweep count of a wave launch (once per process)."""
    for sweeps in range(1, MAX_WAVE_SWEEPS + 1):
        got = (ctypes.c_int * 7)()
        _build.launch("mg_rbgs3d_geometry", sweeps, got)
        if tuple(got) != geometry(sweeps):
            raise RuntimeError(
                f"rbgs3d: the kernel's geometry for {sweeps} sweeps is "
                f"{tuple(got)}, this module plans with {geometry(sweeps)}")


def check_scalar7(name: str, st) -> None:
    """Raise unless ``st`` is a constant-coefficient 7-point stencil that
    does not wrap: kernels E and F read seven scalars and take a box of
    unknowns, and would compute another operator for a coefficient field,
    a ``Stencil27`` or a periodic axis."""
    if not (isinstance(st, Stencil3D) and st.scalar and not any(st.wrap)):
        raise ValueError(f"{name}: takes a constant-coefficient 7-point "
                         f"stencil on a box, got {type(st).__name__} "
                         f"(scalar={getattr(st, 'scalar', False)}, "
                         f"wrap={getattr(st, 'wrap', None)})")


def rbgs3d_plain(st: Stencil3D, u, f, *, sweeps: int = 2, omega: float = 1.0,
                 reverse: bool = False):
    """Plain twin: ``ops.smooth3d.smooth3d`` (RB-GS) in place on u. On bf16
    storage it rounds where E does: u and f widened to fp32, every sweep in
    fp32, one rounding back into u."""
    if torch.bfloat16 in (u.dtype, f.dtype):
        return _build.round_once(rbgs3d_plain, u, st, u, f, sweeps=sweeps,
                                 omega=omega, reverse=reverse)
    unknown = bc3d.unknown_mask3d(*u.shape, device=u.device)
    return smooth3d_mod.smooth3d(st, u, f, unknown, method="rbgs",
                                 sweeps=sweeps, omega=omega, reverse=reverse)


def rbgs3d(st: Stencil3D, u, f, *, sweeps: int = 2, omega: float = 1.0,
           reverse: bool = False):
    """``sweeps`` RB-GS/SOR sweeps of ``u`` (red then black, or black then
    red with ``reverse``); returns a new tensor of u's dtype, ``u`` is left
    untouched. u and f are each fp32 or bf16."""
    check_scalar7("rbgs3d", st)
    if u.device.type == "cpu":
        return rbgs3d_plain(st, u.clone(), f, sweeps=sweeps, omega=omega,
                            reverse=reverse)
    _build.check_cuda("rbgs3d", u, f, ndim=3, dtypes=STORAGE)
    check_geometry()
    if f.shape != u.shape:
        raise ValueError(f"rbgs3d: f {tuple(f.shape)} != u {tuple(u.shape)}")
    passes = plan_passes(u.shape, sweeps)
    if not passes:
        return u.clone()
    dev, stream = u.device.index, _build.stream_of(u)
    chunk = chunk_planes(u.shape, _build.sm_count(dev))
    # passes before the last alternate between two fp32 scratch fields, so
    # a call on bf16 storage rounds once
    mids = [torch.empty(u.shape, dtype=torch.float32, device=u.device)
            for _ in range(min(len(passes) - 1, 2))]
    outputs = [mids[i % 2] for i in range(len(passes) - 1)]
    outputs.append(torch.empty_like(u))
    src = u
    for n, dst in zip(passes, outputs):
        storage = (_build.bf16(src) | _build.bf16(f) << 1
                   | _build.bf16(dst) << 2)
        _build.launch("mg_rbgs3d", src.data_ptr(), f.data_ptr(),
                      dst.data_ptr(), *u.shape, *st.coefs, omega, n,
                      int(reverse), chunk, storage, dev, stream)
        rbgs3d.launches += 1
        if torch.bfloat16 in (u.dtype, f.dtype):
            rbgs3d.launches_bf16 += 1
        src = dst
    return outputs[-1]


rbgs3d.launches = rbgs3d.launches_bf16 = 0
