"""Kernel H: multi-sweep smoothing with coefficient planes
(``csrc/smooth_var.cu``); its plain twin is ``smooth.multisweep_plain``.

Replaces the variable-coefficient branches of the Pallas ``multisweep`` and
``multisweep_strips`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py``
(:290, :507) for tensor-leaf 5-point stencils on all-Dirichlet rectangles,
on fp32 or bf16 storage (``STORAGE``: u and the planes in the level's
dtype, f fp32 or bf16 on its own, as the Pallas kernel casts each input on
its own, :243): as the Pallas kernel (:231-250), H widens what it loads,
sweeps in fp32 and rounds once per call; the output keeps u's dtype. The
source note in ``csrc/smooth_var.cu`` gives the design and what bounds
it.

On a CPU tensor ``multisweep_var`` runs the plain twin; on a CUDA tensor it
launches the kernel or raises. The kernel runs up to ``MAX_SWEEPS`` sweeps
per launch into a separate output; longer calls take several launches
(``plan_passes``), each into a new output (fp32 scratch fields before the
last, as kernel A's: ``smooth._pass_outputs``), and the last is copied back
into ``u`` once. ``multisweep_var.launches`` counts kernel launches (one
per call at the multigrid cycle's 2 sweeps), ``launches_bf16`` those on
bf16 storage.

The launch geometry is the kernel source's: a level takes the largest tile
of ``TILES`` whose grid holds at least ``MIN_BLOCKS`` blocks (``tile``).
``check_geometry`` holds this module's copy against the built library before
a level shape's first launch, and the CPU schedule test holds it against the
source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..stencil import Stencil
from . import _build
from .smooth import RBGS, _pass_outputs, multisweep_plain, \
    pass_storages as _a_storages

STORAGE = _build.STORAGE

# csrc/smooth_var.cu's kTiles (rows, columns; largest first), kMinBlocks,
# kThreads, kMaxSweeps
TILES = ((32, 64), (16, 64), (8, 64))
MIN_BLOCKS = 128
THREADS = 512
MAX_SWEEPS = 4


def pass_storages(u_dtype, f_dtype, n_passes: int) -> list:
    """The storage flags of each launch of a call: kernel A's (bit 0 the
    launch's input u is bf16, bit 1 f, bit 2 its output) and bit 3 the
    planes, which are in the call's u's dtype."""
    planes = int(u_dtype == torch.bfloat16) << 3
    return [code | planes
            for code in _a_storages(u_dtype, f_dtype, n_passes)]


def tile(nx: int, ny: int) -> tuple:
    """The tile of an (nx, ny) level (``tile_of`` in csrc/smooth_var.cu):
    the largest whose grid holds at least MIN_BLOCKS blocks, else the
    smallest."""
    for t in TILES[:-1]:
        if -(-(nx - 2) // t[0]) * -(-(ny - 2) // t[1]) >= MIN_BLOCKS:
            return t
    return TILES[-1]


def halo(sweeps: int, method: str) -> int:
    """Halo of a launch's window: 2 nodes per sweep for the RB-GS family
    (one per colour phase), one per Jacobi sweep."""
    return sweeps if method == "jacobi" else 2 * sweeps


def plan_passes(sweeps: int) -> list:
    """Sweeps of each launch of a ``sweeps``-sweep call."""
    full, rest = divmod(max(sweeps, 0), MAX_SWEEPS)
    return [MAX_SWEEPS] * full + ([rest] if rest else [])


def geometry(nx: int, ny: int) -> tuple:
    """This module's copy of the kernel's geometry for an (nx, ny) level, in
    the order ``mg_smooth_var_geometry`` reports it."""
    return (*tile(nx, ny), THREADS, MAX_SWEEPS, MIN_BLOCKS, len(TILES))


@functools.lru_cache(maxsize=64)
def check_geometry(nx: int, ny: int) -> None:
    """Raise unless the built kernel reports this module's geometry for an
    (nx, ny) level (once per level shape and process)."""
    got = (ctypes.c_int * 6)()
    _build.launch("mg_smooth_var_geometry", nx, ny, got)
    if tuple(got) != geometry(nx, ny):
        raise RuntimeError(f"multisweep_var: the kernel's geometry at "
                           f"({nx}, {ny}) is {tuple(got)}, this module plans "
                           f"with {geometry(nx, ny)}")


def multisweep_var(st: Stencil, u, f, *, method: str = "rbgs",
                   sweeps: int = 2, omega: float = 1.0):
    """``sweeps`` sweeps of ``method`` in place on ``u`` with the (nx, ny)
    coefficient planes of ``st``; returns ``u``.

    ``method``: 'jacobi', an RB-GS name ('rbgs', 'gauss_seidel', 'red_black',
    'sor'), or 'rbgs_rev' (black before red)."""
    _build.check_five_point("multisweep_var", st)
    if method != "jacobi" and method not in RBGS:
        raise ValueError(f"multisweep_var: unsupported method {method!r}")
    if st.scalar:
        raise ValueError("multisweep_var: takes a stencil with (nx, ny) "
                         "coefficient planes")
    _build.check_unwrapped("multisweep_var", st)
    if u.device.type == "cpu":
        return multisweep_plain(st, u, f, method=method, sweeps=sweeps,
                                omega=omega)
    _build.check_cuda("multisweep_var", u, f, *st.coefs, dtypes=STORAGE)
    if f.shape != u.shape or any(t.shape != u.shape or t.dtype != u.dtype
                                 for t in st.coefs):
        raise ValueError(f"multisweep_var: f must have u's shape "
                         f"{tuple(u.shape)}, the planes its shape and dtype "
                         f"{u.dtype}")
    nx, ny = u.shape
    check_geometry(nx, ny)
    passes = plan_passes(sweeps)
    if not passes:
        return u
    planes = [x.data_ptr() for x in st.coefs]
    dev, stream = u.device.index, _build.stream_of(u)
    # a separate output per launch: neighbouring blocks read this block's
    # nodes as their halo, so H cannot write its input in place
    src = u
    for k, dst, types in zip(passes, _pass_outputs(u, len(passes)),
                             pass_storages(u.dtype, f.dtype, len(passes))):
        _build.launch("mg_smooth_var", src.data_ptr(), f.data_ptr(), *planes,
                      dst.data_ptr(), nx, ny, omega, k,
                      int(method == "jacobi"), int(method == "rbgs_rev"),
                      types, dev, stream)
        multisweep_var.launches += 1
        if u.dtype == torch.bfloat16:
            multisweep_var.launches_bf16 += 1
        src = dst
    return u.copy_(src)


multisweep_var.launches = multisweep_var.launches_bf16 = 0
