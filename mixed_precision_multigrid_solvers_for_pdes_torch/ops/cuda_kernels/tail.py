"""Kernels D and J: the whole coarse tail of a V-cycle in one launch
(``csrc/tail.cu``, ``csrc/tail_var.cu``) and their plain twin, the recursive
V-cycle.

D replaces the Pallas ``tail_vcycle`` and J the Pallas ``tail_vcycle_var`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/tail.py``
(:170, :122) for all-Dirichlet hierarchies: D for constant-coefficient
stencils, J for stencils with (nx, ny) coefficient planes on every level.
Both compute every level in fp32 from an entry u and f of fp32 or bf16
storage (``STORAGE``), whatever the dtypes of the levels below, and store
u once, as the Pallas kernels do (:79-81, :152-154, :193): D takes the
levels' stencils as fp32, J loads each level's planes in that level's
dtype and widens them. The source notes in ``csrc/`` give the design and
what bounds each kernel. D walks the tail in the
shared memory of one CTA, laid out by ``plan``; J in the shared memory of
one thread-block cluster, laid out by ``var_plan``. ``check_plan`` and
``check_var_plan`` hold these against the library's own plans before a
tail shape's first launch.

On a CPU tensor ``tail_vcycle`` and ``tail_vcycle_var`` run the plain twin;
on a CUDA tensor they launch their kernel or raise. ``tail_vcycle.launches``
and ``tail_vcycle_var.launches`` count launches, and their
``launches_bf16`` those on a bf16 entry.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import torch

from ...core import bc
from .. import smooth as smooth_mod
from ..stencil import Stencil
from . import _build
from .transfer import coarse_shape, prolong_correct_plain, \
    residual_restrict_plain

MAX_LEVELS = 16  # kTailMaxLevels in csrc/tail.cu and csrc/tail_var.cu
STORAGE = _build.STORAGE  # D's entry
# kThreads, kWarpMaxNodes and kMaxSmemBytes of both sources (the shared
# memory a CTA may use); kJacobiItems of csrc/tail.cu; kCluster and
# kMinBandRows of csrc/tail_var.cu. check_plan and check_var_plan hold them,
# and the plans, against the library.
THREADS = 1024
WARP_MAX_NODES = 9 * 9
MAX_SMEM_BYTES = 232448
JACOBI_ITEMS = 16
CLUSTER = 8
MIN_BAND_ROWS = 8


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


def _check_cuda(name: str, stencils, u, f, shapes,
                storage=(torch.float32,)) -> None:
    _build.check_cuda(name, u, f, dtypes=storage)
    _check_shapes(shapes, stencils, u)
    if f.shape != u.shape or f.dtype != u.dtype:
        raise ValueError(f"{name}: f {tuple(f.shape)} {f.dtype} != u "
                         f"{tuple(u.shape)} {u.dtype}")


def _shape_arrays(shapes):
    """(nx, ny) of every level as ctypes int arrays."""
    L = len(shapes)
    return ((ctypes.c_int * L)(*(s[0] for s in shapes)),
            (ctypes.c_int * L)(*(s[1] for s in shapes)))


@dataclasses.dataclass(frozen=True)
class Plan:
    """How D lays a tail out in its CTA's shared memory: level l's u at
    float ``offsets[l]`` in rows of ``strides[l]`` floats (ny rounded up to
    even), its f right after; levels from ``warp_from`` on walked by one
    warp, the coarsest level's unknowns in lanes' registers when ``lanes``.
    ``fits``: the ``bytes`` fit a CTA and a Jacobi sweep's unknowns its
    threads' registers."""

    warp_from: int
    lanes: bool
    offsets: Tuple[int, ...]
    strides: Tuple[int, ...]
    bytes: int
    fits: bool


def plan(shapes: Sequence[Tuple[int, int]]) -> Plan:
    """D's plan for a tail of ``shapes`` (``plan`` in csrc/tail.cu)."""
    L = len(shapes)
    warp_from = L
    for lvl in range(L - 1, -1, -1):
        if shapes[lvl][0] * shapes[lvl][1] > WARP_MAX_NODES:
            break
        warp_from = lvl
    nx, ny = shapes[-1]
    lanes = warp_from <= L - 1 and (nx - 2) * (ny - 2) <= 32
    offsets, strides, off, fits = [], [], 0, True
    for lvl, (nx, ny) in enumerate(shapes):
        rs = (ny + 1) & ~1
        offsets.append(off)
        strides.append(rs)
        off += 2 * nx * rs
        group = 32 if lvl >= warp_from else THREADS
        fits &= (nx - 2) * (ny - 2) <= JACOBI_ITEMS * group
    nbytes = 4 * off
    return Plan(warp_from, lanes, tuple(offsets), tuple(strides), nbytes,
                fits and nbytes <= MAX_SMEM_BYTES)


@functools.lru_cache(maxsize=64)
def check_plan(shapes: Tuple[Tuple[int, int], ...]) -> None:
    """Raise unless the built kernel reports this module's constants and
    plan for ``shapes``, and the plan fits (once per tail shape and
    process)."""
    L = len(shapes)
    got = (ctypes.c_int * (8 + 2 * L))()
    _build.launch("mg_tail_geometry", L, *_shape_arrays(shapes), got)
    q = plan(shapes)
    want = (THREADS, WARP_MAX_NODES, JACOBI_ITEMS, MAX_SMEM_BYTES,
            q.warp_from, int(q.lanes), q.bytes, int(q.fits),
            *(x for pair in zip(q.offsets, q.strides) for x in pair))
    if tuple(got) != want:
        raise RuntimeError(f"tail_vcycle: the kernel plans {tuple(got)} for "
                           f"{shapes}, this module {want}")
    if not q.fits:
        raise ValueError(f"tail_vcycle: a tail of {shapes} does not fit one "
                         f"CTA ({q.bytes} bytes of shared memory, at most "
                         f"{MAX_SMEM_BYTES})")


@functools.lru_cache(maxsize=64)
def _launch_arrays(shapes, coefs):
    """The ctypes arrays of a D launch: (nx, ny) per level and the
    stencils' (c, w, e, s, n), cached per tail."""
    return (*_shape_arrays(shapes),
            (ctypes.c_float * len(coefs))(*coefs))


def tail_vcycle_plain(stencils: Sequence[Stencil], u, f, *,
                      shapes: Sequence[Tuple[int, int]], pre: int, post: int,
                      omega: float, method: str = "rbgs",
                      coarse_sweeps: int = 32, symmetric: bool = False):
    """Plain twin of D and J: the recursive V(pre, post) cycle over the tail
    levels, composed of the plain smoother and the plain transfer twins; the
    coarsest level takes ``coarse_sweeps`` RB-GS sweeps with omega = 1.
    Every level runs in the entry's dtype, bf16 stencils widened by type
    promotion; a bf16 entry rounds where D and J do: u and f widened to
    fp32, the cycle in fp32, one rounding back. Updates ``u`` in place and
    returns it."""
    _check_shapes(shapes, stencils, u)
    if u.dtype == torch.bfloat16:
        return _build.round_once(tail_vcycle_plain, u, stencils, u, f,
                                 shapes=shapes, pre=pre, post=post,
                                 omega=omega, method=method,
                                 coarse_sweeps=coarse_sweeps,
                                 symmetric=symmetric)
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
    _build.check_unwrapped("tail_vcycle", *stencils)
    _build.check_five_point("tail_vcycle", *stencils)
    if u.device.type == "cpu":
        return tail_vcycle_plain(stencils, u, f, shapes=shapes, pre=pre,
                                 post=post, omega=omega, method=method,
                                 coarse_sweeps=coarse_sweeps,
                                 symmetric=symmetric)
    _check_cuda("tail_vcycle", stencils, u, f, shapes, storage=STORAGE)
    shapes = tuple(tuple(s) for s in shapes)
    check_plan(shapes)
    nx, ny, coefs = _launch_arrays(shapes, tuple(x for st in stencils
                                                 for x in st.coefs))
    _build.launch("mg_tail_vcycle", u.data_ptr(), f.data_ptr(), len(shapes),
                  nx, ny, coefs, pre, post, omega, int(method == "jacobi"),
                  coarse_sweeps, int(symmetric), _build.bf16(u),
                  u.device.index, _build.stream_of(u))
    tail_vcycle.launches += 1
    if u.dtype == torch.bfloat16:
        tail_vcycle.launches_bf16 += 1
    return u


tail_vcycle.launches = tail_vcycle.launches_bf16 = 0


@dataclasses.dataclass(frozen=True)
class VarPlan:
    """How J lays a tail out: levels 0 .. ``split`` - 1 are cut into row
    bands of ``band0 >> l`` rows, one per CTA of the cluster (the last CTA
    takes the rest); the others are walked by CTA 0, from ``warp_from`` on
    by its first warp alone. ``bytes``: shared memory per CTA."""

    split: int
    band0: int
    warp_from: int
    bytes: int

    def band(self, level: int, rank: int, nx: int) -> Tuple[int, int]:
        """Rows [row0, row1) of ``level`` (nx rows) that CTA ``rank``
        holds."""
        if level >= self.split:
            return (0, nx)
        b = self.band0 >> level
        return rank * b, (nx if rank == CLUSTER - 1 else (rank + 1) * b)


def _band0(split: int, nx: Sequence[int]) -> int:
    """``band0`` in csrc/tail_var.cu: the largest multiple of 2^split, at
    most the rows over CLUSTER rounded up, that leaves the last CTA two rows
    of every split level; 0 when none does."""
    unit = 1 << split
    for b in range(unit * -(-(nx[0] - 1) // (CLUSTER * unit)), unit - 1,
                   -unit):
        if all((CLUSTER - 1) * (b >> lvl) < nx[lvl] - 1
               for lvl in range(split)):
            return b
    return 0


def _layout(shapes: Sequence[Tuple[int, int]], split: int) -> VarPlan:
    """``layout`` in csrc/tail_var.cu: the first ``split`` levels split
    (fewer when no band size fits them)."""
    nx = [s[0] for s in shapes]
    L = len(shapes)
    band0 = 0
    while split > 0:
        band0 = _band0(split, nx)
        if band0:
            break
        split -= 1
    warp_from = L
    for lvl in range(L - 1, split - 1, -1):
        if shapes[lvl][0] * shapes[lvl][1] > WARP_MAX_NODES:
            break
        warp_from = lvl
    floats = 0
    for lvl, (n, m) in enumerate(shapes):
        rows = n
        if lvl < split:
            b = band0 >> lvl
            rows = max(b, n - (CLUSTER - 1) * b)
        floats += 8 * rows * m   # u, f, r and the five planes
    return VarPlan(split, band0, warp_from, 4 * floats)


def var_plan(shapes: Sequence[Tuple[int, int]]) -> VarPlan:
    """J's plan for a tail of ``shapes`` (``plan`` in csrc/tail_var.cu): the
    levels of at least CLUSTER * MIN_BAND_ROWS rows split, and the next ones
    too while a CTA's shared memory would overflow."""
    L = len(shapes)
    split = 0
    while split < L - 1 and shapes[split][0] - 1 >= CLUSTER * MIN_BAND_ROWS:
        split += 1
    q = _layout(shapes, split)
    for k in range(split + 1, L):
        if q.bytes <= MAX_SMEM_BYTES:
            break
        more = _layout(shapes, k)
        if more.bytes < q.bytes:
            q = more
    return q


@functools.lru_cache(maxsize=64)
def var_fits(shapes: Tuple[Tuple[int, int], ...]) -> bool:
    """True when J takes a tail of ``shapes``: every tail of two or more
    levels from an entry of at most 129 x 129 does; a one-level tail does up
    to 7264 nodes."""
    return var_plan(shapes).bytes <= MAX_SMEM_BYTES


@functools.lru_cache(maxsize=64)
def check_var_plan(shapes: Tuple[Tuple[int, int], ...]) -> None:
    """Raise unless the built kernel reports this module's constants and
    plan for ``shapes`` (once per tail shape and process)."""
    got = (ctypes.c_int * 8)()
    _build.launch("mg_tail_var_geometry", len(shapes), *_shape_arrays(shapes),
                  got)
    q = var_plan(shapes)
    want = (CLUSTER, THREADS, MIN_BAND_ROWS, WARP_MAX_NODES, q.split,
            q.band0, q.warp_from, q.bytes)
    if tuple(got) != want:
        raise RuntimeError(f"tail_vcycle_var: the kernel plans {tuple(got)} "
                           f"for {shapes}, this module {want}")
    if q.bytes > MAX_SMEM_BYTES:
        raise ValueError(f"tail_vcycle_var: a tail of {shapes} needs "
                         f"{q.bytes} bytes of shared memory per CTA, more "
                         f"than {MAX_SMEM_BYTES}")


def tail_vcycle_var(stencils: Sequence[Stencil], u, f, *,
                    shapes: Sequence[Tuple[int, int]], pre: int, post: int,
                    omega: float, method: str = "rbgs",
                    coarse_sweeps: int = 32, symmetric: bool = False):
    """J: ``tail_vcycle`` for stencils whose leaves are (nx, ny) coefficient
    planes on every level, in place on ``u``; returns ``u``. One launch of
    one thread-block cluster (``var_plan``)."""
    _build.check_five_point("tail_vcycle_var", *stencils)
    _check_method("tail_vcycle_var", method)
    if any(st.scalar for st in stencils):
        raise ValueError("tail_vcycle_var: every level needs a stencil with "
                         "(nx, ny) coefficient planes")
    _build.check_unwrapped("tail_vcycle_var", *stencils)
    if u.device.type == "cpu":
        return tail_vcycle_plain(stencils, u, f, shapes=shapes, pre=pre,
                                 post=post, omega=omega, method=method,
                                 coarse_sweeps=coarse_sweeps,
                                 symmetric=symmetric)
    _check_cuda("tail_vcycle_var", stencils, u, f, shapes, storage=STORAGE)
    narrow = 0  # bit l set: level l's planes are bf16
    for lvl, (st, shape) in enumerate(zip(stencils, shapes)):
        _build.check_cuda("tail_vcycle_var", u, *st.coefs, dtypes=STORAGE)
        if any(tuple(x.shape) != tuple(shape) or x.dtype != st.c.dtype
               for x in st.coefs):
            raise ValueError(f"tail_vcycle_var: the planes of a level must "
                             f"have its shape {tuple(shape)} and one dtype")
        narrow |= _build.bf16(st.c) << lvl
    shapes = tuple(tuple(s) for s in shapes)
    check_var_plan(shapes)
    L = len(shapes)
    planes = (ctypes.c_void_p * (5 * L))(*(x.data_ptr() for st in stencils
                                           for x in st.coefs))
    _build.launch("mg_tail_var_vcycle", u.data_ptr(), f.data_ptr(), L,
                  *_shape_arrays(shapes), planes, narrow, pre, post, omega,
                  int(method == "jacobi"), coarse_sweeps, int(symmetric),
                  _build.bf16(u), u.device.index, _build.stream_of(u))
    tail_vcycle_var.launches += 1
    if u.dtype == torch.bfloat16:
        tail_vcycle_var.launches_bf16 += 1
    return u


tail_vcycle_var.launches = tail_vcycle_var.launches_bf16 = 0
