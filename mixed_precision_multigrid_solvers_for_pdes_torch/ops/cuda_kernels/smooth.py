"""Kernels A and L: multi-sweep smoothing (``csrc/smooth.cu``,
``csrc/smooth_parity.cu``) and their plain twins.

Kernel A replaces the Pallas ``multisweep`` and ``multisweep_strips`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py``
(:290, :507) for constant-coefficient 5-point stencils on all-Dirichlet
rectangles, on fp32 or bf16 storage: as the Pallas kernels (:207-228,
:438-458), A loads bf16, sweeps in fp32 and stores bf16 once per call, so
a call of several launches keeps its passes before the last in fp32 scratch
fields. u and f are each fp32 or bf16, as the Pallas kernels cast each on
its own (:213, :224, :578); the output keeps u's dtype. Kernel L replaces
their ``layout="parity"`` body (``_parity_sweeps`` :119, reached from :211
and :413): split into parity planes on chip, sweep, merge, on the same
storages, rounding as A does.
The source notes in ``csrc/smooth.cu`` and ``csrc/smooth_parity.cu`` give
the designs and what bounds them.

``multisweep(layout=...)`` chooses between them as the Pallas kernels do
(``_resolve_parity``): 'parity' takes L, 'direct' takes A, 'auto' follows
``PARITY_DEFAULT``. Jacobi and the reversed colour order ('rbgs_rev') always
take the direct body: the parity body sweeps red then black only.

On a CPU tensor each wrapper runs its plain twin in place and returns
``u``; on a CUDA tensor it launches its kernel or raises. A and L (and
kernel K, ``smooth_planes.py``) run up to ``MAX_SWEEPS`` sweeps per launch
into a separate output and return that output, leaving ``u`` untouched;
longer calls take several launches (``plan_passes``, ``launch_passes``).
``multisweep.launches`` counts A's launches and ``multisweep_parity.launches``
L's (``launches_bf16`` those on bf16 storage).

A, K and L share one launch geometry (``csrc/smooth_tiles.cuh``): a level
takes the largest tile of ``TILES`` whose grid holds at least
``MIN_BLOCKS`` blocks (``tile``). ``check_geometry`` holds this module's
copy against the built library before a level shape's first launch, and the
CPU schedule tests hold it against the source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core import bc
from .. import planes as pln
from .. import smooth as smooth_mod
from ..stencil import Stencil
from . import _build

RBGS = smooth_mod.RBGS_METHODS + ("rbgs_rev",)
STORAGE = _build.STORAGE  # A's and L's
LAYOUTS = ("auto", "direct", "parity")
# Off by default, as in the JAX package (its smooth.py:277).
PARITY_DEFAULT = False
# csrc/smooth_tiles.cuh's kTiles (rows, columns; largest first), kMinBlocks,
# kThreads, kMaxSweeps
TILES = ((64, 64), (32, 64), (8, 64))
MIN_BLOCKS = 128
THREADS = 512
MAX_SWEEPS = 4


def tile(nx: int, ny: int) -> tuple:
    """The tile of an (nx, ny) level (``tile_of`` in
    csrc/smooth_tiles.cuh): the largest whose grid holds at least
    MIN_BLOCKS blocks, else the smallest."""
    for t in TILES[:-1]:
        if -(-(nx - 2) // t[0]) * -(-(ny - 2) // t[1]) >= MIN_BLOCKS:
            return t
    return TILES[-1]


def halo(sweeps: int, method: str) -> int:
    """Halo of a launch's window: 2 nodes per RB-GS sweep (one per colour
    phase), one per Jacobi sweep."""
    return sweeps if method == "jacobi" else 2 * sweeps


def plan_passes(sweeps: int) -> list:
    """Sweeps of each launch of a ``sweeps``-sweep call."""
    full, rest = divmod(max(sweeps, 0), MAX_SWEEPS)
    return [MAX_SWEEPS] * full + ([rest] if rest else [])


def geometry(nx: int, ny: int) -> tuple:
    """This module's copy of A's, K's and L's geometry for an (nx, ny)
    level, in the order ``mg_smooth_geometry`` reports it."""
    return (*tile(nx, ny), THREADS, MAX_SWEEPS, MIN_BLOCKS, len(TILES))


@functools.lru_cache(maxsize=64)
def check_geometry(nx: int, ny: int) -> None:
    """Raise unless the built kernel reports this module's geometry for an
    (nx, ny) level (once per level shape and process)."""
    got = (ctypes.c_int * 6)()
    _build.launch("mg_smooth_geometry", nx, ny, got)
    if tuple(got) != geometry(nx, ny):
        raise RuntimeError(f"multisweep: the kernel's geometry at ({nx}, "
                           f"{ny}) is {tuple(got)}, this module plans with "
                           f"{geometry(nx, ny)}")


def _pass_outputs(u, passes: int) -> list:
    """The output of each launch of a ``passes``-launch call: the passes
    before the last alternate between two fp32 scratch fields, so that a
    call on bf16 storage rounds to bf16 once, as the Pallas kernel's one
    call does; the last writes a new field of u's dtype."""
    mids = [torch.empty(u.shape, dtype=torch.float32, device=u.device)
            for _ in range(min(passes - 1, 2))]
    return [mids[i % 2] for i in range(passes - 1)] + [torch.empty_like(u)]


def pass_storages(u_dtype, f_dtype, n_passes: int) -> list:
    """The storage flags of each launch of an ``n_passes``-launch call on a
    u and an f of these dtypes (bit 0 the launch's input u is bf16, bit 1
    f, bit 2 its output), as ``_pass_outputs`` gives them: the passes
    before the last write fp32 scratch fields, the last a field of u's
    dtype."""
    bu, bf = u_dtype == torch.bfloat16, f_dtype == torch.bfloat16
    return [int(bu and k == 0) | int(bf) << 1
            | int(bu and k == n_passes - 1) << 2 for k in range(n_passes)]


def launch_passes(entry: str, wrapper, u, f, nx: int, ny: int, coefs,
                  omega: float, sweeps: int, *flags, storage: bool = False):
    """Launch C entry ``entry`` (A's, K's or L's) once per pass of
    ``plan_passes(sweeps)``, each on the last one's output, and count the
    launches on ``wrapper`` (bf16 ones on ``wrapper.launches_bf16`` too);
    returns the last output, a new tensor (``u`` itself when there is no
    pass). The kernels write a separate output: neighbouring blocks load a
    block's nodes as their halo, so no kernel writes its input in place.
    ``storage``: the entry takes A's and L's storage flags
    (``pass_storages``), each launch its own: a bf16 u's passes before the
    last run on fp32 scratch fields, whatever f's dtype."""
    passes = plan_passes(sweeps)
    if not passes:
        return u
    check_geometry(nx, ny)
    dev, stream = u.device.index, _build.stream_of(u)
    outputs = _pass_outputs(u, len(passes))
    codes = pass_storages(u.dtype, f.dtype, len(passes))
    src = u
    for k, dst, code in zip(passes, outputs, codes):
        types = (code,) if storage else ()
        _build.launch(entry, src.data_ptr(), f.data_ptr(), dst.data_ptr(),
                      nx, ny, *coefs, omega, k, *flags, *types, dev, stream)
        wrapper.launches += 1
        if u.dtype == torch.bfloat16:
            wrapper.launches_bf16 += 1
        src = dst
    return outputs[-1]


def _resolve_parity(layout: str, method: str) -> bool:
    """True when ``multisweep`` takes the parity body (kernel L)."""
    if layout not in LAYOUTS:
        raise ValueError(f"multisweep: unknown layout {layout!r}; expected "
                         f"one of {LAYOUTS}")
    if method not in smooth_mod.RBGS_METHODS:
        return False  # jacobi and rbgs_rev: the direct body only
    if layout == "auto":
        return PARITY_DEFAULT
    return layout == "parity"


def multisweep_plain(st: Stencil, u, f, *, method: str = "rbgs",
                     sweeps: int = 2, omega: float = 1.0):
    """Plain twin of A and H: ``ops.smooth.smooth`` on the interior of an
    all-Dirichlet level, in place on u. On bf16 storage it rounds where A
    and H do: u, f and H's planes widened to fp32, every sweep in fp32, one
    rounding back into u. An f of another dtype than u's is widened to
    u's, as the kernels widen it, exactly, into their fp32 windows."""
    if u.dtype == torch.bfloat16:
        wide = st if st.scalar else st.astype(torch.float32)
        return _build.round_once(multisweep_plain, u, wide, u, f,
                                 method=method, sweeps=sweeps, omega=omega)
    f = f.to(u.dtype)
    unknown = bc.unknown_mask(*u.shape, device=u.device)
    return smooth_mod.smooth(st, u, f, unknown, method=method,
                             sweeps=sweeps, omega=omega)


def multisweep_parity_plain(st: Stencil, u, f, *, sweeps: int = 2,
                            omega: float = 1.0):
    """Plain twin of L: split u and f into parity planes (the whole level is
    one window), run the parity body ``ops.planes.plane_sweeps``, merge back
    into u. On bf16 storage it rounds where L does: u and f widened to
    fp32, every sweep in fp32, one rounding back into u; an f of another
    dtype than u's widened to u's."""
    if u.dtype == torch.bfloat16:
        return _build.round_once(multisweep_parity_plain, u, st, u, f,
                                 sweeps=sweeps, omega=omega)
    f = f.to(u.dtype)
    up, fp = pln.split_field(u), pln.split_field(f)
    masks = pln.masks_for(*u.shape, *up.shape[1:], device=u.device)
    pln.plane_sweeps(st.coefs, up, fp, masks, sweeps=sweeps, omega=omega)
    return u.copy_(pln.merge_field(up, u.shape))


def multisweep_parity(st: Stencil, u, f, *, sweeps: int = 2,
                      omega: float = 1.0):
    """``sweeps`` red-then-black RB-GS/SOR sweeps through parity planes;
    returns the smoothed field: ``u`` itself, updated in place, on the CPU,
    a new tensor from kernel L (``u`` untouched)."""
    _build.check_five_point("multisweep_parity", st)
    if not st.scalar:
        raise ValueError("multisweep_parity: takes a constant-coefficient "
                         "stencil")
    _build.check_unwrapped("multisweep_parity", st)
    if u.device.type == "cpu":
        return multisweep_parity_plain(st, u, f, sweeps=sweeps, omega=omega)
    _build.check_cuda("multisweep_parity", u, f, dtypes=STORAGE)
    if f.shape != u.shape:
        raise ValueError(f"multisweep_parity: f {tuple(f.shape)} != u "
                         f"{tuple(u.shape)}")
    return launch_passes("mg_rbgs_parity", multisweep_parity, u, f,
                         *u.shape, st.coefs, omega, sweeps, storage=True)


def multisweep(st: Stencil, u, f, *, method: str = "rbgs", sweeps: int = 2,
               omega: float = 1.0, layout: str = "auto"):
    """``sweeps`` sweeps of ``method``; returns the smoothed field: ``u``
    itself, updated in place, on the CPU, a new tensor from A and L (``u``
    untouched).

    ``method``: 'jacobi', an RB-GS name ('rbgs', 'gauss_seidel', 'red_black',
    'sor'), or 'rbgs_rev' (black before red). ``layout``: 'auto', 'direct'
    or 'parity' (see the module docstring)."""
    if method != "jacobi" and method not in RBGS:
        raise ValueError(f"multisweep: unsupported method {method!r}")
    _build.check_unwrapped("multisweep", st)
    _build.check_five_point("multisweep", st)
    if _resolve_parity(layout, method):
        return multisweep_parity(st, u, f, sweeps=sweeps, omega=omega)
    if u.device.type == "cpu":
        return multisweep_plain(st, u, f, method=method, sweeps=sweeps,
                                omega=omega)
    _build.check_cuda("multisweep", u, f, dtypes=STORAGE)
    if f.shape != u.shape:
        raise ValueError(f"multisweep: f {tuple(f.shape)} != u "
                         f"{tuple(u.shape)}")
    return launch_passes("mg_smooth", multisweep, u, f, *u.shape, st.coefs,
                         omega, sweeps, int(method == "jacobi"),
                         int(method == "rbgs_rev"), storage=True)


multisweep.launches = multisweep.launches_bf16 = 0
multisweep_parity.launches = multisweep_parity.launches_bf16 = 0
