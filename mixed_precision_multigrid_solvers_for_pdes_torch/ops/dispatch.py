"""Routing between the hand-written CUDA kernels and the plain PyTorch path.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/dispatch.py``
(``smooth``, ``transfer_fused_ok``, ``residual_restrict``,
``prolong_correct``, ``tail_ok``, ``tail_vcycle``), with the TPU byte gates
dropped. ``backend`` is 'auto' or 'torch':

- 'auto' routes every configuration the kernels take (5-point stencil,
  default transfers, Jacobi or RB-GS smoothing, the storage dtypes below)
  to the kernel
  wrappers in ``ops/cuda_kernels``. A wrapper launches its kernel on a CUDA
  tensor and runs its plain twin on a CPU tensor, so 'auto' means kernels on
  the GPU and plain code on the CPU.
- 'torch' forces the plain PyTorch path on any device.

Constant-coefficient stencils (float leaves, all-Dirichlet) take kernels A
(smoothing, out of place), B and C (fused transfers) on every level above
the tail, and the tail kernel D, which runs V-recursions only: a W or F
branch smooths and transfers through A, B and C down to the depth where the
recursion turns into a V-cycle (``MultigridConfig.w_depth``). Stencils with
(nx, ny) coefficient planes (a coefficient field, an array lam, or
Neumann/Robin sides) follow the JAX package's varcoef routes
(``_pallas_smooth_ok``, ``transfer_fused_ok`` with ``_dirichlet_sides``,
``tail_ok``/``tail_vcycle``): all-Dirichlet levels smooth with kernel H and
take the tail kernel J; every level restricts with kernel I and prolongs
with C, both given the per-side Dirichlet flags; a level with a
Neumann/Robin side smooths on the plain path and has no tail kernel, as in
the JAX package. Periodic and segmented levels take no kernel at all, and
the line, ADI and Chebyshev smoothers no smoothing or tail kernel, as in
the JAX package; transfers on all-Dirichlet levels still take B and C
whatever the smoother, and the coarsest level's RB-GS takes A. A tail
starts at the first level whose logical size is at most
``TAIL_MAX_ENTRY`` x ``TAIL_MAX_ENTRY``; that is where the TPU started its
tail, and H100 gates await H100 measurements. J holds its tail in the
shared memory of one thread-block cluster, which takes every tail of two or
more levels from such an entry; a one-level tail of more than 7264 nodes
(the coarsest solve alone) smooths with kernel H instead
(``cuda_kernels.tail.var_fits``).
Kernel A's wrapper picks the direct body (A) or the parity body (kernel L)
by ``layout``, as the Pallas kernels do (``ops/cuda_kernels/smooth.py``).

Storage dtypes, as the JAX package's gates take them (its ``ops/dispatch.py``
:87, :236-240 and :316-320): A, H and L take an fp32 or a bf16 u, with
an fp32 or bf16 f of either dtype (H's planes in u's dtype); B,
I and C take each of their two levels in fp32 or bf16 (a fine fp32 level
over a coarse bf16 one restricts into bf16), on constant-coefficient,
coefficient-plane and Neumann/Robin rectangles alike; D and J take a tail
whose entry level is fp32 or bf16, whatever the dtypes below it, and
compute every level in fp32 (so a 'mixed' hierarchy's bf16 levels inside
a tail run in fp32 on the kernel, as on the TPU). E takes fp32 or bf16 u
and f, F and G each of their two levels in fp32 or bf16 (the JAX
package's :146-151 and :179-183). Each loads its storage, computes in
fp32 and stores once per call. K takes fp32 planes only, as the JAX
package's plane gate does (its ``solvers/plane_solve.py`` :51). A level
with an
irregular domain (``Level.domain``) takes no kernel: every 2D kernel
builds its unknowns from the rectangle, as in the JAX package's gates
(:83, :229, :326). A ``Stencil9`` level (Galerkin coarsening) takes no 2D
kernel either, as in the JAX package's gates (:68, :218 for either level,
:324 for any tail level): the kernels read five coefficients. Every gate
also looks at the fields it would hand a kernel, not only at the level: a
multigrid preconditioner under an fp64 Krylov loop starts level 0's iterate
in the Krylov vector's dtype on an fp32 level, and that level then smooths,
restricts and prolongs on the plain path in fp64, as the JAX package's XLA
path computes it, while the fp32 levels below it take their kernels.

Parity planes (``smooth_planes``, the route of ``plane_solve``): fp32
level-0 planes take kernel K, others its plain twin. The JAX package's
``_smooth_planes`` always called Pallas; the port keeps its own 'auto' /
'torch' convention here, so that the two can be compared on the card.

3D (``smooth3d``, ``transfer_fused3d_ok``, ``residual_restrict3d``,
``prolong_correct3d``; counterparts of ``pallas_smooth3d_ok`` and
``transfer_fused3d_ok``): fp32 and bf16 levels of an all-Dirichlet box with
a constant-coefficient 7-point stencil take kernel E for RB-GS smoothing
and kernels F and G for the transfers on every level, down to the
coarsest; the TPU's byte, plane-budget and ``px >= 4`` gates are dropped.
A level with a coefficient field, an array lam, Neumann/Robin or periodic
faces, or a ``Stencil27`` (Galerkin) takes none of them, as in the JAX
package's gates (:147, :175: a stencil whose c is not 0-d): the kernels
read seven scalars. Weighted Jacobi and the line smoother stay on the
plain path in 3D, as they did on the TPU. There is no 3D tail kernel: the
JAX package never built one.

The float64 outer step of ``ir_solve3d`` on an all-Dirichlet level 0
(``refine_step3d``) takes kernel N, which replaces no Pallas kernel (the
JAX package leaves that step to XLA), where ``refine3d_ok`` admits it: a
constant-coefficient 7-point level 0 of fp32 or bf16, with contiguous
fp64 fields on a card. Any other such level 0 takes N's plain twin; a
solve under a sharding hook and any other spec keep the masked plain step
(``ir_solve3d`` asks).
"""

from __future__ import annotations

import torch

from . import smooth as smooth_mod, smooth3d as smooth3d_mod
from .stencil import Stencil9
from .stencil3d import Stencil3D
from .cuda_kernels import refine3d as k_refine3d, smooth as k_smooth, \
    smooth3d as k_smooth3d, smooth_planes as k_planes, \
    smooth_var as k_smooth_var, tail as k_tail, transfer as k_transfer, \
    transfer3d as k_transfer3d

BACKENDS = ("auto", "torch")
TAIL_MAX_ENTRY = 129
_SMOOTHERS = ("jacobi",) + smooth_mod.RBGS_METHODS


def _kernels(backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend == "auto"


def _fields_ok(lev, fields) -> bool:
    """True when every field has ``lev``'s dtype."""
    return all(x.dtype == lev.dtype for x in fields)


def kernel_smooth_ok(u, lev, backend: str, method: str, f=None) -> bool:
    """True when kernel A, H or L smooths ``u`` on ``lev``: a point
    smoother on a 5-point all-Dirichlet rectangle, fp32 or bf16 storage
    (the JAX package's :87, which looks at u alone); H's planes in u's
    dtype. ``f``, where given, is fp32 or bf16 too, of u's dtype or not, as
    the Pallas kernels cast u and f each on its own; any other f (fp64)
    takes the plain path."""
    return (_kernels(backend)
            and (method in _SMOOTHERS or method == "rbgs_rev")
            and lev.domain is None
            and not isinstance(lev.stencil, Stencil9)
            and lev.spec.all_dirichlet
            and u.dtype in k_smooth.STORAGE
            and (f is None or f.dtype in k_smooth.STORAGE)
            and (lev.stencil.scalar or u.dtype == lev.dtype))


def smooth(stencil, u, f, lev, *, method: str, sweeps: int, omega: float,
           backend: str = "auto"):
    """``sweeps`` smoothing sweeps of ``u``; returns the smoothed field: a
    new tensor from kernels A and L (which work out of place, ``u``
    untouched), ``u`` itself, updated in place, from kernel H and the plain
    path. Callers take the return value."""
    if kernel_smooth_ok(u, lev, backend, method, f):
        return smooth_kernel(stencil, u, f, method=method, sweeps=sweeps,
                             omega=omega)
    return smooth_mod.smooth(stencil, u, f, lev.unknown, method=method,
                             sweeps=sweeps, omega=omega)


def smooth_kernel(stencil, u, f, *, method: str, sweeps: int,
                  omega: float):
    """Kernel A (a constant stencil) or H (coefficient planes) on the whole
    of ``u``, its outer ring held fixed (gate with kernel_smooth_ok first;
    ``parallel.blocks`` also calls it on a haloed window of a block)."""
    kernel = (k_smooth.multisweep if stencil.scalar
              else k_smooth_var.multisweep_var)
    return kernel(stencil, u, f, method=method, sweeps=sweeps, omega=omega)


def kernel_planes_ok(up, backend: str) -> bool:
    """True when kernel K runs the level-0 plane smoothing: fp32 planes.
    ``plane_solve.plane_solve_ok`` has already gated the level."""
    return _kernels(backend) and up.dtype == torch.float32


def smooth_planes(lev0, up, fp, cfg, sweeps: int):
    """``sweeps`` RB-GS/SOR sweeps of the (4, hx, hy) parity planes ``up``
    of level 0; returns the smoothed planes: new planes from kernel K (which
    works out of place, ``up`` untouched), ``up`` itself, updated in place,
    from its plain twin. Callers take the return value."""
    if sweeps <= 0:
        return up
    kernel = (k_planes.multisweep_planes
              if kernel_planes_ok(up, cfg.backend)
              else k_planes.multisweep_planes_plain)
    return kernel(lev0.stencil, up, fp, nx=lev0.grid.nx, ny=lev0.grid.ny,
                  sweeps=sweeps, omega=cfg.omega)


def transfer_fused_ok(lev, nxt, cfg, *fields) -> bool:
    """True when kernels B or I and C replace the plain residual -> restrict
    and prolong -> correct chain between ``lev`` and ``nxt``: any spec
    without periodic sides or segments (Dirichlet, Neumann, Robin), on
    rectangles of 5-point levels; each level fp32 or bf16; ``fields`` (the
    cycle passes the level's u and f) of ``lev``'s dtype."""
    if not (_kernels(cfg.backend)
            and not (lev.spec.any_periodic or lev.spec.any_segments)
            and lev.domain is None and nxt.domain is None
            and not isinstance(lev.stencil, Stencil9)
            and not isinstance(nxt.stencil, Stencil9)
            and cfg.restriction == "full_weighting"
            and cfg.prolongation == "bilinear"
            and _fields_ok(lev, fields)):
        return False
    return lev.dtype in k_transfer.STORAGE and nxt.dtype in k_transfer.STORAGE


def residual_restrict(lev, nxt, u, f):
    """Fused fc = R(f - A u), zero off the coarse unknowns (gate with
    transfer_fused_ok first)."""
    if lev.stencil.scalar:
        return k_transfer.residual_restrict(lev.stencil, u, f,
                                            out_dtype=nxt.dtype)
    return k_transfer.residual_restrict_var(
        lev.stencil, u, f, sides=lev.spec.dirichlet_sides,
        out_dtype=nxt.dtype)


def prolong_correct(lev, nxt, ec, u):
    """Fused u += P ec on fine unknowns, in place (gate with
    transfer_fused_ok first)."""
    return k_transfer.prolong_correct(ec, u, sides=lev.spec.dirichlet_sides)


def tail_ok(levels, lvl, cfg, cycle_type, *fields) -> bool:
    """True when the whole V-recursion from ``lvl`` down may run as one
    tail-kernel launch: D or J with an fp32 or bf16 entry level (the levels
    below in any dtype, computed in fp32; the JAX package's :316-320 look
    at the entry alone), J on a tail that fits its shared memory; every
    level a 5-point all-Dirichlet rectangle; ``fields`` (the cycle passes
    the entry's u and f) of the entry level's dtype."""
    if cycle_type != "V" or not _kernels(cfg.backend):
        return False
    if not _fields_ok(levels[lvl], fields):
        return False
    if cfg.smoother not in _SMOOTHERS:
        return False
    if cfg.restriction != "full_weighting" or cfg.prolongation != "bilinear":
        return False
    tail = levels[lvl:]
    entry = tail[0].grid
    if entry.nx > TAIL_MAX_ENTRY or entry.ny > TAIL_MAX_ENTRY:
        return False
    if len(tail) > k_tail.MAX_LEVELS:
        return False
    if any(lev.domain is not None or not lev.spec.all_dirichlet
           or isinstance(lev.stencil, Stencil9) for lev in tail):
        return False
    if not (tail[0].stencil.scalar
            or k_tail.var_fits(tuple(lev.grid.shape for lev in tail))):
        return False  # J holds a tail in shared memory: too large a level
    return tail[0].dtype in k_tail.STORAGE  # the entry's storage


def tail_vcycle(levels, lvl, u, f, cfg):
    """One V-cycle over ``levels[lvl:]`` through tail kernel D (constant
    stencils) or J (coefficient planes), in place on ``u`` (gate with
    tail_ok first)."""
    tail = levels[lvl:]
    kernel = (k_tail.tail_vcycle if tail[0].stencil.scalar
              else k_tail.tail_vcycle_var)
    return kernel(
        [lev.stencil for lev in tail], u, f,
        shapes=[lev.grid.shape for lev in tail],
        pre=cfg.pre_sweeps, post=cfg.post_sweeps, omega=cfg.omega,
        method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
        symmetric=cfg.symmetric,
    )


def _scalar7(st) -> bool:
    """True for a constant-coefficient 7-point stencil (float leaves)."""
    return isinstance(st, Stencil3D) and st.scalar


def kernel_smooth3d_ok(u, lev, backend: str, method: str, *fields) -> bool:
    """True when kernel E runs the 3D smoothing: an RB-GS-family method
    (Jacobi and line_z stay plain), a constant-coefficient 7-point stencil
    on an all-Dirichlet box, fp32 or bf16 ``u``, and ``fields`` (the
    dispatch passes f) of u's dtype."""
    return (_kernels(backend)
            and (method in smooth_mod.RBGS_METHODS or method == "rbgs_rev")
            and _scalar7(lev.stencil)
            and lev.spec.all_dirichlet
            and u.dtype in k_smooth3d.STORAGE
            and all(x.dtype == u.dtype for x in fields))


def smooth3d(lev, u, f, *, method: str, sweeps: int, omega: float,
             reverse: bool = False, backend: str = "auto"):
    """``sweeps`` 3D smoothing sweeps of ``u``; returns the smoothed field:
    a new tensor from kernel E (which works out of place), ``u`` itself,
    updated in place, from the plain path."""
    if kernel_smooth3d_ok(u, lev, backend, method, f):
        return k_smooth3d.rbgs3d(lev.stencil, u, f, sweeps=sweeps,
                                 omega=omega,
                                 reverse=reverse or method == "rbgs_rev")
    return smooth3d_mod.smooth3d(lev.stencil, u, f, lev.unknown,
                                 method=method, sweeps=sweeps, omega=omega,
                                 reverse=reverse)


def transfer_fused3d_ok(lev, nxt, cfg, *fields) -> bool:
    """True when kernels F/G replace the plain 3D residual -> restrict and
    prolong -> correct chain between ``lev`` and ``nxt``: a constant-
    coefficient 7-point stencil on an all-Dirichlet box at ``lev`` (G
    reads no stencil), each level fp32 or bf16, and ``fields`` (the cycle
    passes the level's u and f) of ``lev``'s dtype."""
    return (_kernels(cfg.backend)
            and cfg.restriction == "full_weighting"
            and _scalar7(lev.stencil)
            and lev.spec.all_dirichlet
            and lev.dtype in k_transfer3d.STORAGE
            and nxt.dtype in k_transfer3d.STORAGE
            and _fields_ok(lev, fields))


def residual_restrict3d(lev, nxt, u, f):
    """Fused fc = R(f - A u) (gate with transfer_fused3d_ok first)."""
    return k_transfer3d.residual_restrict3d(lev.stencil, u, f,
                                            out_dtype=nxt.dtype)


def prolong_correct3d(lev, nxt, ec, u):
    """Fused u += P ec on fine unknowns, in place (gate with
    transfer_fused3d_ok first)."""
    return k_transfer3d.prolong_correct3d(ec, u)


def refine3d_ok(lev0, cfg, *fields) -> bool:
    """True when kernel N runs ``ir_solve3d``'s float64 outer step on
    ``lev0``: a constant-coefficient 7-point stencil on an all-Dirichlet
    box, fp32 or bf16 level storage, and ``fields`` (the solve's f and u0)
    contiguous fp64 tensors on a CUDA device. The caller also asks that no
    sharding hook is given."""
    return (_kernels(cfg.backend)
            and _scalar7(lev0.stencil)
            and lev0.spec.all_dirichlet
            and lev0.dtype in k_refine3d.STORAGE
            and all(x.is_cuda and x.dtype == torch.float64
                    and x.is_contiguous() for x in fields))


def refine_step3d(lev0, st_hi, u_in, e, f, *, kernel: bool, out=None,
                  r_lo=None, scratch=None):
    """The float64 step (``e`` given) or start (``e`` None) of
    ``ir_solve3d`` on an all-Dirichlet level 0 with its float64 stencil
    ``st_hi``: kernel N where ``kernel`` (refine3d_ok's answer for the
    solve; ``scratch`` from ``refine3d_scratch``), else its plain twin,
    which updates ``u_in`` in place when ``out`` is ``u_in``. Returns
    ``(u, r_lo, rnorm, fnorm)`` (``cuda_kernels.refine3d``)."""
    g = lev0.grid
    h = (g.hx, g.hy, g.hz)
    if kernel:
        return k_refine3d.refine_step3d(st_hi, u_in, e, f, h=h, out=out,
                                        r_lo=r_lo, scratch=scratch)
    return k_refine3d.refine_step3d_plain(st_hi, u_in, e, f, h=h, out=out,
                                          r_lo=r_lo, unknown=lev0.unknown)


def refine3d_scratch(f):
    """Kernel N's scratch for a solve of ``f``'s shape on its card (one per
    solve: each launch leaves it ready for the next)."""
    return k_refine3d.new_scratch(f.shape, f.device)
