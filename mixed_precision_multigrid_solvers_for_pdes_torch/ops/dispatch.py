"""Routing between the hand-written CUDA kernels and the plain PyTorch path.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/dispatch.py``
(``smooth``, ``transfer_fused_ok``, ``residual_restrict``,
``prolong_correct``, ``tail_ok``, ``tail_vcycle``), with the TPU byte gates
dropped. ``backend`` is 'auto' or 'torch':

- 'auto' routes every configuration the kernels take (fp32, 5-point
  stencil, default transfers, Jacobi or RB-GS smoothing) to the kernel
  wrappers in ``ops/cuda_kernels``. A wrapper launches its kernel on a CUDA
  tensor and runs its plain twin on a CPU tensor, so 'auto' means kernels on
  the GPU and plain code on the CPU.
- 'torch' forces the plain PyTorch path on any device.

Constant-coefficient stencils (float leaves, all-Dirichlet) take kernels A
(smoothing), B and C (fused transfers) on every level above the tail, and
the tail kernel D. Stencils with (nx, ny) coefficient planes (a coefficient
field, an array lam, or Neumann/Robin sides) follow the JAX package's
varcoef routes (``_pallas_smooth_ok``, ``transfer_fused_ok`` with
``_dirichlet_sides``, ``tail_ok``/``tail_vcycle``): all-Dirichlet levels
smooth with kernel H and take the tail kernel J; every level restricts with
kernel I and prolongs with C, both given the per-side Dirichlet flags; a
level with a Neumann/Robin side smooths on the plain path and has no tail
kernel, as in the JAX package. A tail starts at the first level whose
logical size is at most ``TAIL_MAX_ENTRY`` x ``TAIL_MAX_ENTRY``; that is
where the TPU started its tail, and H100 gates await H100 measurements.
Kernel A's wrapper picks the direct body (A) or the parity body (kernel L)
by ``layout``, as the Pallas kernels do (``ops/cuda_kernels/smooth.py``).

Parity planes (``smooth_planes``, the route of ``plane_solve``): fp32
level-0 planes take kernel K, others its plain twin. The JAX package's
``_smooth_planes`` always called Pallas; the port keeps its own 'auto' /
'torch' convention here, so that the two can be compared on the card.

3D (``smooth3d``, ``transfer_fused3d_ok``, ``residual_restrict3d``,
``prolong_correct3d``; counterparts of ``pallas_smooth3d_ok`` and
``transfer_fused3d_ok``): fp32 levels of an all-Dirichlet box take kernel E
for RB-GS smoothing and kernels F and G for the transfers on every level,
down to the coarsest; the TPU's byte, plane-budget and ``px >= 4`` gates are
dropped. Weighted Jacobi stays on the plain path in 3D, as it did on the
TPU. There is no 3D tail kernel: the JAX package never built one.
"""

from __future__ import annotations

import torch

from . import smooth as smooth_mod, smooth3d as smooth3d_mod
from .cuda_kernels import smooth as k_smooth, smooth3d as k_smooth3d, \
    smooth_planes as k_planes, smooth_var as k_smooth_var, tail as k_tail, \
    transfer as k_transfer, transfer3d as k_transfer3d

BACKENDS = ("auto", "torch")
TAIL_MAX_ENTRY = 129
_SMOOTHERS = ("jacobi",) + smooth_mod.RBGS_METHODS


def _kernels(backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend == "auto"


def kernel_smooth_ok(u, lev, backend: str, method: str) -> bool:
    return (_kernels(backend)
            and (method in _SMOOTHERS or method == "rbgs_rev")
            and lev.spec.all_dirichlet
            and u.dtype == torch.float32)


def smooth(stencil, u, f, lev, *, method: str, sweeps: int, omega: float,
           backend: str = "auto"):
    """``sweeps`` smoothing sweeps in place on ``u``; returns ``u``."""
    if kernel_smooth_ok(u, lev, backend, method):
        kernel = (k_smooth.multisweep if stencil.scalar
                  else k_smooth_var.multisweep_var)
        return kernel(stencil, u, f, method=method, sweeps=sweeps,
                      omega=omega)
    return smooth_mod.smooth(stencil, u, f, lev.unknown, method=method,
                             sweeps=sweeps, omega=omega)


def kernel_planes_ok(up, backend: str) -> bool:
    """True when kernel K runs the level-0 plane smoothing: fp32 planes.
    ``plane_solve.plane_solve_ok`` has already gated the level."""
    return _kernels(backend) and up.dtype == torch.float32


def smooth_planes(lev0, up, fp, cfg, sweeps: int):
    """``sweeps`` RB-GS/SOR sweeps in place on the (4, hx, hy) parity planes
    ``up`` of level 0 (kernel K, or its plain twin); returns ``up``."""
    if sweeps <= 0:
        return up
    kernel = (k_planes.multisweep_planes
              if kernel_planes_ok(up, cfg.backend)
              else k_planes.multisweep_planes_plain)
    return kernel(lev0.stencil, up, fp, nx=lev0.grid.nx, ny=lev0.grid.ny,
                  sweeps=sweeps, omega=cfg.omega)


def transfer_fused_ok(lev, nxt, cfg) -> bool:
    """True when kernels B or I and C replace the plain residual -> restrict
    and prolong -> correct chain between ``lev`` and ``nxt``: any spec
    without periodic sides or segments (Dirichlet, Neumann, Robin)."""
    return (_kernels(cfg.backend)
            and not (lev.spec.any_periodic or lev.spec.any_segments)
            and cfg.restriction == "full_weighting"
            and cfg.prolongation == "bilinear"
            and lev.dtype == torch.float32 and nxt.dtype == torch.float32)


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


def tail_ok(levels, lvl, cfg, cycle_type) -> bool:
    """True when the whole V-recursion from ``lvl`` down may run as one
    tail-kernel launch."""
    if cycle_type != "V" or not _kernels(cfg.backend):
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
    return all(lev.dtype == torch.float32 and lev.spec.all_dirichlet
               for lev in tail)


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


def kernel_smooth3d_ok(u, lev, backend: str, method: str) -> bool:
    """True when kernel E runs the 3D smoothing: an RB-GS-family method
    (Jacobi stays plain), an all-Dirichlet box, fp32 data."""
    return (_kernels(backend)
            and (method in smooth_mod.RBGS_METHODS or method == "rbgs_rev")
            and lev.spec.all_dirichlet
            and u.dtype == torch.float32)


def smooth3d(lev, u, f, *, method: str, sweeps: int, omega: float,
             reverse: bool = False, backend: str = "auto"):
    """``sweeps`` 3D smoothing sweeps in place on ``u``; returns ``u``."""
    if kernel_smooth3d_ok(u, lev, backend, method):
        return k_smooth3d.rbgs3d(lev.stencil, u, f, sweeps=sweeps,
                                 omega=omega,
                                 reverse=reverse or method == "rbgs_rev")
    return smooth3d_mod.smooth3d(lev.stencil, u, f, lev.unknown,
                                 method=method, sweeps=sweeps, omega=omega,
                                 reverse=reverse)


def transfer_fused3d_ok(lev, nxt, cfg) -> bool:
    """True when kernels F/G replace the plain 3D residual -> restrict and
    prolong -> correct chain between ``lev`` and ``nxt``."""
    return (_kernels(cfg.backend)
            and cfg.restriction == "full_weighting"
            and lev.spec.all_dirichlet
            and lev.dtype == torch.float32 and nxt.dtype == torch.float32)


def residual_restrict3d(lev, nxt, u, f):
    """Fused fc = R(f - A u) (gate with transfer_fused3d_ok first)."""
    return k_transfer3d.residual_restrict3d(lev.stencil, u, f,
                                            out_dtype=nxt.dtype)


def prolong_correct3d(lev, nxt, ec, u):
    """Fused u += P ec on fine unknowns, in place (gate with
    transfer_fused3d_ok first)."""
    return k_transfer3d.prolong_correct3d(ec, u)
