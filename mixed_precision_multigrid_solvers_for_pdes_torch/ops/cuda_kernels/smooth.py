"""Kernels A and L: multi-sweep smoothing (``csrc/smooth.cu``,
``csrc/smooth_parity.cu``) and their plain twins.

Kernel A replaces the Pallas ``multisweep`` and ``multisweep_strips`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py``
(:290, :507) for constant-coefficient 5-point stencils on all-Dirichlet
rectangles in fp32. Kernel L replaces their ``layout="parity"`` body
(``_parity_sweeps`` :119): split into parity planes on chip, sweep, merge.
The source notes in ``csrc/smooth.cu`` and ``csrc/smooth_parity.cu`` give
the designs and what bounds them.

``multisweep(layout=...)`` chooses between them as the Pallas kernels do
(``_resolve_parity``): 'parity' takes L, 'direct' takes A, 'auto' follows
``PARITY_DEFAULT``. Jacobi and the reversed colour order ('rbgs_rev') always
take the direct body: the parity body sweeps red then black only.

On a CPU tensor each wrapper runs its plain twin; on a CUDA tensor it
launches its kernel or raises. ``multisweep.launches`` counts A's launches
(one per colour half-sweep, one per Jacobi sweep),
``multisweep_parity.launches`` counts L's (one per call of up to
``MAX_PARITY_SWEEPS`` sweeps).
"""

from __future__ import annotations

import torch

from ...core import bc
from .. import planes as pln
from .. import smooth as smooth_mod
from ..stencil import Stencil
from . import _build

RBGS = smooth_mod.RBGS_METHODS + ("rbgs_rev",)
LAYOUTS = ("auto", "direct", "parity")
# Off by default, as in the JAX package (its smooth.py:277).
PARITY_DEFAULT = False
MAX_PARITY_SWEEPS = 24   # kMaxSweeps in csrc/smooth_parity.cu


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
    all-Dirichlet level, in place on u."""
    unknown = bc.unknown_mask(*u.shape, device=u.device)
    return smooth_mod.smooth(st, u, f, unknown, method=method, sweeps=sweeps,
                             omega=omega)


def multisweep_parity_plain(st: Stencil, u, f, *, sweeps: int = 2,
                            omega: float = 1.0):
    """Plain twin of L: split u and f into parity planes (the whole level is
    one window), run the parity body ``ops.planes.plane_sweeps``, merge back
    into u."""
    up, fp = pln.split_field(u), pln.split_field(f)
    masks = pln.masks_for(*u.shape, *up.shape[1:], device=u.device)
    pln.plane_sweeps(st.coefs, up, fp, masks, sweeps=sweeps, omega=omega)
    return u.copy_(pln.merge_field(up, u.shape))


def multisweep_parity(st: Stencil, u, f, *, sweeps: int = 2,
                      omega: float = 1.0):
    """``sweeps`` red-then-black RB-GS/SOR sweeps in place on ``u`` through
    parity planes (kernel L: one launch per call of up to
    ``MAX_PARITY_SWEEPS`` sweeps); returns ``u``."""
    if not st.scalar:
        raise ValueError("multisweep_parity: takes a constant-coefficient "
                         "stencil")
    if u.device.type == "cpu":
        return multisweep_parity_plain(st, u, f, sweeps=sweeps, omega=omega)
    _build.check_cuda_fp32("multisweep_parity", u, f)
    if f.shape != u.shape:
        raise ValueError(f"multisweep_parity: f {tuple(f.shape)} != u "
                         f"{tuple(u.shape)}")
    nx, ny = u.shape
    # a separate output: neighbouring blocks read this block's nodes as
    # their halo, so L cannot write u in place
    out = torch.empty_like(u)
    done = 0
    while done < sweeps:
        # the window of k sweeps must fit in shared memory: longer runs
        # (a coarsest-level solve) take several launches
        k = min(sweeps - done, MAX_PARITY_SWEEPS)
        _build.launch("mg_rbgs_parity", u.data_ptr(), f.data_ptr(),
                      out.data_ptr(), nx, ny, *st.coefs, omega, k,
                      u.device.index, _build.stream_of(u))
        multisweep_parity.launches += 1
        u.copy_(out)
        done += k
    return u


def multisweep(st: Stencil, u, f, *, method: str = "rbgs", sweeps: int = 2,
               omega: float = 1.0, layout: str = "auto"):
    """``sweeps`` sweeps of ``method`` in place on ``u``; returns ``u``.

    ``method``: 'jacobi', an RB-GS name ('rbgs', 'gauss_seidel', 'red_black',
    'sor'), or 'rbgs_rev' (black before red). ``layout``: 'auto', 'direct'
    or 'parity' (see the module docstring)."""
    if method != "jacobi" and method not in RBGS:
        raise ValueError(f"multisweep: unsupported method {method!r}")
    if _resolve_parity(layout, method):
        return multisweep_parity(st, u, f, sweeps=sweeps, omega=omega)
    if u.device.type == "cpu":
        return multisweep_plain(st, u, f, method=method, sweeps=sweeps,
                                omega=omega)
    _build.check_cuda_fp32("multisweep", u, f)
    if f.shape != u.shape:
        raise ValueError(f"multisweep: f {tuple(f.shape)} != u "
                         f"{tuple(u.shape)}")
    nx, ny = u.shape
    dev, stream = u.device.index, _build.stream_of(u)
    if method == "jacobi":
        scratch = torch.empty_like(u)
        src, dst = u, scratch
        for _ in range(sweeps):
            _build.launch("mg_jacobi", src.data_ptr(), dst.data_ptr(),
                          f.data_ptr(), nx, ny, *st.coefs, omega, dev, stream)
            multisweep.launches += 1
            src, dst = dst, src
        if src is not u:
            u.copy_(src)
        return u
    colors = (1, 0) if method == "rbgs_rev" else (0, 1)
    for _ in range(sweeps):
        for color in colors:
            _build.launch("mg_rbgs_color", u.data_ptr(), f.data_ptr(), nx, ny,
                          *st.coefs, omega, color, dev, stream)
            multisweep.launches += 1
    return u


multisweep.launches = 0
multisweep_parity.launches = 0
