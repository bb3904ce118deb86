"""Kernels B, C and I: fused residual+restriction and prolongation+correction
(``csrc/transfer.cu``, ``csrc/transfer_var.cu``) and their plain twins.

B and I replace the Pallas ``residual_restrict`` and C the Pallas
``prolong_correct`` of
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/transfer.py``
(:262, :488), in fp32. B takes a constant-coefficient stencil on an
all-Dirichlet rectangle; I takes the (nx, ny) coefficient planes of a
tensor-leaf stencil and per-side boundary kinds; C takes the same side flags.
The source notes in ``csrc/`` give the design and what bounds each kernel.

``sides`` is a (west, east, south, north) tuple of Dirichlet flags, as the
Pallas kernels take it (``BoundarySpec.dirichlet_sides``): a Dirichlet
side's ring is fixed, a Neumann/Robin side's ring holds unknowns.

On a CPU tensor each wrapper runs its plain twin; on a CUDA tensor it
launches its kernel or raises. ``residual_restrict.launches``,
``residual_restrict_var.launches`` and ``prolong_correct.launches`` count
kernel launches.
"""

from __future__ import annotations

import torch

from ...core import bc
from .. import stencil as st_mod, transfer as transfer_mod
from ..stencil import Stencil
from . import _build

DIRICHLET = (True, True, True, True)


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
    'reflect' boundary and zeroed off the coarse unknowns."""
    ncx, ncy = coarse_shape(*u.shape)
    r = st_mod.residual(st, u, f, bc.rect_mask(*u.shape, sides,
                                               device=u.device))
    dtype = out_dtype or u.dtype
    if all(sides):
        return transfer_mod.restrict(r, ncx, ncy, boundary="zero",
                                     dtype=dtype)
    fc = transfer_mod.restrict(r, ncx, ncy, boundary="reflect", dtype=dtype)
    return torch.where(bc.rect_mask(ncx, ncy, sides, device=u.device), fc,
                       torch.zeros((), dtype=dtype, device=u.device))


def _check_restrict(name, u, f, out_dtype, *planes):
    _build.check_cuda_fp32(name, u, f, *planes)
    if any(t.shape != u.shape for t in (f, *planes)):
        raise ValueError(f"{name}: f and the planes must have u's shape "
                         f"{tuple(u.shape)}")
    if out_dtype not in (None, torch.float32):
        raise TypeError(f"{name}: the kernel writes float32, asked for "
                        f"{out_dtype}")
    return coarse_shape(*u.shape)


def residual_restrict(st: Stencil, u, f, *, out_dtype=None):
    """B: fc = R_fw(f - A u) on the coarse grid of an all-Dirichlet level
    with a constant stencil; coarse ring zero."""
    _build.check_unwrapped("residual_restrict", st)
    if u.device.type == "cpu":
        return residual_restrict_plain(st, u, f, out_dtype=out_dtype)
    ncx, ncy = _check_restrict("residual_restrict", u, f, out_dtype)
    fc = torch.empty((ncx, ncy), dtype=torch.float32, device=u.device)
    _build.launch("mg_residual_restrict", u.data_ptr(), f.data_ptr(),
                  fc.data_ptr(), u.shape[1], ncx, ncy, *st.coefs,
                  u.device.index, _build.stream_of(u))
    residual_restrict.launches += 1
    return fc


residual_restrict.launches = 0


def residual_restrict_var(st: Stencil, u, f, *, sides=DIRICHLET,
                          out_dtype=None):
    """I: fc = R_fw(f - A u) with the (nx, ny) coefficient planes of ``st``;
    Neumann/Robin rings are unknowns and restrict with the reflect fold;
    coarse nodes off the coarse unknowns are zero."""
    if st.scalar:
        raise ValueError("residual_restrict_var: takes a stencil with "
                         "(nx, ny) coefficient planes")
    _build.check_unwrapped("residual_restrict_var", st)
    if u.device.type == "cpu":
        return residual_restrict_plain(st, u, f, sides=sides,
                                       out_dtype=out_dtype)
    ncx, ncy = _check_restrict("residual_restrict_var", u, f, out_dtype,
                               *st.coefs)
    fc = torch.empty((ncx, ncy), dtype=torch.float32, device=u.device)
    _build.launch("mg_residual_restrict_var", u.data_ptr(), f.data_ptr(),
                  *(x.data_ptr() for x in st.coefs), fc.data_ptr(),
                  *u.shape, ncx, ncy, side_bits(sides), u.device.index,
                  _build.stream_of(u))
    residual_restrict_var.launches += 1
    return fc


residual_restrict_var.launches = 0


def prolong_correct_plain(ec, u, *, sides=DIRICHLET):
    """Plain twin of C: u += prolong(ec) on the unknowns, in place."""
    e = transfer_mod.prolong(ec, *u.shape, dtype=u.dtype)
    i0, i1, j0, j1 = bc.unknown_rect(*u.shape, sides)
    u[i0:i1, j0:j1] += e[i0:i1, j0:j1]
    return u


def prolong_correct(ec, u, *, sides=DIRICHLET):
    """C: u <- u + P_bilinear(ec) on fine unknowns, in place; returns u."""
    if u.device.type == "cpu":
        return prolong_correct_plain(ec, u, sides=sides)
    _build.check_cuda_fp32("prolong_correct", ec, u)
    if tuple(ec.shape) != coarse_shape(*u.shape):
        raise ValueError(f"prolong_correct: ec {tuple(ec.shape)} is not the "
                         f"coarse grid of u {tuple(u.shape)}")
    _build.launch("mg_prolong_correct", ec.data_ptr(), u.data_ptr(),
                  ec.shape[1], u.shape[0], u.shape[1], side_bits(sides),
                  u.device.index, _build.stream_of(u))
    prolong_correct.launches += 1
    return u


prolong_correct.launches = 0
