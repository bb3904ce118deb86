"""Galerkin (RAP) coarse-grid operators.

Counterpart of ``galerkin_coarse_stencil`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/galerkin.py``:

    A_c = R M_f A M_f P

where R and P are the cycle's restriction and prolongation and ``M_f``
masks to the fine unknowns, so A_c is exactly the operator the two-grid
correction applies. The nine coarse coefficient planes come from nine
applications of the composed operator to mod-3 comb fields (unit impulses
3 coarse nodes apart): the composed operator has coarse support radius at
most 1, so within any 3 x 3 coarse neighbourhood each comb phase isolates
one matrix entry,

    (A_c)[J, J + d] = (R M A M P chi_p)[J]   with   p = (J + d) mod 3.

The nine phases run as a loop of plain prolong, mask, apply, mask and
restrict passes (the JAX package batches them with ``vmap``) on the level's
device. The coarse operator of a 5-point stencil under full weighting and
bilinear interpolation is 9-point, and 9-point is closed under further RAP,
so every level below the finest is a ``Stencil9``.

In 3D (``galerkin_coarse_stencil3d``) the same construction takes 27 comb
phases (mod 3 along each axis) under full weighting and trilinear
interpolation, and the coarse operator is a ``Stencil27`` (27-point is
closed under further RAP). The phases run one after another: at 257^3 a
27-wide batch would hold 27 fine float64 fields at once.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.domain import unknown_mask
from ..core import bc3d
from ..core.grid import Grid
from ..core.precision import as_dtype
from . import stencil as st_mod, stencil3d as st3, transfer, transfer3d
from .stencil import Stencil9
from .stencil3d import OFFSETS27, Stencil27


def galerkin_coarse_stencil(st_f, grid_f: Grid, grid_c: Grid, spec, *,
                            domain=None, dtype=torch.float64,
                            restriction: str = "full_weighting",
                            prolongation: str = "bilinear",
                            device=None) -> Stencil9:
    """Coarse ``Stencil9`` = RAP of ``st_f`` (a ``Stencil`` or a
    ``Stencil9``), computed in ``dtype`` (float64 by default) on ``device``
    (the card when None).

    ``restriction`` and ``prolongation`` must be the cycle's, so that the
    coarse equation A_c e_c = R r uses one R; the restriction boundary is the
    cycle's too ('zero' on a plain spec, else 'reflect'). The caller casts
    the result to the level's dtype."""
    if spec.any_periodic:
        # the mod-3 comb phases alias across a periodic seam whenever the
        # unique extent is not divisible by 3 (always, for 2^k+1 grids)
        raise NotImplementedError(
            "Galerkin coarsening does not support periodic BCs; use "
            "coarsening='rediscretize'")
    dtype = as_dtype(dtype)
    device = resolve_device(device)
    st_hi = st_f.astype(dtype)
    unk_f = unknown_mask(grid_f, spec, domain, device=device)
    unk_c = unknown_mask(grid_c, spec, domain, device=device)
    boundary = "zero" if spec.plain else "reflect"
    zero = torch.zeros((), dtype=dtype, device=device)
    ic = torch.arange(grid_c.nx, device=device)[:, None]
    jc = torch.arange(grid_c.ny, device=device)[None, :]

    phases = []
    for p in range(9):
        chi = ((ic % 3 == p // 3) & (jc % 3 == p % 3) & unk_c).to(dtype)
        ef = transfer.prolong(chi, grid_f.nx, grid_f.ny, method=prolongation,
                              dtype=dtype)
        ef = torch.where(unk_f, ef, zero)
        ae = torch.where(unk_f, st_mod.apply(st_hi, ef), zero)
        y = transfer.restrict(ae, grid_c.nx, grid_c.ny, method=restriction,
                              boundary=boundary, dtype=dtype)
        phases.append(torch.where(unk_c, y, zero))
    # (9, ncx, ncy): Y[3*px + py] = R M A M P chi_(px, py)
    Y = torch.stack(phases)

    def coef(dx: int, dy: int):
        # (A_c)[J, J + d]: the phase that isolates offset d at each J
        idx = ((ic + dx) % 3) * 3 + (jc + dy) % 3
        return torch.gather(Y, 0, idx.expand(grid_c.shape)[None])[0]

    def off(dx: int, dy: int):
        return torch.where(unk_c, -coef(dx, dy), zero)

    c = torch.where(unk_c, coef(0, 0), torch.ones((), dtype=dtype,
                                                  device=device))
    return Stencil9(c, off(-1, 0), off(1, 0), off(0, -1), off(0, 1),
                    off(-1, -1), off(1, -1), off(-1, 1), off(1, 1))


def galerkin_coarse_stencil3d(st_f, grid_f, grid_c, spec, *,
                              dtype=torch.float64, device=None) -> Stencil27:
    """Coarse ``Stencil27`` = RAP of ``st_f`` (a ``Stencil3D`` or a
    ``Stencil27``) under the 3D cycle's full-weighting restriction ('zero'
    on an all-Dirichlet spec, else 'reflect') and trilinear prolongation,
    computed in ``dtype`` (float64 by default) on ``device`` (the card when
    None). The caller casts the result to the level's dtype."""
    if spec.any_periodic:
        raise NotImplementedError(
            "Galerkin coarsening does not support periodic BCs; use "
            "coarsening='rediscretize'")
    dtype = as_dtype(dtype)
    device = resolve_device(device)
    st_hi = st_f.astype(dtype)
    unk_f = bc3d.unknown_mask3d(*grid_f.shape, spec, device=device)
    unk_c = bc3d.unknown_mask3d(*grid_c.shape, spec, device=device)
    boundary = "zero" if spec.all_dirichlet else "reflect"
    zero = torch.zeros((), dtype=dtype, device=device)
    ic, jc, kc = (torch.arange(n, device=device).reshape(
        [n if ax == axis else 1 for ax in range(3)])
        for axis, n in enumerate(grid_c.shape))

    # Y[9*px + 3*py + pz] = R M A M P chi_(px, py, pz), one phase at a time
    Y = torch.empty((27, *grid_c.shape), dtype=dtype, device=device)
    for p in range(27):
        chi = ((ic % 3 == p // 9) & (jc % 3 == (p // 3) % 3)
               & (kc % 3 == p % 3) & unk_c).to(dtype)
        ef = torch.where(unk_f, transfer3d.prolong3d(chi, *grid_f.shape,
                                                     dtype=dtype), zero)
        ae = torch.where(unk_f, st3.apply(st_hi, ef), zero)
        y = transfer3d.restrict3d(ae, *grid_c.shape, boundary=boundary,
                                  dtype=dtype)
        Y[p] = torch.where(unk_c, y, zero)

    def coef(dx: int, dy: int, dz: int):
        idx = (((ic + dx) % 3) * 9 + ((jc + dy) % 3) * 3
               + (kc + dz) % 3).expand(grid_c.shape)
        return torch.gather(Y, 0, idx[None])[0]

    c = torch.where(unk_c, coef(0, 0, 0), torch.ones((), dtype=dtype,
                                                     device=device))
    off = torch.stack([torch.where(unk_c, -coef(*d), zero)
                       for d in OFFSETS27])
    return Stencil27(c=c, off=off)
