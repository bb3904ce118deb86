"""Parity-plane storage of a 2D field and the level-0 operators on it.

Counterpart of ``PLANE_ORDER``, ``plane_shape``, ``split_field``,
``merge_field``, ``plane_masks``, ``plane_residual``, ``restrict_planes``,
``prolong_correct_planes`` and ``plane_norm_scaled_l2`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/planes.py``.

A field u of shape (nx, ny) is held as four parity planes
P[a][b](i, j) = u(2i + a, 2j + b), stacked in one (4, hx, hy) tensor in the
order (ee, eo, oe, oo), with hx = (nx + 1) // 2 and hy = (ny + 1) // 2. A
plane entry that falls outside the field (the odd planes of an odd nx or ny)
holds zero and is masked off. Red nodes ((i + j) even) are exactly the ee
and oo planes, black nodes the eo and oe planes. With nx = 2 nc - 1 the ee
plane is the coarse lattice, so ``restrict_planes`` writes the (nc, nc)
coarse level directly.

Split and merge are strided copies: the JAX package's selection matmuls and
transposes exist for the TPU's lanes only. Neighbour reads are
``torch.roll`` as in the JAX package; every read that wraps lands on a
masked node. Sums keep the JAX package's operand order, so fp32 results
agree bit for bit with its un-jitted functions. ``plane_sweeps`` is the
RB-GS body on planes (``_parity_sweeps`` / ``_plane_sweeps`` of the Pallas
kernels), the plain twin of kernels K and L.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid

PLANE_ORDER = ((0, 0), (0, 1), (1, 0), (1, 1))  # ee, eo, oe, oo


def plane_shape(shape):
    """(hx, hy) of the planes of an (nx, ny) field."""
    nx, ny = shape
    return (nx + 1) // 2, (ny + 1) // 2


def split_field(u: torch.Tensor) -> torch.Tensor:
    """(nx, ny) field -> (4, hx, hy) parity planes (ee, eo, oe, oo)."""
    hx, hy = plane_shape(u.shape)
    out = u.new_zeros((4, hx, hy))
    for k, (a, b) in enumerate(PLANE_ORDER):
        blk = u[a::2, b::2]
        out[k, : blk.shape[0], : blk.shape[1]] = blk
    return out


def merge_field(planes: torch.Tensor, shape) -> torch.Tensor:
    """(4, hx, hy) planes -> (nx, ny) field (inverse of ``split_field``)."""
    u = planes.new_empty(tuple(shape))
    for k, (a, b) in enumerate(PLANE_ORDER):
        blk = u[a::2, b::2]
        blk.copy_(planes[k, : blk.shape[0], : blk.shape[1]])
    return u


def masks_for(nx: int, ny: int, hx: int, hy: int, *,
              device=None) -> torch.Tensor:
    """(4, hx, hy) bool: the all-Dirichlet unknowns of an (nx, ny) grid,
    plane by plane."""
    ii = torch.arange(hx, device=device)[:, None]
    jj = torch.arange(hy, device=device)[None, :]
    out = []
    for a, b in PLANE_ORDER:
        gi, gj = 2 * ii + a, 2 * jj + b
        out.append((gi > 0) & (gi < nx - 1) & (gj > 0) & (gj < ny - 1))
    return torch.stack(out)


def plane_masks(grid: Grid, *, device=None) -> torch.Tensor:
    """(4, hx, hy) bool: the all-Dirichlet unknown mask per plane."""
    return masks_for(grid.nx, grid.ny, *plane_shape(grid.shape),
                     device=device)


def plane_residual(stp, up: torch.Tensor, fp: torch.Tensor,
                   masks: torch.Tensor) -> torch.Tensor:
    """r = f - A u in plane space for the scalar 5-point stencil
    ``stp = (c, w, e, s, n)``; zero off ``masks``."""
    c, w, e, s, n = stp
    ee, eo, oe, oo = up.unbind(0)
    roll = torch.roll
    r_ee = fp[0] - (c * ee - (w * roll(oe, 1, 0) + e * oe
                              + s * roll(eo, 1, 1) + n * eo))
    r_eo = fp[1] - (c * eo - (w * roll(oo, 1, 0) + e * oo
                              + s * ee + n * roll(ee, -1, 1)))
    r_oe = fp[2] - (c * oe - (w * ee + e * roll(ee, -1, 0)
                              + s * roll(oo, 1, 1) + n * oo))
    r_oo = fp[3] - (c * oo - (w * eo + e * roll(eo, -1, 0)
                              + s * oe + n * roll(oe, -1, 1)))
    r = torch.stack([r_ee, r_eo, r_oe, r_oo])
    return torch.where(masks, r, torch.zeros((), dtype=r.dtype,
                                             device=r.device))


def restrict_planes(rp: torch.Tensor, ncx: int, ncy: int,
                    dtype=None) -> torch.Tensor:
    """Full-weighting restriction of residual planes onto the (ncx, ncy)
    coarse grid, whose nodes are the ee lattice:

      16 fc = 4 ee + 2 (oe + oe[I-1]) + 2 (eo + eo[J-1])
              + (oo + oo[I-1] + oo[J-1] + oo[I-1, J-1])

    The coarse ring is zero."""
    if tuple(rp.shape[1:]) != (ncx, ncy):
        raise ValueError(f"restrict_planes: planes {tuple(rp.shape[1:])} "
                         f"are not the ee lattice of a ({ncx}, {ncy}) grid")
    dtype = dtype or rp.dtype
    ee, eo, oe, oo = (x.to(dtype) for x in rp.unbind(0))
    acc = 4.0 * ee
    acc = acc + 2.0 * (oe + torch.roll(oe, 1, 0))
    acc = acc + 2.0 * (eo + torch.roll(eo, 1, 1))
    oo_w = oo + torch.roll(oo, 1, 0)
    acc = acc + oo_w + torch.roll(oo_w, 1, 1)
    acc = acc / 16.0
    ci = torch.arange(ncx, device=rp.device)[:, None]
    cj = torch.arange(ncy, device=rp.device)[None, :]
    interior = (ci > 0) & (ci < ncx - 1) & (cj > 0) & (cj < ncy - 1)
    return torch.where(interior, acc, torch.zeros((), dtype=dtype,
                                                  device=rp.device))


def prolong_correct_planes(ec: torch.Tensor, up: torch.Tensor,
                           masks: torch.Tensor) -> torch.Tensor:
    """u + bilinear prolongation of the coarse correction ``ec``, in plane
    space, on the unknowns:

      ee += ec ; eo += (ec + ec[J+1])/2 ; oe += (ec + ec[I+1])/2 ;
      oo += (ec + ec[I+1] + ec[J+1] + ec[I+1, J+1])/4
    """
    hx, hy = up.shape[1], up.shape[2]
    E = ec[:hx, :hy].to(up.dtype)
    Ex = torch.roll(E, -1, 0)
    Ey = torch.roll(E, -1, 1)
    Exy = torch.roll(Ex, -1, 1)
    add = torch.stack([E, 0.5 * (E + Ey), 0.5 * (E + Ex),
                       0.25 * (E + Ex + Ey + Exy)])
    return torch.where(masks, up + add, up)


def plane_norm_scaled_l2(rp: torch.Tensor, hx_grid: float,
                         hy_grid: float) -> torch.Tensor:
    """sqrt(hx*hy * sum r^2) over all planes, accumulated in float64 (the
    scaled l2 norm of the merged field: the planes partition the nodes)."""
    acc = torch.sum(rp.to(torch.float64) ** 2)
    return torch.sqrt(hx_grid * hy_grid * acc)


def fp32_reciprocal(c: float) -> float:
    """1/c computed in fp32, as the Pallas kernels and the CUDA kernels
    compute it."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return (one / torch.tensor(c, dtype=torch.float32)).item()


def plane_sweeps(stp, up: torch.Tensor, fp: torch.Tensor,
                 masks: torch.Tensor, *, sweeps: int,
                 omega: float) -> torch.Tensor:
    """``sweeps`` red-then-black RB-GS/SOR sweeps in place on the planes
    ``up`` for the scalar stencil ``stp = (c, w, e, s, n)``: the per-node
    arithmetic and operand order of the Pallas ``_parity_sweeps`` and
    ``_plane_sweeps`` bodies,

      p + omega * ((f + (w*W + e*E + s*S + n*N)) * inv_c - p),

    with inv_c = 1/c in fp32. The plain twin of kernels K and L."""
    c, w, e, s, n = stp
    inv_c = fp32_reciprocal(c)
    roll = torch.roll
    fee, feo, foe, foo = fp.unbind(0)
    m_ee, m_eo, m_oe, m_oo = masks.unbind(0)
    ee, eo, oe, oo = up.unbind(0)   # views: the updates land in up

    def upd(p, mask, gs):
        p.copy_(torch.where(mask, p + omega * (gs - p), p))

    for _ in range(sweeps):
        # red = {ee, oo}, then black = {oe, eo} reads the fresh red planes
        upd(ee, m_ee, (fee + (w * roll(oe, 1, 0) + e * oe
                              + s * roll(eo, 1, 1) + n * eo)) * inv_c)
        upd(oo, m_oo, (foo + (w * eo + e * roll(eo, -1, 0)
                              + s * oe + n * roll(oe, -1, 1))) * inv_c)
        upd(oe, m_oe, (foe + (w * ee + e * roll(ee, -1, 0)
                              + s * roll(oo, 1, 1) + n * oo)) * inv_c)
        upd(eo, m_eo, (feo + (w * roll(oo, 1, 0) + e * oo
                              + s * ee + n * roll(ee, -1, 1))) * inv_c)
    return up
