"""Kernel I's launch plans, emulated on the CPU, against its plain twin.

``csrc/transfer_var.cu`` (I) runs one of two plans on a level. A tile
plan gives each block a TX x TY tile of coarse nodes, whose fine window is
the (2TX + 1) x (2TY + 1) fine nodes from (2 I0 - 1, 2 J0 - 1): it stages
u over the window and a one-node halo (zero outside the field), loads f
and the five planes at pairs of window columns where a residual is formed,
forms each fine residual of the window once into a shared tile (zero off
the fine unknowns), and after a barrier sums each coarse node of the tile
from that tile at the 'reflect' fold of its window rows and columns, in the
twin's order, writing 0 off the coarse unknowns. The direct plan gives
each coarse node a thread that forms its nine folded fine residuals
itself. ``var_plan`` picks the plan per level from the source's table, the
level's storage and the card's SM count.

The emulation below repeats both plans with torch ops over every block at
once: the source's own tiles and tiny ones that do not divide the coarse
grid, the window origins, u halo, fold and shared residual tile. A bf16
node is one 2-byte load, widened exactly, so a bf16 field goes through the
same emulation as its fp32 widening. It must equal
``residual_restrict_plain`` bit for bit for every side mask, in all four
in/out storage pairings, on views at storage offsets 0 and 1 (I takes
fine grids that coarsen 2:1, so ny is odd), and it must fail when the u
halo is one node short or the fold is dropped.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
    import transfer as kx
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.stencil import \
    Stencil

SOURCE = (Path(T.__file__).parent / "csrc" / "transfer_var.cu").read_text()
H100_SMS = 132
STATIC_SMEM = 48 * 1024       # a block's static shared memory
SMEM_PER_SM = 228 * 1024      # an H100 SM's shared memory
TINY_TILES = [(2, 3), (3, 2)]
SHAPES = [(17, 21), (37, 69)]
PAIRINGS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
            (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]
PAIRING_IDS = ["fp32", "fp32-bf16", "bf16", "bf16-fp32"]
DIRECT = "direct"


def _consts():
    """The source's integer constants and its tile table."""
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", SOURCE)}
    body = re.search(r"constexpr VarTile kVarTiles\[\] = \{(.*?)\};",
                     SOURCE, re.S).group(1)
    tiles = [tuple(map(int, t)) for t in re.findall(
        r"\{(\d+), (\d+), (\d+)\}", body)]
    return consts, tiles


CONSTS, TILES = _consts()


def _sides(mask):
    return tuple(bool(mask >> k & 1) for k in range(4))


def _rect(nx, ny, mask):
    """The unknowns [i0, i1) x [j0, j1) of a side mask (bit k: side k of
    west, east, south, north is Dirichlet)."""
    return (mask & 1, nx - (mask >> 1 & 1), mask >> 2 & 1,
            ny - (mask >> 3 & 1))


def _inside(rect, i, j):
    i0, i1, j0, j1 = rect
    return (i >= i0) & (i < i1) & (j >= j0) & (j < j1)


def _fields(shape, seed):
    """u, f and five planes (random, c away from 0), fp32 numpy."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    f = (50.0 * rng.standard_normal(shape)).astype(np.float32)
    c = (4.0 + rng.random(shape)).astype(np.float32)
    return u, f, [c] + [rng.random(shape).astype(np.float32)
                        for _ in range(4)]


def _at(a, offset, dtype):
    """``a`` as a ``dtype`` tensor in a view at element ``offset`` of its
    storage."""
    t = torch.from_numpy(a).to(dtype)
    buf = torch.empty(t.numel() + offset, dtype=dtype)
    v = buf[offset:].view(t.shape)
    v.copy_(t)
    return v


def _take(a, i, j, where):
    """a[i, j] where ``where``, else 0: a load the kernel makes only where
    its node is used (fp32, or bf16 widened on load)."""
    nx, ny = a.shape
    ic, jc = np.clip(i, 0, nx - 1), np.clip(j, 0, ny - 1)
    return torch.where(torch.from_numpy(np.array(where)),
                       a[torch.from_numpy(ic), torch.from_numpy(jc)],
                       torch.zeros(()))


def _residuals(q, centre, live):
    """f - (c u - (w W + e E + s S + n N)) where ``live``, else 0: q the
    loaded f and planes, ``centre(di, dj)`` u at the offset neighbour."""
    fv, c, w, e, s, n = q
    nb = (w * centre(-1, 0) + e * centre(1, 0)
          + s * centre(0, -1) + n * centre(0, 1))
    r = fv - (c * centre(0, 0) - nb)
    return torch.where(torch.from_numpy(np.array(live)), r, torch.zeros(()))


def _restrict(R):
    """The coarse values from the nine residuals R[..., da, db], in the
    twin's order: 4 centre + 2 edges + corners, over 16."""
    edges = ((R[..., 2, 1] + R[..., 0, 1]) + R[..., 1, 2]) + R[..., 1, 0]
    corners = ((R[..., 2, 2] + R[..., 0, 2]) + R[..., 2, 0]) + R[..., 0, 0]
    return ((4.0 * R[..., 1, 1] + 2.0 * edges) + corners) / 16.0


def _fold(k, n, fold):
    if not fold:
        return k
    return np.where(k < 0, -k, np.where(k >= n, 2 * (n - 1) - k, k))


def _tile_plan(arrs, mask, tile, halo, fold):
    """Every block of a tile launch at once: (BX, BY, ...) index arrays."""
    u = arrs[0]
    nx, ny = u.shape
    ncx, ncy = kx.coarse_shape(nx, ny)
    tx, ty = tile
    bx, by = -(-ncx // tx), -(-ncy // ty)
    wx, wy = 2 * tx + 1, 2 * ty + 1
    wi0 = (2 * tx * np.arange(bx) - 1)[:, None, None, None]
    wj0 = (2 * ty * np.arange(by) - 1)[None, :, None, None]
    i = wi0 + np.arange(wx)[None, None, :, None]
    j = wj0 + np.arange(wy)[None, None, None, :]
    live = np.broadcast_to(_inside(_rect(nx, ny, mask), i, j),
                           (bx, by, wx, wy))
    # u over the window and its halo (halo < 1: the window alone), zero
    # outside the field
    ui = wi0 - 1 + np.arange(wx + 2)[None, None, :, None]
    uj = wj0 - 1 + np.arange(wy + 2)[None, None, None, :]
    staged = (ui >= 0) & (ui < nx) & (uj >= 0) & (uj < ny)
    if halo < 1:
        staged = staged & (ui >= wi0) & (ui < wi0 + wx) & (uj >= wj0) & (
            uj < wj0 + wy)
    us = _take(u, ui, uj, np.broadcast_to(staged, (bx, by, wx + 2, wy + 2)))
    q = [_take(a, i, j, live) for a in arrs[1:]]
    r = _residuals(q, lambda di, dj: us[..., 1 + di:wx + 1 + di,
                                        1 + dj:wy + 1 + dj], live)
    # phase 2: coarse node (bi tx + x, bj ty + y), past the grid as its last
    d = np.arange(3)
    I = np.minimum(tx * np.arange(bx)[:, None] + np.arange(tx), ncx - 1)
    J = np.minimum(ty * np.arange(by)[:, None] + np.arange(ty), ncy - 1)
    la = _fold(2 * I[..., None] + d - 1, nx, fold) - wi0[:, 0, 0, :, None]
    lb = _fold(2 * J[..., None] + d - 1, ny, fold) - wj0[0, :, 0, :, None]
    assert la.min() >= 0 and la.max() < wx and lb.min() >= 0 \
        and lb.max() < wy
    R = r[torch.arange(bx)[:, None, None, None, None, None],
          torch.arange(by)[None, :, None, None, None, None],
          torch.from_numpy(la)[:, None, :, None, :, None],
          torch.from_numpy(lb)[None, :, None, :, None, :]]
    out = _restrict(R)                    # (BX, BY, TX, TY)
    return out.permute(0, 2, 1, 3).reshape(bx * tx, by * ty)[:ncx, :ncy]


def _direct_plan(arrs, mask, fold):
    """The direct plan: each coarse node's nine folded residuals itself."""
    u = arrs[0]
    nx, ny = u.shape
    ncx, ncy = kx.coarse_shape(nx, ny)
    d = np.arange(3)
    ri = _fold(2 * np.arange(ncx)[:, None] + d - 1, nx, fold)
    rj = _fold(2 * np.arange(ncy)[:, None] + d - 1, ny, fold)
    i = ri[:, None, :, None]              # (NCX, 1, 3, 1)
    j = rj[None, :, None, :]              # (1, NCY, 1, 3)
    live = np.broadcast_to(_inside(_rect(nx, ny, mask), i, j),
                           (ncx, ncy, 3, 3))
    q = [_take(a, i, j, live) for a in arrs[1:]]

    def centre(di, dj):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny)
        return _take(u, ii, jj, np.broadcast_to(ok, (ncx, ncy, 3, 3)))

    return _restrict(_residuals(q, centre, live))


def emulate(u, f, planes, mask, out_dtype, plan, *, halo=1, fold=True):
    """One launch of I with ``plan`` (a tile, or DIRECT): fc in
    ``out_dtype``; u, f and the planes tensors of one dtype at any storage
    offset, widened on load."""
    arrs = [t.float() for t in (u, f, *planes)]
    if plan == DIRECT:
        fc = _direct_plan(arrs, mask, fold)
    else:
        fc = _tile_plan(arrs, mask, plan[:2], halo, fold)
    ncx, ncy = fc.shape
    unknown = _inside(_rect(ncx, ncy, mask), np.arange(ncx)[:, None],
                      np.arange(ncy)[None, :])
    fc = torch.where(torch.from_numpy(unknown), fc, torch.zeros(()))
    return fc.to(out_dtype)


def _case(shape, mask, dtype, out_dtype, offset, plan, seed=0, **kw):
    """(emulated fc, twin's fc) on fields of ``dtype``: u at ``offset``, f at
    the other parity, the planes alternating."""
    u, f, planes = _fields(shape, seed + 7 * mask + offset)
    tu, tf = _at(u, offset, dtype), _at(f, 1 - offset, dtype)
    tp = [_at(p, (k + offset) % 2, dtype) for k, p in enumerate(planes)]
    got = emulate(tu, tf, tp, mask, out_dtype, plan, **kw)
    want = kx.residual_restrict_plain(Stencil(*tp), tu, tf,
                                      sides=_sides(mask),
                                      out_dtype=out_dtype)
    return got, want


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a.float().view(torch.int32),
                                              b.float().view(torch.int32))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("pairing", PAIRINGS, ids=PAIRING_IDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_i_plans_equal_twin_every_mask(shape, pairing, offset):
    """Every side mask, tiny tiles that do not divide the coarse grid and
    the direct plan: the emulated launch equals the twin bit for bit."""
    for mask in range(16):
        for plan in TINY_TILES + [DIRECT]:
            got, want = _case(shape, mask, *pairing, offset, plan)
            assert _same(got, want), (mask, plan)


def test_i_source_tiles_equal_twin_on_ragged_grid():
    """Each of the source's tiles over a grid it does not divide, in every
    storage pairing, at a mixed mask and the all-Dirichlet one."""
    for tile in TILES:
        for pairing in PAIRINGS:
            for mask in (0b1001, 0b1111):
                got, want = _case((69, 101), mask, *pairing, 1, tile)
                assert _same(got, want), (tile, pairing, mask)


@pytest.mark.parametrize("fine", [257, 513, 1025])
def test_i_plan_per_level_fills_the_card(fine):
    """var_plan on an H100 (132 SMs): a tile plan gives every SM a block at
    each level of the 1025^2 paths (513 -> 257 and 257 -> 129 included),
    bf16 takes the direct plan at 1025 -> 513 alone, and the plan taken
    equals the twin bit for bit (fp32 at a Neumann/Robin mask, bf16 at the
    Dirichlet one)."""
    nc = (fine - 1) // 2 + 1
    for dtype, mask in ((torch.float32, 0b0110), (torch.bfloat16, 0b1111)):
        k = kx.var_plan(nc, nc, H100_SMS, dtype == torch.bfloat16)
        assert (k == kx.VAR_DIRECT) == (fine == 1025
                                         and dtype == torch.bfloat16)
        plan = DIRECT if k == kx.VAR_DIRECT else TILES[k]
        if plan != DIRECT:
            assert kx.var_blocks(nc, nc, plan) >= H100_SMS
        got, want = _case((fine, fine), mask, dtype, dtype, fine % 2, plan)
        assert _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_i_plans_fail_short_halo_or_no_fold(dtype):
    """The check has teeth: u staged over the window alone, or the window
    read unfolded at a Neumann side (in either plan), differs from the
    twin."""
    got, want = _case((37, 69), 0b1111, dtype, dtype, 0, (3, 2), halo=0)
    assert not _same(got, want)
    for plan in ((3, 2), DIRECT):
        got, want = _case((37, 69), 0b0000, dtype, dtype, 0, plan,
                          fold=False)
        assert not _same(got, want)


def test_i_geometry_matches_source_and_fits():
    """The wrapper's plans are the source's; the tiles are largest first;
    every tile's shared tiles fit a block's static shared memory and the
    blocks the plan rule counts on fit an SM; the direct plan keeps the
    parent's 32 x 8 blocks."""
    assert kx.VAR_TILES == tuple(TILES)
    assert CONSTS["kVarTileCount"] == len(TILES) == kx.VAR_DIRECT
    assert kx.VAR_MIN_BLOCKS_PER_SM == CONSTS["kVarMinBlocksPerSm"]
    assert kx.VAR_DIRECT_MIN_NODES_PER_SM == \
        CONSTS["kVarDirectMinNodesPerSm"]
    assert (CONSTS["kDirectX"], CONSTS["kDirectY"]) == (32, 8)
    assert "__launch_bounds__(kVarTiles[K].threads)" in SOURCE
    sizes = [tx * ty for tx, ty, _ in TILES]
    assert sizes == sorted(sizes, reverse=True)
    for tx, ty, threads in TILES:
        wx, wy = 2 * tx + 1, 2 * ty + 1
        smem = ((wx + 2) * (wy + 2) + wx * wy) * 4
        assert smem <= STATIC_SMEM
        assert kx.VAR_MIN_BLOCKS_PER_SM * smem <= SMEM_PER_SM
        assert kx.VAR_MIN_BLOCKS_PER_SM * threads <= 2048
    assert kx.var_plan(3, 3, H100_SMS, True) == len(TILES) - 1
    assert kx.var_plan(513, 513, H100_SMS, False) == 0
