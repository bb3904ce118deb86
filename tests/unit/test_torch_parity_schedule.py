"""Kernels K's and L's schedule, emulated on the CPU, against their plain
twins.

``csrc/smooth_parity.cu`` runs up to MAX_SWEEPS sweeps per launch, with
kernel A's tiles (``csrc/smooth_tiles.cuh``): each block owns a tile of the
interior (plus the ring next to it at the field's edge), loads a window of u
and f, the tile plus a halo of 2 nodes per sweep clamped to the field, as
the window's four parity planes (window node (li, lj) in plane
(li & 1, lj & 1) at (li >> 1, lj >> 1)), walks each colour phase over the
two planes of that colour, the cells off the window's border only, and
stores the tile into a separate output. L reads and writes an (nx, ny)
field, K the (4, hx, hy) planes of one, copying their padding through. The
emulation below repeats that with torch ops on each window's planes: the
plane shapes, the walk's bounds and the neighbour rows and columns of the
source. Every cell is the kernel's arithmetic (p + omega*((f + nb)/c - p),
each operation rounded in fp32), so a call equals
``multisweep_parity_plain`` and ``multisweep_planes_plain`` bit for bit; a
halo one plane cell (two nodes) short breaks it.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (
    planes,
    stencil,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    smooth as ks,
    smooth_planes as kp,
)

CSRC = Path(T.__file__).parent / "csrc"
TINY_TILES = [(4, 6), (2, 4)]   # the kernel's tiles are even on both axes
LAYOUTS = ("field", "planes")   # L, K
# odd and even sides none of the tiles divides; at (10, 7) one tile (4, 6)
# spans the columns, its stored rows (padding included) 2 nodes longer
SHAPES = [(23, 19), (9, 30), (16, 13), (10, 7), (3, 3)]


def _problem(shape):
    g = T.Grid(*shape, (0.0, 1.3, 0.0, 0.7))
    st = stencil.make_stencil(g)
    rng = np.random.default_rng(sum(shape) + 5)
    u = rng.standard_normal(shape).astype(np.float32)  # a non-zero ring too
    f = np.zeros(shape, np.float32)
    f[1:-1, 1:-1] = st.c * rng.standard_normal((shape[0] - 2, shape[1] - 2))
    return st, torch.from_numpy(u), torch.from_numpy(f)


def _inputs(layout, u, f):
    """u and f as the kernel takes them: the field (L) or its planes (K),
    whose padding holds something other than zero."""
    if layout == "field":
        return u, f
    up, fp = planes.split_field(u), planes.split_field(f)
    nx, ny = u.shape
    pad = torch.ones(up.shape, dtype=torch.bool)
    for a, b in planes.PLANE_ORDER:   # the field's nodes of each plane
        pad[2 * a + b, : (nx - a + 1) // 2, : (ny - b + 1) // 2] = False
    up[pad], fp[pad] = 7.0, -3.0
    return up, fp


def _twin(layout, st, u, f, nx, ny, sweeps, omega):
    if layout == "field":
        return ks.multisweep_parity_plain(st, u.clone(), f, sweeps=sweeps,
                                          omega=omega)
    return kp.multisweep_planes_plain(st, u.clone(), f, nx=nx, ny=ny,
                                      sweeps=sweeps, omega=omega)


def _tile_span(t, tile, n):
    lo, hi = (0 if t == 0 else 1 + t * tile), min(1 + (t + 1) * tile, n - 1)
    return lo, (n if hi == n - 1 else hi)


def _at(layout, gi, gj):
    """Index of the nodes gi x gj in the field, or in its planes
    (``node_at``)."""
    gi, gj = gi[:, None], gj[None, :]
    if layout == "field":
        return gi, gj
    return 2 * (gi % 2) + gj % 2, gi // 2, gj // 2


def _update(st, omega, p, fv, W, E, S, N):
    """rbgs_scalar_update: every operation rounded in fp32."""
    c, w, e, s, n = st.coefs
    acc = w * W
    acc = acc + e * E
    acc = acc + s * S
    acc = acc + n * N
    return p + omega * ((fv + acc) / c - p)


def _split(win, pr, pc):
    """The window's four parity planes in (pr, pc) shared-memory planes;
    cells the window does not fill hold NaN, so reading one shows."""
    out = torch.full((4, pr, pc), float("nan"))
    for a, b in planes.PLANE_ORDER:
        blk = win[a::2, b::2]
        assert blk.shape[0] <= pr and blk.shape[1] <= pc  # fits the planes
        out[2 * a + b, : blk.shape[0], : blk.shape[1]] = blk
    return out


def _phases(st, us, fs, wx, wy, par, sweeps, omega):
    """The kernel's colour phases on a window's planes, in place on us."""
    pr, pc = us.shape[1:]
    r_last = ((wx - 2) >> 1, (wx - 3) >> 1)   # last row pi of plane a
    c_last = ((wy - 2) >> 1, (wy - 3) >> 1)   # last column pj of plane b
    # the walk, whole rows 1 - a .. pr - 1 - a, holds every cell to update
    assert r_last[0] <= pr - 1 and r_last[1] <= pr - 2
    assert max(c_last) <= pc - 1
    for ph in range(2 * sweeps):
        b0 = (ph + par) & 1   # colour ph & 1: planes (0, b0), (1, b0 ^ 1)
        new = []
        for a in (0, 1):
            b = b0 ^ a
            r1, c1 = r_last[a] + 1, c_last[b] + 1
            if r1 <= 1 - a or c1 <= 1 - b:
                continue
            q, qx, qy = 2 * a + b, 2 * (a ^ 1) + b, 2 * a + (b ^ 1)
            rows, cols = slice(1 - a, r1), slice(1 - b, c1)
            # (li -+ 1, lj): plane (a ^ 1, b) rows pi - 1 + a, pi + a;
            # (li, lj -+ 1): plane (a, b ^ 1) columns pj - 1 + b, pj + b
            new.append((q, rows, cols, _update(
                st, omega, us[q, rows, cols], fs[q, rows, cols],
                us[qx, 0:r1 - 1 + a, cols], us[qx, 1:r1 + a, cols],
                us[qy, rows, 0:c1 - 1 + b], us[qy, rows, 1:c1 + b])))
        for q, rows, cols, v in new:   # every cell computed, then stored
            us[q, rows, cols] = v


def _launch(layout, st, u, f, *, nx, ny, sweeps, omega, tile, short):
    """One launch: every tile's window swept on its planes, the tile (and
    K's padding) stored to out."""
    tx, ty = tile
    halo = 2 * (sweeps - short)
    pr, pc = tx // 2 + halo, ty // 2 + halo   # plane_rows(tile, sweeps)
    hx, hy = planes.plane_shape((nx, ny))
    out = torch.full_like(u, float("nan"))
    for ti in range(math.ceil((nx - 2) / tx)):
        for tj in range(math.ceil((ny - 2) / ty)):
            ai, aj = 1 + ti * tx, 1 + tj * ty
            bi, bj = min(ai + tx, nx - 1), min(aj + ty, ny - 1)
            wi0, wj0 = max(ai - halo, 0), max(aj - halo, 0)
            wx, wy = min(bi + halo, nx) - wi0, min(bj + halo, ny) - wj0
            win = _at(layout, torch.arange(wi0, wi0 + wx),
                      torch.arange(wj0, wj0 + wy))
            us, fs = _split(u[win], pr, pc), _split(f[win], pr, pc)
            _phases(st, us, fs, wx, wy, (wi0 + wj0) & 1, sweeps, omega)
            swept = torch.empty(wx, wy)
            for a, b in planes.PLANE_ORDER:
                blk = swept[a::2, b::2]
                blk.copy_(us[2 * a + b, : blk.shape[0], : blk.shape[1]])
            (li, hi), (lj, hj) = (_tile_span(ti, tx, nx),
                                  _tile_span(tj, ty, ny))
            assert hj - lj <= ty + 2   # the span's columns, at most (SY)
            out[_at(layout, torch.arange(li, hi), torch.arange(lj, hj))] = \
                swept[li - wi0:hi - wi0, lj - wj0:hj - wj0]
            if layout == "planes":   # K: the padding next to the span
                pad_i, pad_j = nx % 2 and hi == nx, ny % 2 and hj == ny
                for rows, cols in (
                        ([nx] * pad_i, range(lj, hj + pad_j)),
                        (range(li, hi), [ny] * pad_j)):
                    idx = _at(layout, torch.tensor(rows, dtype=torch.long),
                              torch.tensor(cols, dtype=torch.long))
                    out[idx] = u[idx]
    return out


def _emulate(layout, st, u, f, *, nx, ny, sweeps, omega, tile, short=0):
    """A call: its launches (plan_passes), each on the last one's output."""
    for k in ks.plan_passes(sweeps):
        u = _launch(layout, st, u, f, nx=nx, ny=ny, sweeps=k, omega=omega,
                    tile=tile, short=short)
    return u


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("sweeps", [1, 2, 5])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_parity_schedule_equals_twin(layout, shape, sweeps, omega):
    st, u, f = _problem(shape)
    u, f = _inputs(layout, u, f)
    ref = _twin(layout, st, u, f, *shape, sweeps, omega)
    for tile in TINY_TILES:
        got = _emulate(layout, st, u, f, nx=shape[0], ny=shape[1],
                       sweeps=sweeps, omega=omega, tile=tile)
        assert torch.equal(got, ref), (tile, (got - ref).abs().max())


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("sweeps", [1, 2, 5])
@pytest.mark.parametrize("shape", [(70, 133), (129, 66)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_parity_schedule_at_the_kernels_tiles(layout, shape, sweeps, omega):
    """Each of the kernel's tiles on shapes none divides, odd and even."""
    st, u, f = _problem(shape)
    u, f = _inputs(layout, u, f)
    ref = _twin(layout, st, u, f, *shape, sweeps, omega)
    for tile in ks.TILES:
        got = _emulate(layout, st, u, f, nx=shape[0], ny=shape[1],
                       sweeps=sweeps, omega=omega, tile=tile)
        assert torch.equal(got, ref), (tile, (got - ref).abs().max())


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_parity_schedule_at_the_main_paths_levels(layout, omega):
    """The level's own tile at 1025^2, 513^2 and 257^2 (the plane solve's
    level 0 and the parity-layout main path's levels), 2 sweeps."""
    for n in (1025, 513, 257):
        st, u, f = _problem((n, n))
        u, f = _inputs(layout, u, f)
        ref = _twin(layout, st, u, f, n, n, 2, omega)
        got = _emulate(layout, st, u, f, nx=n, ny=n, sweeps=2, omega=omega,
                       tile=ks.tile(n, n))
        assert torch.equal(got, ref), (n, (got - ref).abs().max())


@pytest.mark.parametrize("sweeps", [2, 3])   # at 1 the halo would be 0
@pytest.mark.parametrize("layout", LAYOUTS)
def test_parity_schedule_fails_with_a_halo_one_plane_cell_short(layout,
                                                                sweeps):
    st, u, f = _problem((23, 19))
    u, f = _inputs(layout, u, f)
    ref = _twin(layout, st, u, f, 23, 19, sweeps, 1.0)
    got = _emulate(layout, st, u, f, nx=23, ny=19, sweeps=sweeps, omega=1.0,
                   tile=TINY_TILES[0], short=1)
    assert not torch.equal(got, ref)


def _constants(text, names):
    exprs = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))
    return {k: eval(exprs[k], {}) for k in names}


def test_launch_plan_and_geometry_are_the_kernel_sources():
    """K and L take the tiles, threads and sweeps per launch of
    csrc/smooth_tiles.cuh, which the wrappers plan with; a plane holds
    tile / 2 + 2 sweeps rows, so a window of the tile plus 2 sweeps nodes
    per side fills it; the largest window fits shared memory."""
    src = (CSRC / "smooth_parity.cu").read_text()
    assert '#include "smooth_tiles.cuh"' in src
    header = (CSRC / "smooth_tiles.cuh").read_text()
    consts = _constants(header, ("kThreads", "kMaxSweeps", "kMinBlocks"))
    body = re.search(r"constexpr Tile kTiles\[\] = \{(.*?)\};", header,
                     re.S).group(1)
    tiles = tuple((int(a), int(b))
                  for a, b in re.findall(r"\{(\d+), (\d+)\}", body))
    assert tiles == ks.TILES
    assert (consts["kThreads"], consts["kMaxSweeps"], consts["kMinBlocks"]) \
        == (ks.THREADS, ks.MAX_SWEEPS, ks.MIN_BLOCKS)
    assert "return rows / 2 + 2 * sweeps;" in src
    assert "return 8 * plane_rows(tx, sweeps) * plane_rows(ty, sweeps) *" \
        in src
    assert "constexpr int halo = 2 * kSweeps;" in src
    assert "constexpr int SY = kTileY + 2;" in src   # the emulated store
    for tx, ty in tiles:
        assert tx % 2 == 0 and ty % 2 == 0
        s = ks.MAX_SWEEPS
        assert 8 * 4 * (tx // 2 + 2 * s) * (ty // 2 + 2 * s) <= 232448
        assert tx + 2 * (2 * s) == 2 * (tx // 2 + 2 * s)
    assert [len(ks.plan_passes(s)) for s in (1, 2, 4, 5, 32)] == \
        [1, 1, 1, 2, 8]


def test_k_and_l_on_cpu_run_their_twins_in_place():
    st, u, f = _problem((13, 21))
    before = ks.multisweep_parity.launches, kp.multisweep_planes.launches
    ref = ks.multisweep_parity_plain(st, u.clone(), f, sweeps=2)
    got = ks.multisweep_parity(st, u, f, sweeps=2)
    assert got is u and torch.equal(got, ref)
    up, fp = planes.split_field(u), planes.split_field(f)
    ref = kp.multisweep_planes_plain(st, up.clone(), fp, nx=13, ny=21)
    got = kp.multisweep_planes(st, up, fp, nx=13, ny=21)
    assert got is up and torch.equal(got, ref)
    assert (ks.multisweep_parity.launches,
            kp.multisweep_planes.launches) == before
