"""Kernel H's schedule, emulated on the CPU, against the plain twin.

``csrc/smooth_var.cu`` runs up to MAX_SWEEPS sweeps per launch: each block
owns a tile of the interior (plus the ring next to it at the field's edge),
loads a window of u, f and the five planes, the tile plus a halo of 2 nodes
per RB-GS sweep (1 per Jacobi sweep) clamped to the field, runs every colour
phase (every Jacobi sweep) on the window, updating only nodes off the
window's border, and stores the tile into a separate output, which the
wrapper copies back into u; a level takes the largest of the kernel's tiles
whose grid holds enough blocks. The emulation below repeats that with torch
ops on each window, colours taken from the global node index, at tiny tiles
and at each of the kernel's own, on shapes the tiles do not divide. Every
node is the twin's arithmetic, so the emulation must equal
``multisweep_plain`` bit for bit, and a halo one node short must break it.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import stencil
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    smooth as ksmooth,
    smooth_var as ksv,
)

SOURCE = Path(T.__file__).parent / "csrc" / "smooth_var.cu"
SHAPES = [(13, 21), (37, 19), (9, 9)]
TINY_TILE = (4, 6)
METHODS = [("rbgs", 1.0), ("rbgs_rev", 1.0), ("sor", 1.3), ("jacobi", 0.8)]


def _problem(shape):
    g = T.Grid(*shape, (0.0, 1.3, 0.0, 0.7))
    X, Y = g.coordinates()
    st = stencil.make_stencil(g, a=np.where(X < 0.6, 1.0, 1e3) + Y)
    rng = np.random.default_rng(sum(shape))
    u = rng.standard_normal(shape).astype(np.float32)  # a non-zero ring too
    f = np.zeros(shape, np.float32)
    f[1:-1, 1:-1] = 1e3 * rng.standard_normal((shape[0] - 2, shape[1] - 2))
    return st, torch.from_numpy(u), torch.from_numpy(f)


def _tile_span(t, tile, n):
    lo, hi = (0 if t == 0 else 1 + t * tile), min(1 + (t + 1) * tile, n - 1)
    return lo, (n if hi == n - 1 else hi)


def _window_sweeps(planes, u, f, parity, method, sweeps, omega):
    """Every sweep of a launch on one window: only nodes off its border
    move; colour of local (li, lj) is that of (li + lj + parity)."""
    c, w, e, s, n = (x[1:-1, 1:-1] for x in planes)
    li = torch.arange(u.shape[0] - 2)[:, None]
    lj = torch.arange(u.shape[1] - 2)[None, :]
    red = (li + lj + parity) % 2 == 0

    def nbsum(v):
        return (w * v[:-2, 1:-1] + e * v[2:, 1:-1] + s * v[1:-1, :-2]
                + n * v[1:-1, 2:])

    fi = f[1:-1, 1:-1]
    for _ in range(sweeps):
        if method == "jacobi":
            ui = u[1:-1, 1:-1]
            r = fi - (c * ui - nbsum(u))
            new = u.clone()
            new[1:-1, 1:-1] = ui + omega * r / c
            u = new
            continue
        first = red if method != "rbgs_rev" else ~red
        for mask in (first, ~first):
            ui = u[1:-1, 1:-1]
            gs = (fi + nbsum(u)) / c
            u[1:-1, 1:-1] = torch.where(mask, ui + omega * (gs - ui), ui)
    return u


def _launch(st, src, f, *, method, sweeps, omega, tile, halo):
    """One launch: every tile's window swept, the tile stored to out."""
    nx, ny = src.shape
    out = torch.full_like(src, float("nan"))
    for ti in range(math.ceil((nx - 2) / tile[0])):
        for tj in range(math.ceil((ny - 2) / tile[1])):
            ai, aj = 1 + ti * tile[0], 1 + tj * tile[1]
            bi, bj = min(ai + tile[0], nx - 1), min(aj + tile[1], ny - 1)
            wi0, wj0 = max(ai - halo, 0), max(aj - halo, 0)
            win = (slice(wi0, min(bi + halo, nx)),
                   slice(wj0, min(bj + halo, ny)))
            got = _window_sweeps([x[win] for x in st.coefs],
                                 src[win].clone(), f[win], wi0 + wj0, method,
                                 sweeps, omega)
            (li, hi), (lj, hj) = (_tile_span(ti, tile[0], nx),
                                  _tile_span(tj, tile[1], ny))
            out[li:hi, lj:hj] = got[li - wi0:hi - wi0, lj - wj0:hj - wj0]
    return out


def _emulate(st, u, f, *, method, sweeps, omega, tile, short=0):
    """A call: its launches (plan_passes), each sweeping the last one's
    output."""
    for k in ksv.plan_passes(sweeps):
        u = _launch(st, u, f, method=method, sweeps=k, omega=omega,
                    tile=tile, halo=ksv.halo(k, method) - short)
    return u


@pytest.mark.parametrize("sweeps", [1, 2, 5])
@pytest.mark.parametrize("method,omega", METHODS)
@pytest.mark.parametrize("shape", SHAPES)
def test_window_schedule_equals_twin(shape, method, omega, sweeps):
    st, u, f = _problem(shape)
    ref = ksmooth.multisweep_plain(st, u.clone(), f, method=method,
                                   sweeps=sweeps, omega=omega)
    got = _emulate(st, u, f, method=method, sweeps=sweeps, omega=omega,
                   tile=TINY_TILE)
    assert torch.equal(got, ref), (got - ref).abs().max()


@pytest.mark.parametrize("method,omega", METHODS)
def test_window_schedule_fails_with_a_halo_one_short(method, omega):
    st, u, f = _problem((37, 19))
    ref = ksmooth.multisweep_plain(st, u.clone(), f, method=method, sweeps=2,
                                   omega=omega)
    got = _emulate(st, u, f, method=method, sweeps=2, omega=omega,
                   tile=TINY_TILE, short=1)
    assert not torch.equal(got, ref)


@pytest.mark.parametrize("tile", ksv.TILES)
@pytest.mark.parametrize("method,omega", METHODS)
def test_window_schedule_at_the_kernels_tile(method, omega, tile):
    shape = (70, 133)  # tiles of 32, 16 or 8 x 64 divide neither axis
    st, u, f = _problem(shape)
    ref = ksmooth.multisweep_plain(st, u.clone(), f, method=method, sweeps=2,
                                   omega=omega)
    got = _emulate(st, u, f, method=method, sweeps=2, omega=omega, tile=tile)
    assert torch.equal(got, ref)


def _source_geometry():
    text = SOURCE.read_text()
    exprs = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))
    consts = {k: eval(exprs[k], {}) for k in ("kNumTiles", "kMinBlocks",
                                              "kThreads", "kMaxSweeps")}
    body = re.search(r"constexpr Tile kTiles\[\] = \{(.*?)\};", text,
                     re.S).group(1)
    tiles = tuple((int(a), int(b))
                  for a, b in re.findall(r"\{(\d+), (\d+)\}", body))
    return tiles, consts


def test_launch_plan_and_geometry_are_the_kernel_sources():
    """One launch per 2-sweep call; the tiles are the ones
    csrc/smooth_var.cu compiles, each level takes the largest whose grid
    holds MIN_BLOCKS blocks, and every window fits shared memory."""
    tiles, consts = _source_geometry()
    assert tiles == ksv.TILES and consts["kNumTiles"] == len(tiles)
    assert (consts["kMinBlocks"], consts["kThreads"], consts["kMaxSweeps"]) \
        == (ksv.MIN_BLOCKS, ksv.THREADS, ksv.MAX_SWEEPS)
    assert ksv.geometry(1025, 1025) == (*ksv.TILES[0], ksv.THREADS,
                                        ksv.MAX_SWEEPS, ksv.MIN_BLOCKS,
                                        len(ksv.TILES))
    # the multigrid levels: 32 x 64 at 1025^2 and 513^2, 8 x 64 at 257^2
    assert [ksv.tile(n, n) for n in (1025, 513, 257)] == \
        [ksv.TILES[0], ksv.TILES[0], ksv.TILES[-1]]
    assert sorted(tiles, reverse=True) == list(tiles)
    assert [len(ksv.plan_passes(s)) for s in (0, 1, 2, 4, 5, 9)] == \
        [0, 1, 1, 1, 2, 3]
    assert ksv.plan_passes(5) == [ksv.MAX_SWEEPS, 1]
    for nx, ny in ((1025, 1025), (513, 513), (257, 257), (257, 513),
                   (513, 1025), (5, 5)):
        t = ksv.tile(nx, ny)
        blocks = [math.ceil((nx - 2) / a) * math.ceil((ny - 2) / b)
                  for a, b in tiles]
        k = tiles.index(t)
        assert k == len(tiles) - 1 or blocks[k] >= ksv.MIN_BLOCKS
        assert all(n < ksv.MIN_BLOCKS for n in blocks[:k])
    for t in tiles:
        assert t[1] % 2 == 0
        for method, arrays in (("rbgs", 7), ("jacobi", 8)):
            h = ksv.halo(ksv.MAX_SWEEPS, method)
            assert arrays * 4 * (t[0] + 2 * h) * (t[1] + 2 * h) <= 232448
        # two blocks per SM at the cycle's 2 RB-GS sweeps
        h = ksv.halo(2, "rbgs")
        assert 2 * 7 * 4 * (t[0] + 2 * h) * (t[1] + 2 * h) <= 232448


def test_multisweep_var_on_cpu_runs_the_twin_in_place():
    st, u, f = _problem((13, 21))
    ref = ksmooth.multisweep_plain(st, u.clone(), f, sweeps=2)
    before = ksv.multisweep_var.launches
    got = ksv.multisweep_var(st, u, f, sweeps=2)
    assert got is u and torch.equal(got, ref)
    assert ksv.multisweep_var.launches == before
