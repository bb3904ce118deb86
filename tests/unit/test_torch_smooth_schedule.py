"""Kernel A's schedule, emulated on the CPU, against the plain twins.

``csrc/smooth.cu`` runs up to MAX_SWEEPS sweeps per launch: each block owns
a tile of the interior (plus the ring next to it at the field's edge),
loads a window of u and f, the tile plus a halo of 2 nodes per RB-GS sweep
(1 per Jacobi sweep) clamped to the field, runs every colour phase (every
Jacobi sweep) on the window, updating only nodes off the window's border,
and stores the tile into a separate output; a level takes the largest of
the kernel's tiles whose grid holds enough blocks. The emulation below
repeats that with torch ops on each window, colours taken from the global
node index, at tiny tiles and at the kernel's own, on shapes the tiles do
not divide. Every node is the kernel's arithmetic (p + omega*((f + nb)/c
- p), each operation rounded in fp32): red-then-black equals
``multisweep_parity_plain`` bit for bit, and every method equals the same
sweeps over the whole field in that arithmetic; a halo one node short
breaks it.
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
    smooth as ks,
)

CSRC = Path(T.__file__).parent / "csrc"
SOURCE = CSRC / "smooth_tiles.cuh"   # A's geometry, which smooth.cu includes
TINY_TILES = [(4, 6), (3, 5)]
METHODS = [("rbgs", 1.0), ("sor", 1.3), ("rbgs_rev", 1.0), ("jacobi", 0.8)]


def _problem(shape):
    g = T.Grid(*shape, (0.0, 1.3, 0.0, 0.7))
    st = stencil.make_stencil(g)
    rng = np.random.default_rng(sum(shape))
    u = rng.standard_normal(shape).astype(np.float32)  # a non-zero ring too
    f = np.zeros(shape, np.float32)
    f[1:-1, 1:-1] = st.c * rng.standard_normal((shape[0] - 2, shape[1] - 2))
    return st, torch.from_numpy(u), torch.from_numpy(f)


def _tile_span(t, tile, n):
    lo, hi = (0 if t == 0 else 1 + t * tile), min(1 + (t + 1) * tile, n - 1)
    return lo, (n if hi == n - 1 else hi)


def _update(st, omega, method, p, fv, W, E, S, N):
    """The kernel's update of the nodes p (rbgs_scalar_update,
    jacobi_scalar_update): every operation rounded in fp32."""
    c, w, e, s, n = st.coefs
    acc = w * W
    acc = acc + e * E
    acc = acc + s * S
    acc = acc + n * N
    if method == "jacobi":
        return p + (omega * (fv - (c * p - acc))) / c
    return p + omega * ((fv + acc) / c - p)


def _whole_field(st, u, f, *, method, sweeps, omega, parity=0):
    """The sweeps over a whole field (or a window, whose first node has the
    colour of ``parity``) in the kernel's arithmetic: only nodes off the
    border move."""
    u = u.clone()
    nx, ny = u.shape
    i = torch.arange(1, nx - 1)[:, None]
    j = torch.arange(1, ny - 1)[None, :]
    red = (i + j + parity) % 2 == 0
    for _ in range(sweeps):
        masks = ([None] if method == "jacobi" else
                 [~red, red] if method == "rbgs_rev" else [red, ~red])
        for mask in masks:
            p = u[1:-1, 1:-1]
            new = _update(st, omega, method, p, f[1:-1, 1:-1], u[:-2, 1:-1],
                          u[2:, 1:-1], u[1:-1, :-2], u[1:-1, 2:])
            new = new if mask is None else torch.where(mask, new, p)
            u = u.clone()
            u[1:-1, 1:-1] = new
    return u


def _launch(st, u, f, *, method, sweeps, omega, tile, short):
    """One launch: every tile's window swept, the tile stored to out."""
    nx, ny = u.shape
    halo = ks.halo(sweeps, method) - short
    out = torch.full_like(u, float("nan"))
    for ti in range(math.ceil((nx - 2) / tile[0])):
        for tj in range(math.ceil((ny - 2) / tile[1])):
            ai, aj = 1 + ti * tile[0], 1 + tj * tile[1]
            bi, bj = min(ai + tile[0], nx - 1), min(aj + tile[1], ny - 1)
            wi0, wj0 = max(ai - halo, 0), max(aj - halo, 0)
            win = (slice(wi0, min(bi + halo, nx)),
                   slice(wj0, min(bj + halo, ny)))
            w = _whole_field(st, u[win], f[win], method=method,
                             sweeps=sweeps, omega=omega, parity=wi0 + wj0)
            (li, hi), (lj, hj) = (_tile_span(ti, tile[0], nx),
                                  _tile_span(tj, tile[1], ny))
            out[li:hi, lj:hj] = w[li - wi0:hi - wi0, lj - wj0:hj - wj0]
    return out


def _emulate(st, u, f, *, method, sweeps, omega, tile, short=0):
    """A call: its launches (plan_passes), each on the last one's output."""
    for k in ks.plan_passes(sweeps):
        u = _launch(st, u, f, method=method, sweeps=k, omega=omega,
                    tile=tile, short=short)
    return u


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("sweeps", [1, 2, 5])
@pytest.mark.parametrize("shape", [(23, 19), (9, 30), (3, 3)])
def test_window_schedule_equals_parity_twin(shape, sweeps, omega):
    st, u, f = _problem(shape)
    ref = ks.multisweep_parity_plain(st, u.clone(), f, sweeps=sweeps,
                                     omega=omega)
    assert torch.equal(_whole_field(st, u, f, method="rbgs", sweeps=sweeps,
                                    omega=omega), ref)
    for tile in TINY_TILES:
        got = _emulate(st, u, f, method="rbgs", sweeps=sweeps, omega=omega,
                       tile=tile)
        assert torch.equal(got, ref), (tile, (got - ref).abs().max())


@pytest.mark.parametrize("method,omega", METHODS)
def test_window_schedule_equals_whole_field_sweeps(method, omega):
    st, u, f = _problem((23, 19))
    ref = _whole_field(st, u, f, method=method, sweeps=3, omega=omega)
    plain = ks.multisweep_plain(st, u.clone(), f, method=method, sweeps=3,
                                omega=omega)
    assert (ref - plain).abs().max() <= 1e-5 * plain.abs().max()
    for tile in TINY_TILES:
        got = _emulate(st, u, f, method=method, sweeps=3, omega=omega,
                       tile=tile)
        assert torch.equal(got, ref), (tile, (got - ref).abs().max())


@pytest.mark.parametrize("method,omega", METHODS)
def test_window_schedule_fails_with_a_halo_one_short(method, omega):
    st, u, f = _problem((23, 19))
    ref = _whole_field(st, u, f, method=method, sweeps=2, omega=omega)
    got = _emulate(st, u, f, method=method, sweeps=2, omega=omega,
                   tile=TINY_TILES[0], short=1)
    assert not torch.equal(got, ref)


@pytest.mark.parametrize("omega", [1.0, 1.3])
def test_window_schedule_at_the_main_paths_levels(omega):
    """The kernel's own tiles on the main path's levels, whose sizes no tile
    divides, red then black, 2 sweeps: bit for bit the parity twin."""
    for n in (1025, 513, 257):
        st, u, f = _problem((n, n))
        ref = ks.multisweep_parity_plain(st, u.clone(), f, sweeps=2,
                                         omega=omega)
        got = _emulate(st, u, f, method="rbgs", sweeps=2, omega=omega,
                       tile=ks.tile(n, n))
        assert torch.equal(got, ref), (n, (got - ref).abs().max())


@pytest.mark.parametrize("tile", ks.TILES)
@pytest.mark.parametrize("method,omega", METHODS)
def test_window_schedule_at_the_kernels_tiles(method, omega, tile):
    st, u, f = _problem((70, 133))  # no tile divides either axis
    ref = _whole_field(st, u, f, method=method, sweeps=2, omega=omega)
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
    """The tiles are the ones csrc/smooth.cu compiles (from
    csrc/smooth_tiles.cuh), each level takes the largest whose grid holds
    MIN_BLOCKS blocks, a 2-sweep call is one launch, and every window fits
    shared memory."""
    assert '#include "smooth_tiles.cuh"' in (CSRC / "smooth.cu").read_text()
    tiles, consts = _source_geometry()
    assert tiles == ks.TILES and consts["kNumTiles"] == len(tiles)
    assert (consts["kMinBlocks"], consts["kThreads"], consts["kMaxSweeps"]) \
        == (ks.MIN_BLOCKS, ks.THREADS, ks.MAX_SWEEPS)
    assert ks.geometry(1025, 1025) == (*ks.tile(1025, 1025), ks.THREADS,
                                       ks.MAX_SWEEPS, ks.MIN_BLOCKS,
                                       len(ks.TILES))
    assert sorted(tiles, reverse=True) == list(tiles)
    assert [len(ks.plan_passes(s)) for s in (0, 1, 2, 4, 5, 32)] == \
        [0, 1, 1, 1, 2, 8]
    for nx, ny in ((1025, 1025), (513, 513), (257, 257), (129, 65), (3, 3)):
        t = ks.tile(nx, ny)
        blocks = [math.ceil((nx - 2) / a) * math.ceil((ny - 2) / b)
                  for a, b in tiles]
        k = tiles.index(t)
        assert k == len(tiles) - 1 or blocks[k] >= ks.MIN_BLOCKS
        assert all(n < ks.MIN_BLOCKS for n in blocks[:k])
    for t in tiles:
        assert t[1] % 2 == 0
        for method, arrays in (("rbgs", 2), ("jacobi", 3)):
            h = ks.halo(ks.MAX_SWEEPS, method)
            assert arrays * 4 * (t[0] + 2 * h) * (t[1] + 2 * h) <= 232448


def test_multisweep_on_cpu_runs_the_twin_in_place():
    st, u, f = _problem((13, 21))
    ref = ks.multisweep_plain(st, u.clone(), f, sweeps=2)
    before = ks.multisweep.launches
    got = ks.multisweep(st, u, f, sweeps=2)
    assert got is u and torch.equal(got, ref)
    assert ks.multisweep.launches == before
