"""Kernel M's probe (``csrc/probes.cu``), its tile schedule emulated on the
CPU against its plain twin.

The probe runs kernel A's scheme: a block owns a tile of the interior (with
the ring next to it at the field's edge), loads a window of u and f, runs
every colour phase of a launch of up to kMaxSweeps sweeps in it and stores
its tile. A mode reads at distance r along an axis (roll and concat 1 along
both, sub 2 along rows, lane 2 along columns, none 0), so the window takes
a halo along it and updates a node only if it is at least r nodes inside
the window (and, along an axis the mode does not read, an unknown of the
field), and where the window reaches
the field's edge takes the ring and, for sub and lane, the far ring's line
beyond it (the wrapped reads of rows -1 and nx, or columns -1 and ny).
The halo is the least that is exact: P = 2 * sweeps nodes at r = 1, and
P + 1 at r = 2, where the node two away has the phase's own colour and was
last written two phases before, so a stale border does not travel 2P.
Every new value of a phase is computed from the window before any is
stored, as the kernel does for sub and lane (roll, concat and none read
only the other colour and each node's own value, so their one barrier a
phase gives the same).

The emulation repeats every block's window, phases and store with numpy
float32 operations in the kernel's order, at tiny tiles and at the
kernel's own (``tile_of`` on the field, read from smooth_tiles.cuh), and
must equal ``probe_plain`` bit for bit; with a halo one node short along a
read axis it must not.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking import (
    kernel_microbench as kb,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    smooth as ksmooth,
)

CSRC = Path(T.__file__).parent / "csrc"
M_SRC = (CSRC / "probes.cu").read_text()
TILES_SRC = (CSRC / "smooth_tiles.cuh").read_text()
SMEM_PER_SM = 232448
# reach_i, reach_j of csrc/probes.cu
REACH = {"roll": (1, 1), "sub": (2, 0), "lane": (0, 2), "none": (0, 0),
         "concat": (1, 1)}


def _tiles():
    body = re.search(r"constexpr Tile kTiles\[\] = \{(.*?)\};", TILES_SRC,
                     re.S).group(1)
    return [(int(a), int(b)) for a, b in re.findall(r"\{(\d+), (\d+)\}",
                                                    body)]


def _max_sweeps():
    return int(re.search(r"constexpr int kMaxSweeps = (\d+);",
                         TILES_SRC).group(1))


def halo_of(r, sweeps):
    return 2 * sweeps + 1 if r == 2 else 2 * sweeps * r


def window_lo(a, h, ghost):
    lo = a - h
    return lo if lo > (1 if h == 0 else 0) else (-1 if ghost else 0)


def window_hi(b, h, n, ghost):
    hi = b + h
    return hi if hi < (n - 1 if h == 0 else n) else (n + 1 if ghost else n)


def tile_span(t, tile, n):
    lo = 0 if t == 0 else 1 + t * tile
    hi = min(1 + (t + 1) * tile, n - 1)
    return lo, (n if hi == n - 1 else hi)


def nbsum(w, mode, i0, i1, j0, j1):
    """The mode's neighbour sum over window rows i0:i1, columns j0:j1, in
    the kernel's order."""
    c = w[i0:i1, j0:j1]
    if mode == "none":
        return np.float32(4.0) * c
    if mode == "sub":
        parts = (w[i0 - 1:i1 - 1, j0:j1], w[i0 + 1:i1 + 1, j0:j1],
                 w[i0 - 2:i1 - 2, j0:j1], w[i0 + 2:i1 + 2, j0:j1])
    elif mode == "lane":
        parts = (w[i0:i1, j0 - 1:j1 - 1], w[i0:i1, j0 + 1:j1 + 1],
                 w[i0:i1, j0 - 2:j1 - 2], w[i0:i1, j0 + 2:j1 + 2])
    else:
        parts = (w[i0 - 1:i1 - 1, j0:j1], w[i0 + 1:i1 + 1, j0:j1],
                 w[i0:i1, j0 - 1:j1 - 1], w[i0:i1, j0 + 1:j1 + 1])
    return ((parts[0] + parts[1]) + parts[2]) + parts[3]


def emulate(u, f, mode, sweeps, tile, short=0):
    """One launch of the probe over every block: a new field. ``short``:
    nodes taken off the halo along each read axis."""
    nx, ny = u.shape
    ri, rj = REACH[mode]
    hi_ = max(halo_of(ri, sweeps) - short * (ri > 0), 0)
    hj_ = max(halo_of(rj, sweeps) - short * (rj > 0), 0)
    out = np.full_like(u, np.nan)
    for by in range(-(-(nx - 2) // tile[0])):
        for bx in range(-(-(ny - 2) // tile[1])):
            ai, aj = 1 + by * tile[0], 1 + bx * tile[1]
            bi, bj = min(ai + tile[0], nx - 1), min(aj + tile[1], ny - 1)
            wi0, wj0 = window_lo(ai, hi_, ri == 2), window_lo(aj, hj_, rj == 2)
            wx = window_hi(bi, hi_, nx, ri == 2) - wi0
            wy = window_hi(bj, hj_, ny, rj == 2) - wj0
            gi = np.arange(wi0, wi0 + wx)
            gj = np.arange(wj0, wj0 + wy)
            rows, cols = gi % nx, gj % ny  # a ghost line wraps
            w = u[np.ix_(rows, cols)].copy()
            fw = f[np.ix_(rows, cols)]
            i0, i1, j0, j1 = ri, wx - ri, rj, wy - rj
            GI, GJ = np.meshgrid(gi[i0:i1], gj[j0:j1], indexing="ij")
            # the kernel's rule: along a read axis the window's border is
            # the ring (and a ghost line), so only along an axis the mode
            # does not read are the field's bounds tested; a ring node
            # updated would break the comparison with the twin
            update = np.ones(GI.shape, bool)
            if ri == 0:
                update &= (GI >= 1) & (GI <= nx - 2)
            if rj == 0:
                update &= (GJ >= 1) & (GJ <= ny - 2)
            for ph in range(2 * sweeps):
                colour = update & (((GI + GJ) & 1) == (ph & 1))
                new = (fw[i0:i1, j0:j1] + nbsum(w, mode, i0, i1, j0, j1)) \
                    * np.float32(0.25)
                w[i0:i1, j0:j1] = np.where(colour, new, w[i0:i1, j0:j1])
            li0, li1 = tile_span(by, tile[0], nx)
            lj0, lj1 = tile_span(bx, tile[1], ny)
            out[li0:li1, lj0:lj1] = w[li0 - wi0:li1 - wi0, lj0 - wj0:lj1 - wj0]
    return out


def emulate_call(u, f, mode, sweeps, tile, short=0):
    for k in ksmooth.plan_passes(sweeps):
        u = emulate(u, f, mode, k, tile, short)
    return u


def fields(shape, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)  # the ring too
    f = rng.standard_normal(shape).astype(np.float32)
    return u, f


def plain(u, f, mode, sweeps):
    return kb.probe_plain(torch.from_numpy(u), torch.from_numpy(f),
                          mode=mode, sweeps=sweeps).numpy()


def kernel_tile(nx, ny):
    tiles = _tiles()
    for t in tiles[:-1]:
        if -(-(nx - 2) // t[0]) * -(-(ny - 2) // t[1]) >= 128:
            return t
    return tiles[-1]


@pytest.mark.parametrize("mode", kb.MODES)
@pytest.mark.parametrize("sweeps", [1, 2, 3, 5])
@pytest.mark.parametrize("shape", [(9, 13), (21, 18), (5, 5), (3, 7)])
def test_probe_schedule_tiny_tiles(mode, sweeps, shape):
    """(4, 6) tiles: many blocks, windows clamped at both edges, ghost
    lines; 5 sweeps run as two launches."""
    u, f = fields(shape, sum(shape) + sweeps)
    got = emulate_call(u, f, mode, sweeps, (4, 6))
    assert np.array_equal(got, plain(u, f, mode, sweeps), equal_nan=False)


@pytest.mark.parametrize("mode", ["roll", "sub", "lane", "none"])
@pytest.mark.parametrize("shape,sweeps", [((513, 513), 2), ((1000, 771), 3),
                                          ((1025, 1025), 2)])
def test_probe_schedule_kernel_tiles(mode, shape, sweeps):
    """The kernel's own tiles: 32 x 64 at 513^2, 64 x 64 at 1025^2, and an
    odd-sided field whose tiles do not divide it."""
    u, f = fields(shape, 7)
    tile = kernel_tile(*shape)
    assert tile == ksmooth.tile(*shape)
    got = emulate_call(u, f, mode, sweeps, tile)
    assert np.array_equal(got, plain(u, f, mode, sweeps))


@pytest.mark.parametrize("sweeps", [1, 2, 4])
@pytest.mark.parametrize("mode", ["roll", "sub", "lane"])
def test_probe_schedule_fails_with_a_short_halo(mode, sweeps):
    u, f = fields((41, 43), 3 + sweeps)
    got = emulate_call(u, f, mode, sweeps, (4, 6), short=1)
    assert not np.array_equal(got, plain(u, f, mode, sweeps))


def test_probe_source_geometry():
    """The source's reach per mode, halo, ghost lines and window spans are
    the emulation's, and every launch's windows fit shared memory."""
    assert "return mode == kSub ? 2 : (mode == kLane || mode == kNone ? 0 : 1);" \
        in M_SRC
    assert "return mode == kLane ? 2 : (mode == kSub || mode == kNone ? 0 : 1);" \
        in M_SRC
    assert "constexpr int hi = halo_of(ri, kSweeps), hj = halo_of(rj, " \
        "kSweeps);" in M_SRC
    assert "return r == 2 ? 2 * sweeps + 1 : 2 * sweeps * r;" in M_SRC
    assert "constexpr bool kGhostI = ri == 2, kGhostJ = rj == 2;" in M_SRC
    assert "return lo > (h ? 0 : 1) ? lo : (ghost ? -1 : 0);" in M_SRC
    assert "return hi < (h ? n : n - 1) ? hi : (ghost ? n + 1 : n);" in M_SRC
    assert "if constexpr (kGhostI || kGhostJ) __syncthreads();" in M_SRC
    assert "(ri == 0 && (gi < 1 || gi > nx - 2)) ||" in M_SRC
    assert "(rj == 0 && (gj < 1 || gj > ny - 2)))" in M_SRC
    assert kb.MODES == ("roll", "sub", "lane", "none", "concat")
    assert "enum Mode : int { kRoll = 0, kSub = 1, kLane = 2, kNone = 3, " \
        "kConcat = 4 };" in M_SRC
    for tx, ty in _tiles():
        for sweeps in range(1, _max_sweeps() + 1):
            for ri, rj in REACH.values():
                hi, hj = halo_of(ri, sweeps), halo_of(rj, sweeps)
                span = (tx + 2 * max(hi, 1)) * (ty + 2 * max(hj, 1))
                assert (ty + 2 * max(hj, 1)) % 2 == 0  # two halves a row
                assert 2 * span * 4 <= SMEM_PER_SM
