"""The bf16 window rows of kernel L, emulated on the CPU.

On bf16 storage ``csrc/smooth_parity.cu`` (L) brings each window row of u
and f in as the aligned 4-byte words that hold it
(``common.cuh`` ``load_windows``, ``load_word``): row li, whose first
element e sits at an element address of parity sh (the tensor's address,
storage offset included, plus e), comes in as the words from element e - sh, word w
holding columns 2w - sh and 2w + 1 - sh; a word across the tensor's first
or last element brings in only its half inside the tensor, and a block
whose words all lie in the tensor loads them with no edge test. Each word
is widened into its even column's place and its odd column's place of a
window that keeps even and odd columns apart (L's parity planes).

The emulation below repeats every block's loads from the field's 16-bit
elements, at the kernel's own tiles and at tiny ones, on fields with odd and
even ny, views at several storage offsets, tiles that do not divide the
interior and windows clamped at both edges. Widened, each block's window
must equal the fp32 window the fp32 path loads bit for bit, every word must
be aligned, no element outside the tensor may be read, and a wrong row
shift must break it. The geometry (tiles, sweeps, words a row) is read from
the sources, whose windows must fit shared memory.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T

CSRC = Path(T.__file__).parent / "csrc"
L_SRC = (CSRC / "smooth_parity.cu").read_text()
TILES_SRC = (CSRC / "smooth_tiles.cuh").read_text()
SMEM_PER_SM = 232448   # two blocks' shared memory on an H100 SM
SENTINEL = 0xDEADBEEF  # a word nothing wrote


def _consts(text, names):
    exprs = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))
    return {k: eval(exprs[k], {}) for k in names}


def _tiles(text):
    body = re.search(r"constexpr Tile kTiles\[\] = \{(.*?)\};", text,
                     re.S).group(1)
    return [(int(a), int(b)) for a, b in re.findall(r"\{(\d+), (\d+)\}",
                                                    body)]


L_MAX = _consts(TILES_SRC, ["kMaxSweeps"])["kMaxSweeps"]


def bf16_field(shape, offset, seed):
    """A bf16 field of ``shape`` (random values, no NaN), a view at element
    ``offset`` of its storage."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    buf = torch.empty(a.numel() + offset, dtype=torch.bfloat16)
    v = buf[offset:].view(shape)
    v.copy_(a)
    return v


class Field:
    """A bf16 field's 16-bit elements and address, and what was read."""

    def __init__(self, field, wrong=0):
        self.h = field.reshape(-1).view(torch.int16).numpy().view(np.uint16)
        self.n, (self.nx, self.ny) = field.numel(), field.shape
        self.ptr = field.data_ptr()
        self.wrong = wrong  # added to every row's shift
        self.ref = field.float().numpy().view(np.uint32)
        self.reads, self.misaligned = [], []

    def word(self, e, align=4):
        """load_word / stage_word: the word whose low half is element e
        (0 in a half outside the tensor)."""
        h, n = self.h, self.n
        if 0 <= e and e + 1 < n:
            self.misaligned += [e] if (self.ptr + 2 * e) % align else []
            self.reads += [e, e + 1]
            return int(h[e]) | int(h[e + 1]) << 16
        if e == -1:
            self.reads.append(0)
            return int(h[0]) << 16
        if e == n - 1:
            self.reads.append(n - 1)
            return int(h[n - 1])
        return 0

    def ok(self):
        return (not self.misaligned and 0 <= min(self.reads)
                and max(self.reads) < self.n)


def word_window(fd, wi0, wx, wj0, wy, words):
    """load_windows over a block's window rows, ``words`` words a row (WR):
    the (wx, wy) window as uint32 bit patterns (SENTINEL where nothing was
    written), each column written once. A block whose words all lie in the
    tensor loads every word of its rows with no edge test (its reads are
    recorded as they are), the others by load_word."""
    out = np.full((wx, wy), SENTINEL, np.uint32)
    pq = (fd.ptr >> 1) & 1
    edge = (wi0 * fd.ny + wj0 < 1
            or (wi0 + wx - 1) * fd.ny + wj0 + 2 * words > fd.n)
    for li in range(wx):
        e = (wi0 + li) * fd.ny + wj0
        sh = (pq + e + fd.wrong) & 1
        for w in range(words):
            x = e - sh + 2 * w
            if not edge:
                fd.reads += [x, x + 1]
            v = fd.word(x)
            r = ((v << 16 | v >> 16) & 0xFFFFFFFF) if sh else v
            for col, val in ((2 * w, r << 16 & 0xFFFFFFFF),
                             (2 * w + 1 - 2 * sh, r & 0xFFFF0000)):
                if 0 <= col < wy:
                    assert out[li, col] == SENTINEL
                    out[li, col] = val
    return out


def _blocks(nx, ny, tile, halo):
    for bi in range(-(-(nx - 2) // tile[0])):
        for bj in range(-(-(ny - 2) // tile[1])):
            ai, aj = 1 + bi * tile[0], 1 + bj * tile[1]
            wi0, wj0 = max(ai - halo, 0), max(aj - halo, 0)
            yield (wi0, min(min(ai + tile[0], nx - 1) + halo, nx) - wi0,
                   wj0, min(min(aj + tile[1], ny - 1) + halo, ny) - wj0)


def check_words(field, tile, halo, words, wrong=0):
    """Every block's window of ``field`` through load_word and widen_word:
    True when each equals the fp32 window bit for bit, every word is
    aligned and nothing is read outside the tensor. ``wrong``: added to
    every row's shift."""
    fd = Field(field, wrong)
    ok = True
    for wi0, wx, wj0, wy in _blocks(fd.nx, fd.ny, tile, halo):
        assert wx <= tile[0] + 2 * halo and 2 * words >= wy + 1
        got = word_window(fd, wi0, wx, wj0, wy, words)
        ok &= np.array_equal(got, fd.ref[wi0:wi0 + wx, wj0:wj0 + wy])
    return ok and fd.ok()


SHAPES = [(37, 70), (37, 71), (21, 133), (9, 6), (5, 9)]
OFFSETS = [0, 1, 3, 6]


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile,sweeps", [((4, 6), 1), ((4, 6), 2),
                                         ((64, 64), 2), ((8, 64), 4)])
def test_l_bf16_words_are_the_fp32_window(shape, offset, tile, sweeps):
    """L: each block's rows of u and f as words, widened into the parity
    planes, are the fp32 window (the even column of word w of row li goes
    to plane (li & 1, 0) at (li >> 1, w), its odd column to plane
    (li & 1, 1) at (li >> 1, w - sh): the fp32 path's places); words a row
    as the kernel's WR = PC + 1."""
    field = bf16_field(shape, offset, 2 * sum(shape) + offset)
    assert field.data_ptr() % 16 == 2 * offset  # a 16-byte aligned storage
    pc = tile[1] // 2 + 2 * sweeps
    assert check_words(field, tile, 2 * sweeps, pc + 1)


def test_bf16_words_fail_with_the_wrong_row_shift():
    """The check has teeth: a row shift one half-word off misaligns the
    words and gives another window."""
    field = bf16_field((37, 71), 1, 5)
    assert not check_words(field, (4, 6), 4, 3 + 2 * L_MAX + 1, wrong=1)


def test_bf16_loads_fit_shared_memory():
    """The source's geometry: L's bf16 launches hold the fp32 planes alone
    (their words go through registers), and L keeps two blocks per SM at
    every sweep count."""
    assert "WR = PC + 1;" in L_SRC
    assert re.search(r"__launch_bounds__\(kThreads, 2\)\s+parity_kernel",
                     L_SRC)
    assert "return 8 * plane_rows(tx, sweeps) * plane_rows(ty, sweeps) *" \
        in L_SRC
    for tx, ty in _tiles(TILES_SRC):
        for sweeps in range(1, L_MAX + 1):
            pr, pc = tx // 2 + 2 * sweeps, ty // 2 + 2 * sweeps
            assert 2 * 8 * pr * pc * 4 <= SMEM_PER_SM


# ---------------------------------------------------------------------------
# kernel A: the same words into A's window, which keeps each row's even and
# odd columns in two halves of HP words (row li at li * RS, odd = HP)

A_SRC = (CSRC / "smooth.cu").read_text()


def a_halo(sweeps, method):
    """halo_of in csrc/smooth.cu: 2 nodes a sweep for RB-GS, 1 for
    Jacobi."""
    return sweeps if method == "jacobi" else 2 * sweeps


def a_window(fd, wi0, wx, wj0, wy, words, rs, pl):
    """load_windows into A's flat window of ``pl`` floats (rows ``rs``
    apart, halves rs / 2 apart): the uint32 patterns, SENTINEL where
    nothing was written; every place is written at most once and lies in
    the window."""
    hp = rs // 2
    out = np.full(pl, SENTINEL, np.uint32)
    pq = (fd.ptr >> 1) & 1
    edge = (wi0 * fd.ny + wj0 < 1
            or (wi0 + wx - 1) * fd.ny + wj0 + 2 * words > fd.n)
    for li in range(wx):
        e = (wi0 + li) * fd.ny + wj0
        sh = (pq + e + fd.wrong) & 1
        for w in range(words):
            x = e - sh + 2 * w
            if not edge:
                fd.reads += [x, x + 1]
            v = fd.word(x)
            r = ((v << 16 | v >> 16) & 0xFFFFFFFF) if sh else v
            base = li * rs + w
            if 2 * w < wy:                          # column 2w
                assert out[base] == SENTINEL
                out[base] = r << 16 & 0xFFFFFFFF
            if 0 <= 2 * w + 1 - 2 * sh < wy:        # column 2w + 1 - 2sh
                at = base + hp - sh
                assert 0 <= at < pl and out[at] == SENTINEL
                out[at] = r & 0xFFFF0000
    return out


def check_a_words(field, tile, sweeps, method, wrong=0):
    """Every block's window of ``field`` through A's word loads, placed as
    A places it: True when each equals the fp32 window at A's places
    (``at(li, lj) = li * RS + (lj & 1) * HP + (lj >> 1)``) bit for bit,
    every word is aligned and nothing is read outside the tensor."""
    fd = Field(field, wrong)
    halo = a_halo(sweeps, method)
    rs = tile[1] + 2 * halo
    pl = (tile[0] + 2 * halo) * rs
    words = rs // 2 + 1  # WR = HP + 1
    ok = True
    for wi0, wx, wj0, wy in _blocks(fd.nx, fd.ny, tile, halo):
        got = a_window(fd, wi0, wx, wj0, wy, words, rs, pl)
        want = np.full(pl, SENTINEL, np.uint32)
        for li in range(wx):
            for lj in range(wy):
                want[li * rs + (lj & 1) * (rs // 2) + (lj >> 1)] = \
                    fd.ref[wi0 + li, wj0 + lj]
        ok &= np.array_equal(got, want)
    return ok and fd.ok()


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile,sweeps,method", [
    ((4, 6), 1, "rbgs"), ((4, 6), 3, "jacobi"), ((64, 64), 2, "rbgs"),
    ((32, 64), 4, "jacobi"), ((8, 64), 4, "rbgs")])
def test_a_bf16_words_are_the_fp32_window(shape, offset, tile, sweeps,
                                          method):
    """A: each block's rows of u and f as words, widened into A's halves,
    are the window the fp32 path's cp.async loads place, at A's tiles and
    tiny ones, RB-GS and Jacobi halos, views at storage offsets and windows
    clamped at both edges."""
    field = bf16_field(shape, offset, 3 * sum(shape) + offset)
    assert check_a_words(field, tile, sweeps, method)


def test_a_bf16_words_fail_with_the_wrong_row_shift():
    field = bf16_field((37, 71), 1, 7)
    assert not check_a_words(field, (4, 6), 2, "rbgs", wrong=1)


def test_a_bf16_loads_fit_shared_memory():
    """A's source loads bf16 rows by load_windows with WR = HP + 1 words a
    row into its own halves, and its windows (u, f and Jacobi's second
    buffer, fp32) fit one block's shared memory at every tile and sweep
    count."""
    assert "constexpr int K = kBu + kBf, WR = HP + 1;" in A_SRC
    assert "[&](int li) { return li * RS; }" in A_SRC
    assert "return jacobi ? sweeps : 2 * sweeps;" in A_SRC
    for tx, ty in _tiles(TILES_SRC):
        for sweeps in range(1, L_MAX + 1):
            for method, arrays in (("rbgs", 2), ("jacobi", 3)):
                h = a_halo(sweeps, method)
                assert arrays * (tx + 2 * h) * (ty + 2 * h) * 4 <= \
                    SMEM_PER_SM
