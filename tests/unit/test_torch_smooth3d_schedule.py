"""Kernel E's schedule, emulated on the CPU, against the plain twin.

``csrc/smooth3d.cu`` runs S <= 2 RB-GS sweeps per launch as a plane
wavefront: each block owns a (j, k) tile, holds it with a halo of H = 2S
nodes in a ring of x-planes, and at step s runs phase p = 1 .. 2S on plane
s - p, a (j, k) column taking phases 1 .. min(d, 2S) where d is its distance
to the window's edge; x-chunks march from 2S planes before their first plane
to 2S planes after their last, holding the end planes fixed; the output is a
separate field. The emulation below repeats that schedule with torch ops on
the window planes: the same tile geometry, ring slots (a plane load lands in
its slot as soon as the fastest thread can have issued it, one step early:
the worst case for the rings' size),
column parity, phase ranges, lead-in and lead-out, and stores (a plane's
tile in the step after it is finished), at tiny tiles
so that tiles do not divide the interior. The halves of a block run their
columns' phase chains one after the other, as warps may, since the kernel
has no barrier between phases. Every node is the twin's arithmetic, so the
emulation must equal ``rbgs3d_plain`` bit for bit.

On bf16 storage a plane comes in as pairs of 4-byte words (``csrc/common.cuh``,
``bf_pair``, ``bf_pair_issue``, ``bf_pair_widen``): the emulation below
builds each block's pairs, reads the words a pair's copies read from the
field's 16-bit elements (the row's shift taken from the element address,
the view's storage offset included), widens and masks them as the kernel
does, and must give the zero-filled fp32 window plane the kernel's fp32 path
loads. ``test_torch_transfer3d_schedule.py`` uses it for kernel F.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import stencil3d
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    smooth3d as ks3,
)

SOURCE = Path(T.__file__).parent / "csrc" / "smooth3d.cu"
COMMON = Path(T.__file__).parent / "csrc" / "common.cuh"
SHAPES = [(5, 5, 5), (9, 33, 17), (17, 17, 17)]
TINY_TILE = (4, 8)


def _fields(shape, scale):
    rng = np.random.default_rng(sum(shape))
    u = rng.standard_normal(shape).astype(np.float32)  # a non-zero shell too
    f = np.zeros(shape, np.float32)
    f[1:-1, 1:-1, 1:-1] = scale * rng.standard_normal(
        tuple(n - 2 for n in shape))
    return torch.from_numpy(u), torch.from_numpy(f)


def _stencil(shape):
    return stencil3d.make_stencil3d(T.Grid3D(*shape, (0.0, 1.3, 0.0, 0.7,
                                                      0.0, 1.1)))


def _window(field, q, jw0, kw0, rj, rk):
    """Plane q of ``field`` over the window, zero outside the field."""
    _, ny, nz = field.shape
    w = torch.zeros((rj, rk), dtype=field.dtype)
    j0, j1 = max(jw0, 0), min(jw0 + rj, ny)
    k0, k1 = max(kw0, 0), min(kw0 + rk, nz)
    w[j0 - jw0:j1 - jw0, k0 - kw0:k1 - kw0] = field[q, j0:j1, k0:k1]
    return w


def _tile_span(t, tile, n):
    lo, hi = (0 if t == 0 else 1 + t * tile), min(1 + (t + 1) * tile, n - 1)
    return lo, (n if hi == n - 1 else hi)


def _wave_pass(st, src, f, sweeps, omega, c0, tile, chunk):
    """One launch of the wave kernel: ``sweeps`` sweeps of src -> out."""
    nx, ny, nz = src.shape
    h = 2 * sweeps
    rj, rk = tile[0] + 2 * h, tile[1] + 2 * h
    nu, nf = ks3.ring_planes(sweeps)
    lj, lk = torch.arange(rj)[:, None], torch.arange(rk)[None, :]
    dist = torch.minimum(torch.minimum(lj, rj - 1 - lj),
                         torch.minimum(lk, rk - 1 - lk))
    halves = (lj % 2 == 1, lj % 2 == 0)
    out = torch.full_like(src, float("nan"))
    tiles_j, tiles_k = ks3.wave_tiles(src.shape, tile)
    for x0 in range(0, nx, chunk):
        x1 = min(x0 + chunk, nx)
        a, b = max(x0 - h, 0), min(x1 - 1 + h, nx - 1)
        for tj in range(tiles_j):
            for tk in range(tiles_k):
                jw0, kw0 = 1 + tj * tile[0] - h, 1 + tk * tile[1] - h
                j, k = jw0 + lj, kw0 + lk
                interior = (j >= 1) & (j <= ny - 2) & (k >= 1) & (k <= nz - 2)
                ring, fring = [None] * nu, [None] * nf

                def issue(q):
                    if q <= b:
                        ring[q % nu] = _window(src, q, jw0, kw0, rj, rk)
                        fring[q % nf] = _window(f, q, jw0, kw0, rj, rk)

                for d in range(ks3.WAVE_AHEAD):
                    issue(a + d)
                for s in range(a, x1 + h + 1):
                    issue(s + ks3.WAVE_AHEAD)
                    # the next step's load may land during this step
                    issue(s + 1 + ks3.WAVE_AHEAD)
                    q = s - h - 1  # finished in the previous step
                    if x0 <= q < x1:
                        jlo, jhi = _tile_span(tj, tile[0], ny)
                        klo, khi = _tile_span(tk, tile[1], nz)
                        out[q, jlo:jhi, klo:khi] = ring[q % nu][
                            jlo - jw0:jhi - jw0, klo - kw0:khi - kw0]
                    plo, phi = max(1, s - b + 1), min(h, s - a - 1)
                    if s == x1 + h:
                        continue
                    active = interior & ((c0 + 1 + s + j + k) % 2 == 0)
                    for half in halves:
                        for p in range(plo, phi + 1):
                            q = s - p
                            pl = ring[q % nu]
                            c = pl[1:-1, 1:-1]
                            nb = (st.w * ring[(q - 1) % nu][1:-1, 1:-1]
                                  + st.e * ring[(q + 1) % nu][1:-1, 1:-1]
                                  + st.s * pl[:-2, 1:-1] + st.n * pl[2:, 1:-1]
                                  + st.b * pl[1:-1, :-2] + st.t * pl[1:-1, 2:])
                            gs = (fring[q % nf][1:-1, 1:-1] + nb) / st.c
                            new = pl.clone()
                            new[1:-1, 1:-1] = c + omega * (gs - c)
                            mask = active & half & (dist >= p)
                            ring[q % nu] = torch.where(mask, new, pl)
    return out


def _emulate(st, u, f, *, sweeps, omega, reverse, tile, chunk):
    """A call of the wave kernel's passes (MAX_WAVE_SWEEPS per launch)."""
    full, rest = divmod(sweeps, ks3.MAX_WAVE_SWEEPS)
    src = u
    for n in [ks3.MAX_WAVE_SWEEPS] * full + ([rest] if rest else []):
        src = _wave_pass(st, src, f, n, omega, int(reverse), tile, chunk)
    return src


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_wave_schedule_equals_twin(shape, sweeps, omega, reverse):
    st = _stencil(shape)
    u, f = _fields(shape, st.c)
    ref = ks3.rbgs3d_plain(st, u.clone(), f, sweeps=sweeps, omega=omega,
                           reverse=reverse)
    for chunk in (shape[0], 3):  # one chunk; chunks with lead-in and -out
        got = _emulate(st, u, f, sweeps=sweeps, omega=omega, reverse=reverse,
                       tile=TINY_TILE, chunk=chunk)
        assert torch.equal(got, ref), (chunk, (got - ref).abs().max())


@pytest.mark.parametrize("sweeps", [2, 3])
def test_wave_schedule_at_the_kernels_tile(sweeps):
    shape = (19, 37, 70)  # 2 x 2 tiles of 32 x 64, neither divides
    st = _stencil(shape)
    u, f = _fields(shape, st.c)
    ref = ks3.rbgs3d_plain(st, u.clone(), f, sweeps=sweeps, omega=1.3)
    got = _emulate(st, u, f, sweeps=sweeps, omega=1.3, reverse=False,
                   tile=ks3.WAVE_TILE, chunk=8)
    assert torch.equal(got, ref)


def test_rbgs3d_on_cpu_returns_a_new_tensor_and_leaves_u():
    shape = (9, 33, 17)
    st = _stencil(shape)
    u, f = _fields(shape, st.c)
    u0 = u.clone()
    got = ks3.rbgs3d(st, u, f, sweeps=2, omega=1.3)
    assert got is not u and torch.equal(u, u0)
    assert torch.equal(got, ks3.rbgs3d_plain(st, u0, f, sweeps=2, omega=1.3))


def test_launch_plan_of_the_513_solve():
    """One launch per smoothing call of a 513^3 V(2,2) cycle: the wave
    kernel on the large levels, the one-block kernel from 17^3 down, the
    32-sweep coarsest solve included (17 per cycle, was 68 + 64)."""
    sizes = [513]
    while sizes[-1] > 3:
        sizes.append((sizes[-1] - 1) // 2 + 1)
    assert sizes[-1] == 3 and len(sizes) == 9
    calls = [((n,) * 3, 2) for n in sizes[:-1] for _ in ("pre", "post")]
    calls.append(((3,) * 3, 32))
    launches = [len(ks3.plan_passes(shape, sweeps)) for shape, sweeps in calls]
    assert launches == [1] * 17
    assert [ks3.one_block((n,) * 3) for n in sizes] == [False] * 5 + [True] * 4
    assert ks3.plan_passes((513,) * 3, 3) == [2, 1]
    assert ks3.plan_passes((513,) * 3, 0) == []
    # the wave kernel's grid on a 132-SM H100
    assert ks3.wave_tiles((513,) * 3) == (16, 8)
    assert ks3.chunk_planes((513,) * 3, 132) == 513      # 128 blocks
    assert ks3.chunk_planes((257,) * 3, 132) == 65       # 4 chunks x 32
    assert ks3.chunk_planes((33,) * 3, 132) == 9         # MIN_CHUNK_PLANES
    # the rings fit a block's 227 KB of shared memory (Wave<S>::BYTES)
    for s in (1, 2):
        rj, rk = (t + 4 * s for t in ks3.WAVE_TILE)
        assert sum(ks3.ring_planes(s)) * rj * rk * 4 <= 232448


@pytest.mark.parametrize("sweeps", [1, 2])
def test_geometry_is_the_kernel_sources(sweeps):
    """The geometry the emulation and the launch plan use is the one
    csrc/smooth3d.cu compiles: its constants and its ring sizes."""
    exprs = dict(re.findall(r"constexpr int (\w+) = ([^;]+);",
                            SOURCE.read_text()))
    names = ("kTileJ", "kTileK", "kMaxWaveSweeps", "kAhead",
             "kOneBlockMaxBytes")
    consts = {k: eval(exprs[k], {}) for k in names}
    ring = tuple(eval(exprs[k], {"S": sweeps, "kAhead": consts["kAhead"]})
                 for k in ("NU", "NF"))
    assert ks3.geometry(sweeps) == (*(consts[k] for k in names), *ring)
    assert sweeps <= ks3.MAX_WAVE_SWEEPS


# ---------------------------------------------------------------------------
# bf16 planes as word pairs (csrc/common.cuh), emulated with numpy.


def _c_int(expr, names):
    """A C integer constant expression of the kernel sources, evaluated."""
    expr = re.sub(r"\(int\)sizeof\((float|unsigned)\)", "4", " ".join(
        expr.split()))
    return eval(expr.replace("/", "//"), {}, dict(names))


def wave_consts(sweeps):
    """Wave<S>'s constants in csrc/smooth3d.cu, and the file's own."""
    text = SOURCE.read_text()
    names = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", text,
                                 re.M):
        names[name] = _c_int(expr, names)
    names["S"] = sweeps
    body = text[text.index("struct Wave {"):]
    body = body[:body.index("};")]
    for name, expr in re.findall(r"static constexpr int (\w+) =\s*([^;]+);",
                                 body):
        names[name] = _c_int(expr, names)
    return names


def pair_bits():
    """common.cuh's kPair* flag bits and kNoRow."""
    text = COMMON.read_text()
    bits = {k: int(v) for k, v in re.findall(r"kPair(\w+) = (\d+)", text)}
    bits["NoRow"] = _c_int(re.search(r"constexpr int kNoRow = ([^;]+);",
                                     text).group(1), {})
    return bits


def bf_pairs(t, valid, lj, j, k0, ny, nz, half, pr):
    """bf_pair for pair t (arrays): pair m = t % pr of window row lj (field
    row j), window column 0 at field column k0; ring and staging words as
    the kernels give them (lj * 2 * half + 2m, 2t)."""
    b = pair_bits()
    m = t % pr
    row = (j >= 0) & (j < ny) & valid
    sx = ny * nz

    def inside(c, word):
        return (k0 + c >= 0) & (k0 + c < nz) & (word >= 0) & (word < half)

    g = j * nz + k0 + 4 * m
    fl = (inside(4 * m, 2 * m) * b["E0"]
          | inside(4 * m + 2, 2 * m + 1) * b["E1"]
          | (2 * m + 1 < half) * b["WE"]
          | inside(4 * m + 1, 2 * m) * (b["A0"] | b["B1"])
          | inside(4 * m - 1, 2 * m - 1) * b["A1"]
          | inside(4 * m + 3, 2 * m + 1) * b["B0"]
          | ((g <= 0) | (g + 3 >= sx)) * b["End"])
    fl = fl | (lj * 2 * half + 2 * m) << 8 | (2 * t) << 20
    return np.where(row, g, b["NoRow"]), np.where(row, fl, 0)


def _byte_perm(x, s):
    """__byte_perm(x, 0, s) on uint32 arrays."""
    out = np.zeros_like(x)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        byte = np.where(sel < 4, (x >> (8 * (sel & 3))) & 0xFF, 0)
        out |= byte << (8 * i)
    return out


GARBAGE = np.uint32(0x7FC17FC1)  # a staging word no copy wrote (NaNs)


def pairs_plane(field, q, g, fl, stage_words, parity=None):
    """One plane q of a bf16 ``field`` through bf_pair_issue: the staging
    words (GARBAGE where nothing was copied) and every element read. Memory
    is read in aligned 4-byte words, as cp.async reads it: a copy of the
    word at element e fetches the aligned word that holds e. ``parity``
    replaces the address parity the kernel reads (the teeth test)."""
    b = pair_bits()
    nx, ny, nz = field.shape
    n, sx = field.numel(), ny * nz
    el = field.contiguous().view(torch.int16).numpy().view(np.uint16)
    el = el.reshape(-1).astype(np.uint32)
    real = (field.data_ptr() >> 1) & 1
    pq = ((real if parity is None else parity) + q * sx) & 1
    stage = np.full(stage_words, GARBAGE, np.uint32)
    reads = []
    live = g != b["NoRow"]
    e0 = q * sx + g - ((pq ^ g) & 1)
    so = (fl >> 20) & 0x7FF
    for i in np.flatnonzero(live):
        for w in (0, 1):
            e, dst = int(e0[i]) + 2 * w, int(so[i]) + w
            e -= (real + e) & 1  # the aligned word that holds element e
            if not fl[i] & b["End"]:  # a 4-byte copy, whatever e is
                reads += [e, e + 1]
                stage[dst] = el[min(max(e, 0), n - 1)] | el[
                    min(max(e + 1, 0), n - 1)] << 16
            elif 0 <= e and e + 1 < n:
                stage[dst] = el[e] | el[e + 1] << 16
                reads += [e, e + 1]
            elif e == -1:
                stage[dst] = (stage[dst] & 0xFFFF) | el[0] << 16
                reads.append(0)
            elif e == n - 1:
                stage[dst] = (stage[dst] & 0xFFFF0000) | el[e]
                reads.append(e)
    return stage, reads, pq


def widen_plane(ring, stage, g, fl, pq, half, off=0):
    """bf_pair_widen of every pair into fp32 ring plane ``ring`` (uint32
    words, updated in place): its even words in the window (0 outside the
    field) and its odd words in the field, none written twice; ``off``
    words past each pair's staging word."""
    b = pair_bits()
    sh = (pq ^ g) & 1
    so = ((fl >> 20) & 0x7FF) + off
    wx, wy = stage[so], stage[so + 1]
    se = (0x1044 + sh * 0x2200).astype(np.uint32)
    sod = (0x3244 - sh * 0x2200).astype(np.uint32)
    r = (fl >> 8) & 0xFFF
    even = (fl & b["WE"]) != 0  # one 8-byte store, 0 outside the field
    writes = ((even, r, np.where(fl & b["E0"], _byte_perm(wx, se), 0)),
              (even, r + 1, np.where(fl & b["E1"], _byte_perm(wy, se), 0)),
              (fl & (b["A0"] << sh), r + half - sh, _byte_perm(wx, sod)),
              (fl & (b["B0"] << sh), r + half + 1 - sh, _byte_perm(wy, sod)))
    at = np.concatenate([a[m != 0] for m, a, _ in writes])
    assert len(set(at.tolist())) == len(at)
    for mask, a, v in writes:
        ring[a[mask != 0]] = v[mask != 0]
    return ring


def natural(ring, half, rows, cols):
    """The (rows, cols) window of a ring plane in its split-half layout."""
    lj, lk = np.arange(rows)[:, None], np.arange(cols)[None, :]
    return ring[lj * 2 * half + (lk & 1) * half + (lk >> 1)]


def bf16_field(shape, offset, seed):
    """A bf16 field of ``shape`` (random in-field values, no NaN), a view
    at element ``offset`` of its storage."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    buf = torch.empty(a.numel() + offset, dtype=torch.bfloat16)
    v = buf[offset:].view(shape)
    v.copy_(a)
    return v


def _e_plane_check(field, sweeps, parity=None):
    """Every block's planes of ``field`` through E's word pairs, widened one
    after another into one ring plane zeroed once; returns True when each
    equals the zero-filled window (the fp32 path's) and no word was read
    outside the tensor."""
    c = wave_consts(sweeps)
    nx, ny, nz = field.shape
    ref32 = field.float()
    t = np.arange(c["kWaveThreads"])
    ok = True
    for bj in range(-(-(ny - 2) // c["kTileJ"])):
        for bk in range(-(-(nz - 2) // c["kTileK"])):
            jw0 = 1 + bj * c["kTileJ"] - c["H"]
            kw0 = 1 + bk * c["kTileK"] - c["H"]
            lj = t // c["PR"]
            g, fl = bf_pairs(t, t < c["PAIRS"], lj, jw0 + lj, kw0, ny, nz,
                             c["HP"], c["PR"])
            ring = np.zeros(c["PLANE"], np.uint32)  # zero_rings, once
            for q in range(nx):  # one ring slot for every plane
                stage, reads, pq = pairs_plane(field, q, g, fl, c["STAGE"],
                                               parity)
                ok &= all(0 <= e < field.numel() for e in reads)
                widen_plane(ring, stage, g, fl, pq, c["HP"])
                got = natural(ring.view(np.float32), c["HP"], c["RJ"],
                              c["RK"])
                want = _window(ref32, q, jw0, kw0, c["RJ"], c["RK"]).numpy()
                ok &= got.tobytes() == want.tobytes()
    return ok


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(3, 37, 70), (3, 37, 71), (2, 34, 131)])
@pytest.mark.parametrize("sweeps", [1, 2])
def test_bf16_word_pairs_are_the_zero_filled_window(shape, offset, sweeps):
    """E's bf16 planes as word pairs, nz even and odd, views at storage
    offsets 0 and 1, tiles that do not divide the grid: each block's
    widened plane is the fp32 path's zero-filled window bit for bit, and no
    word is read outside the tensor (the first and last words of the field
    by 2-byte loads)."""
    field = bf16_field(shape, offset, sum(shape) + offset)
    assert _e_plane_check(field, sweeps)


def test_bf16_word_pairs_fail_with_the_wrong_row_shift():
    """The check has teeth: the row shift taken from the wrong address
    parity gives another window."""
    field = bf16_field((3, 37, 71), 1, 7)
    wrong = ((field.data_ptr() >> 1) & 1) ^ 1
    assert not _e_plane_check(field, 2, parity=wrong)


@pytest.mark.parametrize("sweeps", [1, 2])
def test_bf16_staging_fits_a_block(sweeps):
    """The fp32 rings and a staging ring for each bf16 field fit a block's
    232,448 bytes (wave_bytes), and each thread takes one pair a plane."""
    c = wave_consts(sweeps)
    assert c["PAIRS"] <= c["kWaveThreads"]
    assert c["STAGE"] == 2 * c["RJ"] * c["PR"]
    assert (c["PR"] - 1) * 4 - 1 + 3 >= c["RK"] - 1  # the pairs cover a row
    assert c["BYTES"] + 2 * c["STAGE_BYTES"] <= 232448
    assert c["STAGE_BYTES"] == c["kAhead"] * c["STAGE"] * 4
