"""Kernels F's and G's schedules, emulated on the CPU, against the plain twins.

``csrc/transfer3d.cu`` runs F as a plane stream: each block owns a coarse
(J, K) tile and a chunk of coarse planes [I0, I1), holds u over the tile's
fine residual window plus a one-node halo, and f over the residual window,
in rings of fine x-planes, and a pair of fine residual planes. Step I
computes residual planes 2I and 2I+1 (a chunk's lead-in step I0 - 1 plane
2I0 - 1 alone) and, after a barrier, sums each coarse node of plane I from
residual planes 2I-1 .. 2I+1; u plane 2I-1 and residual plane 2I-1 are the
values the previous step read (threads carry them in registers); the loads
of step I + ahead are issued at step I. G streams fine row pairs: a thread
takes one k of fine rows 2J and 2J+1 over a few coarse x-steps, loads its
u values first, forms the y-z interpolants of each coarse plane there once
and adds the one of plane I (fine plane 2I) or the mean of those of I and
I+1 (fine plane 2I + 1).

The emulation below repeats those schedules with torch ops on the window
planes: the same tile geometry, window origin and halo, ring slots (a plane
load lands in its slot as soon as it is issued: the worst case for the
rings' size), carried planes, lead-in, chunks and shell stores, at tiny
tiles so that tiles do not divide the interior, and at the kernel's own
tile, read from the source; and G's blocks, threads and steps. Every
node is the twin's arithmetic in the twin's order, so the emulation must
equal ``residual_restrict3d_plain`` and ``prolong_correct3d_plain`` bit for
bit, and must fail when a ring or the halo is one plane or one node short.

On bf16 storage F's rows come in as aligned 16-byte chunks and are widened
as pairs of 4-byte words read at a word offset taken from each row's
address; the tests at the end copy each block's chunks from the field's
16-bit elements, widen its pairs (the thread of each pair, the extra pairs
past the block's threads) with the word-pair emulation of
``test_torch_smooth3d_schedule.py``, and hold the widened u and f planes to
the zero-filled windows of the fp32 path.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (
    stencil3d,
    transfer3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    transfer3d as kx3,
)
from test_torch_smooth3d_schedule import (
    GARBAGE,
    _c_int,
    bf16_field,
    bf_pairs,
    natural,
    widen_plane,
)

SOURCE = Path(T.__file__).parent / "csrc" / "transfer3d.cu"
SHAPES = [(5, 5, 5), (9, 17, 13), (17, 9, 21)]
RAGGED = [(37, 69, 131), (17, 129, 65)]  # tiles and chunks do not divide
TINY_TILE = (2, 4)


def _source_consts():
    """csrc/transfer3d.cu's integer constants, evaluated in order."""
    consts = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) =\s*([^;]+);",
                                 SOURCE.read_text(), re.M):
        consts[name] = _c_int(expr, consts)
    return consts


def _geometry():
    """F's tile, ahead count and rings; G's block, as compiled."""
    c = _source_consts()
    return dict(tile=(c["kRrTileJ"], c["kRrTileK"]), ahead=c["kRrAhead"],
                rings=(c["kRrRingU"], c["kRrRingF"], c["kRrRingR"]),
                pc_block=(c["kPcThreads"], c["kPcSteps"]))


def _rings(ahead):
    """The rings the schedule needs: u planes 2I .. 2I+2 and f planes 2I,
    2I+1 read at step I, the 2 * ahead planes of each in flight, and the
    residual planes 2I, 2I+1 written and restricted at step I (u plane 2I-1
    and residual plane 2I-1 are carried from the previous step)."""
    return 2 * ahead + 3, 2 * ahead + 2, 2


def _fields(shape):
    rng = np.random.default_rng(sum(shape))
    u = rng.standard_normal(shape).astype(np.float32)  # a non-zero shell too
    f = 1e3 * rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(u), torch.from_numpy(f)


def _stencil(shape):
    return stencil3d.make_stencil3d(T.Grid3D(*shape, (0.0, 1.3, 0.0, 0.7,
                                                      0.0, 1.1)))


def _window(field, q, j0, k0, rows, cols):
    """Plane q of ``field`` over rows j0.. and columns k0.., zero outside."""
    _, ny, nz = field.shape
    w = torch.zeros((rows, cols), dtype=field.dtype)
    j1, k1 = min(j0 + rows, ny), min(k0 + cols, nz)
    w[:j1 - j0, :k1 - k0] = field[q, j0:j1, k0:k1]
    return w


def _tile_span(t, tile, n):
    lo, hi = (0 if t == 0 else 1 + t * tile), min(1 + (t + 1) * tile, n - 1)
    return lo, (n if hi == n - 1 else hi)


def _residual(st, west, centre, east, fw, zplane):
    """f - A u over the window's inner nodes (border zero), the twin's
    order; the z neighbours from ``zplane`` (the centre plane as it stands
    in its ring slot now; ``centre`` may be the copy a previous step
    read)."""
    c = centre[1:-1, 1:-1]
    nb = (st.w * west[1:-1, 1:-1] + st.e * east[1:-1, 1:-1]
          + st.s * centre[:-2, 1:-1] + st.n * centre[2:, 1:-1]
          + st.b * zplane[1:-1, :-2] + st.t * zplane[1:-1, 2:])
    r = torch.zeros_like(centre)
    r[1:-1, 1:-1] = fw[1:-1, 1:-1] - (st.c * c - nb)
    return r


def _emulate_f(st, u, f, *, tile, ahead, rings, chunk, halo=1):
    """One launch of F: fc from the plane stream of every tile and chunk."""
    _, nyf, nzf = u.shape
    ncx, ncy, ncz = kx3.coarse_shape3d(*u.shape)
    tj, tk = tile
    rows, cols = 2 * tj + 3, 2 * tk + 3  # the window of a one-node halo
    pad = 1 - halo                       # nodes a shorter halo leaves out
    nu, nf, nr = rings
    fc = torch.full((ncx, ncy, ncz), float("nan"))
    for I0 in range(1, ncx - 1, chunk):
        I1 = min(I0 + chunk, ncx - 1)
        for bj in range(-(-(ncy - 2) // tj)):
            for bk in range(-(-(ncz - 2) // tk)):
                J0, K0 = 1 + bj * tj, 1 + bk * tk
                fj0, fk0 = 2 * J0 - 2, 2 * K0 - 2
                jlo, jhi = _tile_span(bj, tj, ncy)
                klo, khi = _tile_span(bk, tk, ncz)
                uring, fring, rring = [None] * nu, [None] * nf, [None] * nr

                def load_u(q):
                    w = torch.zeros((rows, cols))
                    w[pad:rows - pad, pad:cols - pad] = _window(
                        u, q, fj0 + pad, fk0 + pad, rows - 2 * pad,
                        cols - 2 * pad)
                    uring[q % nu] = w

                def load_f(q):
                    w = torch.zeros((rows, cols))
                    w[1:-1, 1:-1] = _window(f, q, fj0 + 1, fk0 + 1, rows - 2,
                                            cols - 2)
                    fring[q % nf] = w

                def issue(I):
                    if I < I1:
                        load_u(2 * I + 1)
                        load_u(2 * I + 2)
                        load_f(2 * I)
                        load_f(2 * I + 1)

                def zero_span(I, whole):
                    j = torch.arange(jlo, jhi)[:, None]
                    k = torch.arange(klo, khi)[None, :]
                    shell = ((j == 0) | (j == ncy - 1) | (k == 0)
                             | (k == ncz - 1))
                    fc[I, jlo:jhi, klo:khi][shell | whole] = 0.0

                if I0 == 1:
                    zero_span(0, True)
                load_u(2 * I0 - 2)
                for d in range(ahead):
                    issue(I0 - 1 + d)
                for I in range(I0 - 1, I1):
                    issue(I + ahead)  # lands at once: the worst case
                    u1, u2 = uring[2 * I % nu], uring[(2 * I + 1) % nu]
                    u3 = uring[(2 * I + 2) % nu]
                    if I >= I0:  # u planes 2I-1, 2I as last step read
                        rring[2 * I % nr] = _residual(
                            st, carry_a, carry_b, u2, fring[2 * I % nf], u1)
                    rring[(2 * I + 1) % nr] = _residual(
                        st, u1 if I < I0 else carry_b, u2, u3,
                        fring[(2 * I + 1) % nf], u2)
                    carry_a, carry_b = u2.clone(), u3.clone()
                    r1, r2 = rring[2 * I % nr], rring[(2 * I + 1) % nr]
                    if I < I0:
                        carry_r = r2.clone()
                        continue
                    planes = [carry_r, r1, r2]
                    carry_r = r2.clone()
                    acc = None
                    for wgt, (dx, dy, dz) in transfer3d.RESTRICT_TERMS:
                        win = planes[dx + 1][2 + dy:2 + dy + 2 * tj:2,
                                             2 + dz:2 + dz + 2 * tk:2]
                        term = wgt * win
                        acc = term if acc is None else acc + term
                    nj, nk = min(tj, ncy - 1 - J0), min(tk, ncz - 1 - K0)
                    fc[I, J0:J0 + nj, K0:K0 + nk] = (acc / 64.0)[:nj, :nk]
                    if jlo == 0 or jhi == ncy or klo == 0 or khi == ncz:
                        zero_span(I, False)
                if I1 == ncx - 1:
                    zero_span(ncx - 1, True)
    return fc


def _along_z(rows, k):
    """Coarse rows interpolated along z at fine columns k."""
    q = k >> 1
    nxt = (q + 1).clamp(max=rows.shape[1] - 1)
    return torch.where(k % 2 == 1, 0.5 * (rows[:, q] + rows[:, nxt]),
                       rows[:, q])


def _emulate_g(ec, u, *, block, x_order=True):
    """One launch of G: the grid's blocks (k range, coarse row J, group of
    coarse x-steps; all J at once), each thread's k, fine rows 2J and 2J+1
    and steps, its u loads first; ``x_order=False`` takes plane 2I+1 from
    Pyz(I) alone."""
    _, nyf, nzf = u.shape
    threads, steps = block
    n_steps = (u.shape[0] - 1) // 2
    out = u.clone()
    seen = torch.zeros(u.shape, dtype=torch.int64)
    even, odd = slice(2, nyf - 2, 2), slice(1, nyf - 1, 2)  # rows 2J, 2J+1
    for bx in range(-(-(nzf - 2) // threads)):
        k = torch.arange(1 + bx * threads, 1 + (bx + 1) * threads)
        k = k[k <= nzf - 2]
        for I0 in range(0, n_steps, steps):
            mine = range(I0, min(I0 + steps, n_steps))
            v = {i: out[i][:, k].clone() for I in mine
                 for i in (2 * I, 2 * I + 1)}

            def pyz(I):  # at rows 2J and 2J + 1: z first, then y
                e = _along_z(ec[I, :-1], k)
                return e, 0.5 * (e + _along_z(ec[I, 1:], k))

            e0, o0 = pyz(I0)
            for I in mine:
                e1, o1 = pyz(I + 1)
                for i, e, o in ((2 * I, e0, o0),
                                (2 * I + 1, 0.5 * (e0 + e1) if x_order
                                 else e0, 0.5 * (o0 + o1) if x_order
                                 else o0)):
                    if i == 0:
                        continue
                    out[i, even][:, k] = v[i][even] + e[1:]
                    out[i, odd][:, k] = v[i][odd] + o
                    seen[i, 1:-1][:, k] += 1
                e0, o0 = e1, o1
    inner = torch.zeros_like(seen)
    inner[1:-1, 1:-1, 1:-1] = 1
    assert torch.equal(seen, inner)  # every interior node once, no shell
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_f_schedule_equals_twin(shape):
    st = _stencil(shape)
    u, f = _fields(shape)
    ref = kx3.residual_restrict3d_plain(st, u, f)
    planes = kx3.coarse_shape3d(*shape)[0] - 2
    for chunk in sorted({planes, 2, 1}):  # one chunk; chunks with lead-ins
        for ahead in (1, 2):
            got = _emulate_f(st, u, f, tile=TINY_TILE, ahead=ahead,
                             rings=_rings(ahead), chunk=chunk)
            assert torch.equal(got, ref), (chunk, ahead)


@pytest.mark.parametrize("shape", RAGGED)
def test_f_schedule_at_the_kernels_geometry(shape):
    g = _geometry()
    st = _stencil(shape)
    u, f = _fields(shape)
    ref = kx3.residual_restrict3d_plain(st, u, f)
    for chunk in (kx3.coarse_shape3d(*shape)[0] - 2, 3):
        got = _emulate_f(st, u, f, tile=g["tile"], ahead=g["ahead"],
                         rings=g["rings"], chunk=chunk)
        assert torch.equal(got, ref), chunk


@pytest.mark.parametrize("short", ["u ring", "f ring", "residual ring",
                                   "halo"])
def test_f_schedule_fails_one_short(short):
    """The check has teeth: a ring one plane short, or a halo one node
    short, gives another fc."""
    shape = (13, 17, 21)
    st = _stencil(shape)
    u, f = _fields(shape)
    ref = kx3.residual_restrict3d_plain(st, u, f)
    ahead = 2
    rings = list(_rings(ahead))
    kw = dict(tile=TINY_TILE, ahead=ahead, chunk=4)
    if short == "halo":
        got = _emulate_f(st, u, f, rings=tuple(rings), halo=0, **kw)
    else:
        rings[["u ring", "f ring", "residual ring"].index(short)] -= 1
        got = _emulate_f(st, u, f, rings=tuple(rings), **kw)
    assert not torch.equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES + RAGGED)
def test_g_row_pairs_equal_twin(shape):
    nc = kx3.coarse_shape3d(*shape)
    rng = np.random.default_rng(len(shape) + sum(shape))
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ec = torch.from_numpy(rng.standard_normal(nc).astype(np.float32))
    ref = kx3.prolong_correct3d_plain(ec, u.clone())
    # (4, 3): k blocks and step groups that do not divide the grid
    for block in (_geometry()["pc_block"], (4, 3)):
        assert torch.equal(_emulate_g(ec, u, block=block), ref), block
    # plane 2I+1 from one coarse plane alone is another field
    assert not torch.equal(_emulate_g(ec, u, block=(4, 3), x_order=False),
                           ref)


def test_geometry_is_the_kernel_sources():
    """The emulation's rings are the ones csrc/transfer3d.cu compiles, and
    they fit the blocks per multiprocessor it launches with."""
    c = _source_consts()
    g = _geometry()
    assert g["rings"] == _rings(g["ahead"])
    words = (2 * g["tile"][0] + 3) * 2 * (g["tile"][1] + 2)
    assert sum(g["rings"]) * words * 4 * c["kRrBlocksPerSM"] <= 227 * 1024
    # the residual rows 1 .. 2 * kRrTileJ + 1 split into kRrStrips strips
    # of at most kRrStripRows rows (residual_restrict3d_kernel's `top`, `n`)
    rows, strips = 2 * g["tile"][0] + 1, c["kRrStrips"]
    tops = [1 + s * rows // strips for s in range(strips)]
    ns = [1 + (s + 1) * rows // strips - tops[s] for s in range(strips)]
    assert [t + n for t, n in zip(tops, ns)] == tops[1:] + [rows + 1]
    assert max(ns) == -(-rows // strips)
    # a thread to each strip of the 2 * kRrTileK + 1 residual columns, and
    # one to each coarse node of the tile
    assert strips * (2 * g["tile"][1] + 1) <= c["kRrThreads"]
    assert g["tile"][0] * g["tile"][1] <= c["kRrThreads"]


# ---------------------------------------------------------------------------
# bf16 planes as word pairs (csrc/common.cuh) in kernel F.


def _f_plane_pairs(c, fj0, fk0, nyf, nzf):
    """Every pair of a block's u planes and f planes, as F's threads take
    them: pair tid of each plane, and the extra pair xt of plane kind xk
    (0, 1: a step's u planes, 2, 3: its f planes); per kind, (g, fl) with
    the staging word of a pair's row (kRrStageRow words a row) and bit 31
    set for an odd m."""
    tid = np.arange(c["kRrThreads"])
    half, pr = c["kRrHalf"], c["kRrPairRow"]

    def pair(t, f_plane, pairs):
        r = t // pr
        lj = r + f_plane
        g, fl = bf_pairs(t, t < pairs, lj, fj0 + lj, fk0, nyf, nzf, half, pr)
        m = t % pr
        stage = r * c["kRrStageRow"] + 2 * m
        fl = np.where(fl != 0, (fl & ((1 << 20) - 1)) | stage << 20
                      | (m & 1) << 31, 0)
        return g, fl

    eu, ef = c["kRrExtraU"], c["kRrExtraF"]
    xk = np.full_like(tid, -1)
    xt = np.zeros_like(tid)
    lo = tid < 2 * eu
    xk[lo], xt[lo] = tid[lo] // eu, c["kRrThreads"] + tid[lo] % eu
    hi = ~lo & (tid < 2 * (eu + ef))
    xk[hi] = 2 + (tid[hi] - 2 * eu) // ef
    xt[hi] = c["kRrThreads"] + (tid[hi] - 2 * eu) % ef
    pairs_of = np.where(xk < 0, 0, np.where(xk < 2, c["kRrPairsU"],
                                            c["kRrPairsF"]))
    xg, xfl = pair(xt, xk >= 2, pairs_of)
    out = {}
    for kind in range(4):
        f_plane = kind >= 2
        pairs = c["kRrPairsF"] if f_plane else c["kRrPairsU"]
        g, fl = pair(tid, f_plane, pairs)
        mine = xk == kind
        taken = np.concatenate([tid[tid < pairs], xt[mine]])
        assert sorted(taken.tolist()) == list(range(pairs))  # each once
        out[kind] = (np.concatenate([g, xg[mine]]),
                     np.concatenate([fl, xfl[mine]]))
    return out


def _f_chunks(c, field, q, fj0, fk0, f_plane, stage_words):
    """The 16-byte chunks of plane q of a block's u rows (f_plane False)
    or f rows, as bf_chunk_issue copies them: the staged words (GARBAGE
    where nothing was copied) and every element read. A chunk that may
    reach outside the tensor (its end flag) goes word by word."""
    nx, ny, nz = field.shape
    n, sx = field.numel(), ny * nz
    el = field.contiguous().view(torch.int16).numpy().view(np.uint16)
    el = el.reshape(-1).astype(np.uint32)
    real = (field.data_ptr() >> 1) & 7
    rows = c["kRrResRows"] if f_plane else c["kRrRows"]
    stage = np.full(stage_words, GARBAGE, np.uint32)
    reads = []
    for t in range(rows * c["kRrChunkRow"]):
        r, k = divmod(t, c["kRrChunkRow"])
        j = fj0 + r + f_plane
        if j >= ny:
            continue
        g = j * nz + fk0
        end = g + 8 * k < 7 or g + 8 * k + 8 > sx
        row = q * sx + g  # element of the row's column 0
        start = row - ((real + row) & 7) + 8 * k  # its 16-byte chunk k
        for w in range(4):
            e, dst = start + 2 * w, r * c["kRrStageRow"] + 4 * k + w
            if not end or (0 <= e and e + 1 < n):
                reads += [e, e + 1]
                stage[dst] = el[min(max(e, 0), n - 1)] | el[
                    min(max(e + 1, 0), n - 1)] << 16
            elif e == -1:
                stage[dst] = (stage[dst] & 0xFFFF) | el[0] << 16
                reads.append(0)
            elif e == n - 1:
                stage[dst] = (stage[dst] & 0xFFFF0000) | el[e]
                reads.append(e)
    return stage, reads


def _f_plane_check(u, f, parity=None):
    """Every block's u and f planes through F's chunks and word pairs;
    True when each equals the zero-filled window of the fp32 path (u over
    the whole window, f over the residual window) and no word is read
    outside its tensor. ``parity`` replaces the low bit of the address the
    kernel reads a row's parity from (the teeth test)."""
    c = _source_consts()
    nxf, nyf, nzf = u.shape
    ncy, ncz = (nyf - 1) // 2 + 1, (nzf - 1) // 2 + 1
    rows, cols = c["kRrRows"], c["kRrCols"]
    ok = True
    for bj in range(-(-(ncy - 2) // c["kRrTileJ"])):
        for bk in range(-(-(ncz - 2) // c["kRrTileK"])):
            fj0 = 2 * (1 + bj * c["kRrTileJ"]) - 2
            fk0 = 2 * (1 + bk * c["kRrTileK"]) - 2
            plan = _f_plane_pairs(c, fj0, fk0, nyf, nzf)
            rings = [np.zeros(c["kRrPlane"], np.uint32) for _ in range(2)]
            for q in range(nxf):
                for kind, field in ((q % 2, u), (2 + q % 2, f)):
                    g, fl = plan[kind]
                    f_plane = kind >= 2
                    stage, reads = _f_chunks(
                        c, field, q, fj0, fk0, f_plane,
                        (c["kRrResRows"] if f_plane else rows)
                        * c["kRrStageRow"])
                    ok &= all(0 <= e < field.numel() for e in reads)
                    p8 = ((field.data_ptr() >> 1) + q * nyf * nzf) & 7
                    if parity is not None:
                        p8 ^= 1
                    off = (((p8 + g) & 7) ^ (((fl >> 31) & 1) << 2)) >> 1
                    ring = rings[f_plane]  # u's, f's: zeroed once
                    widen_plane(ring, stage, g, fl, p8 & 1, c["kRrHalf"],
                                off)
                    ring = natural(ring.view(np.float32), c["kRrHalf"], rows,
                                   cols)
                    ref = _window(field.float(), q, fj0, fk0, rows, cols)
                    if f_plane:  # the residual window, rows and columns 1..
                        ring, ref = ring[1:-1, 1:-1], ref[1:-1, 1:-1]
                    ok &= ring.tobytes() == ref.numpy().tobytes()
    return ok


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(3, 37, 131), (3, 19, 70)])
def test_f_bf16_word_pairs_are_the_zero_filled_windows(shape, offset):
    """F's bf16 u and f planes as 16-byte chunks widened as word pairs, nz
    odd (every shape F takes) and even (the plan alone), views at storage
    offsets 0 and 1 (u and f opposite), tiles that do not divide the grid:
    each block's widened planes are the fp32 path's zero-filled windows bit
    for bit, every pair taken by one thread, and no word read outside the
    tensor."""
    u = bf16_field(shape, offset, 3 + offset)
    f = bf16_field(shape, 1 - offset, 5 + offset)
    assert _f_plane_check(u, f)


def test_f_bf16_word_pairs_fail_with_the_wrong_row_shift():
    """The check has teeth: a row's parity from the wrong address gives
    other planes."""
    u, f = bf16_field((3, 37, 131), 1, 3), bf16_field((3, 37, 131), 1, 5)
    assert not _f_plane_check(u, f, parity=True)


def test_f_bf16_staging_fits_the_blocks_per_multiprocessor():
    """F's rings and bf16 staging rings fit kRrBlocksPerSM blocks in 227 KB,
    a row's pairs fit its 16-byte chunks, a thread takes at most one chunk
    of a plane, and the pairs past a block's threads fit its threads once
    more."""
    c = _source_consts()
    assert c["kRrBytes"] == (c["kRrRingU"] + c["kRrRingF"]
                             + c["kRrRingR"]) * c["kRrPlane"] * 4
    assert c["kRrStageBytes"] == 4 * c["kRrStageRow"] * (
        c["kRrStageU"] * c["kRrRows"] + c["kRrStageF"] * c["kRrResRows"])
    # a row's pairs, up to 3 words into its first chunk, fit its chunks
    assert 3 + 2 * c["kRrPairRow"] <= c["kRrStageRow"]
    assert max(c["kRrChunksU"], c["kRrChunksF"]) <= c["kRrThreads"]
    assert (c["kRrBytes"] + c["kRrStageBytes"]) * c["kRrBlocksPerSM"] \
        <= 227 * 1024
    assert (c["kRrPairRow"] - 1) * 4 + 2 >= c["kRrCols"] - 1  # cover a row
    assert 0 <= 2 * (c["kRrExtraU"] + c["kRrExtraF"]) <= c["kRrThreads"]
    assert c["kRrStageU"] == 2 * c["kRrStageAhead"] + 1
