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
