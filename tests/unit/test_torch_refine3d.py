"""Kernel N (``csrc/refine3d.cu``), the float64 outer step of ``ir_solve3d``,
on the CPU: its plain twin against the plain step, its gate, and its
schedule emulated against the twin.

- ``ir_solve3d`` through N's route (the gate forced open, so the wrapper
  runs the twin on CPU tensors: the start, then one call a step, the
  iterate ping-ponging between two buffers) equals the plain step it
  replaced (repeated here) bit for bit: iterate, history and info, at 17^3
  and 33^3, fp32 and bf16 level 0, zero and non-zero ``u0`` with Dirichlet
  shell values; ``u0`` is never written. So do the gate-closed route (the
  twin updating one iterate in place) and, in fp32, the masked step under
  an identity hook.
- ``dispatch.refine3d_ok`` admits a constant-coefficient 7-point
  all-Dirichlet fp32 or bf16 level 0 with contiguous fp64 CUDA fields and
  refuses everything else; a hooked solve never asks for N.
- The emulation repeats the kernel's schedule with numpy on each block's
  window: its tiles (read from the source), the halo and the shell nodes
  each tile writes, the ring of plane slots with loads that land only when
  the kernel waits for them (a slot is unreadable from the moment a load is
  issued into it), the x-chunks and the shell blocks, e as the aligned
  4-byte words that hold it (bf16 at storage offsets 0 and 1), and the
  norms' two-level sums (a warp's shuffle tree, then the last block's).
  Every node of u_out and r_lo is written once and equals the twin bit for
  bit; the norms differ from the twin's ``torch.sum`` in the order of
  summation only (1e-13 relative). The emulation fails with the ring one
  slot short or the halo one column short.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc3d
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (
    dispatch,
    norms,
    stencil3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    refine3d as kr3,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (
    multigrid as mgs,
    multigrid3d as mg3,
)

SOURCE = Path(T.__file__).parent / "csrc" / "refine3d.cu"
MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
NORM_RTOL = 1e-13  # the norms' sums differ from torch.sum in order only
PERIODIC = bc3d.mixed3d(west="periodic", east="periodic")


def _consts():
    """csrc/refine3d.cu's integer constants, evaluated in order."""
    names = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) =\s*([^;]+);",
                                 SOURCE.read_text(), re.M):
        names[name] = eval(" ".join(expr.split()).replace("/", "//"), {},
                           dict(names))
    return names


C = _consts()


def _field(shape, seed, scale=1.0):
    return torch.from_numpy(scale * np.random.default_rng(seed)
                            .standard_normal(shape))


def _inputs(shape, seed, lo=torch.float32, domain=None):
    """(fp64 stencil, h, u_in with a non-zero shell, e of the level's dtype
    non-zero on the shell too, f)."""
    g = T.Grid3D(*shape, domain) if domain else T.Grid3D(*shape)
    st = stencil3d.make_stencil3d(g, dtype=lo).astype(torch.float64)
    u = _field(shape, seed)
    e = _field(shape, seed + 1, 1e-3).to(lo)
    f = _field(shape, seed + 2, st.c)
    return st, (g.hx, g.hy, g.hz), u, e, f


# ---------------------------------------------------------------------------
# the twin against the plain step of ir_solve3d


def _problem(n, lo, shell):
    prob = T.poisson3d_mms_sinsinsin(n)
    cfg = T.MultigridConfig(**MAIN)
    levels = T.build_hierarchy3d(prob.grid, prob.spec, dtype=lo, cfg=cfg,
                                 device="cpu")
    f = prob.rhs(torch.float64, "cpu")
    u0 = torch.zeros_like(f)
    if shell:  # Dirichlet values on the shell, a guess inside
        u0[:] = _field(f.shape, 5, 0.1)
        u0[1:-1, 1:-1, 1:-1] = _field(tuple(n - 2 for n in f.shape), 6,
                                      0.01)
    return levels, f, u0, cfg


def _plain_step_solve(levels, f, u0, cfg, inner_cycles=2, max_outer=100):
    """The plain float64 step ``ir_solve3d`` ran on a box before N: the
    iterate a copy of ``u0`` updated in place on the interior, the fp64
    residual kept and cast to level 0's dtype for the cycles."""
    lev0 = levels[0]
    g, unknown = lev0.grid, lev0.unknown
    h = (g.hx, g.hy, g.hz)
    st_hi = lev0.stencil.astype(torch.float64)
    u = u0.to(dtype=torch.float64, copy=True)
    fnorm = norms.masked_scaled_l2(f, unknown, *h)
    state = {"r": stencil3d.residual(st_hi, u, f, unknown)}
    rnorm0 = norms.scaled_l2(state["r"], *h)
    tol_eff = mgs.tolerance(cfg, torch.maximum(fnorm, rnorm0))

    def step():
        e = lev0.zeros()
        r_lo = state["r"].to(lev0.dtype)
        for _ in range(inner_cycles):
            e = mg3.mg_cycle3d(levels, e, r_lo, cfg)
        u[1:-1, 1:-1, 1:-1] += e[1:-1, 1:-1, 1:-1]
        state["r"] = stencil3d.residual(st_hi, u, f, unknown)
        return norms.scaled_l2(state["r"], *h)

    info = mgs.outer_iterate(step, rnorm0, tol_eff, fnorm, max_outer)
    info["method"] = "iterative_refinement_3d"
    return u, info


def _assert_same_solve(got, ref):
    (u_n, info_n), (u_p, info_p) = got, ref
    assert torch.equal(u_n, u_p)
    assert info_n["iterations"] == info_p["iterations"] and \
        info_n["converged"]
    for key, value in info_p.items():
        if isinstance(value, np.ndarray):
            assert np.array_equal(info_n[key], value), key
        elif isinstance(value, float) and math.isnan(value):
            assert math.isnan(info_n[key]), key
        else:
            assert info_n[key] == value, key


@pytest.mark.parametrize("shell", [False, True])
@pytest.mark.parametrize("lo", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [17, 33])
def test_twin_route_equals_the_plain_step(monkeypatch, n, lo, shell):
    levels, f, u0, cfg = _problem(n, lo, shell)
    kept = u0.clone()
    u_p, info_p = _plain_step_solve(levels, f, u0, cfg)
    calls = []
    step = dispatch.refine_step3d

    def counted(*a, **k):
        calls.append(a[3] is None)
        return step(*a, **k)

    monkeypatch.setattr(dispatch, "refine3d_ok", lambda *a: True)
    monkeypatch.setattr(dispatch, "refine_step3d", counted)
    u_n, info_n = mg3.ir_solve3d(levels, f, u0, cfg, inner_cycles=2)
    assert calls == [True] + [False] * info_n["iterations"]
    assert torch.equal(u0, kept) and u_n is not u0
    _assert_same_solve((u_n, info_n), (u_p, info_p))


@pytest.mark.parametrize("shell", [False, True])
@pytest.mark.parametrize("lo", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [17, 33])
def test_gate_closed_route_equals_the_plain_step(n, lo, shell):
    """N's gate closed (CPU tensors), the box's step is N's twin updating
    one iterate in place: equal to the plain step bit for bit, ``u0``
    unwritten."""
    levels, f, u0, cfg = _problem(n, lo, shell)
    kept = u0.clone()
    ref = _plain_step_solve(levels, f, u0, cfg)
    u, info = mg3.ir_solve3d(levels, f, u0, cfg, inner_cycles=2)
    assert torch.equal(u0, kept) and u is not u0
    _assert_same_solve((u, info), ref)


@pytest.mark.parametrize("shell", [False, True])
@pytest.mark.parametrize("n", [17, 33])
def test_masked_step_under_a_hook_equals_the_plain_step(n, shell):
    """An identity array hook takes the masked step, which on a box equals
    the plain step bit for bit. fp32 only: under a hook the bf16 cycles
    restrict and prolong unfused, which rounds otherwise."""
    levels, f, u0, cfg = _problem(n, torch.float32, shell)
    kept = u0.clone()
    ref = _plain_step_solve(levels, f, u0, cfg)
    u, info = mg3.ir_solve3d(levels, f, u0, cfg, inner_cycles=2,
                             constrain=lambda x, lev: x)
    assert torch.equal(u0, kept) and u is not u0
    _assert_same_solve((u, info), ref)


def test_twin_route_without_a_step_returns_a_copy(monkeypatch):
    """A guess that already meets the tolerance: no step, and the caller's
    u0 comes back as a copy, as from the plain path."""
    levels, f, u0, cfg = _problem(9, torch.float32, False)
    monkeypatch.setattr(dispatch, "refine3d_ok", lambda *a: True)
    u, info = mg3.ir_solve3d(levels, torch.zeros_like(f), u0, cfg)
    assert info["iterations"] == 0 and u is not u0 and torch.equal(u, u0)


@pytest.mark.parametrize("lo", [torch.float32, torch.bfloat16])
def test_twin_modes(lo):
    """The step writes ``out`` (never u_in) and r_lo; the start gives the
    masked norm of f; each as the plain operations give them."""
    shape = (9, 10, 11)
    st, h, u, e, f = _inputs(shape, 1, lo)
    unknown = bc3d.unknown_mask3d(*shape)
    out, r_lo = torch.empty_like(u), torch.empty(shape, dtype=lo)
    u_in = u.clone()
    got = kr3.refine_step3d(st, u, e, f, h=h, out=out, r_lo=r_lo)
    assert got[0] is out and got[1] is r_lo and got[3] is None
    assert torch.equal(u, u_in)
    ref = u.clone()
    ref[1:-1, 1:-1, 1:-1] += e[1:-1, 1:-1, 1:-1]
    r = stencil3d.residual(st, ref, f, unknown)
    assert torch.equal(out, ref) and torch.equal(r_lo, r.to(lo))
    assert got[2].item() == math.sqrt(math.prod(h) * (r * r).sum().item())
    r_lo0 = torch.empty(shape, dtype=lo)
    u0, _, rnorm0, fnorm = kr3.refine_step3d(st, u, None, f, h=h, r_lo=r_lo0)
    r0 = stencil3d.residual(st, u, f, unknown)
    assert u0 is u and torch.equal(r_lo0, r0.to(lo))
    fm = torch.where(unknown, f, 0.0)
    assert fnorm.item() == math.sqrt(math.prod(h) * (fm * fm).sum().item())
    with pytest.raises(ValueError, match="r_lo"):
        kr3.refine_step3d(st, u, None, f, h=h)


def test_cpu_takes_no_scratch():
    """On the CPU the wrapper runs the twin, which needs no scratch."""
    st, h, u, e, f = _inputs((9, 9, 9), 3)
    assert kr3.new_scratch(u.shape, u.device) is None
    got = kr3.refine_step3d(st, u, e, f, h=h, scratch=None)
    assert torch.equal(got[0], kr3.refine_step3d_plain(st, u, e, f, h=h)[0])


def test_wrapper_refuses_other_stencils():
    g = T.Grid3D(9, 9, 9)
    u = torch.zeros(g.shape, dtype=torch.float64)
    a = torch.ones(g.shape)
    for st in (stencil3d.make_stencil3d(g, a=a),
               stencil3d.make_stencil3d(g, PERIODIC)):
        with pytest.raises(ValueError, match="7-point"):
            kr3.refine_step3d(st, u, u.float(), u, h=(1.0,) * 3)


# ---------------------------------------------------------------------------
# the gate


class _CudaLike:
    """A field as the gate sees it, without a card."""

    def __init__(self, dtype=torch.float64, contiguous=True):
        self.is_cuda, self.dtype, self._c = True, dtype, contiguous

    def is_contiguous(self):
        return self._c


def test_gate_admits_a_constant_dirichlet_box():
    cfg = T.MultigridConfig(**MAIN)
    for dtype in (torch.float32, torch.bfloat16):
        lev0 = T.build_hierarchy3d(T.Grid3D(9, 9, 9), dtype=dtype, cfg=cfg,
                                   device="cpu")[0]
        assert dispatch.refine3d_ok(lev0, cfg, _CudaLike(), _CudaLike())


def _refusals():
    g = T.Grid3D(9, 9, 9)
    cfg = T.MultigridConfig(**MAIN)
    a = 1.0 + torch.rand(g.shape, generator=torch.Generator().manual_seed(0))
    coef = T.build_hierarchy3d(g, a=a, cfg=cfg, device="cpu")[0]
    gal_cfg = T.MultigridConfig(**MAIN, coarsening="galerkin")
    galerkin = T.build_hierarchy3d(g, cfg=gal_cfg, device="cpu")[1]
    periodic = T.build_hierarchy3d(g, PERIODIC, cfg=cfg,
                                   device="cpu")[0]
    neumann = T.build_hierarchy3d(g, bc3d.mixed3d(west="neumann"), cfg=cfg,
                                  device="cpu")[0]
    fp64 = T.build_hierarchy3d(g, dtype=torch.float64, cfg=cfg,
                               device="cpu")[0]
    plain = T.build_hierarchy3d(g, cfg=cfg, device="cpu")[0]
    ok = (_CudaLike(), _CudaLike())
    return {
        "tensor stencil": (coef, cfg, ok),
        "galerkin": (galerkin, gal_cfg, ok),
        "periodic": (periodic, cfg, ok),
        "neumann": (neumann, cfg, ok),
        "backend torch": (plain, cfg.replace(backend="torch"), ok),
        "fp64 level 0": (fp64, cfg, ok),
        "cpu fields": (plain, cfg, (torch.zeros(g.shape,
                                                dtype=torch.float64),) * 2),
        "fp32 field": (plain, cfg, (_CudaLike(), _CudaLike(torch.float32))),
        "strided field": (plain, cfg, (_CudaLike(), _CudaLike(
            contiguous=False))),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_gate_refuses(case):
    lev0, cfg, fields = _refusals()[case]
    assert not dispatch.refine3d_ok(lev0, cfg, *fields)


def test_a_hooked_solve_never_asks_for_n(monkeypatch):
    """An array hook keeps the plain step even where the gate would admit
    the level."""
    levels, f, u0, cfg = _problem(9, torch.float32, False)
    ref = mg3.ir_solve3d(levels, f, u0, cfg, constrain=lambda x, lev: x)

    def refuse(*a, **k):
        raise AssertionError("N asked for under a hook")

    monkeypatch.setattr(dispatch, "refine3d_ok", lambda *a: True)
    monkeypatch.setattr(dispatch, "refine_step3d", refuse)
    got = mg3.ir_solve3d(levels, f, u0, cfg, constrain=lambda x, lev: x)
    assert torch.equal(got[0], ref[0]) and \
        got[1]["iterations"] == ref[1]["iterations"]


# ---------------------------------------------------------------------------
# the kernel's schedule, emulated


def plan(shape, sms):
    """(tiles along z, tiles along y, chunk, chunks): rf_plan."""
    nx, ny, nz = shape
    tz = -(-(nz - 2) // C["kRfTileZ"])
    ty = -(-(ny - 2) // C["kRfTileY"])
    planes = nx - 2
    fill = max(1, min(sms * C["kRfBlocksPerSM"] // (tz * ty),
                      planes // C["kRfMinChunk"]))
    chunk = min(-(-planes // fill), C["kRfMaxChunk"])
    return tz, ty, chunk, -(-planes // chunk)


def tile_span(t, tile, n):
    lo = 0 if t == 0 else 1 + t * tile
    hi = min(1 + (t + 1) * tile, n - 1)
    return lo, (n if hi == n - 1 else hi)


def _shfl_tree(v):
    """Each warp's __shfl_down_sync tree; v of whole warps."""
    v = v.copy()
    lane = np.arange(v.size) % 32
    for o in (16, 8, 4, 2, 1):
        src = np.where(lane + o < 32, np.arange(v.size) + o,
                       np.arange(v.size))
        v = v + v[src]
    return v


def block_sum(v):
    """block_sum: the warps' trees, then warp 0's over their sums."""
    warps = _shfl_tree(v)[::32]
    w0 = np.zeros(32)
    w0[:warps.size] = warps
    return _shfl_tree(w0)[0]


class Words:
    """e as the kernel reads it: the aligned 4-byte word holding element i
    of a field of ``n`` elements at storage offset ``off`` (16-bit
    elements for bf16), widened from the half its address selects."""

    def __init__(self, e, off):
        self.bf = e.dtype == torch.bfloat16
        self.n, self.off = e.numel(), off
        if self.bf:
            mem = np.zeros(off + self.n + 1, np.uint16)
            mem[off:off + self.n] = (e.reshape(-1).view(torch.int16)
                                     .numpy().view(np.uint16))
            self.mem = mem
        else:
            self.vals = e.reshape(-1).numpy()

    def word(self, i):
        if not self.bf:
            return self.vals[i].view(np.uint32).astype(np.int64)
        a = self.off + i
        w = a & ~1  # element address of the word's low half
        assert np.all(w >= self.off) and np.all(w + 1 < self.off + self.n), \
            "a word reaches outside the tensor"
        return (self.mem[w].astype(np.int64)
                | self.mem[w + 1].astype(np.int64) << 16)

    def value(self, w, i):
        assert np.all(w >= 0), "e read before it landed"
        if self.bf:
            hi = (self.off + i) & 1
            bits = np.where(hi == 1, w & 0xffff0000, (w << 16) & 0xffffffff)
        else:
            bits = w
        return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def emulate(st, u_in, e, f, h, lo, *, sms=132, e_off=0, slots=None,
            drop_right=False, shell_past_span=False):
    """N's launch on numpy copies of the fields; returns (u_out, r_lo,
    norms, writes of u_out, writes of r_lo). ``e`` None: the start."""
    nx, ny, nz = shape = tuple(u_in.shape)
    TY, TZ, A = C["kRfTileY"], C["kRfTileZ"], C["kRfAhead"]
    S = C["kRfSlots"] if slots is None else slots
    WZ, NT = C["kRfWinZ"], C["kRfThreads"]
    W = C["kRfWinY"] * WZ
    step = e is not None
    ui, fi = u_in.numpy().reshape(-1), f.numpy().reshape(-1)
    words = Words(e, e_off) if step else None
    sx = ny * nz
    u_out = np.full(ui.size, np.nan)
    r_lo = np.full(ui.size, np.nan)
    n_u, n_r = np.zeros(ui.size, int), np.zeros(ui.size, int)
    c = dict(zip("cwesnbt", st.coefs))
    tz, ty, chunk, chunks = plan(shape, sms)
    nb = tz * ty * (chunks + 1)
    partials = np.zeros(2 * nb)

    def put(idx, uval, rval):
        if step:
            u_out[idx] = uval
            n_u[idx] += 1
        r_lo[idx] = rval
        n_r[idx] += 1

    tid = np.arange(NT)
    for bz in range(chunks + 1):
        for by in range(ty):
            for bx in range(tz):
                bid = bx + tz * (by + ty * bz)
                acc_r, acc_f = np.zeros(NT), np.zeros(NT)
                if bz == chunks:  # the shell planes
                    jlo, jhi = tile_span(by, TY, ny)
                    klo, khi = tile_span(bx, TZ, nz)
                    j, k = np.mgrid[jlo:jhi, klo:khi]
                    for q in (0, nx - 1):
                        idx = (q * sx + j * nz + k).reshape(-1)
                        put(idx, ui[idx], 0.0)
                else:
                    _march(bx, by, bz, chunk, shape, st, c, ui, fi, words,
                           S, A, TY, TZ, WZ, W, NT, tid, put, acc_r, acc_f,
                           drop_right, shell_past_span)
                partials[bid] = block_sum(acc_r)
                partials[nb + bid] = block_sum(acc_f)
    h3 = math.prod(h)
    out = []
    for part in (partials[:nb], partials[nb:]):
        sums = np.zeros(NT)
        for i in range(nb):  # thread i % NT, in index order
            sums[i % NT] = sums[i % NT] + part[i]
        out.append(math.sqrt(h3 * block_sum(sums)))
    norms = out if not step else out[:1]
    u_res = torch.from_numpy(u_out.reshape(shape))
    r_res = torch.from_numpy(r_lo.reshape(shape)).to(torch.float32).to(lo)
    return u_res, r_res, norms, n_u.reshape(shape), n_r.reshape(shape)


def _march(bx, by, bz, chunk, shape, st, c, ui, fi, words, S, A, TY, TZ,
           WZ, W, NT, tid, put, acc_r, acc_f, drop_right, shell_past_span):
    nx, ny, nz = shape
    sx = ny * nz
    step = words is not None
    x0 = 1 + bz * chunk
    x1 = min(x0 + chunk, nx - 1)
    ylo, zlo = 1 + by * TY, 1 + bx * TZ
    yhi, zhi = min(ylo + TY, ny - 1), min(zlo + TZ, nz - 1)
    ly, lz = tid // TZ, tid % TZ
    own = (ylo + ly < yhi) & (zlo + lz < zhi)
    ow = (ly + 1) * WZ + lz + 1
    og = (ylo + ly) * nz + zlo + lz
    hy, hz = np.zeros(NT, int), np.zeros(NT, int)
    wy, wz = np.zeros(NT, int), np.zeros(NT, int)
    halo, shell = np.zeros(NT, bool), np.zeros(NT, bool)
    for t in range(NT):
        if t < TZ:
            hy[t], hz[t], wy[t], wz[t] = ylo - 1, zlo + t, 0, 1 + t
            halo[t], shell[t] = hz[t] < zhi, hy[t] == 0
        elif t < 2 * TZ:
            s = t - TZ
            hy[t], hz[t], wy[t], wz[t] = yhi, zlo + s, yhi - ylo + 1, 1 + s
            halo[t], shell[t] = hz[t] < zhi, hy[t] == ny - 1
        elif t < 2 * TZ + TY:
            s = t - 2 * TZ
            hy[t], hz[t], wy[t], wz[t] = ylo + s, zlo - 1, 1 + s, 0
            halo[t], shell[t] = hy[t] < yhi, hz[t] == 0
        elif t < 2 * TZ + 2 * TY:
            s = t - 2 * TZ - TY
            hy[t], hz[t] = ylo + s, zhi
            wy[t], wz[t] = 1 + s, zhi - zlo + 1
            halo[t], shell[t] = hy[t] < yhi and not drop_right, \
                hz[t] == nz - 1
        elif t < C["kRfHalo"]:
            s = t - 2 * TZ - 2 * TY
            hy[t] = yhi if s & 2 else ylo - 1
            hz[t] = zhi if s & 1 else zlo - 1
            wy[t] = yhi - ylo + 1 if s & 2 else 0
            wz[t] = zhi - zlo + 1 if s & 1 else 0
            shell[t] = hy[t] in (0, ny - 1) and hz[t] in (0, nz - 1)
            halo[t] = shell[t]
    if not shell_past_span:
        shell &= halo  # a row's or column's nodes past the tile's span
    inner = halo & ~shell
    hw, hg = wy * WZ + wz, hy * nz + hz
    su = np.full((S, W), np.nan)
    sf = np.full((S, NT), np.nan)
    se = np.full((S, W), -1, np.int64)
    pending = {}

    def issue(p):
        if p > x1:
            return
        s = p % S
        su[s], sf[s], se[s] = np.nan, np.nan, -1  # unreadable from now
        base = p * sx
        px = 1 <= p <= nx - 2
        loads = [(su, ow[own], ui[base + og[own]]),
                 (su, hw[halo], ui[base + hg[halo]])]
        if step and px:
            loads.append((se, ow[own], words.word(base + og[own])))
            loads.append((se, hw[inner], words.word(base + hg[inner])))
        if x0 <= p < x1:
            loads.append((sf, tid[own], fi[base + og[own]]))
        pending[p] = (s, loads)

    def land(p):
        for q in sorted(x for x in pending if x <= p):
            s, loads = pending.pop(q)
            for arr, where, vals in loads:
                arr[s, where] = vals

    for d in range(A):
        issue(x0 - 1 + d)
    uw = uc = np.zeros(NT)
    for p in range(x0 - 1, x1 + 1):
        land(p)
        issue(p + A)
        s = p % S
        bp = p * sx
        px = 1 <= p <= nx - 2
        up = np.where(own, su[s, ow], 0.0)
        if step and px:
            ev = words.value(se[s, ow[own]], bp + og[own])
            up[own] = up[own] + ev
            su[s, ow[own]] = up[own]
            hv = words.value(se[s, hw[inner]], bp + hg[inner])
            su[s, hw[inner]] = su[s, hw[inner]] + hv
        if p > x0:
            cpl = p - 1
            sc = cpl % S
            bc = cpl * sx
            o = ow[own]
            ns = c["w"] * uw[own]
            ns = ns + c["e"] * up[own]
            ns = ns + c["s"] * su[sc, o - WZ]
            ns = ns + c["n"] * su[sc, o + WZ]
            ns = ns + c["b"] * su[sc, o - 1]
            ns = ns + c["t"] * su[sc, o + 1]
            fv = sf[sc, tid[own]]
            r = fv - (c["c"] * uc[own] - ns)
            put(bc + og[own], uc[own], r)
            acc_r[own] = acc_r[own] + r * r
            if not step:
                acc_f[own] = acc_f[own] + fv * fv
            put(bc + hg[shell], su[sc, hw[shell]], 0.0)
        uw, uc = uc, up


def _twin(st, u, e, f, h, lo):
    r_lo = torch.empty(u.shape, dtype=lo)
    out = kr3.refine_step3d_plain(st, u, e, f, h=h, r_lo=r_lo)
    return out


def _check(got, ref, step):
    u_out, r_lo, norms, n_u, n_r = got
    assert (n_r == 1).all(), "r_lo written other than once"
    assert torch.equal(r_lo, ref[1])
    if step:
        assert (n_u == 1).all(), "u_out written other than once"
        assert torch.equal(u_out, ref[0])
    want = [ref[2].item()] + ([] if step else [ref[3].item()])
    np.testing.assert_allclose(norms, want, rtol=NORM_RTOL, atol=0)


# (33, 65, 17): three x-chunks, eight tile rows; (12, 11, 41): z tiles of
# 32 and 7, a ragged tile row; (3, 3, 3): one plane, one node
SCHEDULE_SHAPES = [(17, 17, 17), (33, 65, 17), (12, 11, 41), (3, 3, 3),
                   (5, 40, 5)]


@pytest.mark.parametrize("mode", ["step", "start"])
@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_schedule_equals_twin(shape, mode):
    st, h, u, e, f = _inputs(shape, 11, domain=(0.0, 1.3, 0.0, 0.7, 0.0,
                                                 1.1))
    e = e if mode == "step" else None
    got = emulate(st, u, e, f, h, torch.float32)
    _check(got, _twin(st, u, e, f, h, torch.float32), mode == "step")


@pytest.mark.parametrize("sms", [1, 16])
def test_schedule_chunks_equal_twin(sms):
    """Fewer multiprocessors: other chunk lengths, more chunks a tile."""
    shape = (70, 19, 37)
    st, h, u, e, f = _inputs(shape, 12)
    assert plan(shape, sms)[3] > 1
    _check(emulate(st, u, e, f, h, torch.float32, sms=sms),
           _twin(st, u, e, f, h, torch.float32), True)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(9, 10, 11), (17, 33, 35)])
def test_schedule_bf16_words_equal_twin(shape, offset):
    """bf16 e (odd rows, so a row starts in either half of a word) read as
    aligned words at storage offsets 0 and 1."""
    st, h, u, e, f = _inputs(shape, 13, torch.bfloat16)
    got = emulate(st, u, e, f, h, torch.bfloat16, e_off=offset)
    _check(got, _twin(st, u, e, f, h, torch.bfloat16), True)


@pytest.mark.parametrize("fault", ["ring one slot short",
                                   "halo one column short"])
def test_schedule_fails_when_cut_short(fault):
    shape = (17, 17, 37)
    st, h, u, e, f = _inputs(shape, 14)
    kw = ({"slots": C["kRfSlots"] - 1} if fault.startswith("ring")
          else {"drop_right": True})
    got = emulate(st, u, e, f, h, torch.float32, **kw)
    ref = _twin(st, u, e, f, h, torch.float32)
    assert not torch.equal(got[1], ref[1])


def test_schedule_fails_with_shell_writes_past_the_span():
    """A halo row's threads past a ragged tile's last column (nz - 2 not a
    multiple of the tile) must not write the shell: their offsets run into
    the next row."""
    shape = (9, 9, 17)
    st, h, u, e, f = _inputs(shape, 15)
    got = emulate(st, u, e, f, h, torch.float32, shell_past_span=True)
    assert (got[4] > 1).any()


def test_plan_fills_the_card_at_513():
    """The cell's level: 16 x 64 tiles, chunks of kRfMaxChunk planes."""
    tz, ty, chunk, chunks = plan((513,) * 3, 132)
    assert (tz, ty, chunk) == (16, 64, C["kRfMaxChunk"])
    assert chunks == -(-511 // chunk)
    assert tz * ty * chunks >= 132 * C["kRfBlocksPerSM"]
