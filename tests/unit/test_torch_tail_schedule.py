"""Kernel D's plan and walk, emulated on the CPU, against the plain twin.

``csrc/tail.cu`` walks a V-cycle tail in the shared memory of one CTA: u
and f of every level at the offsets and padded row strides of its
``plan``, the entry level loaded, the coarser ones zeroed; the levels of
more than WARP_MAX_NODES nodes walked by the block, the rest by its first
warp, the coarsest level's unknowns in lanes' registers when it has at most
32. A colour phase of the block gives each warp two neighbouring rows,
sixteen nodes of the colour in each; one of the warp gives each lane a
node. The emulation below lays the levels out in one flat buffer as the
plan says, updates in each colour phase exactly the nodes the
kernel's items cover, and logs which group walks each level. Every node is
the twin's arithmetic, so the emulation must equal ``tail_vcycle_plain`` bit
for bit; items one row short must break it, and a row stride one short must
put two lanes of a warp on one bank.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (
    dispatch,
    smooth as smooth_mod,
    stencil as st_mod,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    tail as kt,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels.transfer \
    import coarse_shape, prolong_correct_plain, residual_restrict_plain

SOURCE = Path(T.__file__).parent / "csrc" / "tail.cu"
ENTRIES = [(129, 129), (129, 65), (65, 129), (97, 49), (17, 17), (9, 9),
           (3, 3)]
KWS = {"rbgs": dict(method="rbgs", omega=1.0, symmetric=False),
       "symmetric": dict(method="rbgs", omega=1.0, symmetric=True),
       "sor": dict(method="sor", omega=1.3, symmetric=False),
       "jacobi": dict(method="jacobi", omega=0.8, symmetric=False)}


def _chain(entry):
    """Every level shape of the hierarchy below ``entry``."""
    shapes = [tuple(entry)]
    while T.Grid(*shapes[-1]).can_coarsen():
        shapes.append(coarse_shape(*shapes[-1]))
    return shapes


def _hierarchy(entry, levels=None):
    shapes = _chain(entry)[:levels]
    sts = [st_mod.make_stencil(T.Grid(nx, ny, (0.0, 1.3, 0.0, 0.7)))
           for nx, ny in shapes]
    rng = np.random.default_rng(sum(entry))
    u = np.zeros(entry, np.float32)
    u[1:-1, 1:-1] = rng.standard_normal((entry[0] - 2, entry[1] - 2))
    f = np.zeros(entry, np.float32)
    f[1:-1, 1:-1] = sts[0].c * rng.standard_normal((entry[0] - 2,
                                                    entry[1] - 2))
    return shapes, sts, torch.from_numpy(u), torch.from_numpy(f)


def _phase_items(nx, ny, color, row_short=0):
    """(warp, lane, i, j) of the nodes a colour phase's items cover: warp w
    takes rows 2q + 1 and 2q + 2, sixteen lanes each, chunk c of the row's
    nodes of the colour."""
    chunks = -(-((ny - 1) // 2) // 16)
    pairs = (nx - 1) // 2 if not row_short else (nx - 2) // 2
    t = torch.arange(32 * chunks * pairs)
    lane, w = t & 31, t >> 5
    q, c = w // chunks, w % chunks
    i = 1 + 2 * q + (lane >> 4)
    j = 1 + ((i + 1 + color) & 1) + 2 * (16 * c + (lane & 15))
    ok = (i <= nx - 2) & (j <= ny - 2)
    return w[ok], lane[ok], i[ok], j[ok]


def _lane_items(nx, ny, color):
    """(i, j) of the nodes a colour phase of the warp covers: lane t takes
    the t-th node of the colour, rows first."""
    hc = (ny - 1) // 2
    t = torch.arange((nx - 2) * hc)
    i = 1 + t // hc
    j = 1 + ((i + 1 + color) & 1) + 2 * (t % hc)
    ok = j <= ny - 2
    return i[ok], j[ok]


def _phase_mask(shape, color, row_short, warp=False):
    nx, ny = shape
    i, j = (_lane_items(nx, ny, color) if warp else
            _phase_items(nx, ny, color, row_short)[2:])
    mask = torch.zeros((nx - 2, ny - 2), dtype=torch.bool)
    mask[i - 1, j - 1] = True
    assert int(mask.sum()) == len(i)  # every node once
    assert bool(((i + j) % 2 == color).all())
    return mask


class _Walk:
    """D's walk over the plan's flat shared memory."""

    def __init__(self, shapes, sts, kw, row_short=0):
        self.shapes, self.sts, self.kw = shapes, sts, kw
        self.q, self.row_short, self.log = kt.plan(shapes), row_short, []
        self.sm = torch.full((self.q.bytes // 4,), float("nan"))

    def level(self, lvl):
        (nx, ny), rs = self.shapes[lvl], self.q.strides[lvl]
        o = self.q.offsets[lvl]
        return (self.sm[o:o + nx * rs].view(nx, rs)[:, :ny],
                self.sm[o + nx * rs:o + 2 * nx * rs].view(nx, rs)[:, :ny])

    def group(self, lvl):
        return "warp" if lvl >= self.q.warp_from else "block"

    def smooth(self, lvl, method, sweeps, omega, reverse=False):
        st, (u, f) = self.sts[lvl], self.level(lvl)
        unknown = bc.unknown_mask(*u.shape)
        size = 32 if self.group(lvl) == "warp" else kt.THREADS
        for _ in range(sweeps):
            if method == "jacobi":
                assert (u.shape[0] - 2) * (u.shape[1] - 2) <= \
                    kt.JACOBI_ITEMS * size  # the new values fit registers
                smooth_mod.jacobi_sweep(st, u, f, unknown, omega)
                continue
            for color in ((1, 0) if reverse else (0, 1)):
                mask = _phase_mask(u.shape, color, self.row_short,
                                   warp=size == 32)
                smooth_mod.rb_color_update(st, u, f, unknown, mask, omega)

    def cycle(self, lvl):
        kw, L = self.kw, len(self.shapes)
        if lvl == L - 1:
            self.log.append((lvl, "lanes" if self.q.lanes
                             else self.group(lvl)))
            return self.smooth(lvl, "rbgs", kw["coarse_sweeps"], 1.0)
        self.log.append((lvl, self.group(lvl)))
        self.smooth(lvl, kw["method"], kw["pre"], kw["omega"])
        u, f = self.level(lvl)
        _, fc = self.level(lvl + 1)
        fc[1:-1, 1:-1] = residual_restrict_plain(self.sts[lvl], u,
                                                 f)[1:-1, 1:-1]
        self.cycle(lvl + 1)
        prolong_correct_plain(self.level(lvl + 1)[0], u)
        self.smooth(lvl, kw["method"], kw["post"], kw["omega"],
                    reverse=kw["symmetric"] and kw["method"] != "jacobi")

    def run(self, u, f):
        u0, f0 = self.level(0)
        u0[...], f0[...] = u, f
        if len(self.shapes) > 1:
            self.sm[self.q.offsets[1]:] = 0.0
        self.cycle(0)
        return u0.clone()


@pytest.mark.parametrize("smoother", list(KWS))
@pytest.mark.parametrize("entry", ENTRIES)
def test_walk_equals_twin(entry, smoother):
    shapes, sts, u, f = _hierarchy(entry)
    kw = dict(KWS[smoother], pre=2, post=2, coarse_sweeps=32)
    ref = kt.tail_vcycle_plain(sts, u.clone(), f, shapes=shapes, **kw)
    walk = _Walk(shapes, sts, kw)
    got = walk.run(u, f)
    assert torch.equal(got, ref), (got - ref).abs().max()
    q = kt.plan(shapes)
    assert [lvl for lvl, _ in walk.log] == list(range(len(shapes)))
    assert all((g == "block") == (lvl < q.warp_from) for lvl, g in walk.log
               if g != "lanes")


@pytest.mark.parametrize("entry,levels", [((129, 129), 1), ((33, 17), 1),
                                          ((65, 65), 2)])
def test_short_tails_equal_twin(entry, levels):
    shapes, sts, u, f = _hierarchy(entry, levels)
    kw = dict(KWS["sor"], pre=2, post=2, coarse_sweeps=32)
    ref = kt.tail_vcycle_plain(sts, u.clone(), f, shapes=shapes, **kw)
    assert torch.equal(_Walk(shapes, sts, kw).run(u, f), ref)


@pytest.mark.parametrize("entry", [(129, 129), (65, 129)])
def test_walk_fails_with_items_one_row_short(entry):
    shapes, sts, u, f = _hierarchy(entry)
    kw = dict(KWS["rbgs"], pre=2, post=2, coarse_sweeps=32)
    ref = kt.tail_vcycle_plain(sts, u.clone(), f, shapes=shapes, **kw)
    got = _Walk(shapes, sts, kw, row_short=1).run(u, f)
    assert not torch.equal(got, ref)


def _banks_clash(nx, ny, rs):
    """True when two lanes of one warp of a colour phase load one bank."""
    for color in (0, 1):
        w, _, i, j = _phase_items(nx, ny, color)
        bank = (i * rs + j) % 32
        for k in torch.unique(w):
            b = bank[w == k]
            if len(torch.unique(b)) != len(b):
                return True
    return False


def test_colour_phases_load_32_banks():
    """Each warp of a colour phase loads every operand from 32 banks at the
    plan's even row strides; a stride one short (odd) puts two lanes on one
    bank."""
    for entry in ((129, 129), (129, 65), (65, 129)):
        shapes = _chain(entry)
        q = kt.plan(shapes)
        for (nx, ny), rs in zip(shapes, q.strides):
            assert not _banks_clash(nx, ny, rs)
        nx, ny = shapes[0]
        assert _banks_clash(nx, ny, q.strides[0] - 1)


def test_plan_of_the_129_tail():
    """From 129^2: seven levels one after another, rows padded to an even
    stride, u then f; 129^2 to 17^2 walked by the block, 9^2 to 3^2 by the
    first warp, the 3^2 unknown in a lane; 180,960 bytes."""
    shapes = _chain((129, 129))
    q = kt.plan(shapes)
    assert [s[0] for s in shapes] == [129, 65, 33, 17, 9, 5, 3]
    assert q.strides == (130, 66, 34, 18, 10, 6, 4)
    assert (q.warp_from, q.lanes, q.fits) == (4, True, True)
    assert q.bytes == 4 * 2 * sum(n * (n + 1) for n, _ in shapes) == 180960
    ends = [o + 2 * nx * rs for o, (nx, _), rs in zip(q.offsets, shapes,
                                                      q.strides)]
    assert q.offsets == (0, *ends[:-1]) and ends[-1] * 4 == q.bytes
    assert kt.plan([(3, 3)]) == kt.Plan(0, True, (0,), (4,), 96, True)
    assert kt.plan([(129, 129)]).warp_from == 1


def test_every_accepted_tail_fits():
    """Each tail a V-cycle may hand D, from an entry of at most 129 x 129
    (any shape, any number of levels), fits one CTA: shared memory and the
    Jacobi registers."""
    for nx in range(3, 130):
        for ny in range(3, 130):
            chain = _chain((nx, ny))
            for L in range(1, len(chain) + 1):
                assert kt.plan(chain[:L]).fits, chain[:L]
    assert not kt.plan([(131, 257)]).fits


@pytest.mark.parametrize("max_levels", [1, 2, 7])
def test_the_cycle_takes_d_from_129(max_levels):
    cfg = T.MultigridConfig(max_levels=max_levels)
    levels = T.build_hierarchy(T.Grid(129, 129), cfg=cfg, device="cpu")
    assert dispatch.tail_ok(levels, 0, cfg, "V")
    assert kt.plan([lev.grid.shape for lev in levels]).fits


def test_constants_are_the_kernel_sources():
    exprs = dict(re.findall(r"constexpr int (\w+) = ([^;]+);",
                            SOURCE.read_text()))
    got = tuple(eval(exprs[k], {}) for k in ("kThreads", "kWarpMaxNodes",
                                             "kJacobiItems", "kMaxSmemBytes",
                                             "kTailMaxLevels"))
    assert got == (kt.THREADS, kt.WARP_MAX_NODES, kt.JACOBI_ITEMS,
                   kt.MAX_SMEM_BYTES, kt.MAX_LEVELS)
