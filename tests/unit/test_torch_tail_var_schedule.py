"""Kernel J's schedule, emulated on the CPU, against the plain twin.

``csrc/tail_var.cu`` walks a V-cycle tail in one thread-block cluster: the
first ``split`` levels are cut into row bands, one per CTA, each CTA holding
its rows of u, f, the residual and the planes and reading its neighbours'
edge rows of u and of the residual (one halo row); restriction writes coarse
row I from the CTA that holds fine row 2I, prolongation reads the next CTA's
first coarse row for a band's last odd row; the levels below are walked by
CTA 0, from ``warp_from`` on by its first warp. The emulation below repeats
that with torch ops: each CTA's step sees only its own rows (its planes and
f) and its halo rows of u and the residual, every other row NaN, and keeps
only the rows it holds. Every node is the twin's arithmetic, so the
emulation must equal ``tail_vcycle_plain`` bit for bit, and a halo one row
short must break it.
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
    transfer as transfer_mod,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    tail as kt,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels.transfer \
    import coarse_shape, prolong_correct_plain

SOURCE = Path(T.__file__).parent / "csrc" / "tail_var.cu"
# (49, 129) and (121, 129): levels split past the row rule so that the
# tail fits a CTA's shared memory
ENTRIES = [(129, 129), (65, 65), (17, 17), (3, 3), (129, 65), (65, 129),
           (97, 49), (49, 129), (121, 129)]


def _hierarchy(entry):
    shapes = [tuple(entry)]
    while min(shapes[-1]) >= 5 and all(n % 2 for n in shapes[-1]):
        shapes.append(coarse_shape(*shapes[-1]))
    sts = []
    for nx, ny in shapes:
        g = T.Grid(nx, ny, (0.0, 1.3, 0.0, 0.7))
        X, Y = g.coordinates()
        sts.append(st_mod.make_stencil(g, a=np.where(X < 0.5, 1.0, 1e3) + Y))
    rng = np.random.default_rng(sum(entry))
    u = np.zeros(entry, np.float32)
    u[1:-1, 1:-1] = rng.standard_normal((entry[0] - 2, entry[1] - 2))
    f = np.zeros(entry, np.float32)
    f[1:-1, 1:-1] = 1e3 * rng.standard_normal((entry[0] - 2, entry[1] - 2))
    return shapes, sts, torch.from_numpy(u), torch.from_numpy(f)


def _seen(x, row0, row1, halo):
    """x as a CTA holding rows [row0, row1) sees it: NaN off those rows and
    ``halo`` rows either side."""
    out = torch.full_like(x, float("nan"))
    a, b = max(row0 - halo, 0), min(row1 + halo, x.shape[0])
    out[a:b] = x[a:b]
    return out


class _Split:
    """The cluster's steps on split level ``lvl``."""

    def __init__(self, q, lvl, st, halo):
        self.q, self.lvl, self.st, self.halo = q, lvl, st, halo
        self.nx = st.c.shape[0]

    def bands(self):
        for rank in range(kt.CLUSTER):
            yield self.q.band(self.lvl, rank, self.nx)

    def own(self, r0, r1, fn, *fields):
        """fn on a CTA's view: its own rows of the planes and of the fields
        after the first (f), halo rows of the first (u or r) too."""
        st = st_mod.Stencil(*(_seen(x, r0, r1, 0) for x in self.st.coefs))
        first, *rest = fields
        return fn(st, _seen(first, r0, r1, self.halo),
                  *(_seen(x, r0, r1, 0) for x in rest))

    def step(self, fn, *fields):
        out = torch.empty_like(fields[0])
        for r0, r1 in self.bands():
            out[r0:r1] = self.own(r0, r1, fn, *fields)[r0:r1]
        return out

    def smooth(self, u, f, method, sweeps, omega):
        unknown = bc.unknown_mask(*u.shape)
        red = smooth_mod._red(self.st, u)
        for _ in range(sweeps):
            if method == "jacobi":
                u = self.step(lambda st, uu, ff: smooth_mod.jacobi_sweep(
                    st, uu, ff, unknown, omega), u, f)
                continue
            first = ~red if method == "rbgs_rev" else red
            for mask in (first, ~first):
                u = self.step(lambda st, uu, ff: smooth_mod.rb_color_update(
                    st, uu, ff, unknown, mask, omega), u, f)
        return u

    def residual_restrict(self, u, f):
        unknown = bc.unknown_mask(*u.shape)
        r = self.step(lambda st, uu, ff: st_mod.residual(st, uu, ff, unknown),
                      u, f)
        ncx, ncy = coarse_shape(*u.shape)
        fc = torch.zeros((ncx, ncy))
        for r0, r1 in self.bands():
            full = transfer_mod.restrict(_seen(r, r0, r1, self.halo), ncx, ncy)
            i0, i1 = max((r0 + 1) // 2, 1), min((r1 + 1) // 2, ncx - 1)
            fc[i0:i1] = full[i0:i1]
        return fc

    def prolong(self, ec, u):
        out = torch.empty_like(u)
        for rank, (r0, r1) in enumerate(self.bands()):
            c0, c1 = self.q.band(self.lvl + 1, rank, ec.shape[0])
            seen = _seen(ec, c0, c1, self.halo)
            out[r0:r1] = prolong_correct_plain(seen, _seen(u, r0, r1, 0))[r0:r1]
        return out


def _cta0_walk(sts, u, f, q, lvl, kw, log):
    """CTA 0's V-cycle from level ``lvl`` down, whole levels, the group that
    runs each level logged."""
    log.append((lvl, "warp" if lvl >= q.warp_from else "block"))
    st = sts[lvl]
    unknown = bc.unknown_mask(*u.shape)
    if lvl == len(sts) - 1:
        return smooth_mod.smooth(st, u, f, unknown, method="rbgs",
                                 sweeps=kw["coarse_sweeps"], omega=1.0)
    method = kw["method"]
    post = "rbgs_rev" if kw["symmetric"] and method != "jacobi" else method
    smooth_mod.smooth(st, u, f, unknown, method=method, sweeps=kw["pre"],
                      omega=kw["omega"])
    ncx, ncy = coarse_shape(*u.shape)
    fc = transfer_mod.restrict(st_mod.residual(st, u, f, unknown), ncx, ncy)
    ec = _cta0_walk(sts, torch.zeros_like(fc), fc, q, lvl + 1, kw, log)
    prolong_correct_plain(ec, u)
    return smooth_mod.smooth(st, u, f, unknown, method=post,
                             sweeps=kw["post"], omega=kw["omega"])


def _emulate(sts, u, f, shapes, kw, halo=1):
    q = kt.var_plan(shapes)
    splits = [_Split(q, lvl, sts[lvl], halo) for lvl in range(q.split)]
    post = ("rbgs_rev" if kw["symmetric"] and kw["method"] != "jacobi"
            else kw["method"])
    us, fs = [u.clone()], [f]
    for sp in splits:
        us[-1] = sp.smooth(us[-1], fs[-1], kw["method"], kw["pre"],
                           kw["omega"])
        fs.append(sp.residual_restrict(us[-1], fs[-1]))
        us.append(torch.zeros_like(fs[-1]))
    log = []
    _cta0_walk(sts, us[-1], fs[-1], q, q.split, kw, log)
    for sp in reversed(splits):
        lvl = sp.lvl
        us[lvl] = sp.prolong(us[lvl + 1], us[lvl])
        us[lvl] = sp.smooth(us[lvl], fs[lvl], post, kw["post"], kw["omega"])
    return us[0], log


KWS = {"rbgs": dict(method="rbgs", omega=1.0, symmetric=False),
       "symmetric": dict(method="rbgs", omega=1.0, symmetric=True),
       "sor": dict(method="sor", omega=1.3, symmetric=False),
       "jacobi": dict(method="jacobi", omega=0.8, symmetric=False)}


@pytest.mark.parametrize("smoother", list(KWS))
@pytest.mark.parametrize("entry", ENTRIES)
def test_cluster_schedule_equals_twin(entry, smoother):
    shapes, sts, u, f = _hierarchy(entry)
    kw = dict(KWS[smoother], pre=2, post=2, coarse_sweeps=32)
    ref = kt.tail_vcycle_plain(sts, u.clone(), f, shapes=shapes, **kw)
    got, log = _emulate(sts, u, f, shapes, kw)
    assert torch.equal(got, ref), (got - ref).abs().max()
    q = kt.var_plan(shapes)
    assert [lvl for lvl, _ in log] == list(range(q.split, len(shapes)))


@pytest.mark.parametrize("entry", [(129, 129), (97, 49)])
def test_cluster_schedule_fails_with_a_halo_one_row_short(entry):
    shapes, sts, u, f = _hierarchy(entry)
    kw = dict(KWS["rbgs"], pre=2, post=2, coarse_sweeps=32)
    ref = kt.tail_vcycle_plain(sts, u.clone(), f, shapes=shapes, **kw)
    got, _ = _emulate(sts, u, f, shapes, kw, halo=0)
    assert not torch.equal(got, ref)


def test_plan_of_the_129_tail():
    """From 129^2: 129^2 and 65^2 in bands of 16 and 8 rows (the last CTA
    takes one row more), 33^2 and 17^2 walked by CTA 0's block, 9^2 to 3^2
    by its first warp; a CTA's shared memory fits the 227 KB a block may
    use."""
    shapes, _, _, _ = _hierarchy((129, 129))
    q = kt.var_plan(shapes)
    assert [s[0] for s in shapes] == [129, 65, 33, 17, 9, 5, 3]
    assert (q.split, q.band0, q.warp_from) == (2, 16, 4)
    assert [q.band(0, r, 129) for r in (0, 1, 7)] == [(0, 16), (16, 32),
                                                      (112, 129)]
    assert [q.band(1, r, 65) for r in (0, 7)] == [(0, 8), (56, 65)]
    assert q.bytes == 4 * 8 * (17 * 129 + 9 * 65 + 33 * 33 + 17 * 17 + 81
                               + 25 + 9)
    assert q.bytes <= kt.MAX_SMEM_BYTES
    for entry in ENTRIES:
        shapes, _, _, _ = _hierarchy(entry)
        q = kt.var_plan(shapes)
        assert q.bytes <= kt.MAX_SMEM_BYTES
        assert q.split <= len(shapes) - 1
        for lvl in range(q.split):  # bands are even-aligned and non-empty
            nx = shapes[lvl][0]
            rows = [q.band(lvl, r, nx) for r in range(kt.CLUSTER)]
            assert rows[0][0] == 0 and rows[-1][1] == nx
            assert all(a % 2 == 0 and b > a for a, b in rows)
            assert all(rows[r][1] == rows[r + 1][0]
                       for r in range(kt.CLUSTER - 1))
    assert kt.var_plan([(3, 3)]) == kt.VarPlan(0, 0, 0, 4 * 8 * 9)
    # fitted by bytes: 49 rows split into bands of 6 (row rule: none);
    # from 121 rows the 61-row level splits too, in bands of 8
    for entry, split_band0 in (((49, 129), (1, 6)), ((121, 129), (2, 16))):
        q = kt.var_plan(_hierarchy(entry)[0])
        assert (q.split, q.band0) == split_band0


def _chain(entry):
    """Every level shape of the hierarchy below ``entry``."""
    shapes = [entry]
    while T.Grid(*shapes[-1]).can_coarsen():
        shapes.append(coarse_shape(*shapes[-1]))
    return shapes


def test_every_tail_of_two_or_more_levels_fits():
    """Each tail a V-cycle may hand J from an entry of at most 129 x 129
    (any shape, any number of levels from two on) fits a CTA's shared
    memory, in bands that leave the last CTA two rows or more; a one-level
    tail fits up to 7264 nodes."""
    for nx in range(3, 130):
        for ny in range(3, 130):
            chain = _chain((nx, ny))
            for L in range(2, len(chain) + 1):
                q = kt.var_plan(chain[:L])
                assert q.bytes <= kt.MAX_SMEM_BYTES, chain[:L]
                for lvl in range(q.split):
                    n = chain[lvl][0]
                    b = q.band0 >> lvl
                    assert b % 2 == 0 and (kt.CLUSTER - 1) * b < n - 1
            one = [chain[0]]
            assert kt.var_fits(tuple(one)) == (nx * ny <= 7264)


@pytest.mark.parametrize("max_levels,takes_j", [(1, False), (2, True)])
def test_the_cycle_takes_j_only_where_it_fits(max_levels, takes_j):
    g = T.Grid(129, 129)
    X, Y = g.coordinates()
    cfg = T.MultigridConfig(max_levels=max_levels)
    levels = T.build_hierarchy(g, a=1.0 + X + Y, cfg=cfg, device="cpu")
    assert len(levels) == max_levels
    assert dispatch.tail_ok(levels, 0, cfg, "V") == takes_j


def test_constants_are_the_kernel_sources():
    exprs = dict(re.findall(r"constexpr int (\w+) = ([^;]+);",
                            SOURCE.read_text()))
    got = tuple(eval(exprs[k], {}) for k in ("kCluster", "kThreads",
                                             "kMinBandRows", "kWarpMaxNodes",
                                             "kMaxSmemBytes"))
    assert got == (kt.CLUSTER, kt.THREADS, kt.MIN_BAND_ROWS,
                   kt.WARP_MAX_NODES, kt.MAX_SMEM_BYTES)
