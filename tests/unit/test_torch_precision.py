"""The port's precision staging against the JAX package, on the CPU.

``PrecisionPolicy``, the 'mixed' and 'adaptive' solves (from fp32 and from
bf16), ``autotune``, and the rounding points of the bf16 twins of kernels
A-D. Inputs are numpy arrays from a seed, or the same problem built by both
packages; fields are compared on the logical (nx, ny) region.

Tolerances, each with its reason:

- ``level_dtypes`` and the promotion tests: exact (the same integer and
  float64 arithmetic).
- solves on ``poisson_mms_sinsin(65)``, port ``backend='torch'`` (the plain
  path, which rounds bf16 levels op by op as the JAX XLA path does): equal
  outer-step counts and ``precision_switches``, l2 error within 2% of the
  JAX one. The port's ``backend='auto'`` runs the kernels' twins on the
  CPU, which round once per kernel call: the same count for the fp32-start
  solves, within 1 for the bf16 start, whose bf16 stage sees other
  roundings.
- autotune: the same choice as the JAX function when both are given the
  same wall times (``benchmark_function`` replaced, as the JAX package's
  own autotune test does).
- the bf16 twins against hand-made fp32 numpy references: bit for bit
  (both compute in fp32 in the same operation order and round once); a
  twin on bf16 storage against the Pallas kernel in interpret mode on the
  same bf16 inputs: within one bf16 ulp (2^-7 of the value) plus 1e-5 of
  the largest value, since the fp32 bodies differ by ~1e-7 relative (1/c
  against a division, separable sums) and that can move a value across a
  bf16 rounding boundary.
- D's twin on a mixed tail: bit for bit against the fp32 twin on the same
  stencils (D computes every level in fp32).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    poisson as japp,
    precision_analysis as jpa,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (  # noqa: E402
    precision as jprec,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (  # noqa: E402
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    stencil as jst,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.pallas_kernels import (  # noqa: E402
    smooth as psmooth,
    tail as ptail,
    transfer as ptransfer,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid as jmg,
    refinement as jref,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.applications import (  # noqa: E402
    precision_analysis as pa,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    smooth as smooth_mod,
    stencil,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth as ksmooth,
    tail as ktail,
    transfer as ktransfer,
)

BF16 = torch.bfloat16
N = 65
MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
L2_RTOL = 0.02
TOL = 1e-5


def _jcfg(**kw):
    return jmg.MultigridConfig(**{**MAIN, **kw})


def _cfg(**kw):
    return T.MultigridConfig(**{**MAIN, **kw})


# ---------------------------------------------------------------------------
# PrecisionPolicy


@pytest.mark.parametrize("mode", ["fp64", "fp32", "bf16", "mixed",
                                  "adaptive"])
def test_level_dtypes_match_jax(mode):
    names = {jnp.dtype(jnp.float64): torch.float64,
             jnp.dtype(jnp.float32): torch.float32,
             jnp.dtype(jnp.bfloat16): BF16}
    jpol, pol = jprec.policy(mode), T.policy(mode)
    for levels in range(1, 13):
        want = tuple(names[jnp.dtype(d)] for d in jpol.level_dtypes(levels))
        assert pol.level_dtypes(levels) == want, levels
    assert interop.policy_from_jax(jpol) == pol


def test_promotion_rules_match_jax():
    jpol, pol = jprec.PrecisionPolicy(), T.PrecisionPolicy()
    rng = np.random.default_rng(11)
    histories = [
        [1.0, 0.1, 0.01, 1e-3, 1e-4, 1e-5, 1e-6],      # converging
        [1.0, 0.95, 0.93, 0.92, 0.91, 0.905, 0.9],      # stagnating
        [1.0, 0.9999, 0.99985, 0.9998, 0.99975, 0.9997],  # plateau
        [1.0, 1.1, 1.2, 1.3, 1.4, 1.5],                 # growing
        [1.0, 0.5, 0.25],                               # too short
        list(np.cumprod(rng.uniform(0.05, 1.2, 12))),
    ]
    for h in histories:
        assert pol.should_promote(h) == jpol.should_promote(h), h
    for r in (1e-9, 1e-6, 9.9e-6, 1e-5, 1e-4, 1e-3, 1.0):
        assert pol.should_upgrade(r) == jpol.should_upgrade(r), r
        assert pol.should_downgrade(r) == jpol.should_downgrade(r), r


# ---------------------------------------------------------------------------
# staged solves on poisson_mms_sinsin(65)


def _check(res_t, res_j, count_slack=0):
    assert res_t.converged and res_j.converged
    assert abs(res_t.iterations - res_j.iterations) <= count_slack
    assert abs(res_t.errors["l2"] / res_j.errors["l2"] - 1) <= L2_RTOL


@pytest.mark.parametrize("precision", ["mixed", "adaptive"])
def test_solve_poisson_staged_matches_jax(precision):
    ref = japp.solve_poisson(JP.poisson_mms_sinsin(N), precision=precision,
                             cfg=_jcfg())
    prob = T.poisson_mms_sinsin(N)
    for backend in ("torch", "auto"):
        res = T.solve_poisson(prob, precision=precision,
                              cfg=_cfg(backend=backend), device="cpu")
        _check(res, ref)
        assert res.info.get("precision_switches") == ref.info.get(
            "precision_switches")
    if precision == "adaptive":
        assert [s["stage"] for s in res.info["stage_factors"]] == [
            s["stage"] for s in ref.info["stage_factors"]]


def test_adaptive_bf16_start_matches_jax():
    jp = JP.poisson_mms_sinsin(N)
    u, info = jref.adaptive_solve(jp.grid, jp.spec, jp.rhs(jnp.float64),
                                  jp.initial_guess(jnp.float64), cfg=_jcfg(),
                                  start=jprec.Precision.BF16)
    prob = T.poisson_mms_sinsin(N)
    l2_ref = jp.error_norms(u)["l2"]
    for backend, slack in (("torch", 0), ("auto", 1)):
        got, tinfo = T.adaptive_solve(
            prob.grid, prob.spec, prob.rhs(torch.float64),
            prob.initial_guess(torch.float64), cfg=_cfg(backend=backend),
            start=T.Precision.BF16, device="cpu")
        assert tinfo["converged"] and tinfo["method"] == "adaptive"
        assert abs(tinfo["iterations"] - info["iterations"]) <= slack
        assert [s[1] for s in tinfo["precision_switches"]] == [
            s[1] for s in info["precision_switches"]] == ["fp32", "ir"]
        assert tinfo["precision_switches"][0] == info["precision_switches"][0]
        assert abs(prob.error_norms(got)["l2"] / l2_ref - 1) <= L2_RTOL
        if backend == "torch":
            assert tinfo["precision_switches"] == info["precision_switches"]


def test_bf16_policy_solve_runs_uniform_bf16_levels():
    """precision='bf16' builds a uniform bf16 hierarchy and runs mg_solve,
    as the JAX package does; a bf16 residual at h = 1/16 is noise, so only
    the shape of the result is checked."""
    prob = T.poisson_mms_sinsin(17)
    res = T.solve_poisson(prob, precision="bf16",
                          cfg=_cfg(max_iterations=3), device="cpu")
    assert res.u.dtype == BF16 and res.iterations == 3
    assert torch.isfinite(res.u).all()


def test_autotune_matches_jax_and_caches(monkeypatch):
    """Both packages, given the same wall times, choose alike; the accuracy
    rule drops candidates whose error is above accuracy_factor times the
    best; a second call takes the cache."""
    cfg, jcfg = _cfg(), _jcfg()
    prob, jprob = T.poisson_mms_sinsin(N), JP.poisson_mms_sinsin(N)
    cands = ("fp32", "mixed", "adaptive")
    for factor, want in ((10.0, "mixed"), (1.0, None)):
        choices = []
        for mod, run in ((pa, lambda: pa.autotune(
                prob, cfg=cfg, candidates=cands, runs=1,
                accuracy_factor=factor, use_cache=False, device="cpu")),
                (jpa, lambda: jpa.autotune(
                    jprob, cfg=jcfg, candidates=cands, runs=1,
                    accuracy_factor=factor, use_cache=False))):
            times = iter([3.0, 1.0, 2.0])
            monkeypatch.setattr(mod, "benchmark_function",
                                lambda *a, **k: {"min_s": next(times)})
            choices.append(run())
        assert choices[0] == choices[1]
        if want:
            assert choices[0] == want
    pa._AUTOTUNE_CACHE.clear()
    monkeypatch.setattr(pa, "benchmark_function",
                        lambda *a, **k: {"min_s": 1.0})
    first = pa.autotune(prob, cfg=cfg, candidates=("fp32",), runs=1,
                        device="cpu")

    def boom(*a, **k):
        raise AssertionError("autotune measured a cached choice again")

    monkeypatch.setattr(pa, "benchmark_function", boom)
    assert pa.autotune(prob, cfg=cfg, candidates=("fp32",), runs=1,
                       device="cpu") == first == "fp32"
    times = iter([3.0, 2.0, 1.0])
    monkeypatch.setattr(pa, "benchmark_function",
                        lambda *a, **k: {"min_s": next(times)})
    res = T.solve_poisson(prob, precision="auto", cfg=cfg, device="cpu")
    assert res.converged and res.info["method"] == "adaptive"


def test_benchmark_function_times_each_run():
    calls = []
    stats = T.utils.timing.benchmark_function(lambda: calls.append(1),
                                              warmup=2, runs=3)
    assert len(calls) == 5 and stats["runs"] == 3
    assert 0.0 <= stats["min_s"] <= stats["mean_s"] <= stats["max_s"]


def test_mixed_hierarchy_crosses_fp32_to_bf16():
    """A mixed hierarchy at 1025^2 puts 1025^2..65^2 in fp32 and 33^2..3^2
    in bf16 (JAX core/precision.py:98-103); a plain cycle restricts into
    the coarse dtype and prolongs into the fine one."""
    levels = T.build_hierarchy(T.Grid(33, 33), policy=T.policy("mixed"),
                               device="cpu", cfg=_cfg(backend="torch"))
    assert [lev.dtype for lev in levels] == [torch.float32] * 2 + [BF16] * 3
    big = T.PrecisionPolicy(mode=T.Precision.MIXED).level_dtypes(10)
    assert big == (torch.float32,) * 5 + (BF16,) * 5
    f = torch.from_numpy(_field((33, 33), 5, 8.0))
    u = T.mg_cycle(levels, levels[0].zeros(), f, _cfg(backend="torch"))
    assert u.dtype == torch.float32 and torch.isfinite(u).all()


# ---------------------------------------------------------------------------
# the bf16 twins' rounding points


def _field(shape, seed, scale=1.0, ring=False):
    rng = np.random.default_rng(seed)
    a = np.zeros(shape, np.float32)
    if ring:
        a[:] = scale * rng.standard_normal(shape)
    else:
        a[1:-1, 1:-1] = scale * rng.standard_normal(
            (shape[0] - 2, shape[1] - 2))
    return a


def _bf16(a):
    return torch.from_numpy(a).to(BF16)


def _np32(t):
    return t.float().numpy()


def _rbgs_np(u, f, st, sweeps):
    """RB-GS with omega = 1 in numpy float32, the plain twin's order."""
    u = u.copy()
    i, j = np.meshgrid(np.arange(u.shape[0]), np.arange(u.shape[1]),
                       indexing="ij")
    for _ in range(sweeps):
        for color in (0, 1):
            nb = (np.float32(st.w) * u[:-2, 1:-1] + np.float32(st.e)
                  * u[2:, 1:-1] + np.float32(st.s) * u[1:-1, :-2]
                  + np.float32(st.n) * u[1:-1, 2:])
            gs = (f[1:-1, 1:-1] + nb) / np.float32(st.c)
            old = u[1:-1, 1:-1]
            new = old + np.float32(1.0) * (gs - old)
            mask = ((i + j) % 2 == color)[1:-1, 1:-1]
            u[1:-1, 1:-1] = np.where(mask, new, old)
    return u


def test_bf16_smoothing_twin_rounds_once():
    g = T.Grid(17, 17)
    st = stencil.make_stencil(g)
    u, f = _bf16(_field(g.shape, 21, ring=True)), _bf16(_field(g.shape, 22,
                                                                st.c))
    got = ksmooth.multisweep_plain(st, u.clone(), f, sweeps=9)
    ref = torch.from_numpy(_rbgs_np(_np32(u), _np32(f), st, 9)).to(BF16)
    assert got.dtype == BF16 and torch.equal(got, ref)
    # rounding after every operation instead gives another field
    per_op = smooth_mod.smooth(st, u.clone(), f, T.core.bc.unknown_mask(
        17, 17), method="rbgs", sweeps=9, omega=1.0)
    assert not torch.equal(per_op, ref)


def test_bf16_transfer_twins_round_once():
    g = T.Grid(33, 33)
    st = stencil.make_stencil(g)
    u32, f32 = _field(g.shape, 23), _field(g.shape, 24, st.c)
    u, f = _bf16(u32), _bf16(f32)
    a, b = _np32(u), _np32(f)
    r = np.zeros_like(a)
    nb = (np.float32(st.w) * a[:-2, 1:-1] + np.float32(st.e) * a[2:, 1:-1]
          + np.float32(st.s) * a[1:-1, :-2] + np.float32(st.n) * a[1:-1, 2:])
    r[1:-1, 1:-1] = b[1:-1, 1:-1] - (np.float32(st.c) * a[1:-1, 1:-1] - nb)
    fc = np.zeros((17, 17), np.float32)

    def win(di, dj):
        return r[2 + di: 31 + di: 2, 2 + dj: 31 + dj: 2]

    fc[1:-1, 1:-1] = (np.float32(4.0) * win(0, 0) + np.float32(2.0) * (
        win(1, 0) + win(-1, 0) + win(0, 1) + win(0, -1)) + (
        win(1, 1) + win(-1, 1) + win(1, -1) + win(-1, -1))) / np.float32(16)
    for tin, tout in ((BF16, BF16), (torch.float32, BF16), (BF16,
                                                            torch.float32)):
        ui, fi = u.to(tin), f.to(tin)
        got = ktransfer.residual_restrict_plain(st, ui, fi, out_dtype=tout)
        assert got.dtype == tout
        assert torch.equal(got, torch.from_numpy(fc).to(tout))

    ec = _bf16(_field((17, 17), 25, ring=True))
    uf = _bf16(_field((33, 33), 26, ring=True))
    c = _np32(ec)
    e = np.empty((33, 33), np.float32)
    e[0::2, 0::2] = c
    e[0::2, 1::2] = np.float32(0.5) * (c[:, :-1] + c[:, 1:])
    e[1::2, 0::2] = np.float32(0.5) * (c[:-1, :] + c[1:, :])
    e[1::2, 1::2] = np.float32(0.25) * (c[:-1, :-1] + c[1:, :-1]
                                        + c[:-1, 1:] + c[1:, 1:])
    want = _np32(uf)
    want[1:-1, 1:-1] += e[1:-1, 1:-1]
    got = ktransfer.prolong_correct_plain(ec, uf.clone())
    assert torch.equal(got, torch.from_numpy(want).to(BF16))


def _tail(entry, mode):
    pol = T.policy(mode)
    levels = T.build_hierarchy(T.Grid(129, 129), policy=pol, device="cpu")
    return [lev for lev in levels if lev.grid.nx <= entry]


def test_tail_twin_on_a_mixed_tail_is_the_fp32_twin():
    """At 129^2 'mixed' gives 129^2..17^2 fp32 and 9^2..3^2 bf16: the twin
    computes every level in fp32 on the same stencils, as D does; a bf16
    entry is widened, cycled in fp32 and rounded once."""
    mixed, fp32 = _tail(129, "mixed"), _tail(129, "fp32")
    assert mixed[0].dtype == torch.float32 and mixed[-1].dtype == BF16
    kw = dict(shapes=[lev.grid.shape for lev in mixed], pre=2, post=2,
              omega=1.0, method="rbgs", coarse_sweeps=32, symmetric=False)
    u = torch.from_numpy(_field((129, 129), 27))
    f = torch.from_numpy(_field((129, 129), 28, mixed[0].stencil.c))
    got = ktail.tail_vcycle_plain([lev.stencil for lev in mixed], u.clone(),
                                  f, **kw)
    ref = ktail.tail_vcycle_plain([lev.stencil for lev in fp32], u.clone(),
                                  f, **kw)
    assert torch.equal(got, ref)
    ub, fb = u.to(BF16), f.to(BF16)
    got = ktail.tail_vcycle_plain([lev.stencil for lev in mixed], ub.clone(),
                                  fb, **kw)
    ref = ktail.tail_vcycle_plain([lev.stencil for lev in fp32], ub.float(),
                                  fb.float(), **kw).to(BF16)
    assert got.dtype == BF16 and torch.equal(got, ref)


# ---------------------------------------------------------------------------
# the bf16 twins against the Pallas kernels in interpret mode


def _jax_bf16(t, n):
    a = interop.field_to_jax_layout(t.float(), JGrid(n, n))
    return jnp.asarray(a, jnp.bfloat16)


def _within_a_bf16_ulp(got, ref_padded, n):
    ref = np.asarray(ref_padded, np.float32)[:n, :n]
    g = got.float().numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert (np.abs(g - ref) <= 2.0 ** -7 * np.abs(ref)
            + TOL * scale).all(), float(np.abs(g - ref).max())


def test_bf16_twins_match_pallas_interpret():
    n, nc = 33, 17
    g = T.Grid(n, n)
    st, jstc = stencil.make_stencil(g), jst.make_stencil(JGrid(n, n))
    u, f = _bf16(_field(g.shape, 31)), _bf16(_field(g.shape, 32, st.c))
    ref = psmooth.multisweep(jstc, _jax_bf16(u, n), _jax_bf16(f, n), nx=n,
                             ny=n, method="rbgs", sweeps=2, omega=1.0,
                             interpret=True)
    assert ref.dtype == jnp.bfloat16
    got = ksmooth.multisweep_plain(st, u.clone(), f, sweeps=2)
    _within_a_bf16_ulp(got, ref, n)

    ref = ptransfer.residual_restrict(
        jstc, _jax_bf16(u, n), _jax_bf16(f, n), nxf=n, nyf=n, ncx=nc,
        ncy=nc, pshape_coarse=JGrid(nc, nc).shape_padded,
        out_dtype=jnp.bfloat16, interpret=True)
    got = ktransfer.residual_restrict_plain(st, u, f, out_dtype=BF16)
    _within_a_bf16_ulp(got, ref, nc)

    ec = _bf16(_field((nc, nc), 33, ring=True))
    ref = ptransfer.prolong_correct(_jax_bf16(ec, nc), _jax_bf16(u, n),
                                    ncx=nc, ncy=nc, nxf=n, nyf=n,
                                    interpret=True)
    got = ktransfer.prolong_correct_plain(ec, u.clone())
    _within_a_bf16_ulp(got, ref, n)

    sizes = [n, 17, 9, 5, 3]
    sts = [stencil.make_stencil(T.Grid(k, k)) for k in sizes]
    jsts = [jst.make_stencil(JGrid(k, k)) for k in sizes]
    meta = tuple((k, k) + JGrid(k, k).shape_padded for k in sizes)
    kw = dict(pre=2, post=2, omega=1.0, method="rbgs", coarse_sweeps=32,
              symmetric=False)
    ref = ptail.tail_vcycle(jsts, _jax_bf16(u, n), _jax_bf16(f, n),
                            meta=meta, interpret=True, **kw)
    got = ktail.tail_vcycle_plain(sts, u.clone(), f,
                                  shapes=[(k, k) for k in sizes], **kw)
    _within_a_bf16_ulp(got, ref, n)
