"""The port's 2D heat equations (``applications/heat.py``,
``heat_problems.py``) and its checkpoint manager against the JAX package,
on the CPU (``device="cpu"``, so the kernel wrappers run their plain
twins).

Tolerances, each with its reason:

- float64 runs (every scheme, the adaptive controller, Neumann sides,
  time-dependent Dirichlet data, a source, a coefficient field, snapshots):
  the final state within 1e-8 of max|u|, the same steps, t and dt_history
  (dt_history to 1e-12 relative). Measured: 2e-16 to 5e-16; the sums of
  the norms run in another order than XLA's. The adaptive runs: the same
  accepted count and dt_history within 1e-9 relative (measured 2e-11 to
  4e-11: the step-doubling error, ~1e-5, is the difference of two states
  that agree to ~1e-16, and dt goes as its cube root).
- float32 runs (Crank-Nicolson, BDF2): the states within 1e-6 of max|u|
  and ``errors["l2"]`` within 1e-3 relative. Measured at 17^2: 0.7e-7 to
  2.2e-7 and 1e-5 to 8e-5. XLA fuses the fp32 cycles and contracts
  multiply-adds into FMAs, torch rounds each operation, and a float32 step
  sits on its rounding noise (its residual cannot reach the default
  ``step_rtol`` 1e-9, so every step runs all 12 cycles); the l2 error is
  part rounding noise too. The float32 adaptive controller follows that
  noise, so a float32 adaptive run is held to reaching t_final only.
- sin, cos and exp on the meshes: within 1 ulp elementwise (XLA's and
  torch's may differ by that much). The sources, exact solutions and
  initial states of all twelve factories at 33^2, products of two or three
  of them: within 4 ulps of the field's largest value (measured <= 3;
  elementwise ulps mean nothing where a sum cancels). The shift ``lam``
  and every level's ``c + lam``: bit for bit.
- checkpoint resume against the uninterrupted run of the port: bit for
  bit.
"""

import collections
import json
import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    heat as JH,
    heat_problems as JHP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (  # noqa: E402
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid as jmg,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.applications import (  # noqa: E402
    heat as PH,
    heat_problems as PHP,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth as ksmooth,
    smooth_var as ksmooth_var,
    tail as ktail,
    transfer as ktransfer,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (  # noqa: E402
    multigrid as tmg,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.utils import (  # noqa: E402
    CheckpointManager,
)

N = 17
F64_RTOL = 1e-8
F32_STATE_RTOL = 1e-6
F32_L2_RTOL = 1e-3
DT_RTOL = 1e-12
ADAPTIVE_DT_RTOL = 1e-9
ULPS = 4
SCHEMES = {"explicit": {}, "backward_euler": {"save_every": 2},
           "crank_nicolson": {}, "theta": {"theta": 0.7}, "bdf2": {}}


def _jax_exact(X, Y, t):
    return jnp.sin(np.pi * X) * jnp.sin(np.pi * Y) * jnp.exp(
        -2 * np.pi**2 * t)


def _port_exact(X, Y, t):
    e = torch.exp(-2 * np.pi**2 * t)
    return PHP._up(torch.sin(np.pi * X) * torch.sin(np.pi * Y), e) * e


def _varcoef(jax: bool, n=N):
    """A Dirichlet problem with a = 1 + x + y and the pure-diffusion mode
    as initial and boundary data, in either package."""
    pkg, grid, exact = ((JH, JGrid, _jax_exact) if jax
                        else (PH, T.Grid, _port_exact))
    return pkg.heat_problem_from_callables(
        "heat_varcoef", grid(n, n), exact=exact, a=lambda X, Y: 1.0 + X + Y)


def _problem(name):
    """(JAX problem, port problem) of a catalogue name or 'varcoef'."""
    if name == "varcoef":
        return _varcoef(True), _varcoef(False)
    return JHP.CATALOGUE[name](N), PHP.CATALOGUE[name](N)


def _solve_both(name, t_final, dt, n_steps=None, **cfg):
    """The same run through the JAX package and the port (on the CPU)."""
    jp, pp = _problem(name)
    jres = JH.solve_heat(jp, t_final, dt, JH.HeatConfig(**cfg),
                         n_steps=n_steps)
    pres = PH.solve_heat(pp, t_final, dt, PH.HeatConfig(**cfg),
                         n_steps=n_steps, device="cpu")
    return jp, jres, pres


def _rel_state(pres, jres, grid):
    ju = interop.field_from_jax(np.asarray(jres.u), grid).to(torch.float64)
    return (pres.u.to(torch.float64) - ju).abs().max().item() / \
        ju.abs().max().item()


def _same_schedule(pres, jres):
    assert pres.steps == jres.steps
    assert pres.t == jres.t
    np.testing.assert_allclose(pres.dt_history, jres.dt_history,
                               rtol=DT_RTOL, atol=0)


# ---------------------------------------------------------------------------
# sources, exact solutions, initial states, shifts


def _ulps(got, ref):
    """max|got - ref| in ulps of the largest |ref| (the field's scale)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    scale = np.max(np.abs(ref))
    if scale == 0:
        return np.inf if np.any(got) else 0.0
    return float(np.max(np.abs(got - ref)) / np.spacing(scale))


def test_transcendentals_within_one_ulp():
    """sin, cos and exp of the float32 and float64 meshes, elementwise:
    XLA's and torch's differ by at most 1 ulp."""
    g = T.Grid(33, 33)
    for dt in (np.float32, np.float64):
        X = np.asarray(g.coordinates()[0], dt) * dt(np.pi)
        for jf, tf in ((jnp.sin, torch.sin), (jnp.cos, torch.cos),
                       (jnp.exp, torch.exp)):
            ref = np.asarray(jf(X))
            got = tf(torch.from_numpy(X)).numpy()
            big = np.maximum(np.abs(ref), np.abs(got))
            assert np.all(np.abs(got - ref) <= np.spacing(big))


@pytest.mark.parametrize("name", list(JHP.CATALOGUE))
def test_sources_and_states_match_jax(name):
    """q at two times on float32 meshes (cast to float32, as a step casts
    it), exact on float64 meshes and on float32 ones (a float64 product,
    as in JAX), u0 and the float32 initial state with its t=0 Dirichlet
    ring: within ULPS ulps of the field's largest value at 33^2 (a product
    of two or three transcendentals, each within 1 ulp; measured <= 3)."""
    n = 33
    jp, pp = JHP.CATALOGUE[name](n), PHP.CATALOGUE[name](n)
    assert pp.name == jp.name and pp.spec == interop.spec_from_jax(jp.spec)
    assert (pp.q is None) == (jp.q is None)
    assert (pp.dirichlet is None) == (jp.dirichlet is None)
    g = pp.grid
    jX32, jY32 = jp.mesh(jnp.float32)
    jX64, jY64 = jp.mesh(jnp.float64)
    pX32, pY32 = pp.mesh(torch.float32)
    pX64, pY64 = pp.mesh(torch.float64)

    def logical(a):
        return np.asarray(a)[: g.nx, : g.ny]

    for t in (0.0125, 0.3):
        jt = jnp.asarray(t, jnp.float64)
        if jp.q is not None:
            assert _ulps(pp.q(pX32, pY32, PH._time(t)).to(torch.float32),
                         logical(jp.q(jX32, jY32, jt).astype(jnp.float32))
                         ) <= ULPS
        for (pX, pY), (jX, jY), dt in (
                ((pX64, pY64), (jX64, jY64), np.float64),
                ((pX32, pY32), (jX32, jY32), np.float32)):
            got = pp.exact(pX, pY, PH._time(t))
            ref = jp.exact(jX, jY, jt)
            # a float32 mesh times a float64 time factor is float64; its
            # ulps are counted in float32, where a step uses it
            assert str(got.dtype) == f"torch.{ref.dtype}"
            assert _ulps(got.expand(g.shape).numpy().astype(dt),
                         logical(ref).astype(dt)) <= ULPS
    assert _ulps(pp.u0, logical(jp.u0)) <= ULPS
    assert _ulps(pp.initial_state(torch.float32),
                 logical(jp.initial_state(jnp.float32))) <= ULPS


@pytest.mark.parametrize("scheme", ["crank_nicolson", "theta", "bdf2"])
def test_fp32_shift_bit_equal(scheme):
    """One float32 step's lam (theta-method, variable-step BDF2 with its
    ratio r) and every level's c + lam, scalar and coefficient-plane
    levels: bit for bit the JAX package's."""
    alpha, dt, dt_prev, th = 1.3, 1e-4, 0.7e-4, 0.7
    f32 = jnp.float32
    dt_ = jnp.asarray(dt, jnp.float64).astype(f32)
    if scheme == "bdf2":
        r = (jnp.asarray(dt, jnp.float64)
             / jnp.asarray(dt_prev, jnp.float64)).astype(f32)
        jlam = (1.0 + 2.0 * r) / ((1.0 + r) * alpha * dt_)
        plam, pr = PH.bdf2_shift(alpha, dt, dt_prev, torch.float32)
        assert pr.item() == float(r)
    else:
        theta = 0.5 if scheme == "crank_nicolson" else th
        jlam = 1.0 / (alpha * theta * dt_)
        plam = PH.theta_shift(alpha, theta, dt, torch.float32)
    assert plam.dtype == torch.float32 and jlam.dtype == f32
    assert plam.item() == float(jlam)
    for name in ("pure_diffusion", "neumann_heat"):
        jp, pp = JHP.CATALOGUE[name](N), PHP.CATALOGUE[name](N)
        jl = jmg.build_hierarchy(jp.grid, jp.spec, dtype="float32")
        pl = T.build_hierarchy(pp.grid, pp.spec, dtype="float32",
                               device="cpu")
        unknown = pl[0].unknown
        js, ps = JH.shift_hierarchy(jl, jlam), PH.shift_hierarchy(pl, plam)
        assert ps[0].unknown is unknown  # the cached mask is carried
        for jlev, plev in zip(js, ps):
            jc = np.asarray(jlev.stencil.c)
            if np.ndim(jc) == 0:
                assert plev.stencil.c == float(jc)
            else:
                got = plev.stencil.c.numpy()
                assert np.array_equal(got, jc[: got.shape[0],
                                              : got.shape[1]])


# ---------------------------------------------------------------------------
# whole runs against the JAX package


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_fp64_schemes_match_jax(scheme):
    """Every scheme in float64 on the oscillating problem (a source at t
    and t + dt) at 17^2: the state within 1e-8, the same steps, t and
    dt_history; backward Euler's snapshots (save_every=2) too."""
    extra = SCHEMES[scheme]
    if scheme == "explicit":
        limit = PH.stability_limit_dt(T.Grid(N, N), 1.0)
        t_final, dt = 10 * 0.9 * limit, None
    else:
        t_final, dt = 0.02, 0.002
    jp, jres, pres = _solve_both("oscillating", t_final, dt, scheme=scheme,
                                 dtype="float64", **extra)
    _same_schedule(pres, jres)
    assert _rel_state(pres, jres, T.Grid(N, N)) <= F64_RTOL
    assert abs(pres.errors["l2"] / jres.errors["l2"] - 1) <= F64_RTOL
    if extra.get("save_every"):
        assert len(pres.saved) == len(jres.saved) == 5
        for (tp, up), (tj, uj) in zip(pres.saved, jres.saved):
            assert tp == tj
            ref = np.asarray(uj)[:N, :N]
            assert np.max(np.abs(up - ref)) <= F64_RTOL * np.max(np.abs(ref))
        np.testing.assert_array_equal(pres.saved[-1][1], pres.u.numpy())


@pytest.mark.parametrize("scheme", ["crank_nicolson", "bdf2"])
def test_fp32_schemes_match_jax(scheme):
    """Crank-Nicolson and BDF2 in float32 (the default HeatConfig): the
    states within 1e-6 of max|u|, the l2 errors within 1e-3."""
    jp, jres, pres = _solve_both("oscillating", 0.02, 0.002, scheme=scheme)
    assert pres.u.dtype == torch.float32
    _same_schedule(pres, jres)
    assert _rel_state(pres, jres, T.Grid(N, N)) <= F32_STATE_RTOL
    assert abs(pres.errors["l2"] / jres.errors["l2"] - 1) <= F32_L2_RTOL


@pytest.mark.parametrize("name", ["neumann_heat", "time_dependent_bc",
                                  "heat_source", "varcoef"])
def test_fp64_problems_match_jax(name):
    """Crank-Nicolson in float64 on Neumann sides, time-dependent
    Dirichlet data, a source and a = 1 + x + y: state within 1e-8."""
    jp, jres, pres = _solve_both(name, 0.01, 0.002, dtype="float64")
    _same_schedule(pres, jres)
    assert _rel_state(pres, jres, T.Grid(N, N)) <= F64_RTOL
    if jres.errors is not None:
        # the l2 difference is at most the states' (time_dependent_bc's
        # error is round-off, 3e-11, so no relative bound holds there)
        scale = pres.u.abs().max().item()
        assert abs(pres.errors["l2"] - jres.errors["l2"]) <= F64_RTOL * scale


@pytest.mark.parametrize("scheme", ["crank_nicolson", "bdf2"])
def test_adaptive_fp64_matches_jax(scheme):
    """Step-doubling control in float64 (BDF2: a CN bootstrap, then
    variable steps): the same accepted count and dt_history (1e-9), the
    state within 1e-8. Two cycles per step (step_rtol=0), which halves
    JAX's compile of the three-step trial; the fixed-dt tests hold the
    extra-cycle loop."""
    jp, jres, pres = _solve_both(
        "oscillating", 0.1, 0.02, scheme=scheme, dtype="float64",
        adaptive_dt=True, dt_tol=1e-5, step_rtol=0.0)
    assert pres.steps == jres.steps >= 5
    assert len(pres.dt_history) == pres.steps
    np.testing.assert_allclose(pres.dt_history, jres.dt_history,
                               rtol=ADAPTIVE_DT_RTOL, atol=0)
    assert pres.t == pytest.approx(jres.t, abs=1e-14)
    assert _rel_state(pres, jres, T.Grid(N, N)) <= F64_RTOL


def test_adaptive_fp32_reaches_t_final():
    """A float32 adaptive run reaches t_final; its controller follows
    rounding noise, so nothing else is compared."""
    res = PH.solve_heat(PHP.oscillating(N), 0.1, 0.02,
                        PH.HeatConfig(adaptive_dt=True, dt_tol=1e-5),
                        device="cpu")
    assert res.t == pytest.approx(0.1, abs=1e-10)
    assert res.dt_history.size == res.steps >= 5
    assert res.u.dtype == torch.float32 and torch.isfinite(res.u).all()


# ---------------------------------------------------------------------------
# the port's own behaviour


def _count_cycles(monkeypatch):
    count = [0]
    real = tmg.mg_cycle

    def counting(*a, **k):
        count[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(tmg, "mg_cycle", counting)
    return count


def test_fp32_step_runs_every_cycle(monkeypatch):
    """A default float32 step cannot reach step_rtol 1e-9, so it runs all
    max_cycles_per_step = 12 cycles (10 of them tested on the host first);
    a float64 step stops early, and step_rtol=0 runs cycles_per_step."""
    count = _count_cycles(monkeypatch)
    PH.solve_heat(PHP.pure_diffusion(33), 0.001, n_steps=3, device="cpu")
    assert count[0] == 3 * 12
    count[0] = 0
    PH.solve_heat(PHP.pure_diffusion(33), 0.001, n_steps=3,
                  cfg=PH.HeatConfig(dtype="float64"), device="cpu")
    assert 3 * 2 < count[0] < 3 * 12
    count[0] = 0
    PH.solve_heat(PHP.pure_diffusion(33), 0.001, n_steps=3,
                  cfg=PH.HeatConfig(step_rtol=0.0), device="cpu")
    assert count[0] == 3 * 2


def _recorders(monkeypatch, calls):
    """Every 2D kernel wrapper replaced by a call of itself (its twin on
    CPU tensors) that records its name."""
    wrapped = ((ksmooth, ("multisweep",)), (ksmooth_var, ("multisweep_var",)),
               (ktransfer, ("residual_restrict", "residual_restrict_var",
                            "prolong_correct")),
               (ktail, ("tail_vcycle", "tail_vcycle_var")))
    for mod, names in wrapped:
        for name in names:
            real = getattr(mod, name)

            def record(*a, _real=real, _name=name, **k):
                calls.append(_name)
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, record)


@pytest.mark.parametrize("name,per_cycle", [
    ("pure_diffusion", {"multisweep": 2, "residual_restrict": 1,
                        "prolong_correct": 1, "tail_vcycle": 1}),
    ("varcoef", {"multisweep_var": 2, "residual_restrict_var": 1,
                 "prolong_correct": 1, "tail_vcycle_var": 1}),
    ("neumann_heat", {"residual_restrict_var": 7, "prolong_correct": 7}),
])
def test_fp32_shifted_steps_reach_the_kernel_wrappers(monkeypatch, name,
                                                      per_cycle):
    """A float32 step on the shifted hierarchy at 257^2 with backend
    'auto' goes through the wrappers the card launches: A, B, C on level 0
    and D from 129^2 (Dirichlet, constant coefficients); H, I, C and J
    (a = 1 + x + y); I and C on every level, no smoothing or tail kernel
    (Neumann sides). Two fixed cycles per step (step_rtol=0)."""
    calls = []
    _recorders(monkeypatch, calls)
    if name == "varcoef":
        prob = _varcoef(False, n=257)
    else:
        prob = PHP.CATALOGUE[name](257)
    PH.solve_heat(prob, 1e-4, n_steps=1, device="cpu",
                  cfg=PH.HeatConfig(step_rtol=0.0))
    assert collections.Counter(calls) == {k: 2 * v
                                          for k, v in per_cycle.items()}


def test_unequal_bdf2_steps_exact_on_quadratics():
    """Variable-step BDF2 (r = 2.5) is exact on a solution quadratic in
    time and space, so any coefficient error shows directly."""

    def exact(X, Y, t):
        return (X**2 + Y**2) * (1 + t + t * t)

    def q(X, Y, t):
        return (X**2 + Y**2) * (1 + 2 * t) - 4 * (1 + t + t * t)

    prob = PH.heat_problem_from_callables("quad_quad", T.Grid(33, 33),
                                          exact=exact, q=q)
    cfg = PH.HeatConfig(scheme="bdf2", dtype="float64", step_rtol=1e-12,
                        max_cycles_per_step=30)
    levels0 = T.build_hierarchy(prob.grid, dtype="float64", device="cpu",
                                cfg=cfg.mg)
    step = PH.make_step_fn(prob, levels0, cfg)
    X, Y = prob.mesh(torch.float64)
    t0, dt_prev, dt = 0.1, 0.02, 0.05
    u_prev = exact(X, Y, torch.tensor(t0, dtype=torch.float64))
    u = exact(X, Y, torch.tensor(t0 + dt_prev, dtype=torch.float64))
    before = (u_prev.clone(), u.clone())
    got = step(u_prev, u, t0 + dt_prev, dt, dt_prev)
    want = exact(X, Y, torch.tensor(t0 + dt_prev + dt, dtype=torch.float64))
    assert (got - want).abs().max().item() <= 1e-9
    # the step never writes into its inputs
    assert torch.equal(u_prev, before[0]) and torch.equal(u, before[1])


def test_explicit_stability_guard():
    prob = PHP.pure_diffusion(N)
    limit = PH.stability_limit_dt(prob.grid, prob.alpha)
    with pytest.raises(ValueError, match="stability limit"):
        PH.solve_heat(prob, 0.1, 10 * limit,
                      PH.HeatConfig(scheme="explicit"), device="cpu")


def test_unported_options_raise():
    prob = PHP.pure_diffusion(N)
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        PH.solve_heat(prob, 0.01, 0.001, mesh=object(), device="cpu")
    levels = T.build_hierarchy(prob.grid, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        PH.make_step_fn(prob, levels, PH.HeatConfig(), constrain=object())


def test_default_device_is_the_card():
    """device=None means the card: without one the solver raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PH.solve_heat(PHP.pure_diffusion(N), 0.01, 0.001)


# ---------------------------------------------------------------------------
# checkpoint/resume (the JAX package's TestCheckpointResume, in the port)


def _ck_cfg(scheme="crank_nicolson", **kw):
    return PH.HeatConfig(scheme=scheme, dtype="float64", **kw)


def _heat(t_final, n_steps, cfg, **kw):
    return PH.solve_heat(PHP.pure_diffusion(N), t_final, n_steps=n_steps,
                         cfg=cfg, device="cpu", **kw)


@pytest.mark.parametrize("scheme,first,every", [
    ("crank_nicolson", (0.01, 5, 5), 5),
    ("bdf2", (0.008, 4, 2), 3),
])
def test_resume_matches_uninterrupted(tmp_path, scheme, first, every):
    """A run stopped after its first checkpoint chunk(s) and resumed over
    the full horizon equals the uninterrupted run bit for bit (BDF2 keeps
    its two-step history)."""
    ref = _heat(0.02, 10, _ck_cfg(scheme))
    ck = CheckpointManager(tmp_path / "ck")
    t1, n1, e1 = first
    _heat(t1, n1, _ck_cfg(scheme), checkpoint=ck, checkpoint_every=e1)
    assert ck.latest_step() == n1
    res = _heat(0.02, 10, _ck_cfg(scheme), checkpoint=ck,
                checkpoint_every=every)
    assert ck.latest_step() == 10
    assert res.t == pytest.approx(0.02, abs=1e-12)
    assert torch.equal(res.u, ref.u)


@pytest.mark.parametrize("n_steps,scheme,match", [
    (7, "crank_nicolson", "dt"), (10, "backward_euler", "scheme")])
def test_checkpoint_mismatch_rejected(tmp_path, n_steps, scheme, match):
    """Resuming with another dt or scheme than the checkpoint's raises."""
    ck = CheckpointManager(tmp_path / "ck")
    _heat(0.01, 5, _ck_cfg(), checkpoint=ck)
    with pytest.raises(ValueError, match=match):
        _heat(0.02, n_steps, _ck_cfg(scheme), checkpoint=ck)


def test_save_every_alignment_enforced(tmp_path):
    ck = CheckpointManager(tmp_path / "ck")
    with pytest.raises(ValueError, match="multiple of save_every"):
        _heat(0.02, 10, _ck_cfg(save_every=2), checkpoint=ck,
              checkpoint_every=5)


def test_save_every_across_chunks(tmp_path):
    cfg = _ck_cfg(save_every=2)
    ref = _heat(0.02, 10, cfg)
    res = _heat(0.02, 10, cfg, checkpoint=CheckpointManager(tmp_path / "ck"),
                checkpoint_every=4)
    assert len(res.saved) == len(ref.saved) == 5
    for (ta, ua), (tb, ub) in zip(res.saved, ref.saved):
        assert ta == pytest.approx(tb)
        np.testing.assert_array_equal(ua, ub)


def test_checkpoint_manager_files(tmp_path):
    """File names, keep-last-k retention, a stray temp file ignored,
    tensors copied to the host, the metadata record."""
    ck = CheckpointManager(tmp_path / "ck", keep_last=2)
    (ck.dir / ".ckpt_000000000009.npz.tmp").write_bytes(b"partial")
    (ck.dir / "ckpt_notes.npz").write_bytes(b"")
    u = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for step in (1, 2, 3):
        path = ck.save(step, {"u": u * step}, {"t": 0.5 * step})
        assert path.name == f"ckpt_{step:012d}.npz"
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    arrays, meta = ck.restore()
    np.testing.assert_array_equal(arrays["u"], (3 * u).numpy())
    assert arrays["u"].dtype == np.float32
    assert meta["t"] == 1.5 and meta["step"] == 3
    json.dumps(meta)
    arrays, meta = ck.restore(2)
    assert meta["step"] == 2
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


# ---------------------------------------------------------------------------
# interop


def test_heat_config_from_jax():
    jcfg = JH.HeatConfig(scheme="theta", theta=0.7, dtype="float64",
                         cycles_per_step=3, save_every=2, adaptive_dt=True,
                         mg=jmg.MultigridConfig(smoother="rbgs", omega=1.0,
                                                backend="xla"))
    pcfg = interop.heat_config_from_jax(jcfg)
    assert pcfg == PH.HeatConfig(
        scheme="theta", theta=0.7, dtype=torch.float64, cycles_per_step=3,
        save_every=2, adaptive_dt=True,
        mg=T.MultigridConfig(smoother="rbgs", omega=1.0, backend="torch"))
    assert pcfg.order == 1 and pcfg.effective_theta == 0.7
    assert math.isinf(pcfg.dt_max)


@pytest.mark.parametrize("name", sorted(PHP.BY_NAME))
def test_heat_problem_from_jax(name):
    """Each of the eleven problem names maps onto the port's catalogue;
    u0 comes across at its logical shape."""
    jp = JHP.CATALOGUE[PHP.BY_NAME[name]](N, alpha=1.5)
    pp = interop.heat_problem_from_jax(jp)
    assert pp.name == jp.name == name and pp.alpha == 1.5
    np.testing.assert_array_equal(pp.u0, np.asarray(jp.u0)[:N, :N])
    ref = PHP.CATALOGUE[PHP.BY_NAME[name]](N, alpha=1.5)
    assert _ulps(pp.u0, ref.u0) <= ULPS


def test_heat_problem_from_jax_refuses_unknown_names():
    with pytest.raises(ValueError, match="heat_varcoef"):
        interop.heat_problem_from_jax(_varcoef(True))
