"""The port's variable-coefficient and Neumann/Robin path against the JAX
package, on the CPU.

Inputs are numpy arrays from a seed (or the same problem built by both
packages); fields are compared on the logical (nx, ny) region.

Tolerances, each with its reason:

- masks, stencil planes, ``bc_rhs_correction``, residuals, the three
  smoothers, the reflect restriction and the hierarchy's coarse planes: bit
  for bit. Both packages run the same IEEE operations in the same order,
  and JAX runs them one by one outside ``jit``.
- the kernel twins against the Pallas kernels in interpret mode: 2e-6
  relative to the largest reference value. The Pallas bodies multiply by
  1/c (c forced to 1 off the unknowns) where the twins divide, restrict
  separably where the twins sum centre, edges and corners, and interpolate
  in two half-weight passes; the tail chains about a hundred such steps
  (1e-5 there).
- whole solves: equal outer-step counts and convergence, l2 within 1%,
  residual histories within 0.5%. One V-cycle of the port equals the JAX
  cycle run op by op bit for bit (tested below); the JAX solve runs its
  cycles inside one ``jit``, where XLA fuses them and rounds differently in
  the last bit, and the fp32 inner cycles carry that into the history
  (0.2% at most at 129^2).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    poisson as jpoisson,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (  # noqa: E402
    bc as jbc,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (  # noqa: E402
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    norms as jnorms,
    smooth as jsmooth,
    stencil as jst,
    transfer as jtransfer,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.pallas_kernels import (  # noqa: E402
    smooth as psmooth,
    tail as ptail,
    transfer as ptransfer,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid as jmg,
)
import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    dispatch,
    norms,
    smooth,
    stencil,
    transfer,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth as ksmooth,
    smooth_var as ksmooth_var,
    tail as ktail,
    transfer as ktransfer,
)

KERNEL_TOL = 2e-6
MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
ROBIN = dict(alpha=1.0, beta=1.0)


def _specs(name):
    """(JAX spec, port spec) for a side set."""
    if name == "dirichlet":
        return jbc.dirichlet(), bc.dirichlet()
    if name == "east_neumann":
        return jbc.mixed(east="neumann"), bc.mixed(east="neumann")
    if name == "south_robin":
        return (jbc.BoundarySpec(south=jbc.BCSide(jbc.BCKind.ROBIN, **ROBIN)),
                bc.BoundarySpec(south=bc.BCSide(bc.BCKind.ROBIN, **ROBIN)))
    if name == "west_north_neumann":
        return (jbc.mixed(west="neumann", north="neumann"),
                bc.mixed(west="neumann", north="neumann"))
    raise ValueError(name)


SIDE_SETS = ["east_neumann", "south_robin", "west_north_neumann"]


def _coef(n, kind="smooth"):
    """A coefficient field on an n^2 unit-square grid (float64 numpy)."""
    X, Y = T.Grid(n, n).coordinates()
    if kind == "jump":
        return np.where(X < 0.5, 1.0, 1e3)
    return 1.0 + X + Y


def _field(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _jax(a, n):
    return jnp.asarray(interop.field_to_jax_layout(torch.from_numpy(a),
                                                   JGrid(n, n)))


def _logical(x, n):
    return np.asarray(x)[:n, :n]


def _stencils(n, spec_name, a_kind="smooth", dtype="float32", lam=0.0):
    jspec, spec = _specs(spec_name)
    np_dt, t_dt = DTYPES[dtype]
    a = _coef(n, a_kind) if a_kind else None
    ja = None if a is None else interop.field_to_jax_layout(
        torch.from_numpy(a), JGrid(n, n))
    jlam = lam if np.ndim(lam) == 0 else interop.field_to_jax_layout(
        torch.from_numpy(lam), JGrid(n, n))
    jstc = jst.make_stencil(JGrid(n, n), jspec, a=ja, lam=jlam, dtype=np_dt)
    st = stencil.make_stencil(T.Grid(n, n), spec, a=a, lam=lam, dtype=t_dt)
    return jspec, spec, jstc, st


def _scaled_close(got, ref, tol=KERNEL_TOL):
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(ref) / scale, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# core/bc.py and ops/stencil.py


@pytest.mark.parametrize("side_set", SIDE_SETS)
def test_unknown_mask_matches_jax(side_set):
    n = 17
    jspec, spec = _specs(side_set)
    ref = jbc.unknown_mask(n, n, JGrid(n, n).shape_padded, jspec)
    got = bc.unknown_mask(n, n, spec)
    assert np.array_equal(got.numpy(), _logical(ref, n))
    if side_set == "south_robin":
        # Dirichlet claims the corners of the Robin side
        assert not got[0, 0] and not got[-1, 0] and got[1:-1, 0].all()
    assert bc.unknown_mask(n, n).sum() == (n - 2) ** 2
    all_neumann = jbc.unknown_mask(n, n, JGrid(n, n).shape_padded,
                                   jbc.neumann())
    assert np.array_equal(bc.unknown_mask(n, n, bc.neumann()).numpy(),
                          _logical(all_neumann, n))


@pytest.mark.parametrize("side_set", ["dirichlet"] + SIDE_SETS)
def test_spec_properties_side_regions_and_logical_mask_match_jax(side_set):
    n = 17
    jspec, spec = _specs(side_set)
    pshape = JGrid(n, n).shape_padded
    for prop in ("all_dirichlet", "any_periodic", "any_segments", "plain"):
        assert getattr(spec, prop) == getattr(jspec, prop), prop
    for name in bc.SIDES:
        ref = jbc.side_regions(name, n, n, pshape, jspec.side(name))
        got = bc.side_regions(name, n, n, spec.side(name))
        assert len(got) == len(ref) == 1
        (side, mask), (jside, jmask) = got[0], ref[0]
        assert (side.kind.value, side.alpha, side.beta) == \
            (jside.kind.value, jside.alpha, jside.beta)
        assert np.array_equal(mask.numpy(), _logical(jmask, n))
        assert not np.asarray(jmask)[n:].any()
    ref = jbc.logical_mask(n, n, pshape)
    assert np.array_equal(bc.logical_mask(n, n).numpy(), _logical(ref, n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["varcoef", "jump", "robin", "array_lam",
                                  "neumann_jump"])
def test_make_stencil_and_rhs_correction_match_jax(case, dtype):
    n = 33
    lam = 0.0
    spec_name, a_kind = {"varcoef": ("dirichlet", "smooth"),
                         "jump": ("dirichlet", "jump"),
                         "robin": ("south_robin", None),
                         "array_lam": ("dirichlet", "smooth"),
                         "neumann_jump": ("west_north_neumann", "jump")}[case]
    if case == "array_lam":
        lam = 1.0 + _coef(n) ** 2
    jspec, spec, jstc, st = _stencils(n, spec_name, a_kind, dtype, lam)
    assert not st.scalar
    for k in "cwesn":
        assert np.array_equal(getattr(st, k).numpy(),
                              _logical(getattr(jstc, k), n)), k
    np_dt, t_dt = DTYPES[dtype]
    g_south = _coef(n) * 3.0
    values = {"south": g_south, "west": 0.5, "north": -2.0}
    ref = jst.bc_rhs_correction(
        JGrid(n, n), jspec,
        {k: interop.field_to_jax_layout(torch.from_numpy(v), JGrid(n, n))
         if np.ndim(v) else v for k, v in values.items()}, dtype=np_dt)
    got = stencil.bc_rhs_correction(T.Grid(n, n), spec, values, t_dt)
    assert np.array_equal(got.numpy(), _logical(ref, n))


@pytest.mark.parametrize("method", ["rbgs", "rbgs_rev", "jacobi"])
@pytest.mark.parametrize("side_set", ["dirichlet"] + SIDE_SETS)
def test_residual_and_smoothers_match_jax(side_set, method):
    """Ring unknowns of Neumann/Robin sides are updated too, bit for bit."""
    n = 33
    jspec, spec, jstc, st = _stencils(
        n, side_set, "jump" if side_set == "east_neumann" else "smooth")
    u, f = _field((n, n), 1), _field((n, n), 2, 50.0)
    unknown = bc.unknown_mask(n, n, spec)
    junknown = jbc.unknown_mask(n, n, JGrid(n, n).shape_padded, jspec)
    ref_r = jst.residual(jstc, _jax(u, n), _jax(f, n), junknown)
    got_r = stencil.residual(st, torch.from_numpy(u), torch.from_numpy(f),
                             unknown)
    assert np.array_equal(got_r.numpy(), _logical(ref_r, n))
    omega = 0.8 if method == "jacobi" else 1.0
    ref = jsmooth.smooth(jstc, _jax(u, n), _jax(f, n), junknown,
                         method=method, sweeps=2, omega=omega)
    ut = torch.from_numpy(u.copy())
    got = smooth.smooth(st, ut, torch.from_numpy(f), unknown, method=method,
                        sweeps=2, omega=omega)
    assert got is ut
    assert np.array_equal(got.numpy(), _logical(ref, n))
    ring = unknown.numpy().copy()
    ring[1:-1, 1:-1] = False
    assert ring.any() == (side_set != "dirichlet")
    assert (got.numpy() != u)[ring].all()  # ring unknowns are smoothed


@pytest.mark.parametrize("side_set", SIDE_SETS)
def test_restrict_reflect_matches_jax(side_set):
    n = 33
    jspec, spec, jstc, st = _stencils(n, side_set)
    u, f = _field((n, n), 3), _field((n, n), 4, 50.0)
    r = stencil.residual(st, torch.from_numpy(u), torch.from_numpy(f),
                         bc.unknown_mask(n, n, spec))
    jgc = JGrid(n, n).coarsen()
    ref = jtransfer.restrict(_jax(r.numpy(), n), jgc.nx, jgc.ny,
                             jgc.shape_padded, boundary="reflect")
    got = transfer.restrict(r, jgc.nx, jgc.ny, boundary="reflect")
    assert np.array_equal(got.numpy(), _logical(ref, jgc.nx))
    assert got[0].any() and got[:, -1].any()  # the ring is restricted too


def test_h1_seminorm_matches_jax():
    n = 17
    e = _field((n, n), 5).astype(np.float64)
    mask = bc.unknown_mask(n, n, bc.mixed(east="neumann"))
    jmask = jbc.unknown_mask(n, n, JGrid(n, n).shape_padded,
                             jbc.mixed(east="neumann"))
    g = T.Grid(n, n)
    got = norms.h1_seminorm(torch.from_numpy(e), mask, g.hx, g.hy).item()
    ref = float(jnorms.h1_seminorm(_jax(e, n), jmask, g.hx, g.hy))
    np.testing.assert_allclose(got, ref, rtol=1e-13)


# ---------------------------------------------------------------------------
# the kernel twins against the Pallas kernels (interpret mode)


@pytest.mark.parametrize("method", ["jacobi", "rbgs"])
@pytest.mark.parametrize("layout", ["whole", "strips"])
def test_smooth_var_twin_matches_pallas(layout, method):
    n = 65
    _, _, jstc, st = _stencils(n, "dirichlet", "jump")
    u, f = _field((n, n), 6), _field((n, n), 7, 1e3)
    u[[0, -1], :] = 0.0
    u[:, [0, -1]] = 0.0
    omega = 0.8 if method == "jacobi" else 1.0
    kw = dict(nx=n, ny=n, method=method, sweeps=2, omega=omega,
              interpret=True)
    if layout == "whole":
        ref = psmooth.multisweep(jstc, _jax(u, n), _jax(f, n), **kw)
    else:
        ref = psmooth.multisweep_strips(jstc, _jax(u, n), _jax(f, n),
                                        strip=16, **kw)
    got = ksmooth_var.multisweep_var(st, torch.from_numpy(u.copy()),
                                     torch.from_numpy(f), method=method,
                                     sweeps=2, omega=omega)
    _scaled_close(got.numpy(), _logical(ref, n))


@pytest.mark.parametrize("side_set", ["dirichlet"] + SIDE_SETS)
def test_transfer_twins_match_pallas_with_sides(side_set):
    """I's twin and C's twin (with the per-side flags) against the Pallas
    residual_restrict and prolong_correct given the same ``sides``."""
    n = 65
    jspec, spec, jstc, st = _stencils(n, side_set, "smooth")
    sides = spec.dirichlet_sides
    assert sides == tuple(jspec.side(s).kind == jbc.BCKind.DIRICHLET
                          for s in jbc.SIDES)
    g, jg = T.Grid(n, n), JGrid(n, n)
    gc, jgc = g.coarsen(), jg.coarsen()
    u, f = _field(g.shape, 8), _field(g.shape, 9, 50.0)
    ref = ptransfer.residual_restrict(
        jstc, _jax(u, n), _jax(f, n), nxf=n, nyf=n, ncx=gc.nx, ncy=gc.ny,
        pshape_coarse=jgc.shape_padded, sides=sides, interpret=True)
    got = ktransfer.residual_restrict_var(st, torch.from_numpy(u),
                                          torch.from_numpy(f), sides=sides)
    _scaled_close(got.numpy(), _logical(ref, gc.nx))
    coarse_unknown = bc.unknown_mask(gc.nx, gc.ny, spec).numpy()
    assert not got.numpy()[~coarse_unknown].any()

    ec = _field(gc.shape, 10) * coarse_unknown
    ref_u = ptransfer.prolong_correct(_jax(ec, gc.nx), _jax(u, n), ncx=gc.nx,
                                      ncy=gc.ny, nxf=n, nyf=n, sides=sides,
                                      interpret=True)
    ut = torch.from_numpy(u.copy())
    got_u = ktransfer.prolong_correct(torch.from_numpy(ec), ut, sides=sides)
    assert got_u is ut
    np.testing.assert_allclose(got_u.numpy(), _logical(ref_u, n), rtol=1e-6,
                               atol=1e-6)
    fixed = ~bc.unknown_mask(n, n, spec).numpy()
    assert np.array_equal(got_u.numpy()[fixed], u[fixed])


@pytest.mark.parametrize("symmetric", [False, True])
def test_tail_var_twin_matches_pallas(symmetric):
    """J's twin from a 65^2 entry (6 levels) on the jump coefficient."""
    sizes = [65, 33, 17, 9, 5, 3]
    a = _coef(65, "jump")
    sts, jsts = [], []
    for n in sizes:
        step = (65 - 1) // (n - 1)
        an = a[::step, ::step]
        sts.append(stencil.make_stencil(T.Grid(n, n), a=an))
        jsts.append(jst.make_stencil(
            JGrid(n, n), a=interop.field_to_jax_layout(torch.from_numpy(an),
                                                       JGrid(n, n))))
    meta = tuple((n, n) + JGrid(n, n).shape_padded for n in sizes)
    u, f = np.zeros((65, 65), np.float32), _field((65, 65), 11, 1e3)
    kw = dict(pre=2, post=2, omega=1.0, method="rbgs", coarse_sweeps=32,
              symmetric=symmetric)
    ref = ptail.tail_vcycle_var(jsts, _jax(u, 65), _jax(f, 65), meta=meta,
                                interpret=True, **kw)
    got = ktail.tail_vcycle_var(sts, torch.from_numpy(u), torch.from_numpy(f),
                                shapes=[(n, n) for n in sizes], **kw)
    _scaled_close(got.numpy(), _logical(ref, 65), tol=1e-5)


# ---------------------------------------------------------------------------
# the hierarchy, one cycle, and whole solves


def _hierarchies(jp, dtype="float32", backend="torch"):
    tp = interop.problem_from_jax(jp)
    np_dt, t_dt = DTYPES[dtype]
    jcfg = jmg.MultigridConfig(backend="xla", **MAIN)
    jl = jmg.build_hierarchy(jp.grid, jp.spec, a=jp.a, lam=jp.lam,
                             dtype=np_dt, cfg=jcfg)
    cfg = T.MultigridConfig(backend=backend, **MAIN)
    tl = T.build_hierarchy(tp.grid, tp.spec, a=tp.a, lam=tp.lam, dtype=t_dt,
                           cfg=cfg, device="cpu")
    return tp, jl, tl, jcfg, cfg


@pytest.mark.parametrize("problem", ["varcoef", "robin"])
def test_build_hierarchy_and_one_cycle_match_jax(problem):
    """Coarse planes (injection-sampled a, rebuilt operator) bit for bit,
    and one V(2,2) cycle bit for bit against the JAX cycle run op by op."""
    n = 33
    jp = (JP.variable_coefficient_mms(n) if problem == "varcoef"
          else JP.robin_test_problem(n))
    tp, jl, tl, jcfg, cfg = _hierarchies(jp)
    assert [lev.grid.nx for lev in tl] == [33, 17, 9, 5, 3]
    for jlev, lev in zip(jl, tl):
        m = lev.grid.nx
        for k in "cwesn":
            assert np.array_equal(getattr(lev.stencil, k).numpy(),
                                  _logical(getattr(jlev.stencil, k), m))
    assert interop.levels_from_jax(jl)[2].spec == tl[2].spec
    f = jp.rhs(jnp.float32)
    ref = jmg.mg_cycle(jl, jnp.zeros_like(f), f, jcfg)
    got = T.mg_cycle(tl, torch.zeros(n, n), tp.rhs(torch.float32), cfg)
    assert np.array_equal(got.numpy(), _logical(ref, n))


PROBLEMS = {
    "varcoef": (JP.variable_coefficient_mms, T.variable_coefficient_mms),
    "jump": (lambda n: JP.jump_coefficient_problem(n, 1e3),
             lambda n: T.jump_coefficient_problem(n, 1e3)),
    "robin": (JP.robin_test_problem, T.robin_test_problem),
}
EXPECTED_STEPS = {65: {"varcoef": 4, "jump": 9, "robin": 4},
                  129: {"varcoef": 4, "jump": 10, "robin": 4}}


@pytest.mark.parametrize("n", [65, 129])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_solve_poisson_fp32_matches_jax(problem, n):
    jfac, tfac = PROBLEMS[problem]
    jcfg = jmg.MultigridConfig(backend="xla", **MAIN)
    ref = jpoisson.solve_poisson(jfac(n), precision="fp32", cfg=jcfg)
    prob = tfac(n)
    got = T.solve_poisson(prob, precision="fp32",
                          cfg=T.MultigridConfig(backend="auto", **MAIN),
                          device="cpu")
    assert got.info["method"] == "iterative_refinement"
    assert got.converged and ref.converged
    assert got.iterations == ref.iterations == EXPECTED_STEPS[n][problem]
    np.testing.assert_allclose(got.info["history"], ref.info["history"],
                               rtol=5e-3)
    if prob.exact is not None:
        for k in ("l2", "h1"):
            np.testing.assert_allclose(got.errors[k], ref.errors[k],
                                       rtol=0.01)
    assert tuple(got.u.shape) == (n, n) and got.u.dtype == torch.float64


def test_auto_backend_on_cpu_runs_the_twins_varcoef():
    """'auto' routes the new levels through H, I, C and J's wrappers, which
    run their plain twins for CPU tensors: identical result, no launch."""
    wrappers = (ksmooth_var.multisweep_var, ktransfer.residual_restrict_var,
                ktransfer.prolong_correct, ktail.tail_vcycle_var,
                ksmooth.multisweep)
    for w in wrappers:
        w.launches = 0
    for factory in (T.jump_coefficient_problem, T.robin_test_problem):
        prob = factory(33)
        out = {b: T.solve_poisson(prob, precision="fp32",
                                  cfg=T.MultigridConfig(backend=b, **MAIN),
                                  device="cpu")
               for b in ("auto", "torch")}
        assert torch.equal(out["auto"].u, out["torch"].u)
        assert out["auto"].info["history"].tolist() == \
            out["torch"].info["history"].tolist()
    assert [w.launches for w in wrappers] == [0] * len(wrappers)


def test_dispatch_routes_varcoef_levels(monkeypatch):
    cfg = T.MultigridConfig(**MAIN)
    var = T.build_hierarchy(T.Grid(257, 257), a=_coef(257), cfg=cfg,
                            device="cpu")
    robin = T.build_hierarchy(T.Grid(257, 257), _specs("south_robin")[1],
                              cfg=cfg, device="cpu")
    u = var[0].zeros()
    assert dispatch.kernel_smooth_ok(u, var[0], "auto", "rbgs")
    assert not dispatch.kernel_smooth_ok(u, robin[0], "auto", "rbgs")
    assert dispatch.transfer_fused_ok(var[0], var[1], cfg)
    assert dispatch.transfer_fused_ok(robin[0], robin[1], cfg)
    assert [dispatch.tail_ok(var, lvl, cfg, "V") for lvl in range(3)] == \
        [False, True, True]
    assert not any(dispatch.tail_ok(robin, lvl, cfg, "V")
                   for lvl in range(len(robin)))
    calls = []
    for mod, name in ((ksmooth_var, "multisweep_var"),
                      (ktransfer, "residual_restrict_var"),
                      (ktransfer, "prolong_correct"),
                      (ktail, "tail_vcycle_var")):
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls.append((_name, kw.get("sides")))
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    f = torch.ones(257, 257)
    T.mg_cycle(var, var[0].zeros(), f, cfg)
    assert {c[0] for c in calls} == {"multisweep_var", "residual_restrict_var",
                                     "prolong_correct", "tail_vcycle_var"}
    calls.clear()
    T.mg_cycle(robin, robin[0].zeros(), f, cfg)
    names = {c[0] for c in calls}
    assert names == {"residual_restrict_var", "prolong_correct"}
    assert all(c[1] == (True, True, False, True) for c in calls)


def test_neumann_problem_and_convergence_study():
    """The Neumann problem (quadratic u: the discretization is exact), and
    the fp64 ladder of the varcoef problem: second order."""
    res = T.solve_poisson(T.neumann_test_problem(33), precision="fp64",
                          cfg=T.MultigridConfig(smoother="rbgs", omega=1.0,
                                                tol=1e-12),
                          device="cpu")
    assert res.converged and res.errors["l2"] < 1e-9
    study = T.convergence_study(T.variable_coefficient_mms, [17, 33, 65],
                                device="cpu")
    assert study["converged"] and study["sizes"] == [17, 33, 65]
    assert abs(study["order_l2"] - 2.0) < 0.1
    assert all(abs(p - 2.0) < 0.1 for p in study["pairwise_orders"])


# ---------------------------------------------------------------------------
# interop and what is not ported


def test_interop_carries_varcoef_and_robin_state():
    n = 33
    for jp, tp in ((JP.robin_test_problem(n), T.robin_test_problem(n)),
                   (JP.variable_coefficient_mms(n),
                    T.variable_coefficient_mms(n))):
        got = interop.problem_from_jax(jp)
        assert got.spec == tp.spec
        for name in ("f", "a", "exact", "dirichlet_values"):
            a, b = getattr(got, name), getattr(tp, name)
            assert (a is None and b is None) or np.array_equal(a, b), name
        for dt in (jnp.float32, jnp.float64):
            t_dt = torch.float32 if dt == jnp.float32 else torch.float64
            assert np.array_equal(tp.rhs(t_dt).numpy(),
                                  _logical(jp.rhs(dt), n))
            assert np.array_equal(tp.initial_guess(t_dt).numpy(),
                                  _logical(jp.initial_guess(dt), n))
    jl = jmg.build_hierarchy(JGrid(n, n), jbc.mixed(east="neumann"),
                             dtype=jnp.float32)
    tl = interop.levels_from_jax(jl)
    assert tl[0].spec == bc.mixed(east="neumann")
    back = interop.field_to_jax_layout(tl[0].stencil.e, JGrid(n, n))
    assert back.shape == JGrid(n, n).shape_padded
    assert np.array_equal(back[:n, :n], _logical(jl[0].stencil.e, n))
    assert not back[n:].any() and not back[:, n:].any()


def test_unported_varcoef_features_raise():
    prob = T.variable_coefficient_mms(9)
    for precision in ("mixed", "bf16", "adaptive", "auto", object()):
        with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
            T.solve_poisson(prob, precision=precision, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        T.solve_poisson(prob, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        bc.mixed(west="periodic")
    seg = jbc.BoundarySpec(east=jbc.BCSide(
        segments=(jbc.BCSegment(0.5, 1.0, kind=jbc.BCKind.NEUMANN),)))
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        interop.spec_from_jax(seg)
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        bc.BCSide(segments=seg.east.segments)
    with pytest.raises(ValueError, match="beta"):
        bc.BCSide(bc.BCKind.ROBIN, alpha=1.0, beta=0.0)
    st = T.build_hierarchy(T.Grid(9, 9), device="cpu")[0].stencil
    u = torch.zeros(9, 9)
    with pytest.raises(ValueError, match="coefficient planes"):
        ksmooth_var.multisweep_var(st, u, u)
    with pytest.raises(ValueError, match="coefficient planes"):
        ktransfer.residual_restrict_var(st, u, u)
