"""The port's Galerkin coarsening and 9-point stencil against the JAX
package, on the CPU, and the kernel gates that keep both off the 2D
kernels.

Tolerances, each with its reason:

- coarse ``Stencil9`` coefficients of the float64 RAP chain: 1e-12 relative
  to the level's largest coefficient (the same nine comb phases of float64 prolong,
  apply and restrict; they agree bit for bit here). The float32 chain
  (``galerkin_dtype='float32'``): 1e-6 relative.
- ``Stencil9`` apply and residual in fp32: bit for bit against the JAX
  functions run op by op (eagerly), since both sum (w, e, s, n) and then the
  corners. Under ``jit`` XLA contracts multiply-adds into FMAs and the last
  bit differs.
- smoothers on a ``Stencil9`` level, fp64: 1e-12 relative (the line
  smoothers solve with PCR here and with LAPACK in the JAX package).
- fp64 ``mg_solve`` (V, W, ADI, FMG start): equal iteration counts and
  solutions within 1e-10 relative; fp32 and mixed (bf16 coarse levels)
  ``ir_solve`` (``solve_poisson``): equal outer-step counts and l2 errors
  (or, without an exact solution, solutions) within 2% (the JAX fp32
  cycles run in one ``jit``, which rounds differently; the fp64 outer loop
  stops both at the same relative residual).
- gates: a wrapper reached where the gates should refuse fails the test.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mixed_precision_multigrid_solvers_for_pdes_tpu as J  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    poisson as japp,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (  # noqa: E402
    bc as jbc,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    smooth as jsmooth,
    stencil as jst,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import (  # noqa: E402
    interop,
    preconditioning as tpc,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.core import (  # noqa: E402
    bc as tbc,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    dispatch,
    galerkin as tgk,
    smooth as tsmooth,
    stencil as tst,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth as ksmooth,
    smooth3d as ksmooth3d,
    smooth_planes as kplanes,
    smooth_var as ksmooth_var,
    tail as ktail,
    transfer as ktransfer,
    transfer3d as ktransfer3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.stencil import (  # noqa: E402
    Stencil9,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (  # noqa: E402
    multigrid as tmg,
    plane_solve,
)

MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-10)
GALERKIN = dict(MAIN, coarsening="galerkin")
# (problem, size): constant, jump, Neumann, segmented and L-shaped specs
SPECS = [("poisson_mms_sinsin", 17), ("jump_coefficient_problem", 33),
         ("neumann_test_problem", 17), ("mixed_segment_problem", 33),
         ("l_shaped_problem", 17)]


def _hierarchies(name, n, dtype="float64", **cfg):
    jprob = getattr(JP, name)(n)
    prob = interop.problem_from_jax(jprob)
    jl = J.build_hierarchy(jprob.grid, jprob.spec, a=jprob.a, lam=jprob.lam,
                           domain=jprob.domain, dtype=dtype,
                           cfg=J.MultigridConfig(**cfg))
    tl = T.build_hierarchy(prob.grid, prob.spec, a=prob.a, lam=prob.lam,
                           domain=prob.domain, dtype=dtype, device="cpu",
                           cfg=T.MultigridConfig(**cfg))
    return jprob, prob, jl, tl


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("name,n,galerkin_dtype,tol", [
    *((name, n, "float64", 1e-12) for name, n in SPECS),
    ("jump_coefficient_problem", 33, "float32", 1e-6)])
def test_coarse_stencils_match_jax(name, n, galerkin_dtype, tol):
    _, _, jl, tl = _hierarchies(name, n, galerkin_dtype=galerkin_dtype,
                                **GALERKIN)
    assert len(jl) == len(tl)
    assert type(tl[0].stencil).__name__ == "Stencil"
    for jlev, tlev in zip(jl[1:], tl[1:]):
        assert isinstance(tlev.stencil, Stencil9)
        want = interop.stencil_from_jax(jlev.stencil, jlev.grid)
        scale = max(x.abs().max().item() for x in want.coefs)
        for got, ref in zip(tlev.stencil.coefs, want.coefs):
            assert got.dtype == torch.float64
            assert (got - ref).abs().max().item() <= tol * scale


def test_rap_equals_the_composed_operator():
    """A_c e = R M A M P e for random coarse vectors (the comb extraction
    reproduces the composed operator)."""
    prob = T.variable_coefficient_mms(33)
    gf, gc = prob.grid, prob.grid.coarsen()
    st_f = tst.make_stencil(gf, prob.spec, a=prob.a, dtype=torch.float64)
    st_c = tgk.galerkin_coarse_stencil(st_f, gf, gc, prob.spec,
                                       device="cpu")
    unk_f = tbc.unknown_mask(gf.nx, gf.ny, prob.spec)
    unk_c = tbc.unknown_mask(gc.nx, gc.ny, prob.spec)
    rng = np.random.default_rng(0)
    for _ in range(3):
        ec = torch.where(unk_c, torch.from_numpy(
            rng.standard_normal(gc.shape)), 0.0)
        direct = torch.where(unk_c, tst.apply(st_c, ec), 0.0)
        ef = torch.where(unk_f, T.ops.transfer.prolong(ec, gf.nx, gf.ny),
                         0.0)
        ae = torch.where(unk_f, tst.apply(st_f, ef), 0.0)
        comp = torch.where(unk_c, T.ops.transfer.restrict(ae, gc.nx, gc.ny),
                           0.0)
        assert torch.allclose(direct, comp, rtol=1e-12, atol=1e-12)


def test_periodic_spec_is_refused():
    spec = tbc.mixed(west="periodic", east="periodic")
    prob = T.poisson_mms_sinsin(33)
    with pytest.raises(NotImplementedError):
        T.build_hierarchy(prob.grid, spec, dtype="float64", device="cpu",
                          cfg=T.MultigridConfig(**GALERKIN))
    st = tst.make_stencil(prob.grid, spec, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tgk.galerkin_coarse_stencil(st, prob.grid, prob.grid.coarsen(), spec,
                                    device="cpu")
    # the JAX package refuses it too
    jspec = jbc.mixed(west="periodic", east="periodic")
    with pytest.raises(NotImplementedError):
        J.build_hierarchy(JP.poisson_mms_sinsin(33).grid, jspec,
                          dtype="float64",
                          cfg=J.MultigridConfig(**GALERKIN))


def test_galerkin_hierarchy_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    prob = T.jump_coefficient_problem(33)
    with pytest.raises(RuntimeError):
        T.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                          cfg=T.MultigridConfig(**GALERKIN))


def _level_fields(jlev, seed, dtype):
    rng = np.random.default_rng(seed)
    shape = jlev.grid.shape_padded
    u = rng.standard_normal(shape).astype(dtype)
    f = rng.standard_normal(shape).astype(dtype)
    return u, f


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stencil9_apply_and_residual_bit_for_bit(dtype):
    _, _, jl, _ = _hierarchies("jump_coefficient_problem", 33, dtype=dtype,
                               **GALERKIN)
    for jlev in jl[1:3]:
        st = interop.stencil_from_jax(jlev.stencil, jlev.grid)
        assert st.c.dtype == getattr(torch, dtype)
        u, f = _level_fields(jlev, 1, dtype)
        tu, tf = (interop.field_from_jax(x, jlev.grid) for x in (u, f))
        unk = interop.field_from_jax(np.asarray(jlev.unknown), jlev.grid)
        want_a = interop.field_from_jax(
            jst.apply(jlev.stencil, jnp.asarray(u)), jlev.grid)
        assert torch.equal(tst.apply(st, tu)[unk], want_a[unk])
        want_r = interop.field_from_jax(
            jst.residual(jlev.stencil, jnp.asarray(u), jnp.asarray(f),
                         jlev.unknown), jlev.grid)
        assert torch.equal(tst.residual(st, tu, tf, unk), want_r)


@pytest.mark.parametrize("method,omega", [
    ("jacobi", 0.8), ("rbgs", 1.0), ("sor", 1.3), ("rbgs_rev", 1.0),
    ("line_x", 1.0), ("line_y", 1.0), ("adi", 1.0), ("chebyshev", 1.0)])
def test_stencil9_smoothers_match_jax(method, omega):
    _, _, jl, _ = _hierarchies("jump_coefficient_problem", 33, **GALERKIN)
    jlev = jl[1]
    st = interop.stencil_from_jax(jlev.stencil, jlev.grid)
    u, f = _level_fields(jlev, 2, "float64")
    unk = np.asarray(jlev.unknown)
    u = np.where(unk, u, 0.0)
    want = jsmooth.smooth(jlev.stencil, jnp.asarray(u), jnp.asarray(f),
                          jlev.unknown, method=method, sweeps=2, omega=omega)
    want = interop.field_from_jax(want, jlev.grid)
    tu, tf = (interop.field_from_jax(x, jlev.grid) for x in (u, f))
    got = tsmooth.smooth(st, tu, tf,
                         interop.field_from_jax(unk, jlev.grid),
                         method=method, sweeps=2, omega=omega)
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("name,n,changes", [
    ("jump_coefficient_problem", 33, {}),
    ("jump_coefficient_problem", 33, dict(smoother="adi")),
    ("neumann_test_problem", 33, {}),
    ("poisson_mms_sinsin", 17, dict(cycle="W")),
    ("jump_coefficient_problem", 33, dict(use_fmg=True)),
])
def test_fp64_mg_solve_matches_jax(name, n, changes):
    changes = dict(changes)
    use_fmg = changes.pop("use_fmg", False)
    cfg = {**GALERKIN, **changes}
    jprob, prob, jl, tl = _hierarchies(name, n, **cfg)
    jcfg, tcfg = J.MultigridConfig(**cfg), T.MultigridConfig(**cfg)
    ju, jinfo = J.mg_solve(jl, jprob.rhs(jnp.float64),
                           jprob.initial_guess(jnp.float64), jcfg,
                           use_fmg=use_fmg)
    f64 = torch.float64
    u, info = T.mg_solve(tl, prob.rhs(f64, "cpu"),
                         prob.initial_guess(f64, "cpu"), tcfg,
                         use_fmg=use_fmg)
    assert jinfo["converged"] and info["converged"]
    assert info["iterations"] == jinfo["iterations"]
    assert _rel(u, interop.field_from_jax(ju, jprob.grid)) <= 1e-10


@pytest.mark.parametrize("name,precision", [
    ("poisson_mms_sinsin", "fp32"), ("jump_coefficient_problem", "fp32"),
    ("jump_coefficient_problem", "mixed")])
def test_low_precision_solve_poisson_matches_jax(name, precision):
    cfg = dict(GALERKIN, tol=1e-9)
    jprob = getattr(JP, name)(33)
    ref = japp.solve_poisson(jprob, precision=precision,
                             cfg=J.MultigridConfig(**cfg))
    for backend in ("torch", "auto"):
        res = T.solve_poisson(interop.problem_from_jax(jprob),
                              precision=precision,
                              cfg=T.MultigridConfig(**cfg, backend=backend),
                              device="cpu")
        assert res.converged and res.iterations == ref.iterations
        if ref.errors:
            assert abs(res.errors["l2"] / ref.errors["l2"] - 1) <= 0.02
        else:
            ju = interop.field_from_jax(ref.u, jprob.grid)
            assert _rel(res.u, ju) <= 0.02


def _recorders(monkeypatch, calls):
    """Replace every kernel wrapper by its plain twin run that records the
    wrapper's name and the shape of the fine field it was handed."""
    wrapped = ((ksmooth, ("multisweep", "multisweep_parity")),
               (ksmooth_var, ("multisweep_var",)),
               (ktransfer, ("residual_restrict", "residual_restrict_var",
                            "prolong_correct")),
               (ktail, ("tail_vcycle", "tail_vcycle_var")),
               (kplanes, ("multisweep_planes",)),
               (ksmooth3d, ("rbgs3d",)),
               (ktransfer3d, ("residual_restrict3d", "prolong_correct3d")))
    for mod, names in wrapped:
        for name in names:
            real = getattr(mod, name)

            def record(*a, _real=real, _name=name, **k):
                fine = a[1]  # u: (stencil or ec, u, ...) in every wrapper
                calls.append((_name, tuple(fine.shape), fine.dtype))
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, record)


@pytest.mark.parametrize("name", ["jump_coefficient_problem",
                                  "poisson_mms_sinsin"])
def test_galerkin_levels_take_no_kernel(monkeypatch, name):
    """Repair (i): on a Galerkin hierarchy with backend 'auto' every gate
    refuses the Stencil9 levels, so a V-cycle reaches a kernel wrapper on
    level 0 only (A or H smoothing), never a transfer or tail."""
    calls = []
    _recorders(monkeypatch, calls)
    prob = getattr(T, name)(65)
    cfg = T.MultigridConfig(**GALERKIN)
    levels = T.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                               dtype="float32", device="cpu", cfg=cfg)
    f = prob.rhs(torch.float32, "cpu")
    tmg.mg_cycle(levels, levels[0].zeros(), f, cfg)
    want = "multisweep" if levels[0].stencil.scalar else "multisweep_var"
    assert calls and all(c[:2] == (want, (65, 65)) for c in calls)
    u = levels[1].zeros()
    for lvl, lev in enumerate(levels[1:], 1):
        assert not dispatch.kernel_smooth_ok(lev.zeros(), lev, "auto",
                                             "rbgs")
        assert not dispatch.tail_ok(levels, lvl, cfg, "V")
        assert not dispatch.transfer_fused_ok(levels[lvl - 1], lev, cfg)
    assert not dispatch.transfer_fused_ok(levels[1], levels[2], cfg, u, u)
    # the same levels without the corners take their kernels
    five = [dataclasses.replace(lev, stencil=tst.Stencil(
        *lev.stencil.coefs[:5])) for lev in levels]
    assert dispatch.kernel_smooth_ok(five[1].zeros(), five[1], "auto",
                                     "rbgs")
    assert dispatch.transfer_fused_ok(five[1], five[2], cfg)
    assert dispatch.tail_ok(five, 1, cfg, "V")
    assert not plane_solve.plane_solve_ok(levels[1:], cfg)


def test_fp64_vector_skips_level_0_kernels_2d(monkeypatch):
    """Repair (ii), 2D: an fp64 Krylov vector through the multigrid
    preconditioner over fp32 levels runs level 0 in fp64 on the plain path
    (no wrapper sees the 65^2 field) and the fp32 levels below through
    their wrappers (A, B, C and D, with the tail entry lowered to 17^2)."""
    monkeypatch.setattr(dispatch, "TAIL_MAX_ENTRY", 17)
    calls = []
    _recorders(monkeypatch, calls)
    prob = T.poisson_mms_exponential(65)
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0, symmetric=True)
    levels = T.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                               device="cpu", cfg=cfg)
    r = torch.where(levels[0].unknown, prob.rhs(torch.float64, "cpu"), 0.0)
    z = tpc.multigrid_preconditioner(levels, cfg)(r)
    assert z.dtype == torch.float64
    names = {c[0] for c in calls}
    assert names == {"multisweep", "residual_restrict", "prolong_correct",
                     "tail_vcycle"}
    assert all(c[1] != (65, 65) and c[2] == torch.float32 for c in calls)
    u64, f32 = torch.zeros(65, 65, dtype=torch.float64), levels[0].zeros()
    assert not dispatch.transfer_fused_ok(levels[0], levels[1], cfg, u64,
                                          f32)
    assert dispatch.transfer_fused_ok(levels[0], levels[1], cfg, f32, f32)
    assert not dispatch.tail_ok(levels, 2, cfg, "V", u64[::2, ::2], f32)


def test_fp64_vector_skips_level_0_kernels_3d(monkeypatch):
    """Repair (ii), 3D: level 0 (17^3) runs in fp64 on the plain path, the
    fp32 levels below through E, F and G."""
    calls = []
    _recorders(monkeypatch, calls)
    prob = T.poisson3d_mms_sinsinsin(17)
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0, symmetric=True)
    levels = T.build_hierarchy3d(prob.grid, dtype="float32", device="cpu",
                                 cfg=cfg)
    r = torch.where(levels[0].unknown, prob.rhs(torch.float64, "cpu"), 0.0)
    z = tpc.multigrid_preconditioner3d(levels, cfg)(r)
    assert z.dtype == torch.float64
    assert {c[0] for c in calls} == {"rbgs3d", "residual_restrict3d",
                                     "prolong_correct3d"}
    assert all(c[1] != (17, 17, 17) and c[2] == torch.float32
               for c in calls)
    u64 = torch.zeros(17, 17, 17, dtype=torch.float64)
    assert not dispatch.transfer_fused3d_ok(levels[0], levels[1], cfg, u64,
                                            levels[0].zeros())


def test_2d_wrappers_refuse_a_stencil9_on_the_cpu():
    """Every 2D kernel wrapper that takes a stencil refuses a Stencil9
    before it looks at the device, so its CPU twin is never handed one
    either (``tests/unit/test_torch_cuda_kernels.py`` holds the card)."""
    prob = T.jump_coefficient_problem(33)
    levels = T.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                               dtype="float32", device="cpu",
                               cfg=T.MultigridConfig(**GALERKIN))
    st9, u = levels[1].stencil, levels[1].zeros()
    sts = [lev.stencil for lev in levels[1:]]
    shapes = [lev.grid.shape for lev in levels[1:]]
    planes = T.ops.planes.split_field(u)
    for call in (
            lambda: ksmooth.multisweep(st9, u, u),
            lambda: ksmooth.multisweep_parity(st9, u, u),
            lambda: ksmooth_var.multisweep_var(st9, u, u),
            lambda: kplanes.multisweep_planes(st9, planes, planes, nx=17,
                                              ny=17),
            lambda: ktransfer.residual_restrict(st9, u, u),
            lambda: ktransfer.residual_restrict_var(st9, u, u),
            lambda: ktail.tail_vcycle(sts, u, u, shapes=shapes, pre=2,
                                      post=2, omega=1.0),
            lambda: ktail.tail_vcycle_var(sts, u, u, shapes=shapes, pre=2,
                                          post=2, omega=1.0)):
        with pytest.raises(ValueError, match="Stencil9"):
            call()
