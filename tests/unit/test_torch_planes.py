"""The port's parity-plane layer against the JAX package, on the CPU.

``ops/planes.py`` (split, merge, masks, residual, transfers, norm) against
the JAX package's un-jitted plane functions, which run op by op, so fp32
and fp64 results must be equal bit for bit; the plain twins of kernels K
(plane sweeps), L (parity layout of the direct smoother) and M (the
microbenchmark probes and copy) against the Pallas kernels in interpret
mode; and ``plane_ir_solve`` against the JAX package's and against the
port's own standard refinement solve. Inputs come from numpy seeds, at 33^2,
65^2 and 33x65.
"""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import mixed_precision_multigrid_solvers_for_pdes_tpu as J  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (  # noqa: E402
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    planes as jpln,
    stencil as jst_mod,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.pallas_kernels import (  # noqa: E402
    smooth as jpsmooth,
    smooth_planes as jpsp,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    plane_solve as jplane_solve,
)
import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking import (  # noqa: E402
    kernel_microbench as kb,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    dispatch,
    planes as pln,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth as ksmooth,
    smooth_planes as kplanes,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (  # noqa: E402
    plane_solve,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = [(33, 33), (65, 65), (33, 65)]
MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)


@pytest.fixture(scope="module")
def jax_microbench():
    """The JAX package's scripts/kernel_microbench.py, loaded from its file
    (it puts scripts/ on sys.path for its own helper; that is undone)."""
    path = os.path.join(REPO, "scripts", "kernel_microbench.py")
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location("_jax_kernel_microbench",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def _grids(nx, ny):
    return JGrid(nx, ny), T.Grid(nx, ny)


def _jfield(jg, seed, dtype=np.float32, ring=True):
    """Seeded field in the JAX storage shape, zero outside the logical
    region (and on the ring unless ``ring``)."""
    rng = np.random.default_rng(seed)
    a = np.zeros(jg.shape_padded, dtype)
    a[: jg.nx, : jg.ny] = rng.standard_normal((jg.nx, jg.ny))
    if not ring:
        a[0], a[jg.nx - 1], a[:, 0], a[:, jg.ny - 1] = 0, 0, 0, 0
    return a


def _port(a, g):
    return interop.field_from_jax(a, g)


def _jstencil(jg, dtype=jnp.float32):
    jst = jst_mod.make_stencil(jg, dtype=dtype)
    return jst, jst_coefs(jst, dtype)


def jst_coefs(jst, dtype=jnp.float32):
    return tuple(jnp.asarray(getattr(jst, k), dtype) for k in "cwesn")


def _planes_equal(got, ref, g):
    np.testing.assert_array_equal(got.numpy(),
                                  interop.planes_from_jax(ref, g).numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_split_merge_roundtrip_matches_jax(nx, ny, dtype):
    jg, g = _grids(nx, ny)
    a = _jfield(jg, 1, dtype)
    ref = jpln.split_field(jnp.asarray(a))
    got = pln.split_field(_port(a, g))
    assert got.shape == (4, *pln.plane_shape((nx, ny)))
    _planes_equal(got, ref, g)
    # the JAX layout round trip: zero padding, equal bit for bit
    np.testing.assert_array_equal(interop.planes_to_jax_layout(got, g),
                                  np.asarray(ref))
    np.testing.assert_array_equal(pln.merge_field(got, g.shape).numpy(),
                                  a[:nx, :ny])
    np.testing.assert_array_equal(
        np.asarray(jpln.merge_field(ref, jg.shape_padded))[:nx, :ny],
        a[:nx, :ny])


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_plane_masks_match_jax(nx, ny):
    jg, g = _grids(nx, ny)
    _planes_equal(pln.plane_masks(g), jpln.plane_masks(jg), g)
    merged = pln.merge_field(pln.plane_masks(g), g.shape)
    assert torch.equal(merged, T.core.bc.unknown_mask(nx, ny))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("nx,ny", SHAPES)
def test_plane_operators_match_unjitted_jax(nx, ny, dtype):
    """Residual, restriction, prolongation-correction: tolerance 0 (the
    port keeps JAX's operand order, and op-by-op JAX fuses nothing). The
    norm sums in another order: rtol 1e-13."""
    np_dt = np.dtype(dtype)
    jg, g = _grids(nx, ny)
    jgc, gc = jg.coarsen(), g.coarsen()
    jst, stp = _jstencil(jg, dtype)
    port_stp = tuple(float(x) for x in stp)
    u, f = _jfield(jg, 2, np_dt), _jfield(jg, 3, np_dt)
    jmasks, masks = jpln.plane_masks(jg), pln.plane_masks(g)
    jup, jfp = jpln.split_field(jnp.asarray(u)), jpln.split_field(
        jnp.asarray(f))
    up, fp = pln.split_field(_port(u, g)), pln.split_field(_port(f, g))

    jr = jpln.plane_residual(stp, jup, jfp, jmasks)
    r = pln.plane_residual(port_stp, up, fp, masks)
    _planes_equal(r, jr, g)

    jfc = jpln.restrict_planes(jr, jgc.nx, jgc.ny, jgc.shape_padded,
                               dtype=dtype)
    fc = pln.restrict_planes(r, gc.nx, gc.ny, dtype=r.dtype)
    np.testing.assert_array_equal(
        fc.numpy(), np.asarray(jfc)[: gc.nx, : gc.ny])

    ec = _jfield(jgc, 4, np_dt, ring=False)
    jnew = jpln.prolong_correct_planes(jnp.asarray(ec), jup, jmasks)
    new = pln.prolong_correct_planes(_port(ec, gc), up, masks)
    _planes_equal(new, jnew, g)

    np.testing.assert_allclose(
        pln.plane_norm_scaled_l2(r, g.hx, g.hy).item(),
        float(jpln.plane_norm_scaled_l2(jr, jg.hx, jg.hy)), rtol=1e-13)


def _plane_inputs(n, seed):
    jg, g = _grids(n, n)
    jst, _ = _jstencil(jg)
    st = interop.stencil_from_jax(jst)
    u, f = _jfield(jg, seed, ring=False), _jfield(jg, seed + 1, ring=False)
    return jg, g, jst, st, u, f


def _agrees_with_pallas(got, ref, omega):
    """Bit for bit at omega = 1. Otherwise within 1e-6 of max|ref|: XLA
    compiles the interpreted kernel body and contracts p + omega*(gs - p)
    into a fused multiply-add, which the port (and the JAX body run op by
    op) rounds twice; at omega = 1 the product is exact and both agree."""
    if omega == 1.0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("n,sweeps,omega,strips", [
    (33, 2, 1.0, False), (33, 3, 1.3, False), (65, 2, 1.0, True)])
def test_plane_sweeps_match_pallas_multisweep_planes(monkeypatch, n, sweeps,
                                                     omega, strips):
    """K's twin against the Pallas plane kernel in interpret mode, whole-
    plane and strip variants (see ``_agrees_with_pallas``), and bit for bit
    against the kernel's sweep body run op by op."""
    if strips:
        monkeypatch.setattr(jpsp, "WHOLE_PLANES_BYTES", 0)
    jg, g, jst, st, u, f = _plane_inputs(n, 5)
    jup0, jfp = (jpln.split_field(jnp.asarray(a)) for a in (u, f))
    jup = jpsp.multisweep_planes(jst, jup0, jfp, nx=n, ny=n, sweeps=sweeps,
                                 omega=omega, strip=16, interpret=True)
    up = pln.split_field(_port(u, g))
    before = kplanes.multisweep_planes.launches
    got = kplanes.multisweep_planes(st, up, pln.split_field(_port(f, g)),
                                    nx=n, ny=n, sweeps=sweeps, omega=omega)
    assert got is up and kplanes.multisweep_planes.launches == before
    _agrees_with_pallas(got.numpy(),
                        interop.planes_from_jax(jup, g).numpy(), omega)
    with jax.disable_jit():
        body = jpsp._plane_sweeps(tuple(jup0), tuple(jfp), np.int32(0), n, n,
                                  jst_coefs(jst), jnp.asarray(omega,
                                                              jnp.float32),
                                  sweeps)
    _planes_equal(got, jnp.stack(body), g)


@pytest.mark.parametrize("sweeps,omega", [(1, 1.0), (2, 1.0), (3, 1.3)])
def test_parity_layout_matches_pallas_parity(sweeps, omega):
    """L's twin against the Pallas parity body in interpret mode, in the
    whole-grid kernel (33^2) and the strip kernel (65^2, strip 16) (see
    ``_agrees_with_pallas``); bit for bit against that body run op by op;
    and at omega = 1 equal to the direct body (1/c is a power of two on the
    unit square)."""
    for n, strips in ((33, False), (65, True)):
        jg, g, jst, st, u, f = _plane_inputs(n, 7)
        kw = dict(nx=n, ny=n, method="rbgs", sweeps=sweeps, omega=omega,
                  layout="parity", interpret=True)
        ref = (jpsmooth.multisweep_strips(jst, jnp.asarray(u),
                                          jnp.asarray(f), strip=16, **kw)
               if strips else
               jpsmooth.multisweep(jst, jnp.asarray(u), jnp.asarray(f), **kw))
        before = ksmooth.multisweep_parity.launches
        got = ksmooth.multisweep(st, _port(u, g), _port(f, g),
                                 sweeps=sweeps, omega=omega, layout="parity")
        assert ksmooth.multisweep_parity.launches == before
        _agrees_with_pallas(got.numpy(), np.asarray(ref)[:n, :n], omega)
        with jax.disable_jit():
            body = jpsmooth._parity_sweeps(
                jnp.asarray(u), jnp.asarray(f), 0, n, n, jst_coefs(jst),
                jnp.asarray(omega, jnp.float32), "rbgs", sweeps)
        np.testing.assert_array_equal(got.numpy(), np.asarray(body)[:n, :n])
        if omega == 1.0:
            direct = ksmooth.multisweep(st, _port(u, g), _port(f, g),
                                        sweeps=sweeps, layout="direct")
            assert torch.equal(got, direct)


def test_parity_layout_resolution(monkeypatch):
    """As the Pallas kernels' _resolve_parity: Jacobi (and the reversed
    colour order, which the parity body has not) take the direct body;
    'auto' follows PARITY_DEFAULT."""
    assert not ksmooth.PARITY_DEFAULT
    assert ksmooth._resolve_parity("parity", "rbgs")
    assert ksmooth._resolve_parity("parity", "sor")
    assert not ksmooth._resolve_parity("parity", "jacobi")
    assert not ksmooth._resolve_parity("parity", "rbgs_rev")
    assert not ksmooth._resolve_parity("direct", "rbgs")
    assert not ksmooth._resolve_parity("auto", "rbgs")
    monkeypatch.setattr(ksmooth, "PARITY_DEFAULT", True)
    assert ksmooth._resolve_parity("auto", "rbgs")
    with pytest.raises(ValueError, match="layout"):
        ksmooth._resolve_parity("planes", "rbgs")
    st = T.ops.stencil.make_stencil(T.Grid(9, 9))
    u = torch.zeros(9, 9)
    with pytest.raises(ValueError, match="coefficient"):
        ksmooth.multisweep_parity(
            T.ops.stencil.Stencil(*(torch.ones(9, 9),) * 5), u, u)
    with pytest.raises(ValueError, match="planes"):
        kplanes.multisweep_planes(st, torch.zeros(4, 4, 5), torch.zeros(
            4, 4, 5), nx=9, ny=9)


def _pallas(kernel, out_shape, n_in, *args):
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    return pl.pallas_call(kernel, out_shape=out_shape, in_specs=[vmem] * n_in,
                          out_specs=vmem, interpret=True)(*args)


@pytest.mark.parametrize("mode", kb.MODES)
def test_probe_twins_match_the_jax_probe(jax_microbench, mode):
    """Each probe twin = the JAX script's _probe_kernel in interpret mode,
    run on the unpadded (nx, ny) array, so that both wrap alike: bit for
    bit, 'sub' and 'lane' included."""
    nx, ny, sweeps = 33, 65, 2
    rng = np.random.default_rng(11)
    u, f = (rng.standard_normal((nx, ny)).astype(np.float32)
            for _ in range(2))
    kern = functools.partial(jax_microbench._probe_kernel, nx=nx, ny=ny,
                             sweeps=sweeps, mode=mode)
    ref = _pallas(kern, jax.ShapeDtypeStruct((nx, ny), jnp.float32), 2,
                  jnp.asarray(u), jnp.asarray(f))
    before = kb.probe.launches
    got = kb.probe(torch.from_numpy(u), torch.from_numpy(f), mode=mode,
                   sweeps=sweeps)
    assert kb.probe.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_copy_and_parity_twins_match_the_jax_probes(jax_microbench):
    """copy: o = 2 u, exact (copy_call's body is local to copy_call and is
    restated here). parity: the JAX _parity_kernel on the same planes
    against K's twin with the c = 4 stencil. The JAX probe adds f first
    (f + W + E + S + N) and writes the Gauss-Seidel value, K adds the
    neighbour sum first and writes p + 1 * (gs - p): a few fp32 roundings
    per update, so rtol 1e-5 of max|u|."""
    nx = ny = 65
    rng = np.random.default_rng(12)
    u, f = (rng.standard_normal((nx, ny)).astype(np.float32)
            for _ in range(2))

    def copy_body(u_ref, o_ref):
        o_ref[:] = u_ref[:] * 2.0

    ref = _pallas(copy_body, jax.ShapeDtypeStruct((nx, ny), jnp.float32), 1,
                  jnp.asarray(u))
    np.testing.assert_array_equal(kb.copy2x(torch.from_numpy(u)).numpy(),
                                  np.asarray(ref))

    g = T.Grid(nx, ny)
    up, fp = (pln.split_field(torch.from_numpy(a)) for a in (u, f))
    kern = functools.partial(jax_microbench._parity_kernel, nx=nx, ny=ny,
                             sweeps=3)
    hshape = jax.ShapeDtypeStruct(up.shape[1:], jnp.float32)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    outs = pl.pallas_call(kern, out_shape=[hshape] * 4,
                          in_specs=[vmem] * 8, out_specs=[vmem] * 4,
                          interpret=True)(
        *(jnp.asarray(p.numpy()) for p in up.unbind(0)),
        *(jnp.asarray(p.numpy()) for p in fp.unbind(0)))
    got = kb.parity(up, fp, nx=nx, ny=ny, sweeps=3)
    ref = np.stack([np.asarray(o) for o in outs])
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)
    assert np.array_equal(pln.merge_field(got, g.shape).numpy()[0], u[0])


@pytest.fixture(scope="module")
def plane65():
    """plane_ir_solve at 65^2 through both packages, and the port's
    standard no-FMG refinement solve on the same levels."""
    n = 65
    jcfg = J.MultigridConfig(backend="xla", **MAIN)
    jp = JP.poisson_mms_sinsin(n)
    jl = J.build_hierarchy(jp.grid, jp.spec, dtype="float32", cfg=jcfg)
    ju, jinfo = jplane_solve.plane_ir_solve(
        jl, jp.rhs(jnp.float64), jp.initial_guess(jnp.float64), jcfg,
        inner_cycles=2, interpret=True)
    tp = interop.problem_from_jax(jp)
    tl = interop.levels_from_jax(jl)
    f, u0 = tp.rhs(torch.float64), tp.initial_guess(torch.float64)
    out = {"jax": (np.asarray(ju)[:n, :n], jinfo), "problem": tp,
           "levels": tl}
    for backend in ("auto", "torch"):
        kplanes.multisweep_planes.launches = 0
        cfg = T.MultigridConfig(backend=backend, **MAIN)
        out[backend] = T.plane_ir_solve(tl, f, u0, cfg, inner_cycles=2)
        assert kplanes.multisweep_planes.launches == 0  # CPU: the twin
    cfg = T.MultigridConfig(backend="auto", **MAIN)
    out["standard"] = T.ir_solve(tl, f, u0, cfg, inner_cycles=2,
                                 use_fmg=False)
    return out


def test_plane_ir_solve_matches_jax_65(plane65):
    """The same outer count and converged flag; u to 1e-7, as the JAX
    package holds its plane solve to its standard one."""
    ju, jinfo = plane65["jax"]
    u, info = plane65["auto"]
    assert info["method"] == "plane_ir" and info["converged"]
    assert info["iterations"] == jinfo["iterations"]
    np.testing.assert_allclose(u.numpy(), ju, rtol=0, atol=1e-7)
    np.testing.assert_allclose(info["rhs_norm"], jinfo["rhs_norm"],
                               rtol=1e-13)
    assert plane65["problem"].error_norms(u)["l2"] < 2e-4


def test_plane_ir_solve_matches_standard_solve_65(plane65):
    """Against the port's own ir_solve(use_fmg=False): the same count and
    u to 1e-7; 'auto' on the CPU runs the twins, so 'torch' is identical."""
    u, info = plane65["auto"]
    us, info_s = plane65["standard"]
    assert info["iterations"] == info_s["iterations"]
    np.testing.assert_allclose(u.numpy(), us.numpy(), rtol=0, atol=1e-7)
    ut, info_t = plane65["torch"]
    assert torch.equal(u, ut)
    assert info["history"].tolist() == info_t["history"].tolist()


def test_plane_solve_gate():
    """The cases of the JAX package's gate test, and the ones the port's
    Level adds (a coefficient field, Jacobi)."""
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0)
    prob = T.poisson_mms_sinsin(33)
    levels = T.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                               cfg=cfg, device="cpu")
    assert plane_solve.plane_solve_ok(levels, cfg)
    assert not plane_solve.plane_solve_ok(levels, cfg.replace(cycle="W"))
    assert not plane_solve.plane_solve_ok(levels,
                                          cfg.replace(smoother="jacobi"))
    assert not plane_solve.plane_solve_ok(levels[-1:], cfg)
    levels64 = T.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                 cfg=cfg, device="cpu")
    assert not plane_solve.plane_solve_ok(levels64, cfg)
    neu = T.neumann_test_problem(33)
    levels_n = T.build_hierarchy(neu.grid, neu.spec, dtype="float32",
                                 cfg=cfg, device="cpu")
    assert not plane_solve.plane_solve_ok(levels_n, cfg)
    var = T.variable_coefficient_mms(33)
    levels_v = T.build_hierarchy(var.grid, var.spec, a=var.a,
                                 dtype="float32", cfg=cfg, device="cpu")
    assert not plane_solve.plane_solve_ok(levels_v, cfg)
    with pytest.raises(ValueError, match="gate"):
        T.plane_ir_solve(levels64, prob.rhs(torch.float64), cfg=cfg)
    up = torch.zeros(4, 17, 17)
    assert dispatch.kernel_planes_ok(up, "auto")
    assert not dispatch.kernel_planes_ok(up, "torch")
    assert not dispatch.kernel_planes_ok(up.double(), "auto")
    with pytest.raises(ValueError, match="backend"):
        dispatch.kernel_planes_ok(up, "pallas")


def test_parity_default_solve_equals_direct_257(monkeypatch):
    """The main path (FMG start, IR) at 257^2, the smallest size with a
    level above the tail, with PARITY_DEFAULT on: L's twin takes every
    smoothing call above the tail, and the solve equals the direct
    layout's exactly (the same arithmetic, and 1/c is a power of two on the
    unit square)."""
    prob = T.poisson_mms_sinsin(257)
    cfg = T.MultigridConfig(backend="auto", max_iterations=40, **MAIN)
    levels = T.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                               cfg=cfg, device="cpu")
    f, u0 = prob.rhs(torch.float64), prob.initial_guess(torch.float64)
    seen = []
    plain = ksmooth.multisweep_parity_plain
    monkeypatch.setattr(ksmooth, "multisweep_parity_plain",
                        lambda *a, **k: seen.append(1) or plain(*a, **k))
    out = {}
    for parity in (False, True):
        monkeypatch.setattr(ksmooth, "PARITY_DEFAULT", parity)
        seen.clear()
        out[parity] = T.ir_solve(levels, f, u0, cfg, inner_cycles=2,
                                 use_fmg=True)
        assert bool(seen) == parity
    (ud, info_d), (up, info_p) = out[False], out[True]
    assert info_d["converged"]
    assert info_d["iterations"] == info_p["iterations"]
    assert torch.equal(ud, up)
    assert info_d["history"].tolist() == info_p["history"].tolist()
