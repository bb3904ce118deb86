"""The PyTorch port's 3D path against the JAX package, on the CPU.

Same inputs (numpy, from a seed) go through both packages and are compared on
the logical (nx, ny, nz) region:

- the plain operators and the plain twins of kernels E (RB-GS sweeps), F
  (fused residual + restriction) and G (fused prolongation + correction)
  against the JAX XLA functions. Both sides run the same arithmetic in the
  same order, so the tolerances only allow for a last-bit difference: 1e-6
  relative in fp32, 1e-13 in fp64;
- the same twins against the Pallas kernels in interpret mode, at the shapes
  tests/unit/test_pallas_kernels.py uses: 1e-5 relative to the largest
  reference value, since the Pallas smoother multiplies by 1/c where the
  twin divides, and the Pallas transfers restrict and interpolate
  separably where the twins sum 27 weighted terms and interpolate z, y, x;
- ir_solve3d, mg_solve3d and solve_poisson3d at 33^3 end to end.

On the CPU the port's 'auto' backend runs each kernel wrapper's plain twin,
so it must agree bit for bit with the forced plain path and count no kernel
launches.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson3d import (  # noqa: E402
    solve_poisson3d as jsolve_poisson3d,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid3d import (  # noqa: E402
    Grid3D as JGrid3D,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems3d as JP3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    norms as jnorms,
    stencil3d as jst3,
    transfer3d as jt3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.pallas_kernels import (  # noqa: E402
    smooth3d as ps3,
    transfer3d as pt3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid3d as jmg3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (  # noqa: E402
    MultigridConfig as JConfig,
)
import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc3d  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    dispatch,
    norms,
    smooth3d,
    stencil3d,
    transfer3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    _build,
    refine3d as krefine3d,
    smooth3d as ksmooth3d,
    transfer3d as ktransfer3d,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = [(17, 17, 17), (9, 33, 9), (33, 9, 17)]
DTYPES = {"float32": (np.float32, torch.float32, 1e-6),
          "float64": (np.float64, torch.float64, 1e-13)}
PALLAS_TOL = 1e-5
MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
WRAPPERS = (ksmooth3d.rbgs3d, ktransfer3d.residual_restrict3d,
            ktransfer3d.prolong_correct3d, krefine3d.refine_step3d)
# l2 error of the 7-point solution of sin(pi x) sin(pi y) sin(pi z): the
# discrete solution is (3 pi^2 / lambda_h) u_exact with lambda_h =
# (12/h^2) sin^2(pi h / 2), so the error is |3 pi^2/lambda_h - 1| / sqrt(8)


def closed_form_l2(n):
    h = 1.0 / (n - 1)
    lam_h = 12.0 / h**2 * np.sin(np.pi * h / 2) ** 2
    return abs(3 * np.pi**2 / lam_h - 1) / np.sqrt(8)


def _field(shape, seed, np_dtype=np.float32, scale=1.0, shell=False):
    """Random field; zero on the boundary shell unless ``shell``."""
    rng = np.random.default_rng(seed)
    a = np.zeros(shape, np_dtype)
    if shell:
        a[:] = scale * rng.standard_normal(shape)
    else:
        a[1:-1, 1:-1, 1:-1] = scale * rng.standard_normal(
            tuple(n - 2 for n in shape))
    return a


def _grids(shape):
    return T.Grid3D(*shape), JGrid3D(*shape)


def _jax(a, grid):
    return jnp.asarray(interop.field3d_to_jax_layout(torch.from_numpy(a),
                                                     grid))


def _close(got, ref_padded, grid, tol):
    ref = np.asarray(ref_padded)[: grid.nx, : grid.ny, : grid.nz]
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _stencils(grid, jgrid, np_dtype=np.float32):
    return (stencil3d.make_stencil3d(grid, dtype=np_dtype),
            jst3.make_stencil3d(jgrid, dtype=np_dtype))


# ---------------------------------------------------------------------------
# grid, problem, stencil, norms


def test_grid_problem_and_hierarchy_match_jax():
    n = 17
    jp = JP3.poisson3d_mms_sinsinsin(n)
    tp = T.poisson3d_mms_sinsinsin(n)
    assert interop.grid3d_from_jax(jp.grid) == tp.grid
    g = tp.grid
    assert (g.hx, g.hy, g.hz) == (jp.grid.hx, jp.grid.hy, jp.grid.hz)
    assert g.num_interior == 15**3 and g.coarsen().shape == (9, 9, 9)
    for name in ("f", "dirichlet_values", "exact"):
        assert np.array_equal(getattr(tp, name),
                              np.asarray(getattr(jp, name))[:n, :n, :n])
    assert np.array_equal(tp.initial_guess(torch.float64).numpy(),
                          np.asarray(jp.initial_guess(jnp.float64))[:n, :n,
                                                                    :n])
    ported = interop.problem3d_from_jax(jp)
    assert np.array_equal(ported.f, tp.f) and ported.lam == tp.lam
    jl = jmg3.build_hierarchy3d(jp.grid, jp.spec, dtype="float32")
    tl = T.build_hierarchy3d(tp.grid, tp.spec, dtype="float32",
                             device="cpu")
    assert tl == interop.levels3d_from_jax(jl)
    assert [lev.grid.nx for lev in tl] == [17, 9, 5, 3]
    X, Y, Z = g.coordinates()
    JX, JY, JZ = jp.grid.coordinates(padded=True)
    assert X.shape == g.shape
    for a, ja in ((X, JX), (Y, JY), (Z, JZ)):
        assert np.array_equal(a, ja[:n, :n, :n])
    mask = bc3d.unknown_mask3d(*g.shape).numpy()
    assert np.array_equal(mask, np.asarray(jst3.unknown_mask3d(
        jp.grid))[:n, :n, :n])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_stencil_apply_residual_norms_match_jax(shape, dtype):
    np_dtype, t_dtype, tol = DTYPES[dtype]
    g, jg = _grids(shape)
    st, jst = _stencils(g, jg, np_dtype)
    assert st == interop.stencil3d_from_jax(jst)
    assert st.astype(torch.float64) == interop.stencil3d_from_jax(
        jst.astype(jnp.float64))
    u, f = _field(shape, 1, np_dtype), _field(shape, 2, np_dtype, st.c)
    unknown = bc3d.unknown_mask3d(*shape)
    junknown = jst3.unknown_mask3d(jg)
    ut, ft = torch.from_numpy(u), torch.from_numpy(f)
    _close(stencil3d.apply(st, ut)[1:-1, 1:-1, 1:-1],
           np.asarray(jst3.apply(jst, _jax(u, g)))[1:-1, 1:-1, 1:-1],
           T.Grid3D(*(n - 2 for n in shape)), tol)
    r = stencil3d.residual(st, ut, ft, unknown)
    jr = jst3.residual(jst, _jax(u, g), _jax(f, g), junknown)
    _close(r, jr, g, tol)
    got = norms.scaled_l2(r, g.hx, g.hy, g.hz).item()
    ref = float(jmg3._norm3(jr, jg))
    np.testing.assert_allclose(got, ref, rtol=1e-13)
    mask = torch.from_numpy(_field(shape, 3, np.float32, shell=True) > 0)
    got = norms.h1_seminorm3d(ut, mask, g.hx, g.hy, g.hz).item()
    jmask = jnp.asarray(interop.field3d_to_jax_layout(mask, g))
    ref = float(jnorms.h1_seminorm3d(_jax(u, g), jmask, g.hx, g.hy, g.hz))
    np.testing.assert_allclose(got, ref, rtol=1e-13)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_restrict_and_prolong_match_jax(shape, dtype):
    np_dtype, t_dtype, tol = DTYPES[dtype]
    g, jg = _grids(shape)
    gc, jgc = g.coarsen(), jg.coarsen()
    rf = _field(shape, 4, np_dtype)
    got = transfer3d.restrict3d(torch.from_numpy(rf), *gc.shape)
    ref = jt3.restrict3d(_jax(rf, g), *gc.shape, jgc.shape_padded,
                         method="full_weighting", boundary="zero")
    assert got.shape == gc.shape and got.dtype == t_dtype
    _close(got, ref, gc, tol)
    ec = _field(gc.shape, 5, np_dtype, shell=True)
    got = transfer3d.prolong3d(torch.from_numpy(ec), *g.shape)
    ref = jt3.prolong3d(_jax(ec, gc), *gc.shape, *g.shape, jg.shape_padded)
    _close(got, ref, g, tol)


# ---------------------------------------------------------------------------
# the twins of kernels E, F, G against the JAX XLA functions and the Pallas
# kernels in interpret mode

SMOOTH_CASES = [(1, 1.0, False), (2, 1.0, False), (1, 1.3, False),
                (2, 1.0, True)]


@pytest.mark.parametrize("ref_path", ["xla", "pallas"])
@pytest.mark.parametrize("sweeps,omega,reverse", SMOOTH_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rbgs3d_twin_matches_jax(shape, sweeps, omega, reverse, ref_path):
    g, jg = _grids(shape)
    st, jst = _stencils(g, jg)
    u, f = _field(shape, 6), _field(shape, 7, scale=st.c)
    if ref_path == "xla":
        ref, tol = jmg3.smooth3d(jst, _jax(u, g), _jax(f, g),
                                 jst3.unknown_mask3d(jg), method="rbgs",
                                 sweeps=sweeps, omega=omega,
                                 reverse=reverse), 1e-6
    else:
        ref, tol = ps3.rbgs_planes(jst, _jax(u, g), _jax(f, g), nx=g.nx,
                                   ny=g.ny, nz=g.nz, sweeps=sweeps,
                                   omega=omega, reverse=reverse,
                                   interpret=True), PALLAS_TOL
    ut = torch.from_numpy(u.copy())
    got = ksmooth3d.rbgs3d(st, ut, torch.from_numpy(f), sweeps=sweeps,
                           omega=omega, reverse=reverse)
    assert got is not ut and np.array_equal(ut.numpy(), u)  # out of place
    assert np.array_equal(got.numpy()[0], u[0])  # the shell stays fixed
    _close(got, ref, g, tol)


@pytest.mark.parametrize("ref_path", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_residual_restrict3d_twin_matches_jax(shape, ref_path):
    g, jg = _grids(shape)
    gc, jgc = g.coarsen(), jg.coarsen()
    st, jst = _stencils(g, jg)
    u, f = _field(shape, 8), _field(shape, 9, scale=st.c)
    if ref_path == "xla":
        r = jst3.residual(jst, _jax(u, g), _jax(f, g), jst3.unknown_mask3d(jg))
        ref, tol = jt3.restrict3d(r, *gc.shape, jgc.shape_padded,
                                  method="full_weighting"), 1e-6
    else:
        ref, tol = pt3.residual_restrict3d(
            jst, _jax(u, g), _jax(f, g), nxf=g.nx, nyf=g.ny, nzf=g.nz,
            ncx=gc.nx, ncy=gc.ny, ncz=gc.nz, pshape_coarse=jgc.shape_padded,
            interpret=True), PALLAS_TOL
    got = ktransfer3d.residual_restrict3d(st, torch.from_numpy(u),
                                          torch.from_numpy(f))
    assert got.shape == gc.shape and not got[0].any() and not got[-1].any()
    _close(got, ref, gc, tol)


@pytest.mark.parametrize("ref_path", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_prolong_correct3d_twin_matches_jax(shape, ref_path):
    g, jg = _grids(shape)
    gc, jgc = g.coarsen(), jg.coarsen()
    u = _field(shape, 10)
    ec = _field(gc.shape, 11, shell=True)  # the coarse shell interpolates
    if ref_path == "xla":
        e = jt3.prolong3d(_jax(ec, gc), *gc.shape, *g.shape, jg.shape_padded,
                          dtype=jnp.float32)
        ref, tol = jnp.where(jst3.unknown_mask3d(jg), _jax(u, g) + e,
                             _jax(u, g)), 1e-6
    else:
        ref, tol = pt3.prolong_correct3d(
            _jax(ec, gc), _jax(u, g), ncx=gc.nx, ncy=gc.ny, ncz=gc.nz,
            nxf=g.nx, nyf=g.ny, nzf=g.nz, interpret=True), PALLAS_TOL
    ut = torch.from_numpy(u.copy())
    got = ktransfer3d.prolong_correct3d(torch.from_numpy(ec), ut)
    assert got is ut and np.array_equal(got.numpy()[:, :, -1], u[:, :, -1])
    _close(got, ref, g, tol)


# ---------------------------------------------------------------------------
# solves at 33^3


@functools.lru_cache(maxsize=None)
def _jax_ir33(backend):
    """The JAX package's ir_solve3d at 33^3 (fp32 cycles, tol 1e-9), with
    the XLA path or with its Pallas kernels run in interpret mode."""
    jp = JP3.poisson3d_mms_sinsinsin(33)
    jcfg = JConfig(backend=backend, **MAIN)
    jl = jmg3.build_hierarchy3d(jp.grid, jp.spec, dtype="float32", cfg=jcfg)
    ju, jinfo = jmg3.ir_solve3d(jl, jp.rhs(jnp.float64),
                                jp.initial_guess(jnp.float64), jcfg)
    return np.asarray(ju)[:33, :33, :33], jinfo, jp, jl


def _interpret_pallas(monkeypatch):
    """Run the JAX package's 3D Pallas kernels in interpret mode."""
    for mod, name in ((ps3, "rbgs_planes"), (pt3, "residual_restrict3d"),
                      (pt3, "prolong_correct3d")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))


# residual-history tolerance, relative, of the 33^3 ir_solve3d against the
# JAX solve. The operators above match XLA bit for bit when called one by
# one, but the JAX solve is one jitted loop in which XLA fuses the elementwise
# chains and contracts multiply-adds into FMAs, so a last-bit difference in a
# float64 residual now and then rounds to another fp32 value; the Pallas
# kernels besides multiply by 1/c and restrict and interpolate separably, so
# their fp32 cycles differ by a few ulps from the first step. Each outer step
# shrinks the residual about 70-fold, which lifts such differences to about
# 5e-5 (XLA) and 2e-4 (Pallas) of the later entries (measured on the CPU).
IR_HISTORY_RTOL = {"xla": 1e-4, "pallas": 1e-3}


@pytest.mark.parametrize("ref_path", ["xla", "pallas"])
def test_ir_solve3d_matches_jax_33(ref_path, monkeypatch):
    """Same outer-step count (5), solution within 1e-7 of the reference's,
    residual history within IR_HISTORY_RTOL."""
    if ref_path == "pallas":
        _interpret_pallas(monkeypatch)
    ju, jinfo, jp, jl = _jax_ir33(ref_path)
    tp, tl = interop.problem3d_from_jax(jp), interop.levels3d_from_jax(jl)
    u, info = T.ir_solve3d(tl, tp.rhs(torch.float64),
                           tp.initial_guess(torch.float64),
                           T.MultigridConfig(backend="torch", **MAIN))
    assert info["iterations"] == jinfo["iterations"] == 5
    assert info["converged"] and jinfo["converged"]
    assert info["method"] == "iterative_refinement_3d"
    np.testing.assert_allclose(info["history"], jinfo["history"],
                               rtol=IR_HISTORY_RTOL[ref_path])
    np.testing.assert_allclose(u.numpy(), ju, rtol=0, atol=1e-7)


@pytest.mark.parametrize("dtype,tol,hist_rtol,hist_atol,u_atol", [
    # fp64 cycles: the history matches to 1e-6 down to the float64
    # residual-evaluation floor, where the last entry (7e-10) differs by
    # 7e-15 absolute
    ("float64", 1e-10, 1e-6, 1e-13, 1e-7),
    # fp32 cycles and fp32 residual norms: fused FMAs in the JAX loop, as
    # for IR_HISTORY_RTOL, and each fp32 norm carries its own rounding, up
    # to 6.4e-6 absolute at 33^3 (measured on the CPU)
    ("float32", 1e-3, 1e-4, 1e-5, 1e-5),
])
def test_mg_solve3d_matches_jax_33(dtype, tol, hist_rtol, hist_atol, u_atol):
    jp = JP3.poisson3d_mms_sinsinsin(33)
    jcfg = JConfig(backend="xla", smoother="rbgs", omega=1.0, tol=tol)
    jl = jmg3.build_hierarchy3d(jp.grid, jp.spec, dtype=dtype, cfg=jcfg)
    ju, jinfo = jmg3.mg_solve3d(jl, jp.rhs(jnp.dtype(dtype)),
                                jp.initial_guess(jnp.dtype(dtype)), jcfg)
    tp = interop.problem3d_from_jax(jp)
    cfg = T.MultigridConfig(backend="auto", smoother="rbgs", omega=1.0,
                            tol=tol)
    tl = T.build_hierarchy3d(tp.grid, tp.spec, dtype=dtype, cfg=cfg,
                             device="cpu")
    tdt = T.as_dtype(dtype)
    u, info = T.mg_solve3d(tl, tp.rhs(tdt), tp.initial_guess(tdt), cfg)
    assert info["iterations"] == jinfo["iterations"]
    assert info["converged"] and jinfo["converged"]
    np.testing.assert_allclose(info["history"], jinfo["history"],
                               rtol=hist_rtol, atol=hist_atol)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju)[:33, :33, :33],
                               rtol=0, atol=u_atol)


def test_solve_poisson3d_fp32_reaches_the_closed_form_33():
    """fp32 at tol 1e-9 goes through float64 refinement; the l2 error is the
    7-point discretization error of the closed form, and the JAX front end
    gives the same."""
    cfg = T.MultigridConfig(backend="auto", **MAIN)
    res = T.solve_poisson3d(T.poisson3d_mms_sinsinsin(33), precision="fp32",
                            cfg=cfg, device="cpu")
    assert res.converged and res.iterations == 5
    assert res.info["method"] == "iterative_refinement_3d"
    assert res.u.dtype == torch.float64 and res.solve_time > 0
    np.testing.assert_allclose(res.errors["l2"], closed_form_l2(33),
                               rtol=1e-4)
    jres = jsolve_poisson3d(JP3.poisson3d_mms_sinsinsin(33),
                            precision="fp32",
                            cfg=JConfig(backend="xla", **MAIN))
    for key in ("l2", "linf", "h1"):
        np.testing.assert_allclose(res.errors[key], jres.errors[key],
                                   rtol=1e-6)


def test_auto_backend_on_cpu_runs_the_twins():
    """'auto' routes through the kernel wrappers, which run their plain
    twins for CPU tensors: the same result as 'torch' bit for bit, and no
    launch counted."""
    for w in WRAPPERS:
        w.launches = 0
    tp = T.poisson3d_mms_sinsinsin(17)
    out = {}
    for backend in ("auto", "torch"):
        cfg = T.MultigridConfig(backend=backend, **MAIN)
        out[backend] = T.solve_poisson3d(tp, precision="fp32", cfg=cfg,
                                         device="cpu")
    assert torch.equal(out["auto"].u, out["torch"].u)
    assert out["auto"].info["history"].tolist() == \
        out["torch"].info["history"].tolist()
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_dispatch_gates_3d():
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0)
    levels = T.build_hierarchy3d(T.Grid3D(17, 17, 17), dtype="float32",
                                 cfg=cfg, device="cpu")
    u = levels[0].zeros()
    assert all(dispatch.transfer_fused3d_ok(a, b, cfg)
               for a, b in zip(levels, levels[1:]))
    assert dispatch.kernel_smooth3d_ok(u, levels[0], "auto", "rbgs")
    assert dispatch.kernel_smooth3d_ok(u, levels[0], "auto", "rbgs_rev")
    assert not dispatch.kernel_smooth3d_ok(u, levels[0], "auto", "jacobi")
    assert not dispatch.kernel_smooth3d_ok(u, levels[0], "torch", "rbgs")
    assert not dispatch.transfer_fused3d_ok(levels[0], levels[1],
                                            cfg.replace(backend="torch"))
    lev64 = T.build_hierarchy3d(T.Grid3D(9, 9, 9), dtype="float64", cfg=cfg,
                                device="cpu")
    assert not dispatch.transfer_fused3d_ok(lev64[0], lev64[1], cfg)
    assert not dispatch.kernel_smooth3d_ok(lev64[0].zeros(), lev64[0], "auto",
                                           "rbgs")
    with pytest.raises(ValueError):
        dispatch.transfer_fused3d_ok(levels[0], levels[1],
                                     cfg.replace(backend="pallas"))


def test_jacobi_smoothing_matches_jax():
    """Weighted Jacobi stays on the plain path in 3D; it matches the XLA
    smoother and a Jacobi-smoothed V-cycle matches the JAX cycle."""
    shape = (17, 17, 17)
    g, jg = _grids(shape)
    st, jst = _stencils(g, jg)
    u, f = _field(shape, 12), _field(shape, 13, scale=st.c)
    got = smooth3d.smooth3d(st, torch.from_numpy(u.copy()),
                            torch.from_numpy(f), bc3d.unknown_mask3d(*shape),
                            method="jacobi", sweeps=3, omega=0.8)
    ref = jmg3.smooth3d(jst, _jax(u, g), _jax(f, g), jst3.unknown_mask3d(jg),
                        method="jacobi", sweeps=3, omega=0.8)
    _close(got, ref, g, 1e-6)
    jcfg = JConfig(backend="xla")  # Jacobi, omega 0.8: the defaults
    jl = jmg3.build_hierarchy3d(jg, dtype="float32", cfg=jcfg)
    ref = jmg3.mg_cycle3d(jl, jnp.zeros(jg.shape_padded, jnp.float32),
                          _jax(f, g), jcfg)
    tl = interop.levels3d_from_jax(jl)
    got = T.mg_cycle3d(tl, tl[0].zeros(), torch.from_numpy(f),
                       T.MultigridConfig())
    _close(got, ref, g, 1e-5)


def test_unported_3d_features_raise():
    """Every 3D feature that raised here before it was ported now builds and
    runs: the rest of item 13 (test_torch_3d_operator.py and
    test_torch_3d_precision.py hold it to the JAX package) and sharding
    (item 14b; test_torch_sharded3d.py holds it on four ranks): an array
    hook, and a mesh of one rank, give the unsharded solve."""
    assert not bc3d.mixed3d(top="neumann").all_dirichlet
    assert bc3d.mixed3d(west="periodic", east="periodic").wrap == (
        True, False, False)
    assert bc3d.mixed3d(top="dirichlet").all_dirichlet
    g = T.Grid3D(9, 9, 9)
    assert not stencil3d.make_stencil3d(g, a=np.ones(g.shape)).scalar
    assert [lev.dtype for lev in T.build_hierarchy3d(
        g, policy=T.policy("mixed"), device="cpu")] == [torch.float32,
                                                        torch.bfloat16,
                                                        torch.bfloat16]
    gal = T.build_hierarchy3d(g, cfg=T.MultigridConfig(coarsening="galerkin"),
                              device="cpu")
    assert isinstance(gal[1].stencil, stencil3d.Stencil27)
    levels = T.build_hierarchy3d(g, device="cpu")
    u = levels[0].zeros()
    for cfg in (T.MultigridConfig(cycle="W"),
                T.MultigridConfig(smoother="line_z", backend="torch")):
        assert torch.isfinite(T.mg_cycle3d(levels, u.clone(), u, cfg)).all()
    from mixed_precision_multigrid_solvers_for_pdes_torch.parallel.mesh \
        import Mesh

    f = torch.ones(g.shape, dtype=torch.float64)
    plain = T.ir_solve3d(levels, f)
    hooked = T.ir_solve3d(levels, f, constrain=lambda v, lev: v)
    assert hooked[1]["iterations"] == plain[1]["iterations"]
    assert torch.equal(hooked[0], plain[0])
    prob = T.poisson3d_mms_sinsinsin(9)
    for precision in ("mixed", "bf16", "adaptive"):
        assert T.solve_poisson3d(prob, precision=precision,
                                 device="cpu").u.shape == (9, 9, 9)
    # the hook turns F and G off: their twins round a bf16 level once per
    # call where the plain transfers round per op, so 'mixed' moves by
    # ~1e-12; the fp32 and adaptive (fp32 stages, fp32 IR) solves do not
    for precision, atol in (("fp32", 0.0), ("adaptive", 0.0),
                            ("mixed", 1e-10)):
        res = T.solve_poisson3d(prob, precision=precision, device="cpu")
        one = T.solve_poisson3d(prob, precision=precision, mesh=Mesh((1, 1)),
                                device="cpu")
        assert one.iterations == res.iterations
        assert (one.u - res.u).abs().max() <= atol
    got, info = T.adaptive_solve3d(g, bc3d.BoundarySpec3D(), f,
                                   mesh=Mesh((1, 1)), device="cpu")
    assert info["converged"] and got.shape == g.shape


def test_kernel_wrappers_3d_reject_what_the_kernels_do_not_take():
    u = torch.zeros(9, 9, 9)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda("k", u, ndim=3)
    with pytest.raises(ValueError, match="coarsen"):
        ktransfer3d.coarse_shape3d(9, 8, 9)
    with pytest.raises(ValueError, match="refine"):
        transfer3d.prolong3d(torch.zeros(5, 5, 5), 9, 9, 8)


def test_3d_modules_import_no_jax():
    mods = ["applications.poisson3d", "solvers.multigrid3d",
            "models.problems3d", "ops.cuda_kernels.smooth3d",
            "ops.cuda_kernels.transfer3d", "interop"]
    code = ("import sys, importlib; "
            + "; ".join(f"importlib.import_module('mixed_precision_multigrid_"
                        f"solvers_for_pdes_torch.{m}')" for m in mods)
            + "; bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', "
            "'mixed_precision_multigrid_solvers_for_pdes_tpu'))); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
