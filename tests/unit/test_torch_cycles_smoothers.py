"""The port's W and F cycles, the other transfers, the tridiagonal solves
and the line, ADI and Chebyshev smoothers against the JAX package, on the
CPU.

Inputs are numpy arrays from a seed (or the same problem built by both
packages); fields are compared on the logical (nx, ny) region. On the CPU
the port's 'auto' backend runs its plain paths; the JAX side runs its XLA
path ('xla'), op by op outside ``jit`` except in ``solve_poisson``.

Tolerances, each with its reason:

- ``pcr_solve`` and ``cyclic_tridiagonal_solve`` against the JAX ones: fp64
  1e-13 and fp32 1e-6 relative to the largest reference value (the same
  rounds in the same order; PyTorch and XLA may differ in a last bit).
- the port's ``tridiagonal_solve`` (PCR) against JAX's LAPACK path on the
  CPU: fp64 1e-11, fp32 1e-5 relative. PCR and LU elimination round
  differently on these diagonally dominant lines.
- restrictions and prolongations: bit for bit (the same sums in the same
  order).
- one smoother call: fp64 1e-11, fp32 2e-5 relative (the line smoothers
  solve with PCR where JAX calls LAPACK, see above; the point smoothers
  agree far closer).
- one cycle on a hierarchy carried across from JAX levels: fp64 1e-11,
  fp32 2e-5 relative (line and tridiagonal round-off accumulates over the
  levels).
- whole solves: equal outer-step counts, converged, solutions within 1e-8
  relative (the fp64 outer loop stops both at the same 1e-9 relative
  residual; the JAX solve runs its fp32 cycles in one ``jit``).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    poisson as japp,
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
    smooth as jsmooth,
    transfer as jtransfer,
    tridiag as jtridiag,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid as jmg,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    dispatch,
    transfer,
    tridiag,
)

MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
TOL = {"float32": 2e-5, "float64": 1e-11}


def _logical(x, n):
    return np.asarray(x)[:n, :n]


def _jax(a, n):
    return jnp.asarray(interop.field_to_jax_layout(torch.from_numpy(a),
                                                   JGrid(n, n)))


def _close(got, ref, tol):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale, rtol=0,
                               atol=tol)


def _system(shape, seed, np_dt):
    """A diagonally dominant batch of tridiagonal lines."""
    rng = np.random.default_rng(seed)
    dl, du = rng.uniform(-1.0, 0.0, shape), rng.uniform(-1.0, 0.0, shape)
    d = 2.5 + rng.uniform(0.0, 1.0, shape)
    b = rng.standard_normal(shape)
    return tuple(x.astype(np_dt) for x in (dl, d, du, b))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,axis", [((17, 9), 0), ((20, 33), 1)])
def test_pcr_and_cyclic_solves_match_jax(shape, axis, dtype):
    np_dt, t_dt = DTYPES[dtype]
    dl, d, du, b = _system(shape, 11, np_dt)
    tol = 1e-6 if dtype == "float32" else 1e-13
    args = [torch.from_numpy(x) for x in (dl, d, du, b)]
    for port, ref in ((tridiag.pcr_solve, jtridiag.pcr_solve),
                      (tridiag.cyclic_tridiagonal_solve,
                       jtridiag.cyclic_tridiagonal_solve)):
        got = port(*args, axis=axis)
        assert got.dtype == t_dt
        _close(got.numpy(), ref(*map(jnp.asarray, (dl, d, du, b)),
                                axis=axis), tol)
    # the cyclic solution satisfies the periodic system
    x = tridiag.cyclic_tridiagonal_solve(*args, axis=axis).to(torch.float64)
    A = [torch.from_numpy(v.astype(np.float64)) for v in (dl, d, du, b)]
    res = (A[0] * torch.roll(x, 1, axis) + A[1] * x
           + A[2] * torch.roll(x, -1, axis) - A[3])
    assert res.abs().max() < (1e-4 if dtype == "float32" else 1e-12)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tridiagonal_solve_against_jax_lapack(dtype):
    """The port's tridiagonal_solve is PCR everywhere; off the TPU the JAX
    package's calls LAPACK."""
    np_dt, _ = DTYPES[dtype]
    dl, d, du, b = _system((33, 17), 12, np_dt)
    for axis in (0, 1):
        got = tridiag.tridiagonal_solve(
            *(torch.from_numpy(x) for x in (dl, d, du, b)), axis=axis)
        ref = jtridiag.tridiagonal_solve(*map(jnp.asarray, (dl, d, du, b)),
                                         axis=axis)
        _close(got.numpy(), ref, 1e-5 if dtype == "float32" else 1e-11)


WRAPS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("wrap", WRAPS)
@pytest.mark.parametrize("boundary", ["zero", "inject", "reflect"])
@pytest.mark.parametrize("method", ["full_weighting", "half_weighting",
                                    "injection"])
def test_restrict_matches_jax(method, boundary, wrap):
    """Every restriction, boundary and wrap, bit for bit in fp64; the JAX
    side reads a wrapped axis's seam neighbour from its synced padding."""
    n, nc = 17, 9
    rf = np.random.default_rng(5).standard_normal((n, n))
    spec = jbc.BoundarySpec(**{
        side: jbc.BCSide(jbc.BCKind.PERIODIC)
        for side, w in (("west", wrap[0]), ("east", wrap[0]),
                        ("south", wrap[1]), ("north", wrap[1])) if w})
    jr = _jax(rf, n)
    sync = jbc.periodic_sync(n, n, JGrid(n, n).shape_padded, spec)
    if sync is not None:
        jr = sync(jr)
    ref = jtransfer.restrict(jr, nc, nc, JGrid(nc, nc).shape_padded,
                             method=method, boundary=boundary, wrap=wrap)
    got = transfer.restrict(torch.from_numpy(rf), nc, nc, method=method,
                            boundary=boundary, wrap=wrap)
    port_spec = interop.spec_from_jax(spec)
    csync = jbc.periodic_sync(nc, nc, JGrid(nc, nc).shape_padded, spec)
    if csync is not None:
        # the coarse duplicate nodes are left to the level's sync (JAX
        # reads its zero padding past them under 'reflect')
        ref = csync(ref)
        bc.periodic_sync(port_spec)(got)
    assert np.array_equal(got.numpy(), _logical(ref, nc))


@pytest.mark.parametrize("method", ["bilinear", "injection"])
def test_prolong_matches_jax(method):
    n, nc = 17, 9
    ec = np.random.default_rng(6).standard_normal((nc, nc))
    ref = jtransfer.prolong(_jax(ec, nc), nc, nc, n, n,
                            JGrid(n, n).shape_padded, method=method)
    got = transfer.prolong(torch.from_numpy(ec), n, n, method=method)
    assert np.array_equal(got.numpy(), _logical(ref, n))
    with pytest.raises(ValueError, match="prolongation"):
        transfer.prolong(torch.from_numpy(ec), n, n, method="cubic")


def _problem(name, n):
    """(JAX problem, port problem carried across) for a smoother case."""
    make = {"aniso": JP.poisson_mms_anisotropic,
            "periodic": JP.periodic_helmholtz_mms,
            "segments": JP.mixed_segment_problem,
            "neumann": JP.neumann_test_problem}[name]
    jp = make(n)
    return jp, interop.problem_from_jax(jp)


SMOOTHER_CASES = [
    ("jacobi", "periodic"), ("jacobi", "segments"),
    ("rbgs", "periodic"), ("rbgs", "segments"),
    ("line_x", "periodic"), ("line_x", "aniso"), ("line_x", "neumann"),
    ("line_y", "periodic"), ("line_y", "segments"),
    ("adi", "periodic"), ("adi", "aniso"),
    ("chebyshev", "periodic"), ("chebyshev", "segments"),
    ("chebyshev", "aniso"),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("method,case", SMOOTHER_CASES)
def test_smoother_matches_jax(method, case, dtype):
    """One call of two sweeps, the duplicate nodes included (synced on both
    sides): on the periodic case the line smoothers take the cyclic solve
    along both axes."""
    n = 17
    np_dt, t_dt = DTYPES[dtype]
    jp, tp = _problem(case, n)
    jl = jmg.build_hierarchy(jp.grid, jp.spec, lam=jp.lam, dtype=np_dt,
                             cfg=jmg.MultigridConfig(max_levels=1))
    tl = interop.levels_from_jax(jl)
    jlev, lev = jl[0], tl[0]
    assert lev.stencil.wrap == lev.spec.wrap
    rng = np.random.default_rng(8)
    u = np.where(bc.unknown_mask(n, n, lev.spec).numpy(),
                 rng.standard_normal((n, n)), tp.initial_guess().numpy())
    f = tp.rhs(torch.float64).numpy() + rng.standard_normal((n, n))
    wrap = lev.spec.wrap
    cyclic = (n - 1 if wrap[0] else 0, n - 1 if wrap[1] else 0)
    ref = jsmooth.smooth(jlev.stencil, _jax(u.astype(np_dt), n),
                         _jax(f.astype(np_dt), n), jlev.unknown,
                         method=method, sweeps=2, omega=0.9,
                         sync=jlev.sync, cyclic_axes=cyclic)
    ut = torch.from_numpy(u).to(t_dt)
    got = dispatch.smooth(lev.stencil, ut, torch.from_numpy(f).to(t_dt), lev,
                          method=method, sweeps=2, omega=0.9, backend="auto")
    assert got is ut  # in place on the plain path
    if lev.sync is not None:
        # no port smoother reads or refreshes the duplicate nodes; JAX's
        # leave them one update stale: compare them synced
        lev.sync(got)
        ref = jlev.sync(ref)
    _close(got.numpy(), _logical(ref, n), TOL[dtype])


CYCLE_CASES = [
    ("sinsin", dict(cycle="W"), "float64"),
    ("sinsin", dict(cycle="F"), "float32"),
    ("sinsin", dict(cycle="F"), "float64"),
    ("sinsin", dict(cycle="W", w_depth=2, restriction="half_weighting"),
     "float64"),
    ("sinsin", dict(cycle="F", restriction="injection",
                    prolongation="injection"), "float64"),
    ("periodic", dict(cycle="W"), "float64"),
    ("segments", dict(cycle="F"), "float64"),
    ("aniso", dict(cycle="V", smoother="line_y"), "float64"),
    ("sinsin", dict(cycle="V", smoother="chebyshev"), "float32"),
]


@pytest.mark.parametrize(
    "name,kw,dtype", CYCLE_CASES,
    ids=["-".join([c[0], *(f"{k}={v}" for k, v in c[1].items()), c[2]])
         for c in CYCLE_CASES])
def test_mg_cycle_on_levels_from_jax(name, kw, dtype):
    """A hierarchy carried across by ``interop.levels_from_jax`` (segments
    and periodic axes included) reproduces the JAX cycle."""
    n = 17
    np_dt, t_dt = DTYPES[dtype]
    jp = (JP.poisson_mms_sinsin(n) if name == "sinsin"
          else _problem(name, n)[0])
    jcfg = jmg.MultigridConfig(backend="xla", **{**MAIN, **kw})
    cfg = T.MultigridConfig(backend="auto", **{**MAIN, **kw})
    jl = jmg.build_hierarchy(jp.grid, jp.spec, lam=jp.lam, dtype=np_dt,
                             cfg=jcfg)
    tl = interop.levels_from_jax(jl)
    assert [lev.spec for lev in tl] == [interop.spec_from_jax(jp.spec)] * \
        len(jl)
    f = np.array(jp.rhs(np.float64))[:n, :n]
    u0 = np.array(jp.initial_guess(np.float64))[:n, :n]
    ref = jmg.mg_cycle(jl, _jax(u0.astype(np_dt), n),
                       _jax(f.astype(np_dt), n), jcfg)
    got = T.mg_cycle(tl, torch.from_numpy(u0).to(t_dt),
                     torch.from_numpy(f).to(t_dt), cfg)
    if tl[0].sync is not None:  # duplicates compared synced, as above
        tl[0].sync(got)
        ref = jl[0].sync(ref)
    _close(got.numpy(), _logical(ref, n), TOL[dtype])


def test_w_and_f_routes():
    """The tail kernel runs V-recursions only; line and Chebyshev smoothing
    take no smoothing or tail kernel, while the transfers of an
    all-Dirichlet level keep B and C and the coarsest RB-GS keeps A."""
    cfg = T.MultigridConfig(backend="auto", **MAIN)
    levels = T.build_hierarchy(T.Grid(33, 33), dtype="float32", device="cpu",
                               cfg=cfg)
    for cycle in ("W", "F"):
        assert not any(dispatch.tail_ok(levels, k, cfg, cycle)
                       for k in range(len(levels)))
    assert dispatch.tail_ok(levels, 0, cfg, "V")
    for method in ("line_x", "line_y", "adi", "chebyshev"):
        lcfg = cfg.replace(smoother=method)
        u = levels[0].zeros()
        assert not dispatch.kernel_smooth_ok(u, levels[0], "auto", method)
        assert not dispatch.tail_ok(levels, len(levels) - 1, lcfg, "V")
        assert dispatch.transfer_fused_ok(levels[0], levels[1], lcfg)
        assert dispatch.kernel_smooth_ok(u, levels[0], "auto", "rbgs")
    for name in ("half_weighting", "injection"):
        assert not dispatch.transfer_fused_ok(
            levels[0], levels[1], cfg.replace(restriction=name))


SOLVES = {
    # (n, config changes) of poisson_mms_sinsin, or of the anisotropic
    # problem for the line smoother
    "sinsin-W": (17, dict(cycle="W")),
    "sinsin-F": (17, dict(cycle="F")),
    "sinsin-chebyshev": (17, dict(smoother="chebyshev")),
    "sinsin-half_weighting": (17, dict(restriction="half_weighting")),
    "anisotropic-line_y": (17, dict(smoother="line_y")),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_poisson_matches_jax(case):
    """solve_poisson(precision='fp32', tol=1e-9): the JAX reference's
    outer-step count, converged, the solution within 1e-8 relative."""
    n, kw = SOLVES[case]
    make = ("poisson_mms_anisotropic" if case.startswith("anisotropic")
            else "poisson_mms_sinsin")
    jp, tp = getattr(JP, make)(n), getattr(T, make)(n)
    jres = japp.solve_poisson(
        jp, precision="fp32",
        cfg=jmg.MultigridConfig(backend="xla", **{**MAIN, **kw}))
    res = T.solve_poisson(tp, precision="fp32",
                          cfg=T.MultigridConfig(**{**MAIN, **kw}),
                          device="cpu")
    assert res.converged and jres.converged
    assert res.iterations == jres.iterations
    _close(res.u.numpy(), _logical(jres.u, n), 1e-8)
    assert abs(res.errors["l2"] / jres.errors["l2"] - 1) < 1e-3


def test_periodic_fmg_solve_matches_jax():
    """mg_solve with the FMG start on a periodic problem (fp64): the port
    syncs each coarse field before FMG prolongs it, where the JAX package
    prolongs a duplicate one smoothing update stale, so the starts differ
    at the seam (their residuals within 1%); the same outer-step count and
    the solution within 1e-12 relative after both are synced."""
    n = 17
    jp, tp = _problem("periodic", n)
    jcfg = jmg.MultigridConfig(backend="xla", smoother="rbgs", omega=1.0,
                               tol=1e-10)
    cfg = T.MultigridConfig(backend="auto", smoother="rbgs", omega=1.0,
                            tol=1e-10)
    jl = jmg.build_hierarchy(jp.grid, jp.spec, lam=jp.lam, dtype=np.float64,
                             cfg=jcfg)
    ju, jinfo = jmg.mg_solve(jl, jp.rhs(jnp.float64),
                             jp.initial_guess(jnp.float64), jcfg, use_fmg=True)
    u, info = T.mg_solve(interop.levels_from_jax(jl), tp.rhs(torch.float64),
                         tp.initial_guess(torch.float64), cfg, use_fmg=True)
    assert info["converged"] and jinfo["converged"]
    assert info["iterations"] == jinfo["iterations"]
    np.testing.assert_allclose(info["history"][0], jinfo["history"][0],
                               rtol=1e-2)
    assert torch.equal(u[-1], u[0]) and torch.equal(u[:, -1], u[:, 0])
    _close(u.numpy(), _logical(ju, n), 1e-12)
