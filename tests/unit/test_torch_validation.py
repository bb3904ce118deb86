"""The port's validation layer (``validation/``: theory, mms, baselines)
against the JAX package's, on the CPU (``device="cpu"``: the kernel
wrappers run their plain twins).

Tolerances, each with its reason:

- LFA factors: equal (the same numpy on the same frequency grid).
- ``measure_two_grid_factor``'s history started from the JAX package's own
  draw: within 1e-10 relative at 65^2 in fp64 (the same cycles in fp64;
  measured ~1e-15). The seeded public call draws from a torch generator,
  not JAX's key, so its rho is held to JAX's within 0.02 (both start from
  standard normal noise; the asymptotic factor does not depend on it).
- MMS rows: the same ``passed``, ``exact_floor`` and iterations, orders
  within 1e-6 (fp64 solves to 1e-10 of the same discrete problems).
- ``_assemble_csr``: the same sparsity pattern and indices, values and the
  right-hand side within 1e-14 relative (the stencils are computed in fp64
  by two libraries).
- scipy rows: the same iterations, errors within 1e-12 relative (the same
  host solver on the same system; the JAX package sums its error over
  padded arrays).
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("scipy")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mixed_precision_multigrid_solvers_for_pdes_tpu as J  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    heat_problems as JHP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
    problems3d as JP3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.validation import (  # noqa: E402
    MMSValidator as JMMS,
    PerformanceBaselines as JBase,
    TheoreticalAnalyzer as JTA,
    baselines as jbase,
    measure_two_grid_factor as j_measure,
    theory as jtheory,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.applications import (  # noqa: E402
    heat_problems as THP,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.validation import (  # noqa: E402
    MMSValidator,
    PerformanceBaselines,
    TheoreticalAnalyzer,
    baselines,
    measure_two_grid_factor,
    theory,
)

CFG_T = T.MultigridConfig(smoother="rbgs", omega=1.0)
CFG_J = J.MultigridConfig(smoother="rbgs", omega=1.0)


def test_lfa_factors_equal():
    t, j = TheoreticalAnalyzer(), JTA()
    for omega in (0.5, 0.8, 1.0):
        assert t.jacobi_smoothing_factor(omega) == j.jacobi_smoothing_factor(
            omega)
    assert t.gs_lex_smoothing_factor() == j.gs_lex_smoothing_factor()
    for sm, nu in (("jacobi", 2), ("rbgs", 3), ("sor", 1)):
        assert (t.predicted_two_grid_factor(sm, nu)
                == j.predicted_two_grid_factor(sm, nu))
    with pytest.raises(ValueError):
        t.predicted_two_grid_factor("line_x")


def _levels(n, dtype="float64"):
    pt, pj = T.poisson_mms_sinsin(n), JP.poisson_mms_sinsin(n)
    lt = T.build_hierarchy(pt.grid, pt.spec, dtype=dtype, device="cpu",
                           cfg=CFG_T)
    lj = J.build_hierarchy(pj.grid, pj.spec, dtype=dtype, cfg=CFG_J)
    return lt, lj


def test_two_grid_history_from_jax_draw():
    lt, lj = _levels(65)
    g = lj[0].grid
    e = jax.random.normal(jax.random.PRNGKey(0), g.shape_padded,
                          dtype=jnp.float64)
    e = jnp.where(lj[0].unknown, e, 0.0)
    e0 = torch.from_numpy(np.asarray(e)[: g.nx, : g.ny].copy())
    start = e0.clone()
    got = theory._two_grid_history(lt, e0, CFG_T, 12)
    want = j_measure(lj, CFG_J)
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-10)
    np.testing.assert_allclose(got["ratios"], want["ratios"], rtol=1e-9)
    assert got["rho"] == pytest.approx(want["rho"], rel=1e-9)
    assert torch.equal(e0, start)  # the caller's start is left as it was


def test_seeded_two_grid_factor_near_jax():
    lt, lj = _levels(65)
    got = measure_two_grid_factor(lt, CFG_T, seed=3)
    want = j_measure(lj, CFG_J, seed=3)
    assert len(got["history"]) == 13
    assert abs(got["rho"] - want["rho"]) < 0.02, (got["rho"], want["rho"])
    again = measure_two_grid_factor(lt, CFG_T, seed=3)
    np.testing.assert_array_equal(got["history"], again["history"])


def test_h_independence_matches_jax():
    got = theory.validate_h_independence(T.poisson_mms_sinsin, (33, 65),
                                         CFG_T, device="cpu")
    want = jtheory.validate_h_independence(JP.poisson_mms_sinsin, (33, 65),
                                           CFG_J)
    assert got["h_independent"] == want["h_independent"] is True
    assert set(got["rhos"]) == set(want["rhos"]) == {33, 65}
    for n in (33, 65):
        assert abs(got["rhos"][n] - want["rhos"][n]) < 0.02


@pytest.fixture(scope="module")
def steady_pair():
    """Both validators after the polynomial (round-off floor) and sinsin
    studies at (17, 33, 65)."""
    vt = MMSValidator(CFG_T, device="cpu")
    vj = JMMS(CFG_J)
    for name in ("poisson_mms_polynomial", "poisson_mms_sinsin"):
        vt.validate_steady(getattr(T, name), sizes=(17, 33, 65))
        vj.validate_steady(getattr(JP, name), sizes=(17, 33, 65))
    return vt, vj


def _same_row(a, b, order_atol=1e-6):
    assert (a.problem, a.kind, a.sizes) == (b.problem, b.kind, b.sizes)
    assert a.passed == b.passed
    assert a.exact_floor == b.exact_floor
    assert a.iterations == b.iterations
    assert abs(a.observed_order - b.observed_order) <= order_atol
    if np.isnan(b.h1_order):
        assert np.isnan(a.h1_order)
    else:
        assert abs(a.h1_order - b.h1_order) <= order_atol
    np.testing.assert_allclose(a.l2_errors, b.l2_errors, rtol=1e-6,
                               atol=1e-15)


def test_validate_steady_matches_jax(steady_pair):
    vt, vj = steady_pair
    poly, sinsin = vt.results
    assert poly.exact_floor and poly.passed and np.isnan(poly.h1_order)
    assert sinsin.passed and not sinsin.exact_floor
    assert abs(sinsin.observed_order - 2.0) < 0.3
    for a, b in zip(vt.results, vj.results):
        _same_row(a, b)


def test_report_markdown_and_save(steady_pair, tmp_path):
    vt, vj = steady_pair
    md = vt.report_markdown()
    assert md == vj.report_markdown()
    assert "exact (round-off floor)" in md and "poisson_sinsin" in md
    vt.save(tmp_path / "mms.json")
    vt.save(tmp_path / "mms.md")
    d = json.loads((tmp_path / "mms.json").read_text())
    assert d["total"] == 2 and d["passed"] == 2 and d["failed"] == []
    assert set(d["results"][0]) == set(vj.summary()["results"][0])
    assert (tmp_path / "mms.md").read_text() == md


def test_validate_steady3d_matches_jax():
    cfg_t = CFG_T.replace(tol=1e-8)
    cfg_j = CFG_J.replace(tol=1e-8)
    a = MMSValidator(cfg_t, device="cpu").validate_steady3d(
        T.poisson3d_mms_sinsinsin, sizes=(5, 9))
    b = JMMS(cfg_j).validate_steady3d(JP3.poisson3d_mms_sinsinsin,
                                      sizes=(5, 9))
    _same_row(a, b)
    assert a.kind == "steady_3d"


def test_validate_heat_matches_jax():
    a = MMSValidator(CFG_T, device="cpu").validate_heat(
        THP.oscillating, sizes=(5, 9), t_final=0.002, dt=5e-4)
    b = JMMS(CFG_J).validate_heat(JHP.oscillating, sizes=(5, 9),
                                  t_final=0.002, dt=5e-4)
    assert (a.problem, a.kind, a.passed) == (b.problem, b.kind, b.passed)
    np.testing.assert_allclose(a.l2_errors, b.l2_errors, rtol=1e-8)
    assert abs(a.observed_order - b.observed_order) <= 1e-6


@pytest.mark.parametrize("name", ["poisson_mms_sinsin",
                                  "poisson_mms_inhomogeneous",
                                  "variable_coefficient_mms",
                                  "neumann_test_problem"])
def test_assemble_csr_equals_jax(name):
    """Homogeneous and inhomogeneous Dirichlet rings (the ring's values
    moved into b), a coefficient field, and Neumann sides (ring unknowns
    whose outward neighbours lie off the grid)."""
    A, b, (ii, jj), u0 = baselines._assemble_csr(getattr(T, name)(33))
    Aj, bj, (iij, jjj), u0j = jbase._assemble_csr(getattr(JP, name)(33))
    A.sort_indices()
    Aj.sort_indices()
    assert A.shape == Aj.shape
    np.testing.assert_array_equal(A.indptr, Aj.indptr)
    np.testing.assert_array_equal(A.indices, Aj.indices)
    scale = np.abs(Aj.data).max()
    np.testing.assert_allclose(A.data, Aj.data, rtol=1e-14,
                               atol=1e-14 * scale)
    np.testing.assert_allclose(b, bj, rtol=1e-14,
                               atol=1e-14 * np.abs(bj).max())
    np.testing.assert_array_equal(ii, iij)
    np.testing.assert_array_equal(jj, jjj)
    np.testing.assert_allclose(u0, np.asarray(u0j)[:33, :33], rtol=1e-14,
                               atol=1e-300)


def test_scipy_rows_equal_jax():
    pt, pj = T.poisson_mms_sinsin(33), JP.poisson_mms_sinsin(33)
    bt, bj = PerformanceBaselines(device="cpu"), JBase()
    for meth in ("run_scipy_direct", "run_scipy_cg", "run_scipy_gmres"):
        rt = getattr(bt, meth)(pt, runs=1)
        rj = getattr(bj, meth)(pj, runs=1)
        assert (rt.solver, rt.n, rt.iterations) == (rj.solver, rj.n,
                                                    rj.iterations)
        assert rt.error_l2 == pytest.approx(rj.error_l2, rel=1e-12)
        assert rt.final_residual == pytest.approx(rj.final_residual,
                                                  rel=1e-6, abs=1e-12)


def test_ours_rows_and_missing_packages(tmp_path):
    p = T.poisson_mms_sinsin(33)
    base = PerformanceBaselines(device="cpu")
    ours = base.run_ours(p, "fp64", runs=1)
    mixed = base.run_ours(p, "mixed", runs=1)
    direct = base.run_scipy_direct(p, runs=1)
    for row in (ours, mixed):
        assert row.wall_s > 0 and row.iterations > 0
        assert row.error_l2 == pytest.approx(direct.error_l2, rel=0.02)
    assert base.run_pyamg(p, runs=1) is None
    assert base.run_petsc(p, runs=1) is None
    missing = [r for r in base.rows if not r.available]
    assert [r.solver for r in missing] == ["pyamg", "petsc"]
    base.save(tmp_path / "b.json")
    rep = json.loads((tmp_path / "b.json").read_text())
    assert set(rep) == set(JBase().report())
    assert len(rep["rows"]) == 5
