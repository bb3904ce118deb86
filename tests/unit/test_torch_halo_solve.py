"""The port's explicit distribution path (``parallel.halo_solve``) on four
gloo ranks on the CPU, against the JAX package's ``halo_solve`` on a
4-device slice of the virtual mesh and against the port's single-device
``mg_solve``.

One module-scoped world of four spawned ranks (``parallel.launch.run``)
runs every case of ``CASES`` (the JAX package's
tests/unit/test_halo_solve.py cases, and its explicit-halo
``shard_smooth``/``global_residual_norm`` tests, on meshes (2, 2), (4, 1)
and (1, 1); the ``global_*`` cases of chip_smoke.py's phase 34 on the
world's own mesh, (2, 2), at 129^2 instead of 1025^2) through
``parallel.checks.run_cases``; while it runs,
this process computes the JAX references. Each case is its own test on the
shared result. A second world of two ranks builds ``make_sharded_field``
blocks. The children import the port alone (no JAX, no test module).

Tolerances, each with its reason:

- against the port's ``mg_solve``: equal iteration counts and atol 1e-11 in
  fp64 (the JAX test's); the blocks run the single-device solver's
  operations in its order, so the solutions agree to the last bit except
  for the norms' all_reduce order, which can move a history in its last
  bits. In fp32, equal counts and atol 1e-5.
- against the JAX package's ``halo_solve``: equal counts and atol 1e-11 in
  fp64 (the JAX test's bound against its GSPMD solve); fp32 within one
  iteration and atol 1e-5, as the JAX test holds its fp32 case.
- ``overlap=True`` against ``overlap=False``: bit for bit.
- ``shard_smooth`` against the plain smoother: bit for bit; against the
  JAX ``shard_smooth``: atol 1e-13 (the JAX test's). ``global_residual_norm``:
  rel 1e-12 against both.
- every rank returns the same solution, bit for bit.
"""

import concurrent.futures

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mixed_precision_multigrid_solvers_for_pdes_tpu as jmg_pkg  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu import (  # noqa: E402
    parallel as jpar,
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
from mixed_precision_multigrid_solvers_for_pdes_tpu.parallel import (  # noqa: E402
    halo_solve as jhs,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (  # noqa: E402
    MultigridConfig as JConfig,
)

from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import (  # noqa: E402
    checks,
    launch,
)

RANKS = 4
C = checks.Case
# the JAX package's tests/unit/test_halo_solve.py cases and its
# explicit-halo shard_smooth/global_residual_norm tests; the global_* cases
# run chip_smoke.py's phase 34 at 129^2 on the four ranks' own mesh
CASES = {
    "poisson": C("solve", "poisson_mms_sinsin", 129, (2, 2)),
    "variable_coefficient": C("solve", "variable_coefficient_mms", 65,
                              (2, 2)),
    "galerkin_9point": C("solve", "jump_coefficient_problem", 65, (2, 2),
                         changes={"coarsening": "galerkin"}),
    "periodic": C("solve", "periodic_helmholtz_mms", 129, (2, 2)),
    "periodic_mixed_dirichlet": C("solve", "periodic_x_dirichlet_y", 129,
                                  (2, 2)),
    "neumann": C("solve", "neumann_test_problem", 65, (2, 2)),
    "mixed_segments": C("solve", "mixed_segment_mms", 65, (2, 2)),
    "mixed_segments_robin": C("solve", "mixed_segment_problem", 65, (2, 2)),
    "w_cycle": C("solve", "poisson_mms_sinsin", 65, (2, 2),
                 changes={"cycle": "W"}),
    "fp32_mixed_hierarchy": C("solve", "poisson_mms_sinsin", 65, (2, 2),
                              "float32", {"tol": 1e-4}),
    "l_shaped_domain": C("solve", "l_shaped_problem", 65, (2, 2)),
    "overlap_off_matches_on": C("overlap", "poisson_mms_sinsin", 65, (2, 2)),
    "strip_mesh": C("solve", "poisson_mms_sinsin", 129, (4, 1)),
    "single_device_mesh_replicated": C("solve", "poisson_mms_sinsin", 65,
                                       (1, 1)),
    "line_smoother_raises": C("raises", "poisson_mms_sinsin", 65, (2, 2),
                              changes={"smoother": "adi"}),
    "shard_smooth": C("smooth", "poisson_mms_sinsin", 65, (2, 2)),
    "global_residual_norm": C("norm", "poisson_mms_sinsin", 65, (2, 2)),
    "sharded_field": C("field", "poisson_mms_sinsin", 129, (2, 2)),
    "sharded_field_strip": C("field", "poisson_mms_sinsin", 129, (4, 1)),
    "global_poisson": C("solve", "poisson_mms_sinsin", 129, None),
    "global_jump": C("solve", "jump_coefficient_problem", 129, None,
                     changes={"max_iterations": 60}),
    "global_shard_smooth": C("smooth", "poisson_mms_sinsin", 129, None),
    "global_norm": C("norm", "poisson_mms_sinsin", 129, None),
    "global_field": C("field", "poisson_mms_sinsin", 129, None),
}
SOLVES = [n for n, c in CASES.items() if c.kind == "solve"]
JCFG = JConfig(smoother="rbgs", omega=1.0, backend="xla", max_iterations=30)


def _jax_periodic_x_dirichlet_y(n):
    pi = np.pi
    spec = jbc.BoundarySpec(west=jbc.BCSide(kind=jbc.BCKind.PERIODIC),
                            east=jbc.BCSide(kind=jbc.BCKind.PERIODIC))
    return JP.from_callables(
        "periodic_x_dirichlet_y", JGrid(n, n),
        u_exact=lambda X, Y: np.sin(2 * pi * X) * np.sin(pi * Y),
        f=lambda X, Y: 5 * pi ** 2 * np.sin(2 * pi * X) * np.sin(pi * Y),
        spec=spec)


def _case(name):
    """Case ``name`` with the mesh it runs on: the four ranks' (2, 2) for a
    case on the mesh of the whole world."""
    case = CASES[name]
    return case._replace(mesh=case.mesh or (2, 2))


def _jax_problem(case):
    if case.problem == "periodic_x_dirichlet_y":
        return _jax_periodic_x_dirichlet_y(case.n)
    return getattr(JP, case.problem)(case.n)


def _jax_inputs(case):
    prob = _jax_problem(case)
    cfg = JCFG.replace(**(case.changes or {}))
    levels = jmg_pkg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                     lam=prob.lam, domain=prob.domain,
                                     dtype=case.dtype, cfg=cfg)
    mx, my = case.mesh
    mesh = jpar.make_mesh(jax.devices()[:mx * my], shape=case.mesh)
    return prob, cfg, levels, mesh


def _jax_reference(name):
    """What the JAX package computes for case ``name``."""
    case = _case(name)
    kind, n = case.kind, case.n
    prob, cfg, levels, mesh = _jax_inputs(case)
    f = prob.rhs(jnp.float64)
    if kind in ("solve", "overlap"):
        u0 = prob.initial_guess(jnp.float64)
        u, info = jhs.halo_solve(mesh, levels, f, u0, cfg=cfg)
        return {"iterations": info["iterations"],
                "u": np.asarray(u, np.float64)[:n, :n]}
    if kind == "raises":
        with pytest.raises(NotImplementedError):
            jhs.halo_solve(mesh, levels, f, cfg=cfg)
        return {}
    lev = levels[0]
    if kind == "smooth":
        tlev = checks.case_inputs(case, "cpu")[2][0]
        u = checks.smooth_input(tlev)
        ju = jnp.asarray(interop.field_to_jax_layout(u, lev.grid))
        return {m: np.asarray(jpar.shard_smooth(
            mesh, lev, ju, f, method=m, sweeps=3, omega=0.9))[:n, :n]
            for m in ("jacobi", "rbgs")}
    if kind == "norm":
        u = jnp.zeros(lev.grid.shape_padded, jnp.float64)
        return {"norm": float(jpar.global_residual_norm(mesh, lev, u, f))}
    if kind == "field":
        fn = (lambda X, Y: np.sin(np.pi * X) * np.sin(np.pi * Y))
        from mixed_precision_multigrid_solvers_for_pdes_tpu.parallel import (
            multihost as jmh,
        )
        arr = jmh.make_sharded_field(mesh, prob.grid, fn)
        return {"spec": list(arr.sharding.spec),
                "block_shape": list(arr.addressable_shards[0].data.shape)}
    raise ValueError(kind)


@pytest.fixture(scope="module")
def results():
    """The port's results on four ranks (rank order) and the JAX
    references, computed while the ranks run (three at a time: XLA
    compiles them outside the interpreter lock)."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        four = pool.submit(launch.run, checks.run_cases, RANKS, CASES,
                           "cpu", timeout=600.0)
        refs = dict(zip(CASES, pool.map(_jax_reference, CASES)))
        port = four.result()
    return port, refs


def _port(results, name):
    port, refs = results
    for rank in range(1, RANKS):  # every rank holds the same result
        other = port[rank][name]
        if "u" in other:
            assert np.array_equal(other["u"], port[0][name]["u"]), rank
    return port[0][name], refs[name]


@pytest.mark.parametrize("name", SOLVES)
def test_halo_solve_matches_mg_solve_and_jax(results, name):
    got, ref = _port(results, name)
    fp32 = CASES[name].dtype == "float32"
    atol = 1e-5 if fp32 else 1e-11
    assert got["converged"]
    assert got["iterations"] == got["ref_iterations"]
    assert got["max_diff_ref"] <= atol
    assert abs(got["iterations"] - ref["iterations"]) <= (1 if fp32 else 0)
    np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=atol)
    shape = _case(name).mesh
    # S = 0 exactly on the one-rank mesh: the plain single-device path
    assert (got["n_sharded"] == 0) == (shape == (1, 1))
    assert got["mesh"] == list(shape)


def test_overlap_off_matches_on(results):
    got, ref = _port(results, "overlap_off_matches_on")
    assert got["equal"]
    np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=1e-11)


def test_line_smoother_raises(results):
    got, _ = _port(results, "line_smoother_raises")
    assert got["raised"] and "adi" in got["raised"]


@pytest.mark.parametrize("name", ["shard_smooth", "global_shard_smooth"])
def test_shard_smooth_matches_plain_and_jax(results, name):
    got, ref = _port(results, name)
    for method in ("jacobi", "rbgs"):
        assert got[method]["equal"], method
        np.testing.assert_allclose(got[method]["u"], ref[method], rtol=0,
                                   atol=1e-13)


@pytest.mark.parametrize("name", ["global_residual_norm", "global_norm"])
def test_global_residual_norm_matches(results, name):
    got, ref = _port(results, name)
    assert got["norm"] == pytest.approx(got["ref"], rel=1e-12)
    assert got["norm"] == pytest.approx(ref["norm"], rel=1e-12)


@pytest.mark.parametrize("name", ["sharded_field", "sharded_field_strip",
                                  "global_field"])
def test_make_sharded_field_blocks(results, name):
    got, ref = _port(results, name)
    assert got["block_equal"] and got["gather_equal"]
    assert got["spec"] == ref["spec"]
    assert got["block_shape"] == ref["block_shape"]


def test_make_sharded_field_on_two_ranks():
    """Two ranks, mesh (1, 2): each evaluates its own block only, which
    equals the global field's block; the gather is the global field."""
    two = launch.run(checks.run_cases, 2, {"sharded_field_two": C(
        "field", "poisson_mms_sinsin", 129, (1, 2))}, "cpu", timeout=300.0)
    for rank in (0, 1):
        got = two[rank]["sharded_field_two"]
        assert got["block_equal"] and got["gather_equal"]
        assert got["spec"] == ["x", "y"] and got["block_shape"] == [144, 128]
    assert [r["summary"]["process_count"] for r in two] == [2, 2]
    assert [r["summary"]["backend"] for r in two] == ["gloo", "gloo"]


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank"):
        launch.run(checks.run_cases, 2, {"no_such_case": C(
            "solve", "no_such_problem", 33, (1, 2))}, "cpu", timeout=120.0)
