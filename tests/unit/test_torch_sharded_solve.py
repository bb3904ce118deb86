"""The port's GSPMD path (``parallel.distributed``: ``sharded_solve``,
``make_constrainer``, ``shard_inputs``, ``solve_poisson(mesh=)``,
MG-preconditioned CG on sharded vectors) on four gloo ranks on the CPU,
against the port's single-device plain solve and the JAX package's
single-device solve (and, for the fp64 Poisson case, the JAX package's
``sharded_solve`` on the 8-device virtual mesh).

One module-scoped world of four spawned ranks (``parallel.launch.run``)
runs every case of ``CASES`` (the JAX package's tests/unit/test_parallel.py
solve cases at its size, 65^2, and configuration, RB-GS V(2,2) on the
plain path; the line smoothers, Chebyshev, the other transfers and FMG on
the same problem; FCG, BiCGStab and GMRES beside MG-PCG; the kernel route
on backend 'auto', whose wrappers run their plain twins on the CPU, on the
blocks' haloed windows; the block smoothers against the plain ones)
through ``parallel.checks.run_cases``; while it runs, this process
computes the JAX references. Every case also runs on a one-rank mesh of
each rank, the single-device solve under the sharding hook. Each case is
its own test on the shared result. The children import the port alone
(no JAX, no test module).

Tolerances, each with its reason:

- against the port's single-device solve (plain, and under the hook on a
  one-rank mesh): equal iteration counts and atol 1e-11 in fp64 (the JAX
  test's); the blocks run the single-device operations in its order, so
  the solutions agree to the last bit but for the norms' all_reduce order,
  which can move a history in its last bits;
- the kernel route against the one-rank solve: equal counts, bit for bit
  (the twins on a window compute each node as on the whole level), and in
  fp32 also against the plain solve;
- against the JAX package's single-device solve: equal counts and atol
  1e-11 (the JAX test holds its sharded solve to it so);
- the JAX package's ``sharded_solve`` on 8 devices: equal counts and atol
  1e-11;
- Neumann: l2 error below 1e-3 (the JAX test's);
- the line, ADI and Chebyshev smoothers on every sharded level's blocks
  against the plain smoother on the whole level: bit for bit;
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
from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (  # noqa: E402
    solve_poisson as jsolve_poisson,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.preconditioning import (  # noqa: E402
    multigrid_preconditioner as jmg_precond,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    krylov as jkrylov,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (  # noqa: E402
    MultigridConfig as JConfig,
)

from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import (  # noqa: E402
    checks,
    launch,
)

RANKS = 4
N = 65
C = checks.Case
FRONT = {"tol": 1e-8, "max_iterations": 100}  # the JAX test's cfg
CASES = {
    # TestShardedSolve, TestGradedAgglomeration, TestShardedLineSmoothers
    "poisson": C("sharded", "poisson_mms_sinsin", N, (2, 2)),
    "galerkin_jump": C("sharded", "jump_coefficient_problem", N, (2, 2),
                       changes={"coarsening": "galerkin"}),
    "neumann": C("sharded", "neumann_test_problem", N, (2, 2)),
    "graded": C("sharded", "poisson_mms_sinsin", N, (2, 2, 1, 1)),
    "adi": C("sharded", "poisson_mms_anisotropic", N, (2, 2),
             changes={"smoother": "adi", "omega": 0.8,
                      "max_iterations": 100, "tol": 1e-10}),
    "line_y": C("sharded", "poisson_mms_sinsin", N, (2, 2),
                changes={"smoother": "line_y"}),
    "chebyshev": C("sharded", "poisson_mms_sinsin", N, (2, 2),
                   changes={"smoother": "chebyshev"}),
    # slow to converge on the plain path too: 30 iterations, compared
    "half_weighting_injection": C(
        "sharded", "poisson_mms_sinsin", N, (2, 2),
        changes={"restriction": "half_weighting",
                 "prolongation": "injection"}),
    "injection_injection": C(
        "sharded", "poisson_mms_sinsin", N, (2, 2),
        changes={"restriction": "injection", "prolongation": "injection"}),
    "fmg": C("sharded", "poisson_mms_sinsin", N, (2, 2),
             options={"use_fmg": True}),
    "one_rank_mesh": C("sharded", "poisson_mms_sinsin", N, (1, 1)),
    # TestShardedFrontend
    "frontend_fp64": C("frontend", "poisson_mms_sinsin", N, (2, 2),
                       changes=FRONT, options={"precision": "fp64"}),
    "frontend_mixed": C("frontend", "poisson_mms_sinsin", N, (2, 2),
                        changes=FRONT, options={"precision": "mixed"}),
    "frontend_adaptive": C("frontend", "poisson_mms_sinsin", N, (2, 2),
                           changes=FRONT, options={"precision": "adaptive"}),
    # autotuned on each rank, rank 0's choice taken by all (no JAX
    # reference: the choice follows each side's own timings)
    "frontend_auto": C("frontend", "poisson_mms_sinsin", N, (2, 2),
                       changes=FRONT, options={"precision": "auto"}),
    # TestShardedKrylov, and the other Krylov solvers on the same vectors
    "mg_pcg": C("pcg", "poisson_mms_sinsin", N, (2, 2),
                changes={"symmetric": True},
                options={"tol": 1e-10, "maxiter": 30}),
    "mg_fcg": C("pcg", "poisson_mms_sinsin", N, (2, 2),
                changes={"symmetric": True},
                options={"tol": 1e-10, "maxiter": 30, "solver": "fcg"}),
    "mg_bicgstab": C("pcg", "poisson_mms_sinsin", N, (2, 2),
                     changes={"symmetric": True},
                     options={"tol": 1e-10, "maxiter": 30,
                              "solver": "bicgstab"}),
    "mg_gmres": C("pcg", "poisson_mms_sinsin", N, (2, 2),
                  changes={"symmetric": True},
                  options={"tol": 1e-10, "maxiter": 30, "solver": "gmres"}),
    # backend 'auto': smoothing on the kernel route (kernel A, H on
    # coefficient planes; their plain twins on the CPU), on the blocks'
    # haloed windows and on the replicated levels
    "kernel_fp32": C("sharded", "poisson_mms_sinsin", N, (2, 2), "float32",
                     changes={"backend": "auto"}),
    "kernel_jacobi_graded": C("sharded", "poisson_mms_sinsin", N,
                              (2, 2, 1, 1), "float32",
                              changes={"backend": "auto",
                                       "smoother": "jacobi", "omega": 0.8}),
    "kernel_planes": C("sharded", "variable_coefficient_mms", N, (2, 2),
                       "float32", changes={"backend": "auto"}),
    # 12 sweeps take two windows on 33^2's blocks of 18: fp32 between them
    "kernel_bf16_sweeps": C("sharded", "poisson_mms_sinsin", N, (2, 2),
                            "bfloat16", changes={"backend": "auto",
                                                 "pre_sweeps": 12,
                                                 "symmetric": True}),
    "kernel_mixed": C("frontend", "poisson_mms_sinsin", N, (2, 2),
                      changes={**FRONT, "backend": "auto"},
                      options={"precision": "mixed"}),
    # the block smoothers on every sharded level
    "blocks_dirichlet": C("smooth_blocks", "poisson_mms_sinsin", N, (2, 2)),
    "blocks_graded_jump": C("smooth_blocks", "jump_coefficient_problem", N,
                            (2, 2, 1, 1)),
    "blocks_periodic": C("smooth_blocks", "periodic_helmholtz_mms", N,
                         (2, 2)),
    "blocks_neumann": C("smooth_blocks", "neumann_test_problem", N, (2, 2)),
}
KERNEL = [n for n in CASES if n.startswith("kernel_")]
SHARDED = [n for n, c in CASES.items()
           if c.kind == "sharded" and n not in KERNEL]
FRONTEND = [n for n, c in CASES.items()
            if c.kind == "frontend" and n not in KERNEL]
KRYLOV = [n for n, c in CASES.items() if c.kind == "pcg"]
BLOCKS = [n for n, c in CASES.items() if c.kind == "smooth_blocks"]
JCFG = JConfig(smoother="rbgs", omega=1.0, backend="xla", max_iterations=30)


def _jax_reference(name):
    """What the JAX package computes for case ``name`` on one device (and
    its ``sharded_solve`` on 8 for the Poisson case)."""
    case = CASES[name]
    if case.kind == "smooth_blocks" or name in KERNEL + ["frontend_auto"]:
        return {}
    prob = getattr(JP, case.problem)(case.n)
    cfg = JCFG.replace(**(case.changes or {}))
    opts = dict(case.options or {})
    n = case.n
    if case.kind == "frontend":
        res = jsolve_poisson(prob, cfg=cfg, **opts)
        return {"iterations": res.iterations,
                "u": np.asarray(res.u, np.float64)[:n, :n]}
    levels = jmg_pkg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                     lam=prob.lam, domain=prob.domain,
                                     dtype=case.dtype, cfg=cfg)
    f = prob.rhs(jnp.float64)
    if case.kind == "pcg":
        lev0 = levels[0]
        mv = jkrylov.stencil_matvec(lev0.stencil, lev0.unknown, lev0.sync)
        solver = getattr(jkrylov, opts.pop("solver", "pcg"))
        u, info = solver(mv, f, precond=jmg_precond(levels, cfg), **opts)
        return {"iterations": info["iterations"],
                "u": np.asarray(u, np.float64)[:n, :n]}
    u0 = prob.initial_guess(jnp.float64)
    u, info = jmg_pkg.mg_solve(levels, f, u0, cfg, **opts)
    out = {"iterations": info["iterations"],
           "u": np.asarray(u, np.float64)[:n, :n]}
    if name == "poisson":
        mesh = jpar.make_mesh(jax.devices()[:8])
        us, infos = jpar.sharded_solve(mesh, levels, f, cfg=cfg)
        out.update(sharded_iterations=infos["iterations"],
                   sharded_u=np.asarray(us, np.float64)[:n, :n])
    return out


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
    assert port[0][name]["mesh"] == list(CASES[name].mesh)
    return port[0][name], refs[name]


def _held(got, ref):
    """Equal counts and atol 1e-11 against the port's single-device solve
    (plain, and under the hook on a one-rank mesh) and the JAX package's
    (where it has one)."""
    assert got["converged"] == got["ref_converged"]
    assert got["iterations"] == got["ref_iterations"]
    assert got["max_diff_ref"] <= 1e-11
    assert got["iterations"] == got["one_iterations"]
    assert got["max_diff_one"] <= 1e-11
    if not ref:
        return
    assert got["iterations"] == ref["iterations"]
    np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=1e-11)


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_solve_matches_single_device_and_jax(results, name):
    got, ref = _port(results, name)
    _held(got, ref)
    if "injection" not in name:
        assert got["converged"]
    # every level the rule splits is split, the rest replicated; a mesh of
    # one rank splits nothing (the single-device solve)
    depth = 0 if CASES[name].mesh == (1, 1) else 2
    assert len(got["tiers"]) == depth


def test_sharded_poisson_matches_jax_sharded_solve(results):
    got, ref = _port(results, "poisson")
    assert got["iterations"] == ref["sharded_iterations"]
    np.testing.assert_allclose(got["u"], ref["sharded_u"], rtol=0,
                               atol=1e-11)
    assert got["tiers"] == [[["x"], ["y"]], [["x"], ["y"]]]


def test_neumann_sharded_error(results):
    got, _ = _port(results, "neumann")
    assert got["converged"] and got["l2"] < 1e-3


def test_graded_mesh_runs_three_tiers(results):
    """Mesh (xo, xi, yo, yi) = (2, 2, 1, 1): 65^2 split over both x
    factors (four blocks), 33^2 over the outer one (two blocks, each held
    by a pair of ranks), 17^2 and below replicated."""
    for name in ("graded", "blocks_graded_jump"):
        got, _ = _port(results, name)
        assert got["tiers"] == [[["xo", "xi"], []], [["xo"], []]], name


@pytest.mark.parametrize("name", FRONTEND)
def test_solve_poisson_mesh_matches_single_device_and_jax(results, name):
    got, ref = _port(results, name)
    _held(got, ref)
    assert got["converged"]
    if name == "frontend_adaptive":
        assert got["switches"]  # it promoted, on every rank alike


@pytest.mark.parametrize("name", KRYLOV)
def test_mg_pcg_on_sharded_vectors(results, name):
    got, ref = _port(results, name)
    _held(got, ref)
    assert got["converged"]
    # the Krylov vectors are blocks of the 2 x 2 layout, not global arrays
    assert got["global_shape"] == [N, N]
    assert got["block_shape"] == [36, 36]


@pytest.mark.parametrize("name", KERNEL)
def test_kernel_route_on_blocks_equals_one_rank_solve(results, name):
    """The kernel route's windows equal the kernel on the whole level: the
    sharded solve equals the one-rank (single-device, hooked) solve bit for
    bit; in fp32 the twins' arithmetic is the plain smoother's, so it also
    equals the plain solve."""
    got, _ = _port(results, name)
    assert got["iterations"] == got["one_iterations"]
    assert got["max_diff_one"] == 0.0
    assert len(got["tiers"]) == 2
    if CASES[name].dtype == "float32":
        assert got["iterations"] == got["ref_iterations"]
        assert got["max_diff_ref"] == 0.0


@pytest.mark.parametrize("name", BLOCKS)
def test_block_smoothers_equal_plain(results, name):
    got, _ = _port(results, name)
    checked = [k for k in got if k not in ("tiers", "mesh")]
    assert len(checked) == 4 * len(got["tiers"]) == 8
    assert all(got[k] for k in checked), [k for k in checked if not got[k]]
