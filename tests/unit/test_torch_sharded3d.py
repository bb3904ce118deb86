"""The port's 3D hook (``parallel.distributed.make_constrainer3d``:
``mg_solve3d``/``ir_solve3d``, ``solve_poisson3d(mesh=)``, MG-PCG with
``multigrid_preconditioner3d(constrain=)``, the 3D block operators) and
sharded time stepping (``solve_heat(mesh=)``, ``solve_heat3d(mesh=)``) on
four gloo ranks on the CPU, against the port's single-device solves, the
JAX package's single-device solves and, for the fp64 Poisson case, the
JAX package's ``solve_poisson3d(mesh=)`` on the 8-device virtual mesh.

One module-scoped world of four spawned ranks (``parallel.launch.run``)
runs every case of ``CASES`` through ``parallel.checks.run_cases``; while
it runs, this process computes the JAX references. The 3D cases run at
33^3 with ``min_points_per_device`` 8, so that the rule splits two levels
(33^3 and 17^3) on mesh (2, 2); the heat cases are the JAX package's
``TestShardedHeat`` (tests/unit/test_parallel.py) at its size and
configuration: ``pure_diffusion(65)``, fp64, two V(2,2) RB-GS cycles per
step (and extra ones to a 1e-9 residual), CN and BDF2 to t = 0.01 with
dt = 0.002 (BDF2 without the extra cycles, since JAX runs its own BDF2
case only under -m slow) and explicit for 5 steps to t = 2e-4, plus
adaptive dt, a checkpoint save-and-resume, an fp32 CN run on backend
'auto' and a 3D CN run at 33^3. The 3D solves stop at 1e-6 with two
coarsest sweeps (3^3 has one unknown): their counts and bits are held. Every case also runs on a
one-rank mesh of each rank, the single-device solve under the hook. The
children import the port alone (no JAX, no test module).

Tolerances, each with its reason:

- fp64, against the port's single-device solve (plain, and under the hook
  on a one-rank mesh): equal iteration counts (steps for heat) and atol
  1e-11 for solves, 1e-12 for heat (the JAX test's values); the blocks run
  the single-device operations in their order, so the solutions agree to
  the last bit but for the norms' all_reduce order, which can move a
  history in its last bits;
- the kernel route (backend 'auto': E's twin on the split levels' haloed
  windows, A's for the fp32 heat run) against the one-rank solve: bit for
  bit (the twins on a window compute each node as on the whole level); the
  fp32 heat run also against the plain run, whose arithmetic A's twin is;
- against the JAX package's single-device ``mg_solve3d``, ``solve_heat``
  and ``solve_heat3d``: equal counts, atol 1e-11 (heat 1e-12), and the
  heat runs' l2 error below 5e-3 (the JAX test's);
- the JAX package's ``solve_poisson3d(mesh=)`` on 8 devices: equal counts
  and atol 1e-11;
- every 3D block operator on every split level against the plain operator
  on the whole level: bit for bit;
- every rank returns the same result, bit for bit; the heat loop makes one
  global gather (its end) and its step returns a block.
"""

import concurrent.futures

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu import (  # noqa: E402
    parallel as jpar,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    heat as JH,
    heat3d as JH3,
    heat_problems as JHP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson3d import (  # noqa: E402
    solve_poisson3d as jsolve_poisson3d,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems3d as JP3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.preconditioning.multigrid_preconditioner import (  # noqa: E402
    multigrid_preconditioner3d as jmultigrid_preconditioner3d,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    krylov as jkrylov,
    multigrid3d as jmg3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (  # noqa: E402
    MultigridConfig as JConfig,
)

from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import (  # noqa: E402
    checks,
    launch,
)

RANKS = 4
N3, N2 = 33, 65
MESH = (2, 2)
C = checks.Case
SPLIT = {"min_points_per_device": 8}  # 33^3 and 17^3 split on (2, 2)
# a few cycles (the counts and bits are what is held); the coarsest level,
# 3^3, has one unknown, which one sweep solves
TOL = {"tol": 1e-6, "coarse_sweeps": 2}
CASES = {
    # the 3D hook: mg_solve3d on fp64 levels
    "poisson3d": C("sharded3d", "poisson3d_mms_sinsinsin", N3, MESH,
                   changes=TOL, options=SPLIT),
    # W-branching on the two split levels, V below
    "w_cycle3d": C("sharded3d", "poisson3d_mms_sinsinsin", N3, MESH,
                   changes={**TOL, "cycle": "W", "w_depth": 2},
                   options=SPLIT),
    "line_z3d": C("sharded3d", "anisotropic3d_z", N3, MESH,
                  changes={**TOL, "smoother": "line_z"}, options=SPLIT),
    "varcoef3d": C("sharded3d", "varcoef3d_mms", N3, MESH, changes=TOL,
                   options=SPLIT),
    "neumann3d": C("sharded3d", "neumann3d_test", N3, MESH, changes=TOL,
                   options=SPLIT),
    "periodic3d": C("sharded3d", "periodic3d_helmholtz", N3, MESH,
                    changes=TOL, options=SPLIT),
    "galerkin3d": C("sharded3d", "poisson3d_mms_sinsinsin", N3, MESH,
                    changes={**TOL, "coarsening": "galerkin"},
                    options=SPLIT),
    "mg_pcg3d": C("pcg3d", "poisson3d_mms_sinsinsin", N3, MESH,
                  changes={**TOL, "symmetric": True},
                  options={"tol": 1e-10, "maxiter": 30, **SPLIT}),
    # backend 'auto': E's twin on the split levels' windows (held to the
    # one-rank call, so no plain run): 'mixed' ir_solve3d on two split
    # levels, and solve_poisson3d(mesh=) 'adaptive', which splits as the
    # JAX front end does (16 points a rank: 33^3 alone)
    "kernel_mixed3d": C("sharded3d", "poisson3d_mms_sinsinsin", N3, MESH,
                        "mixed", changes={**TOL, "backend": "auto"},
                        options={"plain": False, **SPLIT}),
    "kernel_adaptive3d": C("frontend3d", "poisson3d_mms_sinsinsin", N3,
                           MESH, changes={**TOL, "backend": "auto"},
                           options={"precision": "adaptive",
                                    "plain": False}),
    # the block operators on every split level
    "blocks3d_dirichlet": C("blocks3d", "poisson3d_mms_sinsinsin", N3, MESH,
                            options=SPLIT),
    "blocks3d_varcoef": C("blocks3d", "varcoef3d_mms", N3, MESH,
                          options=SPLIT),
    "blocks3d_neumann": C("blocks3d", "neumann3d_test", N3, MESH,
                          options=SPLIT),
    "blocks3d_periodic": C("blocks3d", "periodic3d_helmholtz", N3, MESH,
                           options=SPLIT),
    "blocks3d_galerkin": C("blocks3d", "poisson3d_mms_sinsinsin", N3, MESH,
                           changes={"coarsening": "galerkin"},
                           options=SPLIT),
    # sharded time stepping: TestShardedHeat, then the port's own cases
    "heat_cn": C("heat", "pure_diffusion", N2, MESH,
                 options={"t_final": 0.01, "dt": 0.002}),
    # two cycles a step: the JAX package runs its own sharded BDF2 case
    # only under -m slow; CN takes the tolerance-driven extra cycles
    "heat_bdf2": C("heat", "pure_diffusion", N2, MESH,
                   options={"scheme": "bdf2", "t_final": 0.01,
                            "dt": 0.002, "step_rtol": 0.0}),
    "heat_explicit": C("heat", "pure_diffusion", N2, MESH,
                       options={"scheme": "explicit", "t_final": 2e-4,
                                "n_steps": 5}),
    # the port's own cases, two cycles a step
    "heat_adaptive": C("heat", "pure_diffusion", N2, MESH,
                       options={"t_final": 0.004, "dt": 0.002,
                                "adaptive_dt": True, "step_rtol": 0.0}),
    "heat_resume": C("heat", "pure_diffusion", N2, MESH,
                     options={"scheme": "bdf2", "t_final": 0.006,
                              "dt": 0.002, "resume_at": 0.004,
                              "step_rtol": 0.0}),
    "heat_kernel_fp32": C("heat", "pure_diffusion", N2, MESH, "float32",
                          changes={"backend": "auto"},
                          options={"t_final": 0.004, "dt": 0.002,
                                   "step_rtol": 0.0}),
    "heat3d_cn": C("heat3d", "pure_diffusion3d", N3, MESH,
                   options={"t_final": 0.006, "dt": 0.002}),
}
SOLVES = [n for n, c in CASES.items() if c.kind in ("sharded3d", "pcg3d")
          and c.dtype == "float64"]
KERNEL3D = [n for n in CASES if n.startswith("kernel_")]
BLOCKS = [n for n, c in CASES.items() if c.kind == "blocks3d"]
HEAT = [n for n, c in CASES.items() if c.kind in ("heat", "heat3d")
        and c.dtype == "float64"]
JCFG = JConfig(smoother="rbgs", omega=1.0, backend="xla", max_iterations=30)
J3CFG = JCFG.replace(**TOL)
# held to JAX here, beside the ranks; the other fp64 solves at their
# configurations in test_torch_sharded3d_jax.py (single device)
JAX_HELD = ("poisson3d", "heat_cn", "heat_explicit", "heat3d_cn")


def _jax_reference(name):
    """What the JAX package computes for case ``name`` on one device (and
    its ``solve_poisson3d(mesh=)`` on 8 for the Poisson case)."""
    case = CASES[name]
    opts = dict(case.options or {})
    n = case.n
    if case.kind in ("sharded3d", "pcg3d"):
        prob = getattr(JP3, case.problem)(n)
        cfg = J3CFG.replace(**case.changes)
        levels = jmg3.build_hierarchy3d(prob.grid, prob.spec, a=prob.a,
                                        lam=prob.lam, dtype="float64",
                                        cfg=cfg)
        if case.kind == "pcg3d":
            lev0 = levels[0]
            u, info = jkrylov.pcg(
                jkrylov.stencil_matvec3d(lev0.stencil, lev0.unknown),
                prob.rhs(jnp.float64),
                precond=jmultigrid_preconditioner3d(levels, cfg),
                tol=opts["tol"], maxiter=opts["maxiter"])
        else:
            u, info = jmg3.mg_solve3d(levels, prob.rhs(jnp.float64),
                                      prob.initial_guess(jnp.float64), cfg)
        out = {"iterations": info["iterations"],
               "u": np.asarray(u, np.float64)[:n, :n, :n]}
        if name == "poisson3d":
            mesh = jpar.make_mesh(jax.devices()[:8])
            res = jsolve_poisson3d(prob, precision="fp64", cfg=cfg,
                                   mesh=mesh)
            out.update(sharded_iterations=res.iterations,
                       sharded_u=np.asarray(res.u, np.float64)[:n, :n, :n])
        return out
    cfg = JH.HeatConfig(scheme=opts.get("scheme", "crank_nicolson"),
                        cycles_per_step=2, dtype="float64", mg=JCFG)
    if case.kind == "heat3d":
        out = JH3.solve_heat3d(JH3.pure_diffusion3d(n), opts["t_final"],
                               opts["dt"], cfg)
        return {"steps": out["steps"], "l2": out["errors"]["l2"],
                "u": np.asarray(out["u"], np.float64)[:n, :n, :n]}
    kw = {"n_steps": opts["n_steps"]} if "n_steps" in opts else {
        "dt": opts["dt"]}
    res = JH.solve_heat(JHP.pure_diffusion(n), t_final=opts["t_final"],
                        cfg=cfg, **kw)
    return {"steps": res.steps, "l2": res.errors["l2"],
            "u": np.asarray(res.u, np.float64)[:n, :n]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's results on four ranks (rank order) and the JAX
    references, computed while the ranks run (three at a time: XLA
    compiles them outside the interpreter lock)."""
    where = str(tmp_path_factory.mktemp("heat_checkpoints"))
    cases = {name: case._replace(options={**case.options,
                                          "directory": where})
             if "resume_at" in (case.options or {}) else case
             for name, case in CASES.items()}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        four = pool.submit(launch.run, checks.run_cases, RANKS, cases, "cpu",
                           timeout=600.0)
        refs = dict(zip(CASES, pool.map(
            lambda name: _jax_reference(name) if name in JAX_HELD else {},
            CASES)))
        port = four.result()
    return port, refs


def _port(results, name):
    port, refs = results
    for rank in range(1, RANKS):  # every rank holds the same result
        other = port[rank][name]
        if "u" in other:
            assert np.array_equal(other["u"], port[0][name]["u"]), rank
    assert port[0][name]["mesh"] == list(MESH)
    return port[0][name], refs[name]


TWO_SPLIT = [[["x"], ["y"]], [["x"], ["y"]]]


@pytest.mark.parametrize("name", SOLVES)
def test_sharded3d_matches_single_device_and_jax(results, name):
    got, ref = _port(results, name)
    assert got["converged"] and got["ref_converged"]
    assert got["iterations"] == got["ref_iterations"] == got["one_iterations"]
    assert got["max_diff_ref"] <= 1e-11
    assert got["max_diff_one"] <= 1e-11
    assert got["tiers"] == TWO_SPLIT
    if ref:
        assert got["iterations"] == ref["iterations"]
        np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=1e-11)


def test_poisson3d_matches_jax_sharded_solve_poisson3d(results):
    got, ref = _port(results, "poisson3d")
    assert got["iterations"] == ref["sharded_iterations"]
    np.testing.assert_allclose(got["u"], ref["sharded_u"], rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("name", KERNEL3D)
def test_kernel_route_3d_equals_one_rank_solve(results, name):
    """E's twin on the blocks' windows equals E's twin on the whole level:
    the sharded solve equals the one-rank (single-device, hooked) solve bit
    for bit, two levels split (one under the front end's rule)."""
    got, _ = _port(results, name)
    assert got["converged"]
    assert got["iterations"] == got["one_iterations"]
    assert got["max_diff_one"] == 0.0
    if name == "kernel_adaptive3d":
        assert got["tiers"] == TWO_SPLIT[:1]  # the front end's rule
        assert got["switches"]  # it promoted, on every rank alike
    else:
        assert got["tiers"] == TWO_SPLIT


@pytest.mark.parametrize("name", BLOCKS)
def test_block_operators_3d_equal_plain(results, name):
    got, _ = _port(results, name)
    checked = [k for k in got if k not in ("tiers", "mesh")]
    kernel = [k for k in checked if k.startswith("kernel_E")]
    # five operators per split level; E (fp32 and bf16, one and two
    # windows) on the scalar all-Dirichlet levels: both of the Dirichlet
    # case, the finest of the Galerkin one (a Stencil27 below)
    assert len(got["tiers"]) == 2
    assert len(checked) - len(kernel) == 5 * 2
    assert len(kernel) == {"blocks3d_dirichlet": 8,
                           "blocks3d_galerkin": 4}.get(name, 0)
    assert all(got[k] for k in checked), [k for k in checked if not got[k]]


@pytest.mark.parametrize("name", HEAT)
def test_sharded_heat_matches_single_device_and_jax(results, name):
    got, ref = _port(results, name)
    assert got["steps"] == got["ref_steps"] == got["one_steps"]
    assert got["max_diff_ref"] <= 1e-12
    assert got["max_diff_one"] <= 1e-12
    assert got["l2"] < 5e-3
    if ref:
        assert got["steps"] == ref["steps"]
        np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=1e-12)
        assert ref["l2"] < 5e-3


def test_heat_kernel_route_equals_one_rank_and_plain(results):
    """A's twin on the 65^2 and 33^2 blocks' windows: the fp32 run equals
    the one-rank run and the plain run bit for bit."""
    got, _ = _port(results, "heat_kernel_fp32")
    assert got["steps"] == got["one_steps"] == got["ref_steps"] == 2
    assert got["max_diff_one"] == 0.0
    assert got["max_diff_ref"] == 0.0
    assert got["tiers"] == TWO_SPLIT


@pytest.mark.parametrize("name", [n for n in HEAT + ["heat_kernel_fp32"]
                                  if n != "heat_resume"])
def test_heat_loop_stays_on_blocks(results, name):
    """The counterpart of the JAX test_output_is_sharded: the run gathers
    the global field once, at its end, and a step returns this rank's
    block of the 2 x 2 layout."""
    got, _ = _port(results, name)
    assert got["gathers"] == 1
    if CASES[name].kind == "heat":
        assert got["step_is_field"] and got["step_block"] == [36, 36]


def test_heat_resume_gathers_only_at_saves(results):
    """A BDF2 run stopped at t = 0.004 with a checkpoint per step, then
    resumed to t = 0.006: two gathers per save (u_prev and u), one per
    run's end, and the resumed result equals the single-device run resumed
    the same way."""
    got, _ = _port(results, "heat_resume")
    saves = 1 + 1  # step 2 (the bootstrap is step 1), then step 3
    assert got["gathers"] == 2 * saves + 2
    assert got["steps"] == 3 and got["max_diff_ref"] <= 1e-12
