"""The PyTorch port's solvers end to end on the CPU, against the JAX package.

The mixed-precision iterative-refinement solve (fp32 RB-GS V(2,2) cycles,
fp64 outer residual, FMG start) is the main path at a 65^2 size. On the CPU
the port's 'auto' backend runs each kernel wrapper's plain twin, so it must
agree bit for bit with the forced plain path ('torch') and count no kernel
launches.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mixed_precision_multigrid_solvers_for_pdes_tpu as J  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid as jmg,
    refinement as jref,
)
import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    dispatch,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    _build,
    smooth as ksmooth,
    tail as ktail,
    transfer as ktransfer,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9, max_iterations=40)
WRAPPERS = (ksmooth.multisweep, ktransfer.residual_restrict,
            ktransfer.prolong_correct, ktail.tail_vcycle)


@pytest.fixture(scope="module")
def ir65():
    """The main path at 65^2 through both packages."""
    n = 65
    jcfg = J.MultigridConfig(backend="xla", **MAIN)
    jp = JP.poisson_mms_sinsin(n)
    jl = J.build_hierarchy(jp.grid, jp.spec, dtype="float32", cfg=jcfg)
    ju, jinfo = jref.ir_solve(jl, jp.rhs(jnp.float64),
                              jp.initial_guess(jnp.float64), jcfg,
                              inner_cycles=2, use_fmg=True)
    tp = interop.problem_from_jax(jp)
    tl = interop.levels_from_jax(jl)
    out = {"jax": (np.array(ju)[:n, :n], jinfo), "problem": tp,
           "levels": tl}
    for backend in ("torch", "auto"):
        cfg = T.MultigridConfig(backend=backend, **MAIN)
        u, info = T.ir_solve(tl, tp.rhs(torch.float64),
                             tp.initial_guess(torch.float64), cfg,
                             inner_cycles=2, use_fmg=True)
        out[backend] = (u.numpy(), info)
    return out


def test_ir_solve_matches_jax_65(ir65):
    """Same outer iteration count (3), same converged flag, u within 1e-8 on
    the logical region, each residual-history entry within 5%: the fp32
    cycles may round differently, so the tightest step can differ by more
    than round-off."""
    ju, jinfo = ir65["jax"]
    u, info = ir65["torch"]
    assert jinfo["iterations"] == info["iterations"] == 3
    assert jinfo["converged"] and info["converged"]
    assert info["method"] == "iterative_refinement"
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-8)
    np.testing.assert_allclose(info["history"], jinfo["history"], rtol=0.05)
    np.testing.assert_allclose(info["rhs_norm"], jinfo["rhs_norm"],
                               rtol=1e-13)


def test_ir_solve_error_matches_jax_65(ir65):
    ju, _ = ir65["jax"]
    u, _ = ir65["torch"]
    prob = ir65["problem"]
    got = prob.error_norms(torch.from_numpy(u))
    ref = prob.error_norms(torch.from_numpy(ju))
    np.testing.assert_allclose(got["l2"], ref["l2"], rtol=1e-6)
    assert got["l2"] < 2e-4  # O(h^2) discretization error at 65^2


def test_auto_backend_on_cpu_runs_the_twins(ir65):
    """'auto' routes through the kernel wrappers, which run their plain
    twins for CPU tensors: identical result, and no launch counted."""
    for w in WRAPPERS:
        w.launches = 0
    tl, tp = ir65["levels"], ir65["problem"]
    cfg = T.MultigridConfig(backend="auto", **MAIN)
    u, info = T.ir_solve(tl, tp.rhs(torch.float64),
                         tp.initial_guess(torch.float64), cfg,
                         inner_cycles=2, use_fmg=True)
    assert np.array_equal(u.numpy(), ir65["torch"][0])
    assert info["iterations"] == ir65["torch"][1]["iterations"]
    assert [w.launches for w in WRAPPERS] == [0, 0, 0, 0]


@pytest.mark.parametrize("n,use_fmg", [(33, False), (33, True)])
def test_mg_solve_matches_jax(n, use_fmg):
    """Plain cycle iteration (fp64 hierarchy) and the FMG start."""
    jcfg = J.MultigridConfig(backend="xla", smoother="rbgs", omega=1.0,
                             tol=1e-10)
    jp = JP.poisson_mms_sinsin(n)
    jl = J.build_hierarchy(jp.grid, jp.spec, dtype="float64", cfg=jcfg)
    ju, jinfo = jmg.mg_solve(jl, jp.rhs(jnp.float64),
                             jp.initial_guess(jnp.float64), jcfg,
                             use_fmg=use_fmg)
    tp = interop.problem_from_jax(jp)
    cfg = T.MultigridConfig(backend="torch", smoother="rbgs", omega=1.0,
                            tol=1e-10)
    tl = T.build_hierarchy(tp.grid, tp.spec, dtype="float64", cfg=cfg,
                           device="cpu")
    u, info = T.mg_solve(tl, tp.rhs(torch.float64),
                         tp.initial_guess(torch.float64), cfg,
                         use_fmg=use_fmg)
    assert info["iterations"] == jinfo["iterations"]
    assert info["converged"] and jinfo["converged"]
    np.testing.assert_allclose(u.numpy(), np.asarray(ju)[:n, :n], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(info["history"], jinfo["history"], rtol=1e-6)


def test_fmg_matches_jax():
    n = 33
    jcfg = J.MultigridConfig(backend="xla", smoother="rbgs", omega=1.0)
    jp = JP.poisson_mms_sinsin(n)
    jl = J.build_hierarchy(jp.grid, jp.spec, dtype="float32", cfg=jcfg)
    ref = jmg.fmg(jl, jp.rhs(jnp.float32), jcfg)
    tp = interop.problem_from_jax(jp)
    cfg = T.MultigridConfig(backend="torch", smoother="rbgs", omega=1.0)
    tl = T.build_hierarchy(tp.grid, tp.spec, dtype="float32", cfg=cfg,
                           device="cpu")
    got = T.fmg(tl, tp.rhs(torch.float32), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:n, :n],
                               rtol=1e-6, atol=1e-6)


def test_problem_and_hierarchy_match_jax():
    n = 33
    jp = JP.poisson_mms_sinsin(n)
    tp = T.poisson_mms_sinsin(n)
    for name in ("f", "dirichlet_values", "exact"):
        assert np.array_equal(getattr(tp, name),
                              np.asarray(getattr(jp, name))[:n, :n])
    assert np.array_equal(tp.initial_guess(torch.float64).numpy(),
                          np.asarray(jp.initial_guess(jnp.float64))[:n, :n])
    jl = J.build_hierarchy(jp.grid, jp.spec, dtype="float32")
    tl = T.build_hierarchy(tp.grid, tp.spec, dtype="float32", device="cpu")
    assert tl == interop.levels_from_jax(jl)
    assert [lev.grid.nx for lev in tl] == [33, 17, 9, 5, 3]


def test_interop_field_roundtrip():
    g = T.Grid(17, 33)
    t = torch.from_numpy(np.random.default_rng(0).standard_normal(g.shape))
    padded = interop.field_to_jax_layout(t, g)
    assert padded.shape == (32, 128)
    assert not padded[17:].any() and not padded[:, 33:].any()
    assert torch.equal(interop.field_from_jax(padded, g), t)


def test_dispatch_gates():
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0)
    levels = T.build_hierarchy(T.Grid(257, 257), dtype="float32", cfg=cfg,
                               device="cpu")
    assert [dispatch.tail_ok(levels, lvl, cfg, "V")
            for lvl in range(len(levels))] == [False, True, True, True, True,
                                               True, True, True]
    assert dispatch.transfer_fused_ok(levels[0], levels[1], cfg)
    assert not dispatch.tail_ok(levels, 1, cfg.replace(backend="torch"), "V")
    assert not dispatch.transfer_fused_ok(levels[0], levels[1],
                                          cfg.replace(backend="torch"))
    lev64 = T.build_hierarchy(T.Grid(65, 65), dtype="float64", cfg=cfg,
                              device="cpu")
    assert not dispatch.tail_ok(lev64, 0, cfg, "V")
    assert not dispatch.transfer_fused_ok(lev64[0], lev64[1], cfg)
    with pytest.raises(ValueError):
        dispatch.tail_ok(levels, 0, cfg.replace(backend="pallas"), "V")


def test_unported_features_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bc.BCSide(kind=bc.BCKind.PERIODIC)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.build_hierarchy(T.Grid(9, 9),
                          cfg=T.MultigridConfig(coarsening="galerkin"),
                          device="cpu")
    levels = T.build_hierarchy(T.Grid(9, 9), device="cpu")
    u = torch.zeros(9, 9)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.mg_cycle(levels, u, u, T.MultigridConfig(cycle="W",
                                                    backend="torch"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.mg_cycle(levels, u, u, T.MultigridConfig(smoother="line_x",
                                                    backend="torch"))


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    u = torch.zeros(9, 9)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda_fp32("k", u)
    st = T.build_hierarchy(T.Grid(9, 9), device="cpu")[0].stencil
    with pytest.raises(ValueError, match="unsupported method"):
        ksmooth.multisweep(st, u, u, method="line_x")
    with pytest.raises(ValueError, match="coarsening"):
        ktail.tail_vcycle_plain([st, st], u, u, shapes=[(9, 9), (4, 4)],
                                pre=1, post=1, omega=1.0)


ENTRY_POINTS = {
    "solve_poisson": lambda: T.solve_poisson(T.poisson_mms_sinsin(9)),
    "convergence_study": lambda: T.convergence_study(T.poisson_mms_sinsin,
                                                     [9, 17]),
    "solve_poisson3d": lambda: T.solve_poisson3d(
        T.poisson3d_mms_sinsinsin(9)),
    "build_hierarchy": lambda: T.build_hierarchy(T.Grid(9, 9)),
    "build_hierarchy3d": lambda: T.build_hierarchy3d(T.Grid3D(9, 9, 9)),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_run_on_the_card_unless_asked(monkeypatch, entry):
    """Without ``device=`` the entry points resolve to CUDA; on a host
    without a card they raise and name ``device='cpu'``, never falling back
    to the plain CPU path."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.core import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.resolve_device() == torch.device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry]()


def test_port_import_leaves_jax_out():
    code = ("import sys, mixed_precision_multigrid_solvers_for_pdes_torch; "
            "import mixed_precision_multigrid_solvers_for_pdes_torch.interop; "
            "import mixed_precision_multigrid_solvers_for_pdes_torch"
            ".benchmarking.kernel_microbench; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'mixed_precision_multigrid_solvers_for_pdes_tpu'))); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
