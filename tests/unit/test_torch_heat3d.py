"""The port's 3D heat equations (``applications/heat3d.py``) against the
JAX package, on the CPU (``device="cpu"``: the kernel wrappers run their
plain twins).

Tolerances, each with its reason:

- float64 (every scheme on ``oscillating3d`` at 9^3, Crank-Nicolson on all
  three problems at 17^3): the final state within 1e-8 of max|u|, the
  same steps and t; the l2 errors within 1e-8 of max|u|. Measured: 1e-16
  to 5e-16.
- float32 Crank-Nicolson (``pure_diffusion3d`` and ``heat_source3d`` at
  9^3, ``oscillating3d`` at 17^3): the states within 1e-6 of max|u| and the
  l2 errors within 1e-3 relative. Measured: 1.8e-7 to 3.0e-7 and 2e-5 to
  4e-5. XLA contracts the fp32 cycles' multiply-adds into FMAs and torch
  rounds each operation.
- checkpoint resume against the uninterrupted run of the port: bit for
  bit.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    heat as JH,
    heat3d as J3,
)

from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.applications import (  # noqa: E402
    heat as PH,
    heat3d as P3,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.utils import (  # noqa: E402
    CheckpointManager,
)

F64_RTOL = 1e-8
F32_STATE_RTOL = 1e-6
F32_L2_RTOL = 1e-3
PROBLEMS = ("pure_diffusion3d", "oscillating3d", "heat_source3d")
SCHEMES = ("explicit", "backward_euler", "crank_nicolson", "theta", "bdf2")


def _dt(scheme, n):
    """5 steps of dt; explicit within its limit 1/(6 (n-1)^2)."""
    return {9: 2e-4, 17: 5e-5}[n] if scheme == "explicit" else 0.002


CASES = ([("oscillating3d", 9, s, "float64") for s in SCHEMES]
         + [(p, 17, "crank_nicolson", "float64") for p in PROBLEMS]
         + [("pure_diffusion3d", 9, "crank_nicolson", "float32"),
            ("heat_source3d", 9, "crank_nicolson", "float32"),
            ("oscillating3d", 17, "crank_nicolson", "float32")])


@pytest.mark.parametrize("name,n,scheme,dtype", CASES)
def test_heat3d_matches_jax(name, n, scheme, dtype):
    jp, pp = getattr(J3, name)(n), getattr(P3, name)(n)
    assert pp.name == jp.name
    dt = _dt(scheme, n)
    kw = dict(scheme=scheme, dtype=dtype, theta=0.7)
    jres = J3.solve_heat3d(jp, 5 * dt, dt, JH.HeatConfig(**kw))
    pres = P3.solve_heat3d(pp, 5 * dt, dt, PH.HeatConfig(**kw),
                           device="cpu")
    assert pres["steps"] == jres["steps"] == 5
    assert pres["t"] == jres["t"]
    ju = interop.field3d_from_jax(np.asarray(jres["u"]), pp.grid)
    assert pres["u"].dtype == ju.dtype == getattr(torch, dtype)
    scale = ju.abs().max().item()
    du = (pres["u"].double() - ju.double()).abs().max().item()
    l2p, l2j = pres["errors"]["l2"], jres["errors"]["l2"]
    if dtype == "float64":
        assert du <= F64_RTOL * scale
        assert abs(l2p - l2j) <= F64_RTOL * scale
    else:
        assert du <= F32_STATE_RTOL * scale
        assert abs(l2p / l2j - 1) <= F32_L2_RTOL


def test_initial_state_and_mesh():
    """Broadcast coordinates give the full-mesh values; u0 is the exact
    solution at t=0 on every node, the shell included."""
    prob = P3.oscillating3d(9)
    X, Y, Z = prob.mesh(torch.float64)
    assert X.shape == (9, 1, 1) and Y.shape == (1, 9, 1) and Z.shape == (
        1, 1, 9)
    u0 = prob.initial_state(torch.float32)
    assert u0.shape == (9, 9, 9) and u0.is_contiguous()
    full = [torch.as_tensor(c, dtype=torch.float32)
            for c in prob.grid.coordinates()]
    want = prob.exact(*full, torch.tensor(0.0, dtype=torch.float32))
    assert torch.equal(u0, want)


@pytest.mark.parametrize("scheme,first,every", [
    ("crank_nicolson", (0.006, 3, 3), 3),
    ("bdf2", (0.004, 2, 0), 4),
])
def test_resume_matches_uninterrupted(tmp_path, scheme, first, every):
    """Stopped after its first chunk and resumed over the full horizon, a
    run equals the uninterrupted one bit for bit (BDF2: a run whose
    bootstrap covers the first step still saves, and the resume keeps the
    two-step history)."""
    cfg = PH.HeatConfig(scheme=scheme, dtype="float64")
    ref = P3.solve_heat3d(P3.oscillating3d(9), 0.012, 0.002, cfg,
                          device="cpu")
    ck = CheckpointManager(tmp_path / "ck")
    t1, n1, e1 = first
    P3.solve_heat3d(P3.oscillating3d(9), t1, 0.002, cfg, checkpoint=ck,
                    checkpoint_every=e1, device="cpu")
    assert ck.latest_step() == n1
    res = P3.solve_heat3d(P3.oscillating3d(9), 0.012, 0.002, cfg,
                          checkpoint=ck, checkpoint_every=every,
                          device="cpu")
    assert ck.latest_step() == 6
    assert torch.equal(res["u"], ref["u"])


def test_bdf2_single_step_still_saves(tmp_path):
    """n_steps == 1 under BDF2: the bootstrap is the whole run, and the
    checkpoint is written at its end all the same."""
    ck = CheckpointManager(tmp_path / "ck")
    cfg = PH.HeatConfig(scheme="bdf2", dtype="float64")
    res = P3.solve_heat3d(P3.pure_diffusion3d(9), 0.002, 0.002, cfg,
                          checkpoint=ck, device="cpu")
    assert ck.latest_step() == 1
    arrays, meta = ck.restore()
    assert meta["k"] == 1 and meta["scheme"] == "bdf2"
    np.testing.assert_array_equal(arrays["u"], res["u"].numpy())


def test_checkpoint_dt_mismatch_rejected(tmp_path):
    ck = CheckpointManager(tmp_path / "ck")
    cfg = PH.HeatConfig(dtype="float64")
    P3.solve_heat3d(P3.pure_diffusion3d(9), 0.004, 0.002, cfg,
                    checkpoint=ck, device="cpu")
    with pytest.raises(ValueError, match="dt"):
        P3.solve_heat3d(P3.pure_diffusion3d(9), 0.009, 0.003, cfg,
                        checkpoint=ck, device="cpu")


def test_unported_options_raise():
    """mesh= (ROADMAP item 14) and adaptive dt (2D only, as in the JAX
    package) raise; a coefficient field, which raised here before it was
    ported, now runs (test_torch_3d_precision.py holds it to the JAX
    package)."""
    prob = P3.pure_diffusion3d(9)
    out = P3.solve_heat3d(P3.HeatProblem3D("a", prob.grid,
                                           a=np.ones((9,) * 3)),
                          0.01, 0.002, device="cpu")
    assert out["steps"] == 5 and torch.isfinite(out["u"]).all()
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        P3.solve_heat3d(prob, 0.01, 0.002, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="fixed-dt"):
        P3.solve_heat3d(prob, 0.01, 0.002, PH.HeatConfig(adaptive_dt=True),
                        device="cpu")


@pytest.mark.parametrize("name", PROBLEMS)
def test_heat_problem3d_from_jax(name):
    jp = getattr(J3, name)(9, alpha=1.5)
    pp = interop.heat_problem3d_from_jax(jp)
    assert pp.name == jp.name and pp.alpha == 1.5 and pp.u0 is None
    with pytest.raises(ValueError, match="no port problem"):
        interop.heat_problem3d_from_jax(J3.HeatProblem3D("x", jp.grid))
