"""The port's 3D problems and its heat equation with a coefficient field
against the JAX package, on the CPU.

The eight problems of ``models/problems3d.py`` (``CATALOGUE3D`` and the
Neumann, periodic and anisotropic ones): the same data from both
catalogues, and each one's fp32-under-refinement ``solve_poisson3d``; and
``solve_heat3d`` with a coefficient field ``a``. Fields are compared on the
logical (nx, ny, nz) region.

Tolerances, each with its reason:

- problem data: exact (the same float64 arithmetic on the same nodes);
- solves, port ``backend='torch'``: equal outer-step counts, l2 error within
  2% of the JAX one;
- the heat run with a coefficient field: fp64 states within 1e-10 of
  max|u| (the same arithmetic; XLA fuses the step's elementwise ops), fp32
  within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    heat as JH,
    heat3d as JH3,
    poisson3d as jpoisson3d,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems3d as JP3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (  # noqa: E402
    MultigridConfig as JConfig,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.applications import (  # noqa: E402
    heat3d as P3,
)

MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
PROBLEMS = ["poisson3d_mms_sinsinsin", "poisson3d_mms_polynomial",
            "helmholtz3d_mms", "varcoef3d_mms", "jump_coefficient3d",
            "neumann3d_test", "periodic3d_helmholtz", "anisotropic3d_z"]


def _l2_close(got, ref):
    if ref is None:
        assert got is None
    else:
        assert abs(got / ref - 1) <= 0.02, (got, ref)


# ---------------------------------------------------------------------------
# the problems


@pytest.mark.parametrize("name", PROBLEMS)
def test_problems3d_match_jax(name):
    """The same data (f, a, lam, exact, spec, Neumann data) from both
    catalogues, and the fp32-under-refinement solve at 9^3 (line_z on the
    anisotropic box): the JAX package's count and l2."""
    jp, tp = getattr(JP3, name)(9), getattr(T, name)(9)
    ip = interop.problem3d_from_jax(jp)
    for key in ("f", "a", "exact", "dirichlet_values"):
        mine, theirs = getattr(tp, key), getattr(ip, key)
        assert (mine is None and theirs is None) or np.array_equal(mine,
                                                                   theirs)
    assert (tp.spec, tp.lam, tp.bc_values, tp.name, tp.grid) == \
        (ip.spec, ip.lam, ip.bc_values, ip.name, ip.grid)
    torch.testing.assert_close(tp.rhs(torch.float64),
                               ip.rhs(torch.float64), rtol=0, atol=0)
    np.testing.assert_array_equal(
        tp.initial_guess(torch.float64).numpy(),
        np.asarray(jp.initial_guess(jnp.float64))[:9, :9, :9])
    kw = dict(MAIN, smoother="line_z" if name == "anisotropic3d_z"
              else "rbgs")
    jr = jpoisson3d.solve_poisson3d(jp, precision="fp32",
                                    cfg=JConfig(backend="xla", **kw))
    res = T.solve_poisson3d(tp, precision="fp32", cfg=T.MultigridConfig(
        backend="torch", **kw), device="cpu")
    assert res.iterations == jr.iterations and res.converged
    _l2_close(None if res.errors is None else res.errors["l2"],
              None if jr.errors is None else jr.errors["l2"])
    assert set(T.CATALOGUE3D) == set(JP3.CATALOGUE3D)


# ---------------------------------------------------------------------------
# heat with a coefficient field


@pytest.mark.parametrize("dtype,tol,coarsening,n", [
    ("float64", 1e-10, "rediscretize", 9),
    ("float32", 1e-5, "rediscretize", 9),
    ("float64", 1e-10, "galerkin", 5)])
def test_heat3d_with_a_matches_jax(dtype, tol, coarsening, n):
    """solve_heat3d CN, 3 steps with a = 1 + x + y + z on
    pure_diffusion3d(n): the state and its l2 to the JAX package's, the
    shift added to coefficient-field levels, and to the Stencil27 level
    under Galerkin coarsening."""
    jp = JH3.pure_diffusion3d(n)
    X, Y, Z = jp.grid.coordinates(padded=True)
    a = 1.0 + X + Y + Z
    a[n:], a[:, n:], a[:, :, n:] = 0.0, 0.0, 0.0
    jp = dataclasses.replace(jp, a=jnp.asarray(a))
    jc = JH.HeatConfig(dtype=dtype, mg=JConfig(backend="xla",
                                               coarsening=coarsening, **MAIN))
    jr = JH3.solve_heat3d(jp, 3e-3, 1e-3, jc)
    tp = interop.heat_problem3d_from_jax(jp)
    assert tp.a is not None
    tr = P3.solve_heat3d(tp, 3e-3, 1e-3, interop.heat_config_from_jax(jc),
                         device="cpu")
    ref = np.asarray(jr["u"])[:n, :n, :n]
    np.testing.assert_allclose(tr["u"].double().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    assert tr["steps"] == jr["steps"] == 3
    np.testing.assert_allclose(tr["errors"]["l2"], jr["errors"]["l2"],
                               rtol=tol * 10)
