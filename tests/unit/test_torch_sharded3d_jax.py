"""The single-device 3D solves that test_torch_sharded3d.py holds its
sharded solves to (atol 1e-11 and equal counts, on four gloo ranks), held
here to the JAX package's single-device ``mg_solve3d`` (and CG with its
``multigrid_preconditioner3d``) at the same configurations: 33^3, tol
1e-6, two coarsest sweeps, the W-cycle, ``line_z``, coefficient-field,
Neumann/Robin, periodic, Galerkin and MG-PCG cases. Equal counts and atol
1e-11 (the JAX sharded test's value); with the other file's bound the
sharded solve is within 2e-11 of JAX. Kept apart from that file, whose
ranks these compiles would outlast."""

import concurrent.futures

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from test_torch_sharded3d import CASES, JAX_HELD, SOLVES, _jax_reference  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import (  # noqa: E402
    checks,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.preconditioning import (  # noqa: E402
    multigrid_preconditioner3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (  # noqa: E402
    krylov,
    multigrid3d as mg3,
)


def _port_single_device(case):
    """The port's single-device solve of ``case`` on the CPU, unhooked."""
    prob, cfg, levels = checks.case_inputs3d(case, "cpu")
    f = prob.rhs(torch.float64, "cpu")
    if case.kind == "pcg3d":
        lev0 = levels[0]
        return krylov.pcg(
            krylov.stencil_matvec3d(lev0.stencil, lev0.unknown), f,
            precond=multigrid_preconditioner3d(levels, cfg),
            tol=case.options["tol"], maxiter=case.options["maxiter"])
    return mg3.mg_solve3d(levels, f, prob.initial_guess(torch.float64, "cpu"),
                          cfg)


NAMES = [n for n in SOLVES if n not in JAX_HELD]


@pytest.fixture(scope="module")
def references():
    """The JAX references, four at a time (XLA compiles outside the
    interpreter lock), the Galerkin one's long compiles first."""
    order = sorted(NAMES, key=lambda name: name != "galerkin3d")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        return dict(zip(order, pool.map(_jax_reference, order)))


@pytest.mark.parametrize("name", NAMES)
def test_single_device_3d_matches_jax(references, name):
    case = CASES[name]
    u, info = _port_single_device(case)
    ref = references[name]
    n = case.n
    assert info["converged"]
    assert info["iterations"] == ref["iterations"]
    np.testing.assert_allclose(u.numpy()[:n, :n, :n], ref["u"], rtol=0,
                               atol=1e-11)
