"""The port's irregular domain, the corner and L-shaped problems and the
problem catalogue against the JAX package, on the CPU.

Tolerances, each with its reason:

- domain masks, problem data, initial guesses, unknown masks and error
  norms of a given field: bit for bit, or to float64 round-off for the
  norms (the same float64 coordinates, comparisons and sums).
- solves at 129^2 (``solve_poisson(precision='fp32', tol=1e-9)``, RB-GS
  omega = 1): equal outer-step counts (4 and 5) and l2 errors within 2% of
  the JAX ones. The JAX solve runs its fp32 cycles inside one ``jit``,
  where XLA rounds the last bit differently; the fp64 outer loop stops
  both at the same relative residual.
- kernel gates: every one refuses a level that carries a domain, and a
  solve with ``backend='auto'`` on an L-shaped hierarchy reaches no kernel
  wrapper (each wrapper is replaced by one that fails).
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
    domain as jdomain,
    precision as jprec,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (  # noqa: E402
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid as jmg,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    dispatch,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth as ksmooth,
    smooth_planes as kplanes,
    smooth_var as ksmooth_var,
    tail as ktail,
    transfer as ktransfer,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (  # noqa: E402
    plane_solve,
)

MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
L2_RTOL = 0.02
# outer steps and l2 of the JAX reference at 129^2 (the JAX package's
# solve_poisson(precision='fp32') with MAIN on the CPU)
REFERENCE_129 = {"corner_singularity": (4, 4.292021e-6),
                 "l_shaped": (5, 1.407320e-4)}


def _logical(a, n):
    return np.asarray(a)[:n, :n]


@pytest.mark.parametrize("cut", [(0.5, 0.5), (0.3, 0.55), (0.75, 0.25)])
@pytest.mark.parametrize("n", [17, 65, 129])
def test_interior_mask_matches_jax(n, cut):
    """Cuts on the nodes (1/2, 3/4, 1/4) and off them (0.3, 0.55)."""
    g, jg = T.Grid(n, n), JGrid(n, n)
    dom, jdom = T.LShapedDomain(*cut), jdomain.LShapedDomain(*cut)
    want = _logical(jdom.interior_mask(jg), n)
    got = dom.interior_mask(g)
    assert got.shape == (n, n) and got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    i = torch.tensor([0, n // 2, n - 1, n // 3])
    j = torch.tensor([n - 1, n // 2, 0, 2 * n // 3])
    at = dom.interior_mask_at(g, i, j)
    assert np.array_equal(at.numpy(), want[i.numpy(), j.numpy()])


def test_catalogue_matches_jax():
    assert list(T.CATALOGUE) == list(JP.CATALOGUE)
    for name, make in T.CATALOGUE.items():
        prob = make(17)
        assert prob.grid.shape == (17, 17), name


@pytest.mark.parametrize("name", ["corner_singularity", "l_shaped"])
def test_problem_data_match_jax(name):
    n = 65
    prob, jprob = T.CATALOGUE[name](n), JP.CATALOGUE[name](n)
    assert _same(interop.problem_from_jax(jprob), prob)
    assert prob.expected_order == jprob.expected_order == 4.0 / 3.0
    assert prob.domain == interop.domain_from_jax(jprob.domain)
    assert (prob.domain is None) == (name == "corner_singularity")
    for name_ in ("f", "exact", "dirichlet_values"):
        assert np.array_equal(getattr(prob, name_),
                              _logical(getattr(jprob, name_), n))
    assert np.array_equal(prob.initial_guess(torch.float64).numpy(),
                          _logical(jprob.initial_guess(jnp.float64), n))


def _same(a, b):
    """Problems equal field by field (numpy arrays compare elementwise)."""
    for f in ("name", "grid", "spec", "lam", "domain", "expected_order"):
        if getattr(a, f) != getattr(b, f):
            return False
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("f", "exact", "dirichlet_values"))


def test_error_norms_count_the_domain_only():
    """A perturbation inside the removed quadrant changes no error norm;
    the norms of the same field equal the JAX ones."""
    n = 33
    prob, jprob = T.l_shaped_problem(n), JP.l_shaped_problem(n)
    rng = np.random.default_rng(3)
    u = prob.exact + 1e-3 * rng.standard_normal((n, n))
    bumped = u.copy()
    bumped[n // 2 + 2:, n // 2 + 2:] += 10.0
    got = prob.error_norms(torch.from_numpy(u))
    assert prob.error_norms(torch.from_numpy(bumped)) == got
    ju = jnp.asarray(interop.field_to_jax_layout(torch.from_numpy(u),
                                                 jprob.grid))
    want = jprob.error_norms(ju)
    for k in ("l2", "linf", "h1"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0.0), k


@pytest.mark.parametrize("name", ["corner_singularity", "l_shaped"])
def test_solves_match_jax_at_129(name):
    steps, l2 = REFERENCE_129[name]
    ref = japp.solve_poisson(JP.CATALOGUE[name](129), precision="fp32",
                             cfg=jmg.MultigridConfig(**MAIN))
    assert ref.iterations == steps
    assert abs(ref.errors["l2"] / l2 - 1) <= 1e-6
    for backend in ("torch", "auto"):
        res = T.solve_poisson(T.CATALOGUE[name](129), precision="fp32",
                              cfg=T.MultigridConfig(**MAIN, backend=backend),
                              device="cpu")
        assert res.converged and res.iterations == steps
        assert abs(res.errors["l2"] / ref.errors["l2"] - 1) <= L2_RTOL


def test_every_kernel_gate_refuses_a_domain_level(monkeypatch):
    """A-D, H-L all build their unknowns from the rectangle: the gates
    refuse every level of an L-shaped hierarchy (and take the same levels
    without the domain), and an 'auto' solve reaches no kernel wrapper."""
    cfg = T.MultigridConfig(**MAIN)
    prob = T.l_shaped_problem(65)
    for dtype in ("float32", "bfloat16"):
        levels = T.build_hierarchy(prob.grid, prob.spec, dtype=dtype,
                                   domain=prob.domain, device="cpu", cfg=cfg)
        rect = T.build_hierarchy(prob.grid, prob.spec, dtype=dtype,
                                 device="cpu", cfg=cfg)
        for lvl, (lev, plain) in enumerate(zip(levels, rect)):
            assert lev.domain is not None and plain.domain is None
            u = lev.zeros()
            for method in ("rbgs", "jacobi", "rbgs_rev"):
                assert not dispatch.kernel_smooth_ok(u, lev, "auto", method)
                assert dispatch.kernel_smooth_ok(u, plain, "auto", method)
            assert not dispatch.tail_ok(levels, lvl, cfg, "V")
            if plain.grid.nx <= dispatch.TAIL_MAX_ENTRY:
                assert dispatch.tail_ok(rect, lvl, cfg, "V")
            if lvl + 1 < len(levels):
                nxt = levels[lvl + 1]
                assert not dispatch.transfer_fused_ok(lev, nxt, cfg)
                assert not dispatch.transfer_fused_ok(lev, rect[lvl + 1],
                                                      cfg)
                assert not dispatch.transfer_fused_ok(plain, nxt, cfg)
                assert dispatch.transfer_fused_ok(plain, rect[lvl + 1], cfg)
        if dtype == "float32":
            assert not plane_solve.plane_solve_ok(levels, cfg)
            assert plane_solve.plane_solve_ok(rect, cfg)
    # the unknowns: the domain's interior, inside the outer ring
    lev0 = levels[0]
    assert torch.equal(lev0.unknown, T.core.bc.unknown_mask(65, 65)
                       & prob.domain.interior_mask(prob.grid))

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was reached on a domain "
                             "level")

    for mod, names in ((ksmooth, ("multisweep", "multisweep_parity")),
                       (ksmooth_var, ("multisweep_var",)),
                       (ktransfer, ("residual_restrict",
                                    "residual_restrict_var",
                                    "prolong_correct")),
                       (ktail, ("tail_vcycle", "tail_vcycle_var")),
                       (kplanes, ("multisweep_planes",))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    res = T.solve_poisson(T.l_shaped_problem(33), precision="fp32",
                          cfg=cfg, device="cpu")
    assert res.converged


def test_interop_carries_domain_and_policy():
    n = 33
    jprob = JP.l_shaped_problem(n)
    jpol = jprec.policy("mixed")
    jl = jmg.build_hierarchy(jprob.grid, jprob.spec, policy=jpol,
                             domain=jprob.domain)
    tl = interop.levels_from_jax(jl)
    assert [lev.dtype for lev in tl] == list(T.policy("mixed").level_dtypes(
        len(tl)))
    for jlev, lev in zip(jl, tl):
        assert lev.domain == T.LShapedDomain(0.5, 0.5)
        assert np.array_equal(lev.unknown.numpy(),
                              _logical(jlev.unknown, lev.grid.nx))
    assert interop.policy_from_jax(jprec.PrecisionPolicy(
        mode=jprec.Precision.ADAPTIVE, stagnation_window=3)) == \
        T.PrecisionPolicy(mode=T.Precision.ADAPTIVE, stagnation_window=3)
    bf = jnp.asarray(np.linspace(-2, 2, 9 * 9).reshape(9, 9), jnp.bfloat16)
    t = interop.field_from_jax(bf, T.Grid(9, 9))
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(bf, np.float32))
