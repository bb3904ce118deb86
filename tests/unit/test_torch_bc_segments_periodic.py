"""The port's segmented and periodic sides against the JAX package, on the
CPU.

Inputs are numpy arrays from a seed (or the same problem built by both
packages); fields are compared on the logical (nx, ny) region. The JAX
package stores a periodic field with its wrap line in the padding and
refreshes it with ``periodic_sync``; the port reads the wrap neighbours
directly, so its operators get ``u`` unsynced and the JAX side gets the
level's ``sync``.

Tolerances, each with its reason:

- masks, side regions, ``periodic_sync``, stencil planes and
  ``bc_rhs_correction``: bit for bit (the same IEEE operations in the same
  order; the segment claims use float32 fractions in both).
- operator and residual in fp64: 1e-12 relative to the largest reference
  value. Both sum w, e, s, n in the same order, so they agree to round-off.
- whole solves: equal outer-step counts, and the solutions within 1e-8
  relative. The JAX solve runs its fp32 cycles inside one ``jit``, where
  XLA rounds the last bit differently; the fp64 outer loop stops both at
  the same 1e-9 relative residual, far below the discretisation error. The
  periodic JAX solution is compared after ``periodic_sync``: the JAX
  package's ``ir_solve`` leaves its duplicate nodes at the initial guess.
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
    dispatch as jdispatch,
    stencil as jst,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid as jmg,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    dispatch,
    stencil,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (  # noqa: E402
    plane_solve,
)

MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
D, N_, R, P = (bc.BCKind.DIRICHLET, bc.BCKind.NEUMANN, bc.BCKind.ROBIN,
               bc.BCKind.PERIODIC)


def _side(kind, segments=(), kw=None):
    """(JAX BCSide, port BCSide) with the same segments."""
    kw = kw or {}
    jseg = tuple(jbc.BCSegment(lo, hi, kind=jbc.BCKind(k.value), **skw)
                 for lo, hi, k, skw in segments)
    seg = tuple(bc.BCSegment(lo, hi, kind=k, **skw)
                for lo, hi, k, skw in segments)
    return (jbc.BCSide(jbc.BCKind(kind.value), segments=jseg, **kw),
            bc.BCSide(kind, segments=seg, **kw))


def _spec(**sides):
    pairs = {name: _side(*args) for name, args in sides.items()}
    return (jbc.BoundarySpec(**{k: v[0] for k, v in pairs.items()}),
            bc.BoundarySpec(**{k: v[1] for k, v in pairs.items()}))


ROBIN = dict(alpha=1.0, beta=1.0)
SPECS = {
    # the segments of mixed_segment_problem and mixed_segment_mms
    "east_robin_north_neumann": dict(
        east=(D, ((0.5, 1.0, R, ROBIN),)),
        north=(D, ((0.0, 0.5, N_, {}),))),
    "west_neumann_middle": dict(west=(D, ((0.25, 0.75, N_, {}),))),
    # two segments touching at 0.5 on a Neumann default, plus a Robin side
    "touching": dict(
        south=(N_, ((0.0, 0.5, D, {}), (0.5, 1.0, R, ROBIN)))),
    "periodic": dict(west=(P,), east=(P,), south=(P,), north=(P,)),
    "periodic_x_dirichlet_y": dict(west=(P,), east=(P,)),
    "periodic_y_neumann_x": dict(south=(P,), north=(P,), west=(N_,),
                                 east=(R, (), ROBIN)),
}


def _logical(x, n):
    return np.asarray(x)[:n, :n]


def _jax(a, n):
    return jnp.asarray(interop.field_to_jax_layout(torch.from_numpy(a),
                                                   JGrid(n, n)))


def _field(n, seed):
    return np.random.default_rng(seed).standard_normal((n, n))


def test_segment_validation_matches_jax():
    for mod in (jbc, bc):
        with pytest.raises(ValueError, match="lo < hi"):
            mod.BCSegment(0.6, 0.5)
        with pytest.raises(ValueError, match="periodic"):
            mod.BCSegment(0.0, 0.5, kind=mod.BCKind.PERIODIC)
        with pytest.raises(ValueError, match="beta"):
            mod.BCSegment(0.0, 0.5, kind=mod.BCKind.ROBIN, beta=0.0)
        with pytest.raises(ValueError, match="overlapping"):
            mod.BCSide(segments=(mod.BCSegment(0.0, 0.6),
                                 mod.BCSegment(0.5, 1.0)))
        with pytest.raises(ValueError, match="periodic side"):
            mod.BCSide(mod.BCKind.PERIODIC,
                       segments=(mod.BCSegment(0.0, 0.5),))
        with pytest.raises(ValueError, match="west and east"):
            mod.BoundarySpec(west=mod.BCSide(mod.BCKind.PERIODIC)).validate()
        with pytest.raises(ValueError, match="south and north"):
            mod.BoundarySpec(north=mod.BCSide(mod.BCKind.PERIODIC)).validate()


@pytest.mark.parametrize("name", list(SPECS))
def test_masks_properties_and_side_regions_match_jax(name):
    n = 17
    jspec, spec = _spec(**SPECS[name])
    pshape = JGrid(n, n).shape_padded
    for prop in ("all_dirichlet", "any_periodic", "any_segments", "plain"):
        assert getattr(spec, prop) == getattr(jspec, prop), prop
    for side in bc.SIDES:
        assert spec.side(side).kinds == {
            bc.BCKind(k.value) for k in jspec.side(side).kinds}
    ref = jbc.unknown_mask(n, n, pshape, jspec)
    got = bc.unknown_mask(n, n, spec)
    assert np.array_equal(got.numpy(), _logical(ref, n))
    assert not np.asarray(ref)[n:].any() and not np.asarray(ref)[:, n:].any()
    for side in bc.SIDES:
        jreg = jbc.side_regions(side, n, n, pshape, jspec.side(side))
        reg = bc.side_regions(side, n, n, spec.side(side))
        assert len(reg) == len(jreg) == len(spec.side(side).segments) + 1
        for (eff, m), (jeff, jm) in zip(reg, jreg):
            assert (eff.kind.value, eff.alpha, eff.beta) == \
                (jeff.kind.value, jeff.alpha, jeff.beta)
            assert np.array_equal(m.numpy(), _logical(jm, n))


def test_first_segment_wins_at_touching_endpoint():
    """Node 8 of a 17-node side sits at fraction 0.5 exactly, where the
    Dirichlet and Robin segments touch: the first listed one claims it, so
    it is fixed; node 9 is Robin, an unknown."""
    n = 17
    jspec, spec = _spec(**SPECS["touching"])
    got = bc.unknown_mask(n, n, spec)
    assert not got[:9, 0].any() and got[9:-1, 0].all()
    regions = bc.side_regions("south", n, n, spec.south)
    (d, md), (r, mr), (default, rest) = regions
    assert (d.kind, r.kind, default.kind) == (D, R, N_)
    assert md[8, 0] and not mr[8, 0] and mr[9, 0]
    assert not rest.any()  # the segments cover the whole side
    ref = jbc.unknown_mask(n, n, JGrid(n, n).shape_padded, jspec)
    assert np.array_equal(got.numpy(), _logical(ref, n))


@pytest.mark.parametrize("name", ["periodic", "periodic_x_dirichlet_y",
                                  "periodic_y_neumann_x"])
def test_periodic_sync_matches_jax(name):
    n = 17
    jspec, spec = _spec(**SPECS[name])
    u = _field(n, 3)
    jsync = jbc.periodic_sync(n, n, JGrid(n, n).shape_padded, jspec)
    ref = jsync(_jax(u, n))
    got = torch.from_numpy(u.copy())
    assert bc.periodic_sync(spec)(got) is got
    assert np.array_equal(got.numpy(), _logical(ref, n))
    assert bc.periodic_sync(bc.dirichlet()) is None
    wx, wy = spec.wrap
    assert (not wx or torch.equal(got[-1], got[0])) and \
        (not wy or torch.equal(got[:, -1], got[:, 0]))


def _operator_case(name, n, dtype, lam):
    jspec, spec = _spec(**SPECS[name])
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    jlam = lam if np.ndim(lam) == 0 else _jax(lam, n)
    jstc = jst.make_stencil(JGrid(n, n), jspec, lam=jlam, dtype=np_dt)
    st = stencil.make_stencil(T.Grid(n, n), spec, lam=lam, dtype=dtype)
    return jspec, spec, jstc, st


@pytest.mark.parametrize("lam", ["scalar", "array"])
@pytest.mark.parametrize("name", list(SPECS))
def test_operator_and_residual_match_jax_fp64(name, lam):
    n = 17
    lam_v = 0.5 if lam == "scalar" else 0.5 + _field(n, 9) ** 2
    jspec, spec, jstc, st = _operator_case(name, n, torch.float64, lam_v)
    assert st.wrap == spec.wrap
    assert st.scalar == (lam == "scalar" and spec.plain)
    if not st.scalar:  # the coefficient planes: bit for bit
        for k in "cwesn":
            assert np.array_equal(getattr(st, k).numpy(),
                                  _logical(getattr(jstc, k), n)), k
    u, f = _field(n, 1), _field(n, 2)
    sync = jbc.periodic_sync(n, n, JGrid(n, n).shape_padded, jspec)
    unknown = bc.unknown_mask(n, n, spec)
    ju = _jax(u, n) if sync is None else sync(_jax(u, n))
    junknown = jbc.unknown_mask(n, n, JGrid(n, n).shape_padded, jspec)
    ref_r = jst.residual(jstc, ju, _jax(f, n), junknown, sync)
    got_r = stencil.residual(st, torch.from_numpy(u), torch.from_numpy(f),
                             unknown)
    scale = float(np.abs(np.asarray(ref_r)).max())
    np.testing.assert_allclose(got_r.numpy() / scale,
                               _logical(ref_r, n) / scale, rtol=0,
                               atol=1e-12)
    ref_a = np.where(_logical(junknown, n), _logical(jst.apply(jstc, ju), n),
                     0.0)
    got_a = torch.where(unknown, stencil.apply(st, torch.from_numpy(u)),
                        0.0).numpy()
    np.testing.assert_allclose(got_a / scale, ref_a / scale, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["east_robin_north_neumann", "touching"])
def test_bc_rhs_correction_on_segments_matches_jax(name):
    n = 17
    jspec, spec = _spec(**SPECS[name])
    X, Y = T.Grid(n, n).coordinates()
    values = {"east": 3.0 + Y ** 2, "north": 2.0, "south": X - 1.0}
    jvalues = {k: v if np.ndim(v) == 0 else _jax(v, n)
               for k, v in values.items()}
    for np_dt, dt in ((np.float32, torch.float32),
                      (np.float64, torch.float64)):
        ref = jst.bc_rhs_correction(JGrid(n, n), jspec, jvalues, np_dt)
        got = stencil.bc_rhs_correction(T.Grid(n, n), spec, values, dt)
        assert np.array_equal(got.numpy(), _logical(ref, n))


def test_periodic_coefficient_faces_wrap():
    """A coefficient field a = 1 on a periodic spec builds coefficient
    planes equal to the constant stencil on the unknowns, the seam
    included: the face means read the wrap neighbour (the JAX package reads
    its zero padding there and cuts the seam, so it has no reference
    here)."""
    n = 17
    _, spec = _spec(**SPECS["periodic_x_dirichlet_y"])
    g = T.Grid(n, n)
    const = stencil.make_stencil(g, spec, lam=1.0, dtype=torch.float64)
    planes = stencil.make_stencil(g, spec, a=np.ones((n, n)), lam=1.0,
                                  dtype=torch.float64)
    assert const.scalar and not planes.scalar
    unknown = bc.unknown_mask(n, n, spec)
    for k in "cwesn":
        assert (getattr(planes, k)[unknown] == getattr(const, k)).all(), k
    u, f = torch.from_numpy(_field(n, 4)), torch.from_numpy(_field(n, 5))
    assert torch.allclose(stencil.residual(planes, u, f, unknown),
                          stencil.residual(const, u, f, unknown),
                          rtol=0, atol=1e-12)


@pytest.mark.parametrize("make", ["mixed_segment_mms",
                                  "periodic_helmholtz_mms"])
def test_kernel_gates_reject_segmented_and_periodic_specs(make):
    """A segmented or periodic level passes no kernel gate: no smoothing,
    fused transfer, tail or parity-plane kernel (the kernels assume a
    rectangle of unknowns), as the JAX gates route them."""
    prob = getattr(T, make)(33)
    cfg = T.MultigridConfig(backend="auto", **MAIN)
    levels = T.build_hierarchy(prob.grid, prob.spec, a=prob.a, lam=prob.lam,
                               dtype="float32", device="cpu", cfg=cfg)
    for lvl in range(len(levels) - 1):
        assert not dispatch.transfer_fused_ok(levels[lvl], levels[lvl + 1],
                                              cfg)
    for lvl, lev in enumerate(levels):
        assert not dispatch.tail_ok(levels, lvl, cfg, "V")
        assert not dispatch.kernel_smooth_ok(lev.zeros(), lev, "auto",
                                             "rbgs")
    assert not plane_solve.plane_solve_ok(levels, cfg)
    # the JAX package's own gates on the same problem
    jprob = getattr(JP, make)(33)
    jcfg = jmg.MultigridConfig(backend="pallas", **MAIN)
    jl = jmg.build_hierarchy(jprob.grid, jprob.spec, dtype="float32",
                             lam=jprob.lam, cfg=jcfg)
    assert not jdispatch.transfer_fused_ok(jl[0], jl[1], jcfg)
    assert not jdispatch.tail_ok(jl, 0, jcfg, "V")


NEW_PROBLEMS = ["poisson_mms_polynomial", "poisson_mms_high_frequency",
                "poisson_mms_inhomogeneous", "poisson_mms_exponential",
                "poisson_mms_anisotropic", "helmholtz_mms",
                "mixed_segment_problem", "mixed_segment_mms",
                "periodic_helmholtz_mms", "boundary_layer_problem"]


@pytest.mark.parametrize("make", NEW_PROBLEMS)
def test_problem_data_match_jax(make):
    """Every array of a new problem, its right-hand side with the BC terms
    and its initial guess agree bit for bit with the JAX problem's (and
    with the JAX problem carried across by ``interop.problem_from_jax``)."""
    n = 17
    jp, tp = getattr(JP, make)(n), getattr(T, make)(n)
    carried = interop.problem_from_jax(jp)
    assert tp.spec == carried.spec and tp.grid == carried.grid
    assert np.asarray(tp.lam).tolist() == np.asarray(carried.lam).tolist()
    for key in ("f", "exact", "dirichlet_values"):
        assert np.array_equal(getattr(tp, key), getattr(carried, key)), key
        assert np.array_equal(getattr(tp, key), _logical(getattr(jp, key),
                                                         n)), key
    for np_dt, dt in ((np.float32, torch.float32),
                      (np.float64, torch.float64)):
        assert np.array_equal(tp.rhs(dt).numpy(), _logical(jp.rhs(np_dt), n))
        assert np.array_equal(carried.rhs(dt).numpy(),
                              _logical(jp.rhs(np_dt), n))
        assert np.array_equal(tp.initial_guess(dt).numpy(),
                              _logical(jp.initial_guess(np_dt), n))


SOLVES = {"mixed_segment_problem": 33, "mixed_segment_mms": 33,
          "periodic_helmholtz_mms": 33, "poisson_mms_polynomial": 17,
          "poisson_mms_high_frequency": 17, "poisson_mms_inhomogeneous": 17,
          "poisson_mms_exponential": 17, "helmholtz_mms": 17,
          "boundary_layer_problem": 17}


@pytest.mark.parametrize("make", list(SOLVES))
def test_solve_poisson_new_problems_match_jax(make):
    """solve_poisson(precision='fp32', tol=1e-9) with RB-GS V(2,2) cycles
    on the CPU (the anisotropic problem, which needs a line smoother, is
    solved in test_torch_cycles_smoothers.py): the JAX reference's
    outer-step count, converged, and the solution within 1e-8 relative
    (the JAX periodic solution after ``periodic_sync``); the periodic
    duplicates equal node 0."""
    n = SOLVES[make]
    jp, tp = getattr(JP, make)(n), getattr(T, make)(n)
    jres = japp.solve_poisson(jp, precision="fp32",
                              cfg=jmg.MultigridConfig(backend="xla", **MAIN))
    ju = jres.u
    if jp.spec.any_periodic:
        ju = jbc.periodic_sync(n, n, jp.grid.shape_padded, jp.spec)(ju)
    ref = np.array(_logical(ju, n))
    res = T.solve_poisson(tp, precision="fp32",
                          cfg=T.MultigridConfig(**MAIN), device="cpu")
    assert res.converged and jres.converged
    assert res.iterations == jres.iterations
    u = res.u.numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(u / scale, ref / scale, rtol=0, atol=1e-8)
    if tp.spec.any_periodic:
        assert np.array_equal(u[-1], u[0]) and np.array_equal(u[:, -1],
                                                              u[:, 0])
        # the reference bug not copied: JAX's duplicates stay at u0 = 0
        assert not np.asarray(jres.u)[n - 1, : n - 1].any()
    assert abs(res.errors["l2"] / tp.error_norms(torch.from_numpy(ref))
               ["l2"] - 1) < 1e-3
