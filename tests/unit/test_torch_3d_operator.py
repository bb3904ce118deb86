"""The port's 3D operator against the JAX package, on the CPU.

Boundary masks and the periodic sync, ``make_stencil3d`` with a coefficient
field, an array lam and Neumann/Robin/periodic faces, ``bc_rhs_correction3d``,
the 'reflect', wrapped and injection restrictions, the tensor-stencil and
'line_z' smoothers, W and reflect cycles and the Galerkin ``Stencil27``
(RAP, apply, residual), and the kernel gates' refusal of every level the
kernels do not take. Inputs are numpy arrays from a seed, or the same
objects built by both packages; fields are compared on the logical
(nx, ny, nz) region.

Tolerances, each with its reason:

- masks, the sync, the restrictions and fp64 coefficient fields: exact or
  1e-13 relative (the same operations in the same order; the JAX package's
  face means are one XLA fusion, which may round an fp64 quotient once
  differently);
- fp32 coefficient fields and fp32 operators: 1e-6 relative;
- fp64 smoothing sweeps, cycles and the Galerkin RAP: 1e-12 relative (the
  JAX smoothers and cycles are XLA fusions of the same arithmetic; the line
  smoother's tridiagonal solve is LAPACK in the JAX package and PCR here);
- the JAX package's 'reflect' restriction is held everywhere but its coarse
  x = 0 plane, where its padding puts the fold of fine plane -1 and of fine
  plane nf in one padded plane (x is padded to nf + 1); the port's x fold is
  held to the JAX package's y fold by symmetry instead.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (  # noqa: E402
    bc3d as jbc3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.bc import (  # noqa: E402
    BCKind as JKind,
    BCSide as JSide,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid3d import (  # noqa: E402
    Grid3D as JGrid3D,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems3d as JP3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    galerkin as jgal,
    stencil3d as jst3,
    transfer3d as jt3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid3d as jmg3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (  # noqa: E402
    MultigridConfig as JConfig,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core import (  # noqa: E402
    bc3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.core.bc import (  # noqa: E402
    BCKind,
    BCSide,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    dispatch,
    galerkin,
    smooth3d,
    stencil3d,
    transfer3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth3d as ksmooth3d,
    transfer3d as ktransfer3d,
)

# face kinds of each spec: {face: (kind, alpha, beta)}, unnamed faces
# Dirichlet
SPECS = {
    "dirichlet": {},
    "neumann_z": {"bottom": ("neumann",), "top": ("neumann",)},
    "robin_x": {"west": ("robin", 2.0, 1.0), "north": ("neumann",)},
    "neumann_all": {f: ("neumann",) for f in bc3d.SIDES3D},
    "periodic_xz": {"west": ("periodic",), "east": ("periodic",),
                    "bottom": ("periodic",), "top": ("periodic",)},
    "periodic_y_robin_z": {"south": ("periodic",), "north": ("periodic",),
                           "top": ("robin", 1.0, 0.5)},
}
SHAPE = (9, 17, 9)
DTYPES = {"float64": (np.float64, torch.float64, 1e-13),
          "float32": (np.float32, torch.float32, 1e-6)}


def _side(cls, kind_cls, spec):
    return {f: cls(kind=kind_cls(v[0]), **(dict(alpha=v[1], beta=v[2])
                                          if len(v) > 1 else {}))
            for f, v in spec.items()}


def _specs(name):
    spec = SPECS[name]
    return (bc3d.BoundarySpec3D(**_side(BCSide, BCKind, spec)),
            jbc3.BoundarySpec3D(**_side(JSide, JKind, spec)))


def _grids(shape=SHAPE, domain=(0.0, 1.0, 0.0, 1.3, 0.0, 0.7)):
    return T.Grid3D(*shape, domain), JGrid3D(*shape, domain)


def _rand(shape, seed, np_dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np_dtype)


def _jax(a, grid):
    return jnp.asarray(interop.field3d_to_jax_layout(torch.from_numpy(
        np.ascontiguousarray(a)), grid))


def _logical(x, grid):
    return np.asarray(x)[: grid.nx, : grid.ny, : grid.nz]


def _close(got, ref, tol, grid=None):
    ref = np.asarray(ref if grid is None else _logical(ref, grid),
                     np.float64)
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _synced(a, grid, jspec):
    """A JAX padded field of ``a`` with its periodic ghosts filled, as the
    JAX package's operators read it."""
    ja = _jax(a, grid)
    sync = jbc3.periodic_sync3d(grid, jspec)
    return ja if sync is None else sync(ja)


# ---------------------------------------------------------------------------
# boundary masks and the periodic sync


@pytest.mark.parametrize("name", list(SPECS))
def test_masks_and_periodic_sync_match_jax(name):
    spec, jspec = _specs(name)
    g, jg = _grids()
    assert spec.wrap == tuple(
        jspec.side(f).kind == JKind.PERIODIC for f in ("west", "south",
                                                        "bottom"))
    np.testing.assert_array_equal(bc3d.unknown_mask3d(*SHAPE, spec).numpy(),
                                  _logical(jbc3.unknown_mask3d(jg, jspec),
                                           jg))
    for face in bc3d.SIDES3D:
        np.testing.assert_array_equal(
            bc3d.side_mask3d(face, *SHAPE).numpy(),
            _logical(jbc3.side_mask3d(face, jg), jg))
    a = _rand(SHAPE, 1)
    sync = bc3d.periodic_sync3d(spec)
    jsync = jbc3.periodic_sync3d(jg, jspec)
    assert (sync is None) == (jsync is None)
    if sync is not None:
        got = sync(torch.from_numpy(a.copy()))
        np.testing.assert_array_equal(got.numpy(),
                                      _logical(jsync(_jax(a, jg)), jg))


def test_spec_validation_and_constructors():
    with pytest.raises(ValueError, match="both"):
        bc3d.mixed3d(west="periodic").validate()
    with pytest.raises(ValueError, match="faces"):
        bc3d.mixed3d(up="neumann")
    assert bc3d.neumann3d() == bc3d.BoundarySpec3D(
        *(BCSide(kind=BCKind.NEUMANN),) * 6)
    assert bc3d.mixed3d(top="dirichlet").all_dirichlet
    assert not bc3d.mixed3d(top="neumann").plain
    assert bc3d.mixed3d(top="periodic", bottom="periodic").wrap == (
        False, False, True)


# ---------------------------------------------------------------------------
# the operator


def _operator_inputs(name, g, lam_kind):
    """(a, lam) host arrays of the case (a logical field or None)."""
    X, Y, Z = g.coordinates()
    a = None if name == "plain" else 1.0 + X + 0.5 * np.sin(3 * Y) + Z * Z
    lam = 0.75 if lam_kind == "scalar" else 0.5 + X * Y
    return a, lam


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("spec_name,coef,lam_kind", [
    ("dirichlet", "a", "scalar"), ("dirichlet", "plain", "array"),
    ("neumann_z", "a", "array"), ("robin_x", "plain", "scalar"),
    ("neumann_all", "a", "scalar"), ("periodic_xz", "plain", "scalar"),
    ("periodic_y_robin_z", "plain", "array")])
def test_make_stencil3d_apply_residual_match_jax(spec_name, coef, lam_kind,
                                                  dtype):
    """Coefficient fields (fp64 to round-off, fp32 to 1e-6), then A u and
    f - A u on random fields (the periodic ones synced for the JAX
    package). A coefficient field on a periodic axis is not compared: the
    JAX package cuts the face means at the seam (ROADMAP 'Watch for')."""
    np_dtype, t_dtype, tol = DTYPES[dtype]
    spec, jspec = _specs(spec_name)
    g, jg = _grids()
    a, lam = _operator_inputs(coef, g, lam_kind)
    st = stencil3d.make_stencil3d(g, spec, a=a, lam=lam, dtype=t_dtype)
    jpad = (lambda x: x if x is None or np.ndim(x) == 0
            else _jax(x, jg))
    jst = jst3.make_stencil3d(jg, jspec, a=jpad(a), lam=jpad(lam),
                              dtype=np_dtype)
    assert st.scalar == (np.ndim(jst.c) == 0) and st.wrap == spec.wrap
    for got, ref in zip(st.coefs, (jst.c, jst.w, jst.e, jst.s, jst.n,
                                   jst.b, jst.t)):
        if st.scalar:
            assert got == float(ref)
        else:
            _close(got, np.broadcast_to(ref, jg.shape_padded), tol, jg)
    u, f = _rand(SHAPE, 2, np_dtype), _rand(SHAPE, 3, np_dtype)
    unknown = bc3d.unknown_mask3d(*SHAPE, spec)
    ju = _synced(u, jg, jspec)
    un = np.asarray(unknown)
    got = stencil3d.apply(st, torch.from_numpy(u))
    _close(np.where(un, got.numpy(), 0.0),
           np.where(un, _logical(jst3.apply(jst, ju), jg), 0.0), tol * 10)
    got = stencil3d.residual(st, torch.from_numpy(u), torch.from_numpy(f),
                             unknown)
    ref = jst3.residual(jst, ju, _jax(f, jg), jst3.unknown_mask3d(jg,
                                                                  jspec))
    _close(got, ref, tol * 10, jg)


@pytest.mark.parametrize("spec_name", ["neumann_z", "robin_x",
                                       "periodic_y_robin_z"])
def test_bc_rhs_correction3d_matches_jax(spec_name):
    spec, jspec = _specs(spec_name)
    g, jg = _grids()
    face_data = _rand(SHAPE, 4)
    values = {"top": 0.3, "bottom": -1.25, "west": face_data,
              "north": face_data * 2}
    got = stencil3d.bc_rhs_correction3d(g, spec, values, torch.float64)
    ref = jst3.bc_rhs_correction3d(jg, jspec, {
        k: (_jax(v, jg) if np.ndim(v) else v) for k, v in values.items()},
        jnp.float64)
    _close(got, ref, 1e-15, jg)


# ---------------------------------------------------------------------------
# transfers


@pytest.mark.parametrize("method", ["full_weighting", "injection"])
@pytest.mark.parametrize("wrap", [(False, False, False), (True, False, False),
                                  (False, True, True), (True, True, True)])
@pytest.mark.parametrize("boundary", ["zero", "reflect"])
def test_restrict3d_matches_jax(method, wrap, boundary):
    """On the JAX package's synced field (its wrap ghosts in the padding);
    the duplicate coarse nodes of a wrapped axis are left to the level's
    sync and not compared, nor is the JAX reflect fold's coarse x = 0
    plane (module docstring)."""
    g, jg = _grids((17, 9, 9), (0.0, 1.0) * 3)
    gc = jg.coarsen()
    sides = [JSide(kind=JKind.PERIODIC) if w else JSide()
             for w in wrap for _ in (0, 1)]
    jspec = jbc3.BoundarySpec3D(*sides)
    r = _rand(g.shape, 5)
    rt = torch.from_numpy(r.copy())
    for axis, w in enumerate(wrap):
        if w:
            rt.select(axis, -1).copy_(rt.select(axis, 0))
    got = transfer3d.restrict3d(rt, gc.nx, gc.ny, gc.nz, method=method,
                                boundary=boundary, wrap=wrap).numpy()
    ref = _logical(jt3.restrict3d(_synced(r, jg, jspec), gc.nx, gc.ny,
                                  gc.nz, gc.shape_padded, method=method,
                                  boundary=boundary, wrap=wrap), gc)
    keep = np.ones(got.shape, bool)
    for axis, w in enumerate(wrap):
        if w:
            keep[(slice(None),) * axis + (-1,)] = False
    if boundary == "reflect" and method == "full_weighting" and not wrap[0]:
        keep[0] = False
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-14, atol=1e-14)


def test_restrict3d_reflect_folds_x_as_jax_folds_y():
    """The port's x fold at coarse x = 0 equals the JAX package's y fold
    (exact there) on the transposed field, away from the JAX x fold's
    plane (its coarse x = 0, here J = 0)."""
    r = _rand((17, 17, 9), 6)
    got = transfer3d.restrict3d(torch.from_numpy(r), 9, 9, 5,
                                boundary="reflect").numpy()
    jg = JGrid3D(17, 17, 9)
    rt = np.ascontiguousarray(r.transpose(1, 0, 2))
    ref = _logical(jt3.restrict3d(_jax(rt, jg), 9, 9, 5,
                                  jg.coarsen().shape_padded,
                                  boundary="reflect"),
                   jg.coarsen()).transpose(1, 0, 2)
    np.testing.assert_allclose(got[0, 1:], ref[0, 1:], rtol=1e-14,
                               atol=1e-14)


# ---------------------------------------------------------------------------
# smoothers and cycles


@pytest.mark.parametrize("spec_name,method", [
    ("neumann_z", "rbgs"), ("robin_x", "jacobi"), ("dirichlet", "line_z"),
    ("neumann_z", "line_z"), ("periodic_xz", "line_z"),
    ("periodic_y_robin_z", "rbgs_rev")])
def test_tensor_and_line_smoothers_match_jax(spec_name, method):
    """Two sweeps in fp64 on a z-stretched box with a coefficient field
    (scalar on the periodic specs), the JAX smoother given its sync."""
    spec, jspec = _specs(spec_name)
    g, jg = _grids(domain=(0.0, 1.0, 0.0, 1.0, 0.0, 0.1))
    a = None if spec.any_periodic else _operator_inputs("a", g, "")[0]
    st = stencil3d.make_stencil3d(g, spec, a=a, dtype=torch.float64)
    jst = jst3.make_stencil3d(jg, jspec, a=None if a is None
                              else _jax(a, jg), dtype=np.float64)
    u, f = _rand(SHAPE, 7), _rand(SHAPE, 8) * 100
    unknown = bc3d.unknown_mask3d(*SHAPE, spec)
    omega = 0.8 if method == "jacobi" else 1.0
    got = smooth3d.smooth3d(st, torch.from_numpy(u.copy()),
                            torch.from_numpy(f), unknown, method=method,
                            sweeps=2, omega=omega)
    ref = jmg3.smooth3d(jst, _jax(u, jg), _jax(f, jg),
                        jst3.unknown_mask3d(jg, jspec), method=method,
                        sweeps=2, omega=omega,
                        sync=jbc3.periodic_sync3d(jg, jspec))
    un = np.asarray(unknown)
    _close(np.where(un, got.numpy(), 0.0),
           np.where(un, _logical(ref, jg), 0.0), 1e-12)
    if spec.any_periodic:
        # with the level's sync, the duplicate nodes too: refreshed before
        # each update, so one update stale, as in the JAX package
        synced = smooth3d.smooth3d(st, torch.from_numpy(u.copy()),
                                   torch.from_numpy(f), unknown,
                                   method=method, sweeps=2, omega=omega,
                                   sync=bc3d.periodic_sync3d(spec))
        _close(synced, ref, 1e-12, jg)


@pytest.mark.parametrize("cycle,spec_name", [("W", "dirichlet"),
                                             ("F", "dirichlet"),
                                             ("V", "neumann_z"),
                                             ("W", "periodic_xz")])
def test_cycles_match_jax(cycle, spec_name):
    """One fp64 cycle on the levels of a 9 x 17 x 9 grid: W (two coarse
    visits above w_depth),
    F (a V-cycle in 3D, as in the JAX package), the reflect restriction
    with the coarse right-hand side masked, and a periodic W-cycle (wrap
    restriction, synced coarse corrections)."""
    spec, jspec = _specs(spec_name)
    shape = SHAPE
    g, jg = _grids(shape, (0.0, 1.0) * 3)
    kw = dict(smoother="rbgs", omega=1.0, cycle=cycle, w_depth=2)
    levels = T.build_hierarchy3d(g, spec, dtype="float64", device="cpu",
                                 cfg=T.MultigridConfig(backend="torch",
                                                       **kw))
    jcfg = JConfig(backend="xla", **kw)
    jl = jmg3.build_hierarchy3d(jg, jspec, dtype="float64", cfg=jcfg)
    f = _rand(shape, 9) * np.asarray(levels[0].unknown)
    u = T.mg_cycle3d(levels, levels[0].zeros(), torch.from_numpy(f),
                     T.MultigridConfig(backend="torch", **kw))
    ref = jmg3.mg_cycle3d(jl, jnp.zeros(jg.shape_padded), _jax(f, jg), jcfg)
    un = np.asarray(levels[0].unknown)
    _close(np.where(un, u.numpy(), 0.0),
           np.where(un, _logical(ref, jg), 0.0), 1e-12)


# ---------------------------------------------------------------------------
# Galerkin coarsening


def test_galerkin_stencil27_matches_jax():
    """The fp64 RAP chain of the jump problem at 9^3 (Stencil27 below level
    0) to 1e-12 relative, and a Stencil27's apply and residual on a random
    field to round-off."""
    jp = JP3.jump_coefficient3d(9)
    cfg = dict(coarsening="galerkin")
    jl = jmg3.build_hierarchy3d(jp.grid, jp.spec, a=jp.a, dtype="float64",
                                cfg=JConfig(**cfg))
    tp = interop.problem3d_from_jax(jp)
    tl = T.build_hierarchy3d(tp.grid, tp.spec, a=tp.a, dtype="float64",
                             cfg=T.MultigridConfig(**cfg), device="cpu")
    il = interop.levels3d_from_jax(jl)
    assert [type(lev.stencil).__name__ for lev in tl] == \
        ["Stencil3D", "Stencil27", "Stencil27"]
    for mine, theirs in zip(tl[1:], il[1:]):
        for x, y in ((mine.stencil.c, theirs.stencil.c),
                     (mine.stencil.off, theirs.stencil.off)):
            _close(x, y.numpy(), 1e-12)
    st, jst = tl[1].stencil, jl[1].stencil
    jg = jl[1].grid
    u, f = _rand(tl[1].grid.shape, 10), _rand(tl[1].grid.shape, 11)
    _close(stencil3d.apply(st, torch.from_numpy(u)),
           jst3.apply(jst, _jax(u, jg)), 1e-13, jg)
    _close(stencil3d.residual(st, torch.from_numpy(u), torch.from_numpy(f),
                              tl[1].unknown),
           jst3.residual(jst, _jax(u, jg), _jax(f, jg),
                         jst3.unknown_mask3d(jg)), 1e-13, jg)
    direct = galerkin.galerkin_coarse_stencil3d(
        tl[0].stencil, tl[0].grid, tl[1].grid, tl[0].spec, device="cpu")
    assert torch.equal(direct.off, tl[1].stencil.off)
    with pytest.raises(NotImplementedError, match="periodic"):
        galerkin.galerkin_coarse_stencil3d(
            tl[0].stencil, tl[0].grid, tl[1].grid, _specs("periodic_xz")[0],
            device="cpu")
    with pytest.raises(NotImplementedError, match="periodic"):
        jgal.galerkin_coarse_stencil3d(jl[0].stencil, jl[0].grid, jl[1].grid,
                                       _specs("periodic_xz")[1])


# ---------------------------------------------------------------------------
# the kernel gates


def test_3d_gates_refuse_coefficient_periodic_and_27_point_levels():
    """E's gate and F/G's gate take a constant-coefficient 7-point level on
    an all-Dirichlet box in fp32 or bf16, on any device, and refuse a
    coefficient field, an array lam, Neumann or periodic faces, a
    Stencil27 level and fields off the level's dtype; the wrappers refuse
    what the gates refuse, before any launch and on the CPU too."""
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0)
    g = T.Grid3D(9, 9, 9)
    x = np.linspace(0.0, 1.0, 9)
    cases = {
        "box": ({}, True),
        "bf16": (dict(policy=T.policy("bf16")), True),
        "a": (dict(a=1.0 + x[:, None, None] + 0 * x[None, :, None]
                   + 0 * x[None, None, :]), False),
        "lam": (dict(lam=np.ones((9, 9, 9))), False),
        "neumann": (dict(spec=bc3d.mixed3d(top="neumann")), False),
        "periodic": (dict(spec=_specs("periodic_xz")[0]), False),
    }
    for name, (kw, takes) in cases.items():
        spec = kw.pop("spec", bc3d.BoundarySpec3D())
        levels = T.build_hierarchy3d(g, spec, device="cpu", cfg=cfg, **kw)
        lev, nxt = levels[0], levels[1]
        u = lev.zeros()
        assert dispatch.kernel_smooth3d_ok(u, lev, "auto", "rbgs", u) == \
            takes, name
        assert dispatch.transfer_fused3d_ok(lev, nxt, cfg, u, u) == takes, \
            name
        assert not dispatch.kernel_smooth3d_ok(u, lev, "torch", "rbgs")
        if not takes:
            for call in (lambda: ksmooth3d.rbgs3d(lev.stencil, u, u),
                         lambda: ktransfer3d.residual_restrict3d(
                             lev.stencil, u, u)):
                with pytest.raises(ValueError, match="7-point"):
                    call()
    gal = T.build_hierarchy3d(g, device="cpu", cfg=cfg.replace(
        coarsening="galerkin"))
    assert isinstance(gal[1].stencil, stencil3d.Stencil27)
    u1 = gal[1].zeros()
    assert dispatch.transfer_fused3d_ok(gal[0], gal[1], cfg)  # level 0 is
    # a box: F reads its stencil, G none
    assert not dispatch.transfer_fused3d_ok(gal[1], gal[2], cfg)
    assert not dispatch.kernel_smooth3d_ok(u1, gal[1], "auto", "rbgs")
    with pytest.raises(ValueError, match="7-point"):
        ksmooth3d.rbgs3d(gal[1].stencil, u1, u1)
    box = T.build_hierarchy3d(g, device="cpu", cfg=cfg)
    u64 = box[0].zeros().double()
    assert not dispatch.kernel_smooth3d_ok(box[0].zeros(), box[0], "auto",
                                           "rbgs", u64)
    assert not dispatch.transfer_fused3d_ok(box[0], box[1], cfg, u64, u64)
    assert not dispatch.kernel_smooth3d_ok(box[0].zeros(), box[0], "auto",
                                           "line_z")
