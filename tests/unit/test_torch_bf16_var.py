"""bf16 storage in kernels H, I, J and L against the JAX package, on the CPU.

The twins of H (coefficient-plane smoothing), I (coefficient-plane and
reflect residual-restriction), J (the coefficient-plane tail) and L (the
parity layout) on bf16 storage, against the Pallas kernels in interpret
mode; the gates that send bf16 levels to them, against the JAX package's
gates; and ``solve_poisson``'s staged precisions on the three
variable-coefficient problems of chip_smoke.py's phase 33. Inputs are numpy
arrays from a seed; fields are compared on the logical (nx, ny) region.

Tolerances, each with its reason:

- a twin on bf16 storage against the Pallas kernel in interpret mode on the
  same bf16 inputs: within one bf16 ulp (2^-7 of the value) plus 1e-5 of the
  largest value, and equal at most nodes. Both compute in fp32 and round
  once, but their fp32 bodies differ by ~1e-7 relative (the Pallas kernels
  multiply by 1/c and restrict separably; the tail chains about a hundred
  such steps), which moves a value across a bf16 rounding boundary at a few
  nodes. An fp32 result from bf16 inputs (I into an fp32 coarse level, J on
  an fp32 entry with bf16 levels below): 2e-6 of the largest value (1e-5
  for the tail), the fp32 bound of tests/unit/test_torch_varcoef.py.
- gates: exact, on the levels where the JAX package's TPU byte gates
  (64 KB for smoothing, 256 KB for transfers and the tail's entry), which
  the port drops, let it decide.
- solves, port ``backend='torch'`` (the plain path, which rounds bf16
  levels after every op as the JAX XLA path does) against the JAX package:
  equal counts and precision switches, l2 within 2% where the problem has
  an exact solution the grid cannot represent. The Robin problem's
  quadratic solution is exact on the grid, so its l2 (~1e-11) is the
  rounding noise of the stopping residual, which the two packages' fp32
  cycles leave differently: it is held below NOISE_L2. The bf16-start jump
  solve is held within one iteration (its fp32 and fp64 refinement stage
  runs inside one ``jit`` in the JAX package, where XLA contracts and
  reorders fp32 operations, and at 65^2 its last step lands on the other
  side of the tolerance; at 129^2 the counts agree). The port's
  ``backend='auto'`` runs the kernels' twins on the CPU, which round once
  per kernel call: its staged solves converge with l2 within 2% of the
  JAX package's (below NOISE_L2 for Robin), and its 'bf16' cycles reach
  an l2 at most the plain path's.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (  # noqa: E402
    bc as jbc,
    precision as jprec,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (  # noqa: E402
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    dispatch as jdispatch,
    stencil as jst,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.pallas_kernels import (  # noqa: E402
    smooth as psmooth,
    tail as ptail,
    transfer as ptransfer,
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
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth as ksmooth,
    smooth_var as ksmooth_var,
    tail as ktail,
    transfer as ktransfer,
)

import importlib.util  # noqa: E402
import pathlib  # noqa: E402

_SPEC = importlib.util.spec_from_file_location(
    "reference_var_precision", pathlib.Path(__file__).resolve().parents[2]
    / "scripts" / "reference_var_precision.py")
REF = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(REF)

BF16 = torch.bfloat16
TOL = 1e-5
KERNEL_TOL = 2e-6
L2_RTOL = 0.02
NOISE_L2 = 1e-9
ROBIN = dict(alpha=1.0, beta=1.0)


def _field(shape, seed, scale=1.0, ring=False):
    rng = np.random.default_rng(seed)
    a = np.zeros(shape, np.float32)
    if ring:
        a[:] = scale * rng.standard_normal(shape)
    else:
        a[1:-1, 1:-1] = scale * rng.standard_normal(
            (shape[0] - 2, shape[1] - 2))
    return a


def _bf16(a):
    return torch.from_numpy(a).to(BF16)


def _jax(t, n, dtype=jnp.bfloat16):
    a = interop.field_to_jax_layout(t.float(), JGrid(n, n))
    return jnp.asarray(a, dtype)


def _coef(n, kind):
    X, Y = T.Grid(n, n).coordinates()
    if kind == "jump":
        return np.where(X < 0.5, 1.0, 1e3)
    return 1.0 + X + Y


def _specs(name):
    """(port spec, JAX spec) of a side set."""
    if name == "dirichlet":
        return bc.dirichlet(), jbc.dirichlet()
    if name == "south_robin":
        return (bc.BoundarySpec(south=bc.BCSide(bc.BCKind.ROBIN, **ROBIN)),
                jbc.BoundarySpec(south=jbc.BCSide(jbc.BCKind.ROBIN,
                                                  **ROBIN)))
    if name == "east_neumann":
        return bc.mixed(east="neumann"), jbc.mixed(east="neumann")
    raise ValueError(name)


def _var_stencils(n, dtype=BF16, a_kind="jump", side_set="dirichlet"):
    """The port's stencil of an n^2 level in ``dtype`` and the JAX
    package's with the same planes (the port's, in the JAX layout)."""
    spec, _ = _specs(side_set)
    a = _coef(n, a_kind) if a_kind else None
    st = stencil.make_stencil(T.Grid(n, n), spec, a=a).astype(dtype)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    return st, jst.Stencil(*(_jax(x, n, jdt) for x in st.coefs))


def _within_a_bf16_ulp(got, ref_padded, n, equal_share=0.95):
    """Each value within one bf16 ulp of the reference (plus TOL of the
    largest), and at least ``equal_share`` of them equal."""
    ref = np.asarray(ref_padded, np.float32)[:n, :n]
    g = got.float().numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = np.abs(g - ref)
    assert (err <= 2.0 ** -7 * np.abs(ref) + TOL * scale).all(), \
        float(err.max())
    assert (err == 0).mean() >= equal_share, (err == 0).mean()


def _scaled_close(got, ref_padded, n, tol=KERNEL_TOL):
    ref = np.asarray(ref_padded, np.float32)[:n, :n]
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got.float().numpy() / scale, ref / scale,
                               rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the twins on bf16 storage against the Pallas kernels in interpret mode


@pytest.mark.parametrize("n", [65, 33])
@pytest.mark.parametrize("method", ["rbgs", "jacobi"])
def test_smooth_var_bf16_twin_matches_pallas(n, method):
    """H's twin: u, f and the five planes in bf16, two sweeps in fp32, one
    rounding."""
    st, jstc = _var_stencils(n)
    u = _bf16(_field((n, n), 41))
    f = _bf16(_field((n, n), 42, 1e3))
    omega = 0.8 if method == "jacobi" else 1.0
    ref = psmooth.multisweep(jstc, _jax(u, n), _jax(f, n), nx=n, ny=n,
                             method=method, sweeps=2, omega=omega,
                             interpret=True)
    assert ref.dtype == jnp.bfloat16
    got = ksmooth_var.multisweep_var(st, u.clone(), f, method=method,
                                     sweeps=2, omega=omega)
    assert got.dtype == BF16
    _within_a_bf16_ulp(got, ref, n)


@pytest.mark.parametrize("n", [65, 33])
def test_parity_bf16_twin_matches_pallas(n):
    """L's twin: the parity layout on bf16 u and f (layout='parity')."""
    g = T.Grid(n, n)
    st = stencil.make_stencil(g).astype(BF16)
    jstc = jst.make_stencil(JGrid(n, n)).astype(jnp.bfloat16)
    u = _bf16(_field(g.shape, 43))
    f = _bf16(_field(g.shape, 44, st.c))
    ref = psmooth.multisweep(jstc, _jax(u, n), _jax(f, n), nx=n, ny=n,
                             method="rbgs", sweeps=2, omega=1.0,
                             layout="parity", interpret=True)
    got = ksmooth.multisweep(st, u.clone(), f, sweeps=2, layout="parity")
    assert got.dtype == BF16
    _within_a_bf16_ulp(got, ref, n)
    # the parity twin and the direct twin round at the same point
    direct = ksmooth.multisweep_plain(st, u.clone(), f, sweeps=2)
    assert torch.equal(got, direct)


@pytest.mark.parametrize("side_set", ["dirichlet", "south_robin",
                                      "east_neumann"])
@pytest.mark.parametrize("out", ["bf16", "fp32"])
def test_transfer_var_bf16_twin_matches_pallas(side_set, out):
    """I's twin on a bf16 fine level into a bf16 or an fp32 coarse level,
    with the per-side flags of each side set."""
    n, nc = 65, 33
    a_kind = "smooth" if side_set == "dirichlet" else None
    st, jstc = _var_stencils(n, a_kind=a_kind, side_set=side_set)
    sides = _specs(side_set)[0].dirichlet_sides
    u = _bf16(_field((n, n), 45, ring=True))
    f = _bf16(_field((n, n), 46, 50.0, ring=True))
    out_t = BF16 if out == "bf16" else torch.float32
    ref = ptransfer.residual_restrict(
        jstc, _jax(u, n), _jax(f, n), nxf=n, nyf=n, ncx=nc, ncy=nc,
        pshape_coarse=JGrid(nc, nc).shape_padded,
        out_dtype=jnp.bfloat16 if out == "bf16" else jnp.float32,
        sides=sides, interpret=True)
    got = ktransfer.residual_restrict_var(st, u, f, sides=sides,
                                          out_dtype=out_t)
    assert got.dtype == out_t
    if out == "bf16":
        _within_a_bf16_ulp(got, ref, nc)
    else:
        _scaled_close(got, ref, nc)
    coarse = bc.unknown_mask(nc, nc, _specs(side_set)[0]).numpy()
    assert not got.float().numpy()[~coarse].any()


def _tail_stencils(sizes, dtypes):
    """The jump problem's planes on each tail level, in its dtype."""
    a = _coef(sizes[0], "jump")
    sts, jsts = [], []
    for n, dt in zip(sizes, dtypes):
        step = (sizes[0] - 1) // (n - 1)
        st = stencil.make_stencil(T.Grid(n, n), a=a[::step, ::step])
        st = st.astype(dt)
        jdt = jnp.bfloat16 if dt == BF16 else jnp.float32
        sts.append(st)
        jsts.append(jst.Stencil(*(_jax(x, n, jdt) for x in st.coefs)))
    return sts, jsts


@pytest.mark.parametrize("entry", ["bf16", "fp32"])
def test_tail_var_bf16_twin_matches_pallas(entry):
    """J's twin from 33^2: a bf16 entry over bf16 levels, and an fp32
    entry over bf16 levels below it (a 'mixed' tail); every level computed
    in fp32, the entry rounded once."""
    sizes = [33, 17, 9, 5, 3]
    dt0 = BF16 if entry == "bf16" else torch.float32
    sts, jsts = _tail_stencils(sizes, [dt0] + [BF16] * 4)
    meta = tuple((k, k) + JGrid(k, k).shape_padded for k in sizes)
    u = torch.from_numpy(_field((33, 33), 47)).to(dt0)
    f = torch.from_numpy(_field((33, 33), 48, 1e3)).to(dt0)
    jdt = jnp.bfloat16 if entry == "bf16" else jnp.float32
    kw = dict(pre=2, post=2, omega=1.0, method="rbgs", coarse_sweeps=32,
              symmetric=False)
    ref = ptail.tail_vcycle_var(jsts, _jax(u, 33, jdt), _jax(f, 33, jdt),
                                meta=meta, interpret=True, **kw)
    got = ktail.tail_vcycle_var(sts, u.clone(), f,
                                shapes=[(k, k) for k in sizes], **kw)
    assert got.dtype == dt0
    if entry == "bf16":
        _within_a_bf16_ulp(got, ref, 33, equal_share=0.9)
    else:
        _scaled_close(got, ref, 33, tol=TOL)
    # every level in fp32: the same cycle on the widened planes
    wide = ktail.tail_vcycle_plain([st.astype(torch.float32) for st in sts],
                                   u.float(), f.float(),
                                   shapes=[(k, k) for k in sizes], **kw)
    assert torch.equal(got, wide.to(dt0))


def test_bf16_var_wrappers_count_no_launch_on_the_cpu():
    """On CPU tensors H, I, J and L run their twins: no launch, no bf16
    launch."""
    wrappers = (ksmooth_var.multisweep_var, ktransfer.residual_restrict_var,
                ktail.tail_vcycle_var, ksmooth.multisweep_parity)
    for w in wrappers:
        w.launches = w.launches_bf16 = 0
    st, _ = _var_stencils(17)
    u, f = _bf16(_field((17, 17), 49)), _bf16(_field((17, 17), 50))
    ksmooth_var.multisweep_var(st, u.clone(), f)
    ktransfer.residual_restrict_var(st, u, f)
    ktail.tail_vcycle_var([st], u.clone(), f, shapes=[(17, 17)], pre=2,
                          post=2, omega=1.0)
    sc = stencil.make_stencil(T.Grid(17, 17)).astype(BF16)
    ksmooth.multisweep(sc, u.clone(), f, layout="parity")
    assert [(w.launches, w.launches_bf16) for w in wrappers] == \
        [(0, 0)] * len(wrappers)


# ---------------------------------------------------------------------------
# the gates


PROBLEMS = {"varcoef": ("dirichlet", "smooth"), "jump": ("dirichlet", "jump"),
            "robin": ("south_robin", None)}


def _hierarchies(problem, mode, n=513):
    side_set, a_kind = PROBLEMS[problem]
    spec, jspec = _specs(side_set)
    a = _coef(n, a_kind) if a_kind else None
    ja = None if a is None else interop.field_to_jax_layout(
        torch.from_numpy(a), JGrid(n, n))
    jcfg = jmg.MultigridConfig(backend="pallas", smoother="rbgs")
    cfg = T.MultigridConfig(backend="auto", smoother="rbgs")
    jl = jmg.build_hierarchy(JGrid(n, n), jspec, a=ja,
                             policy=jprec.policy(mode), cfg=jcfg)
    tl = T.build_hierarchy(T.Grid(n, n), spec, a=a, policy=T.policy(mode),
                           cfg=cfg, device="cpu")
    return jl, tl, jcfg, cfg


def _jax_bytes(lev):
    px, py = lev.grid.shape_padded
    return px * py * jnp.dtype(lev.dtype).itemsize


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_gates_route_bf16_levels_as_jax(problem, mode):
    """Smoothing (H), the transfer pair (I and C) and the tail (J) on the
    bf16 and mixed hierarchies of the varcoef, jump and Robin problems at
    513^2: the port's gates agree with the JAX package's wherever its TPU
    byte gates let it decide; a Robin level smooths plain and has no tail,
    and a 'mixed' tail (fp32 entry, bf16 below) goes to J by its entry."""
    jl, tl, jcfg, cfg = _hierarchies(problem, mode)
    assert [lev.dtype for lev in tl] == [
        {jnp.dtype(jnp.float32): torch.float32,
         jnp.dtype(jnp.bfloat16): BF16}[jnp.dtype(lev.dtype)] for lev in jl]
    decided = 0
    for lvl, (jlev, lev) in enumerate(zip(jl, tl)):
        u = lev.zeros()
        ju = jnp.zeros(jlev.grid.shape_padded, jlev.dtype)
        if _jax_bytes(jlev) >= jdispatch._MIN_PALLAS_BYTES:
            assert dispatch.kernel_smooth_ok(u, lev, "auto", "rbgs") == \
                jdispatch._pallas_smooth_ok(jlev.stencil, ju, jlev,
                                            "pallas", "rbgs"), lvl
            decided += 1
        if lvl + 1 < len(tl) and \
                _jax_bytes(jlev) >= jdispatch._MIN_TRANSFER_BYTES:
            assert dispatch.transfer_fused_ok(lev, tl[lvl + 1], cfg, u, u) \
                == jdispatch.transfer_fused_ok(jlev, jl[lvl + 1], jcfg), lvl
            decided += 1
        if _jax_bytes(jlev) <= ptail.TAIL_MAX_ENTRY_BYTES and \
                lev.grid.nx <= dispatch.TAIL_MAX_ENTRY:
            assert dispatch.tail_ok(tl, lvl, cfg, "V", u, u) == \
                jdispatch.tail_ok(jl, lvl, jcfg, "V"), lvl
            decided += 1
    assert decided >= 4
    entry = [lev.grid.nx for lev in tl].index(129)
    u = tl[entry].zeros()
    assert dispatch.tail_ok(tl, entry, cfg, "V", u, u) == (problem != "robin")
    assert dispatch.kernel_smooth_ok(tl[0].zeros(), tl[0], "auto", "rbgs") \
        == (problem != "robin")
    if mode == "mixed":
        assert tl[entry].dtype == torch.float32 and tl[-1].dtype == BF16


def test_gates_refuse_what_jax_refuses():
    """Fields off the level's dtype, domain and Stencil9 levels stay plain
    on bf16 as on fp32; K stays fp32."""
    _, tl, _, cfg = _hierarchies("varcoef", "bf16", n=65)
    lev, nxt = tl[0], tl[1]
    u32 = torch.zeros(lev.grid.shape)
    assert not dispatch.kernel_smooth_ok(u32, lev, "auto", "rbgs")
    assert not dispatch.transfer_fused_ok(lev, nxt, cfg, u32, u32)
    assert not dispatch.tail_ok(tl, 0, cfg, "V", u32, u32)
    assert not dispatch.kernel_planes_ok(torch.zeros(4, 33, 33, dtype=BF16),
                                         "auto")
    prob = T.l_shaped_problem(65)
    dl = T.build_hierarchy(prob.grid, prob.spec, domain=prob.domain,
                           policy=T.policy("bf16"), device="cpu")
    assert not dispatch.kernel_smooth_ok(dl[0].zeros(), dl[0], "auto",
                                         "rbgs")
    gal = T.build_hierarchy(T.Grid(65, 65), a=_coef(65, "jump"),
                            policy=T.policy("bf16"), device="cpu",
                            cfg=cfg.replace(coarsening="galerkin"))
    assert not dispatch.kernel_smooth_ok(gal[1].zeros(), gal[1], "auto",
                                         "rbgs")
    assert not dispatch.transfer_fused_ok(gal[0], gal[1], cfg)


# ---------------------------------------------------------------------------
# solve_poisson's staged precisions on the three problems


@pytest.mark.parametrize("precision", list(REF.PRECISIONS))
@pytest.mark.parametrize("problem", list(REF.PROBLEMS))
def test_var_precisions_match_jax(problem, precision):
    n = 65
    jfac, tfac = REF.PROBLEMS[problem]
    steps, l2, switches = REF.jax_run(jfac(n), precision)
    prob = tfac(n)
    got = REF.port_run(prob, precision, "torch")
    slack = 1 if (problem, precision) == ("jump", "bf16_start") else 0
    assert abs(got[0] - steps) <= slack
    assert [s[1] for s in got[2]] == [s[1] for s in switches]
    if slack == 0:
        assert got[2] == switches
    twins = REF.port_run(prob, precision, "auto")
    if precision == "bf16":
        assert twins[0] == steps and (l2 is None or twins[1] <= got[1])
    for res in ((got, twins[:2]) if precision != "bf16" else (got,)):
        if l2 is not None and l2 < NOISE_L2:
            assert res[1] < NOISE_L2
        elif l2 is not None:
            assert abs(res[1] / l2 - 1) <= L2_RTOL
