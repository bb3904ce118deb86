"""The port's 3D precisions against the JAX package, on the CPU.

``PrecisionPolicy`` levels in 3D, every precision of ``solve_poisson3d``
('fp64', 'fp32', 'bf16', 'mixed', 'adaptive' and a ``PrecisionPolicy``),
``adaptive_solve3d``, ``convergence_study3d``, and the rounding points of
the bf16 twins of kernels E, F and G (the problems and heat3d with a
coefficient field are in ``test_torch_3d_problems.py``). Inputs are numpy
arrays from a seed, or the same problem built by both packages; fields are
compared on the logical (nx, ny, nz) region.

Tolerances, each with its reason:

- level dtypes: exact (the same integer arithmetic);
- solves, port ``backend='torch'`` (the plain path, which rounds bf16 levels
  op by op as the JAX XLA path does): equal outer-step counts and precision
  switches, l2 error within 2% of the JAX one. ``backend='auto'`` runs the
  kernels' twins on the CPU, which round once per kernel call: the same
  count for the 'mixed' and 'adaptive' solves (the bf16 levels are below
  the fp64 refinement), and no more cycles for 'bf16';
- the bf16 twins against hand-made fp32 references: bit for bit (both
  compute in fp32 in the same order and round once); against the Pallas
  kernels in interpret mode on the same bf16 inputs: within one bf16 ulp
  (at most 2^-7 of the value) plus 1e-5 of the largest value, since the
  fp32 bodies differ by ~1e-7 relative (1/c against a division, separable
  sums) and that can move a value across a bf16 rounding boundary. E is
  compared one sweep at a time: the Pallas kernel rounds u to its dtype
  after every sweep, E once per call.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    poisson3d as jpoisson3d,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (  # noqa: E402
    precision as jprec,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid3d import (  # noqa: E402
    Grid3D as JGrid3D,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems3d as JP3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    stencil3d as jst3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.pallas_kernels import (  # noqa: E402
    smooth3d as ps3,
    transfer3d as pt3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    multigrid3d as jmg3,
    refinement as jref,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (  # noqa: E402
    MultigridConfig as JConfig,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    stencil3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth3d as ksmooth3d,
    transfer3d as ktransfer3d,
)

MAIN = dict(smoother="rbgs", omega=1.0, tol=1e-9)
BF = torch.bfloat16


def _jax(a, grid):
    return jnp.asarray(interop.field3d_to_jax_layout(torch.from_numpy(
        np.ascontiguousarray(a)), grid))


def _l2_close(got, ref):
    if ref is None:
        assert got is None
    else:
        assert abs(got / ref - 1) <= 0.02, (got, ref)


def _solve_pair(name, n, precision, cfg_kw, backends=("torch",)):
    jr = jpoisson3d.solve_poisson3d(getattr(JP3, name)(n),
                                    precision=precision,
                                    cfg=JConfig(backend="xla", **cfg_kw))
    tp = getattr(T, name)(n)
    out = {b: T.solve_poisson3d(tp, precision=precision,
                                cfg=T.MultigridConfig(backend=b, **cfg_kw),
                                device="cpu") for b in backends}
    return jr, out


# ---------------------------------------------------------------------------
# level dtypes


@pytest.mark.parametrize("mode", ["mixed", "bf16", "fp64", "fp32"])
def test_level_dtypes_3d_match_jax(mode):
    """The 513^3 hierarchy (nine levels: 'mixed' gives fp32 to 513^3-65^3
    and bf16 to 33^3-3^3) and a 33^3 one, built by both packages (scalar
    stencils: no field is allocated)."""
    for n in (513, 33):
        jl = jmg3.build_hierarchy3d(JGrid3D(n, n, n),
                                    policy=jprec.policy(mode))
        tl = T.build_hierarchy3d(T.Grid3D(n, n, n), policy=T.policy(mode),
                                 device="cpu")
        assert [str(lev.dtype) for lev in tl] == [
            "torch." + {"bfloat16": "bfloat16"}.get(np.dtype(j.dtype).name,
                                                    np.dtype(j.dtype).name)
            for j in jl]
        for mine, theirs in zip(tl, interop.levels3d_from_jax(jl)):
            assert mine.stencil == theirs.stencil
    if mode == "mixed":
        assert [lev.dtype for lev in tl] == [torch.float32] * 2 + [BF] * 3


# ---------------------------------------------------------------------------
# the precisions of solve_poisson3d


@pytest.mark.parametrize("precision,n,extra", [
    ("mixed", 9, {}), ("bf16", 17, {"max_iterations": 8}), ("fp64", 9, {}),
    ("fp32", 9, {"tol": 1e-5})])
def test_solve_poisson3d_precisions_match_jax(precision, n, extra):
    """The counts and l2 of the JAX package on the plain path (9^3: fp32
    above bf16 levels under 'mixed'); 'mixed' takes the same count through
    the twins, 'bf16' (8 cycles at 17^3, where its plain path's op-by-op
    roundings stand above the bf16 storage floor) a smaller l2 through
    them, since they round once per call."""
    kw = dict(MAIN, **extra)
    jr, out = _solve_pair("poisson3d_mms_sinsinsin", n, precision, kw,
                          backends=("torch", "auto"))
    plain, twins = out["torch"], out["auto"]
    assert plain.iterations == jr.iterations and plain.converged == \
        jr.converged
    _l2_close(plain.errors["l2"], jr.errors["l2"])
    if precision == "bf16":
        assert twins.iterations == 8 and twins.u.dtype == BF
        assert twins.errors["l2"] <= plain.errors["l2"]
    else:
        assert twins.iterations == jr.iterations
        _l2_close(twins.errors["l2"], jr.errors["l2"])
    if precision == "mixed":
        assert plain.info["method"] == "iterative_refinement_3d"


def test_adaptive_solve3d_matches_jax():
    """adaptive_solve3d at 9^3 from fp32 (chunks of 5 cycles, then fp32
    refinement): iterations, switches, stage factors' stages and l2; the
    'adaptive' precision and a PrecisionPolicy reach the same solve."""
    jp, tp = JP3.poisson3d_mms_sinsinsin(9), T.poisson3d_mms_sinsinsin(9)
    ju, jinfo = jref.adaptive_solve3d(
        jp.grid, jp.spec, jp.rhs(jnp.float64), jp.initial_guess(jnp.float64),
        cfg=JConfig(backend="xla", **MAIN))
    u, info = T.adaptive_solve3d(
        tp.grid, tp.spec, tp.rhs(torch.float64), tp.initial_guess(
            torch.float64), cfg=T.MultigridConfig(backend="torch", **MAIN),
        device="cpu")
    assert info["iterations"] == jinfo["iterations"]
    assert info["precision_switches"] == jinfo["precision_switches"]
    assert info["method"] == jinfo["method"] == "adaptive_3d"
    assert [s["stage"] for s in info["stage_factors"]] == \
        [s["stage"] for s in jinfo["stage_factors"]]
    _l2_close(tp.error_norms(u)["l2"], jp.error_norms(ju)["l2"])
    res = T.solve_poisson3d(tp, precision=T.policy("adaptive"),
                            cfg=T.MultigridConfig(backend="torch", **MAIN),
                            device="cpu")
    assert torch.equal(res.u, u)
    res = T.solve_poisson3d(T.poisson3d_mms_sinsinsin(9),
                            precision=T.PrecisionPolicy(
        mode=T.Precision.MIXED, coarse=T.Precision.FP32),
        cfg=T.MultigridConfig(backend="torch", **MAIN), device="cpu")
    assert res.converged and res.info["method"] == "iterative_refinement_3d"


def test_convergence_study3d_matches_jax():
    jst = jpoisson3d.convergence_study3d(JP3.poisson3d_mms_sinsinsin, [5, 9])
    st = T.convergence_study3d(T.poisson3d_mms_sinsinsin, [5, 9],
                               device="cpu")
    assert st["iterations"] == jst["iterations"]
    np.testing.assert_allclose(st["l2"], jst["l2"], rtol=1e-8)
    np.testing.assert_allclose(st["order_l2"], jst["order_l2"], rtol=1e-8)


# ---------------------------------------------------------------------------
# the bf16 twins of E, F and G


def _bf16_field(shape, seed, scale=1.0, shell=False):
    rng = np.random.default_rng(seed)
    a = np.zeros(shape, np.float32)
    if shell:
        a[:] = scale * rng.standard_normal(shape)
    else:
        a[1:-1, 1:-1, 1:-1] = scale * rng.standard_normal(
            tuple(n - 2 for n in shape))
    return torch.from_numpy(a).to(BF)


def test_bf16_twins_round_once():
    """Each twin on bf16 storage is its fp32 twin on the widened inputs,
    rounded once, bit for bit (E over several sweeps too)."""
    g = T.Grid3D(17, 17, 17)
    st = stencil3d.make_stencil3d(g, dtype=BF)
    u, f = _bf16_field(g.shape, 1), _bf16_field(g.shape, 2, st.c)
    ec = _bf16_field((9, 9, 9), 3, shell=True)
    for sweeps in (1, 2, 5):
        got = ksmooth3d.rbgs3d(st, u, f, sweeps=sweeps)
        ref = ksmooth3d.rbgs3d_plain(st, u.float(), f.float(),
                                     sweeps=sweeps).to(BF)
        assert got.dtype == BF and torch.equal(got, ref)
    for src, out in ((BF, BF), (torch.float32, BF), (BF, torch.float32)):
        got = ktransfer3d.residual_restrict3d(st, u.to(src), f.to(src),
                                              out_dtype=out)
        ref = ktransfer3d.residual_restrict3d_plain(st, u.float(), f.float())
        assert got.dtype == out and torch.equal(got, ref.to(out))
    for e_t, u_t in ((BF, BF), (BF, torch.float32), (torch.float32, BF)):
        uu = u.to(u_t)
        got = ktransfer3d.prolong_correct3d(ec.to(e_t), uu.clone())
        ref = ktransfer3d.prolong_correct3d_plain(ec.float(), uu.float())
        assert got.dtype == u_t and torch.equal(got, ref.to(u_t))


def _bf16_close(got, ref):
    """Within one bf16 ulp of each value (at most 2^-7 of it) plus 1e-5 of
    the largest."""
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    tol = 2.0 ** -7 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


@pytest.mark.parametrize("shape", [(9, 33, 9)])
def test_bf16_twins_match_pallas_interpret(shape):
    """The twins of E (one sweep, each colour order), F (bf16 -> bf16 and
    fp32 -> bf16) and G (bf16 ec into bf16 and fp32 u) against the Pallas
    kernels in interpret mode on the same bf16 inputs."""
    g, jg = T.Grid3D(*shape), JGrid3D(*shape)
    st = stencil3d.make_stencil3d(g, dtype=BF)
    jst = jst3.make_stencil3d(jg, dtype=jnp.bfloat16)
    u, f = _bf16_field(shape, 4), _bf16_field(shape, 5, st.c)
    ju = _jax(u.float().numpy(), jg).astype(jnp.bfloat16)
    jf = _jax(f.float().numpy(), jg).astype(jnp.bfloat16)
    for reverse in (False, True):
        got = ksmooth3d.rbgs3d(st, u, f, sweeps=1, reverse=reverse)
        ref = ps3.rbgs_planes(jst, ju, jf, nx=g.nx, ny=g.ny, nz=g.nz,
                              sweeps=1, reverse=reverse, interpret=True)
        assert ref.dtype == jnp.bfloat16
        _bf16_close(got, np.asarray(ref.astype(jnp.float32))[
            : g.nx, : g.ny, : g.nz])
    gc = jg.coarsen()
    for src in (BF, torch.float32):
        got = ktransfer3d.residual_restrict3d(st, u.to(src), f.to(src),
                                              out_dtype=BF)
        jsrc = jnp.bfloat16 if src == BF else jnp.float32
        ref = pt3.residual_restrict3d(
            jst, ju.astype(jsrc), jf.astype(jsrc), nxf=g.nx, nyf=g.ny,
            nzf=g.nz, ncx=gc.nx, ncy=gc.ny, ncz=gc.nz,
            pshape_coarse=gc.shape_padded, out_dtype=jnp.bfloat16,
            interpret=True)
        assert ref.dtype == jnp.bfloat16
        _bf16_close(got, np.asarray(ref.astype(jnp.float32))[
            : gc.nx, : gc.ny, : gc.nz])
    ec = _bf16_field(gc.shape, 6, shell=True)
    jec = _jax(ec.float().numpy(), gc).astype(jnp.bfloat16)
    for u_t in (BF, torch.float32):
        jsrc = jnp.bfloat16 if u_t == BF else jnp.float32
        got = ktransfer3d.prolong_correct3d(ec, u.to(u_t).clone())
        ref = pt3.prolong_correct3d(
            jec, ju.astype(jsrc), ncx=gc.nx, ncy=gc.ny, ncz=gc.nz, nxf=g.nx,
            nyf=g.ny, nzf=g.nz, interpret=True)
        _bf16_close(got, np.asarray(ref.astype(jnp.float32))[
            : g.nx, : g.ny, : g.nz])
