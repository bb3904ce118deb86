"""The port's Krylov solvers, preconditioners and stand-alone iterative
solvers against the JAX package, on the CPU.

Tolerances, each with its reason:

- fp64 operators and preconditioners (CG, flexible CG, FGMRES and the
  host CG with every preconditioner of the JAX package's
  ``test_krylov.py``): equal iteration counts, histories within 1e-8
  relative and solutions within 1e-10 relative to max|u|. The dot products
  sum in a different order (PyTorch's reduction against XLA's), which moves
  the last bits only. History entries below 1e-11 ||r0|| (FGMRES's Givens
  estimates once it has converged) are round-off, and are only held below
  1e-10 ||r0||.
- a multigrid preconditioner over fp32 levels under an fp64 loop: equal
  counts, histories within 1e-5 relative, solutions within 1e-8 relative.
  The JAX fp32 cycles run inside one ``jit``, where XLA contracts
  multiply-adds into FMAs, so z = M(r) differs from the port's in fp32's
  last bits.
- BiCGStab with the diagonal preconditioner amplifies round-off about a
  thousandfold every five iterations on these systems (measured: relative
  history differences 4e-16, 1e-14, 3e-11, 2e-9 at iterations 0, 5, 10,
  15), so its count cannot be reproduced across two summation orders: its
  first 15 iterations are held within 1e-7, the run to convergence and the
  l2 error of its solution within 1e-6 of the JAX one's. With the multigrid
  preconditioner (fp64 levels) it converges in a few iterations and is
  held like CG.
- z = M(r) of each preconditioner: 1e-12 relative (block_line solves by PCR
  here and by LAPACK in the JAX package), ILU variants 1e-12 (the same
  NumPy/SciPy factorization on the unpadded layout).
- ``iterative_solve``: equal sweep counts, histories and solutions within
  1e-6 relative. The JAX sweeps run in one ``jit``, where XLA contracts
  multiply-adds into FMAs, and the last-bit differences add up over the
  hundreds of sweeps (1e-8 after about 100 SOR sweeps at 33^2).
- 3D multigrid-preconditioned CG over fp32 levels: equal counts,
  histories within 1e-4 relative and solutions within 1e-8: the fp32 3D
  cycles differ in their last bits as the 2D ones do, and a 7-point
  V-cycle carries the difference further (measured 5e-5).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mixed_precision_multigrid_solvers_for_pdes_tpu as J  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu import (  # noqa: E402
    preconditioning as jpc,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
    problems3d as JP3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    stencil as jst,
    stencil3d as jst3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (  # noqa: E402
    iterative as jit_,
    krylov as jkr,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import (  # noqa: E402
    interop,
    preconditioning as tpc,
    solvers as tsolvers,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    stencil as tst,
    stencil3d as tst3,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (  # noqa: E402
    iterative as tit,
    krylov as tkr,
)

CFG = dict(smoother="rbgs", omega=1.0)
N = 65
F64 = torch.float64


class Case:
    """One problem on both sides: the fp64 hierarchy (and an fp32 one when
    asked), the level-0 matvec and the masked right-hand side."""

    def __init__(self, name="poisson_mms_exponential", n=N, galerkin=False,
                 dtype="float64"):
        cfg = dict(CFG, coarsening="galerkin", symmetric=True) \
            if galerkin else CFG
        self.jcfg, self.tcfg = J.MultigridConfig(**cfg), \
            T.MultigridConfig(**cfg)
        self.jprob = getattr(JP, name)(n)
        self.prob = interop.problem_from_jax(self.jprob)
        jp, tp = self.jprob, self.prob
        self.jl = J.build_hierarchy(jp.grid, jp.spec, a=jp.a, dtype=dtype,
                                    cfg=self.jcfg)
        self.tl = T.build_hierarchy(tp.grid, tp.spec, a=tp.a, dtype=dtype,
                                    device="cpu", cfg=self.tcfg)
        self.jst = jst.make_stencil(jp.grid, jp.spec, a=jp.a,
                                    dtype=jnp.float64)
        self.st = tst.make_stencil(tp.grid, tp.spec, a=tp.a, dtype=F64)
        self.junk, self.unk = self.jl[0].unknown, self.tl[0].unknown
        self.jmv = jkr.stencil_matvec(self.jst, self.junk)
        self.mv = tkr.stencil_matvec(self.st, self.unk)
        self.jf = jnp.where(self.junk, jp.rhs(jnp.float64), 0.0)
        self.f = torch.where(self.unk, tp.rhs(F64, "cpu"), 0.0)

    def field(self, x):
        return interop.field_from_jax(x, self.jprob.grid)

    def random(self, seed):
        rng = np.random.default_rng(seed)
        r = np.where(np.asarray(self.junk),
                     rng.standard_normal(self.jprob.grid.shape_padded), 0.0)
        return jnp.asarray(r), self.field(r)


@pytest.fixture(scope="module")
def case():
    return Case()


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


FLOOR = 1e-11  # residuals below FLOOR * ||r0|| are fp64 round-off


def _hist_rel(h, jh):
    """Largest relative difference of two histories above the round-off
    floor; below it (FGMRES's estimates after convergence) both must stay
    there."""
    h, jh = np.asarray(h), np.asarray(jh)
    assert h.shape == jh.shape
    live = jh > FLOOR * jh[0]
    assert np.all(h[~live] <= 10 * FLOOR * jh[0])
    return float(np.max(np.abs(h - jh)[live] / jh[live]))


def _check(case, got, want, hist_tol=1e-8, u_tol=1e-10):
    (u, info), (ju, jinfo) = got, want
    assert info["converged"] == jinfo["converged"]
    assert info["iterations"] == jinfo["iterations"]
    assert _hist_rel(info["history"], jinfo["history"]) <= hist_tol
    assert _rel(u, case.field(ju)) <= u_tol
    assert info["method"] == jinfo["method"]


def _precond(case, kind):
    """The same preconditioner on both sides (None: none)."""
    if kind is None:
        return None, None
    if kind == "mg":
        return (jpc.multigrid_preconditioner(case.jl, case.jcfg),
                tpc.multigrid_preconditioner(case.tl, case.tcfg))
    if kind == "composite":
        return (jpc.composite(jpc.diagonal(case.jst, case.junk),
                              jpc.identity()),
                tpc.composite(tpc.diagonal(case.st, case.unk),
                              tpc.identity()))
    make, kw = {
        "diagonal": ("diagonal", {}),
        "scaled_diagonal": ("scaled_diagonal", dict(scale=0.7)),
        "chebyshev": ("chebyshev", dict(degree=4)),
        "line_x": ("block_line", dict(axis=0)),
        "line_y": ("block_line", dict(axis=1)),
    }[kind]
    extra = ({"grid": case.jl[0].grid}, {"grid": case.tl[0].grid}) \
        if kind == "chebyshev" else ({}, {})
    return (getattr(jpc, make)(case.jst, case.junk, **kw, **extra[0]),
            getattr(tpc, make)(case.st, case.unk, **kw, **extra[1]))


@pytest.mark.parametrize("solver,kind,tol", [
    ("pcg", None, 1e-10), ("pcg", "diagonal", 1e-10),
    ("pcg", "chebyshev", 1e-10), ("pcg", "mg", 1e-10),
    ("pcg", "line_x", 1e-10), ("pcg", "composite", 1e-8),
    ("fcg", "mg", 1e-10), ("bicgstab", "mg", 1e-10),
    ("gmres", "mg", 1e-8)])
def test_krylov_matches_jax(case, solver, kind, tol):
    jM, M = _precond(case, kind)
    kw = dict(restart=20) if solver == "gmres" else {}
    want = getattr(jkr, solver)(case.jmv, case.jf, precond=jM, tol=tol, **kw)
    got = getattr(tkr, solver)(case.mv, case.f, precond=M, tol=tol, **kw)
    _check(case, got, want)
    if solver == "gmres":
        assert got[1]["iterations"] % 20 == 0
        assert len(got[1]["history"]) == got[1]["iterations"] + 1


def test_bicgstab_diagonal_follows_jax_until_roundoff_grows(case):
    jM, M = _precond(case, "diagonal")
    ju, jinfo = jkr.bicgstab(case.jmv, case.jf, precond=jM, tol=1e-10)
    u, info = tkr.bicgstab(case.mv, case.f, precond=M, tol=1e-10)
    assert info["converged"] and jinfo["converged"]
    assert _hist_rel(info["history"][:16], jinfo["history"][:16]) <= 1e-7
    errs, jerrs = case.prob.error_norms(u), case.jprob.error_norms(ju)
    assert abs(errs["l2"] / jerrs["l2"] - 1) <= 1e-6


def test_mg_preconditioner_fp32_levels_fp64_vectors():
    """Phase 26 (a) at 65^2: CG in fp64 preconditioned by symmetric V-cycles
    over fp32 levels (level 0 fp64 on the plain path)."""
    case = Case(dtype="float32")
    cfg = dict(CFG, symmetric=True)
    jM = jpc.multigrid_preconditioner(case.jl, J.MultigridConfig(**cfg))
    want = jkr.pcg(case.jmv, case.jf, precond=jM, tol=1e-10)
    for backend in ("torch", "auto"):
        M = tpc.multigrid_preconditioner(
            case.tl, T.MultigridConfig(**cfg, backend=backend))
        got = tkr.pcg(case.mv, case.f, precond=M, tol=1e-10)
        _check(case, got, want, hist_tol=1e-5, u_tol=1e-8)
        assert got[0].dtype == F64


def test_mg_preconditioned_cg_galerkin_jump():
    """The JAX package's hard case: symmetric V-cycles over a Galerkin
    hierarchy on the 1e3:1 jump problem."""
    case = Case("jump_coefficient_problem", n=17, galerkin=True)
    assert isinstance(case.tl[1].stencil, tst.Stencil9)
    jM, M = _precond(case, "mg")
    want = jkr.pcg(case.jmv, case.jf, precond=jM, tol=1e-10)
    got = tkr.pcg(case.mv, case.f, precond=M, tol=1e-10)
    _check(case, got, want)
    assert got[1]["iterations"] <= 10


def test_pcg3d_mg_preconditioner_fp32_levels():
    """3D: CG in fp64 with ``stencil_matvec3d``, preconditioned by
    symmetric 3D V-cycles over fp32 levels (phase 26 (e) at 17^3)."""
    cfg = dict(CFG, symmetric=True)
    jp = JP3.poisson3d_mms_sinsinsin(17)
    tp = T.poisson3d_mms_sinsinsin(17)
    jl = J.build_hierarchy3d(jp.grid, jp.spec, dtype="float32",
                             cfg=J.MultigridConfig(**cfg))
    tl = T.build_hierarchy3d(tp.grid, dtype="float32", device="cpu",
                             cfg=T.MultigridConfig(**cfg))
    jmv = jkr.stencil_matvec3d(jst3.make_stencil3d(jp.grid, jp.spec,
                                                   dtype=jnp.float64),
                               jl[0].unknown)
    mv = tkr.stencil_matvec3d(tst3.make_stencil3d(tp.grid, dtype=F64),
                              tl[0].unknown)
    jf = jnp.where(jl[0].unknown, jp.rhs(jnp.float64), 0.0)
    f = torch.where(tl[0].unknown, tp.rhs(F64, "cpu"), 0.0)
    ju, jinfo = jkr.pcg(jmv, jf, precond=jpc.multigrid_preconditioner3d(
        jl, J.MultigridConfig(**cfg)), tol=1e-10)
    u, info = tkr.pcg(mv, f, precond=tpc.multigrid_preconditioner3d(
        tl, T.MultigridConfig(**cfg)), tol=1e-10)
    assert info["converged"] and info["iterations"] == jinfo["iterations"]
    assert _hist_rel(info["history"], jinfo["history"]) <= 1e-4
    ju = interop.field3d_from_jax(ju, jp.grid)
    assert _rel(u, ju) <= 1e-8


@pytest.mark.parametrize("kind", ["diagonal", "scaled_diagonal", "chebyshev",
                                  "line_x", "line_y", "mg", "composite"])
def test_preconditioner_outputs_match_jax(case, kind):
    jM, M = _precond(case, kind)
    jr, r = case.random(4)
    assert _rel(M(r), case.field(jax.jit(jM)(jr))) <= 1e-12


def test_identity_and_adaptive(case):
    _, r = case.random(5)
    assert tpc.identity()(r) is r
    a = tpc.AdaptivePreconditioner([tpc.identity(), tpc.identity()],
                                   window=3)
    ja = jpc.AdaptivePreconditioner([jpc.identity(), jpc.identity()],
                                    window=3)
    for hist in ([1.0, 0.5], [1.0, 0.99, 0.985, 0.984, 0.9835],
                 [1.0, 0.1, 0.01, 0.001, 0.0001]):
        assert a.observe(hist) == ja.observe(hist)
        assert a.active == ja.active
    with pytest.raises(ValueError):
        tpc.AdaptivePreconditioner([])


def test_host_cg_and_ilu_match_jax(case):
    """pcg_host with the NumPy matvec, plain and with ILU(0), against the
    JAX package's; the port's NumPy matvec reads zero outside the array."""
    jmv = jkr.stencil_matvec_np(case.jst, case.junk)
    mv = tkr.stencil_matvec_np(case.st, case.unk)
    jr, r = case.random(6)
    assert np.abs(mv(r.numpy()) - case.field(jmv(np.asarray(jr))).numpy()
                  ).max() <= 1e-12 * np.abs(mv(r.numpy())).max()
    jilu = jpc.ILUPreconditioner(case.jl[0].grid, case.jst, case.junk)
    ilu = tpc.ILUPreconditioner(case.tl[0].grid, case.st, case.unk)
    for jM, M in ((None, None), (jilu, ilu)):
        ju, jinfo = jkr.pcg_host(jmv, np.asarray(case.jf), precond=jM,
                                 tol=1e-8)
        u, info = tkr.pcg_host(mv, case.f.numpy(), precond=M, tol=1e-8)
        assert info["iterations"] == jinfo["iterations"]
        assert info["converged"] and jinfo["converged"]
        assert _hist_rel(info["history"], jinfo["history"]) <= 1e-8
        assert _rel(torch.from_numpy(u), case.field(ju)) <= 1e-10
    # a neighbour outside the array is zero, not the opposite ring
    st = tst.make_stencil(T.Grid(9, 9), T.core.bc.mixed(west="neumann"),
                          dtype=F64)
    x = np.zeros((9, 9))
    x[-1, 4] = 1.0
    unk = T.core.bc.unknown_mask(9, 9, T.core.bc.mixed(west="neumann"))
    assert tkr.stencil_matvec_np(st, unk)(x)[0, 4] == 0.0


@pytest.mark.parametrize("kw", [dict(fill_level=0), dict(fill_level=1),
                                dict(fill_level=3),
                                dict(fill_level=5, drop_tolerance=5e-2),
                                dict(fill_level=1, drop_tolerance=1e-3,
                                     milu=True)])
def test_ilu_variants_match_jax(case, kw):
    jM = jpc.ILUKPreconditioner(case.jl[0].grid, case.jst, case.junk, **kw)
    M = tpc.ILUKPreconditioner(case.tl[0].grid, case.st, case.unk, **kw)
    jr, r = case.random(7)
    for apply in ("apply", "apply_transpose"):
        want = case.field(getattr(jM, apply)(np.asarray(jr)))
        got = torch.from_numpy(getattr(M, apply)(r))
        assert _rel(got, want) <= 1e-12
    assert M.memory_usage()["factor_nnz"] == \
        jM.memory_usage()["factor_nnz"]
    assert M.memory_usage()["fill_ratio"] == jM.memory_usage()["fill_ratio"]


def test_ilu0_and_stencil9_refusal(case):
    jM = jpc.ILUPreconditioner(case.jl[0].grid, case.jst, case.junk)
    M = tpc.ILUPreconditioner(case.tl[0].grid, case.st, case.unk)
    jr, r = case.random(8)
    assert _rel(torch.from_numpy(M(r)), case.field(jM(np.asarray(jr)))) \
        <= 1e-12
    assert M.memory_usage() == {**jM.memory_usage(),
                                "bytes": M.memory_usage()["bytes"]}
    g = Case("jump_coefficient_problem", n=17, galerkin=True)
    lev = g.tl[1]
    for make in (tpc.ILUPreconditioner, tpc.ILUKPreconditioner):
        with pytest.raises(NotImplementedError):
            make(lev.grid, lev.stencil, lev.unknown)
    with pytest.raises(NotImplementedError):
        tkr.stencil_matvec_np(lev.stencil, lev.unknown)


@pytest.mark.parametrize("method,n", [("jacobi", 17), ("line_x", 17),
                                      ("rbgs", 33), ("sor", 33),
                                      ("adi", 33), ("chebyshev", 17)])
def test_iterative_solve_matches_jax(method, n):
    jp = JP.poisson_mms_sinsin(n)
    tp = interop.problem_from_jax(jp)
    jlev = J.build_hierarchy(jp.grid, jp.spec, dtype="float64")[0]
    lev = T.build_hierarchy(tp.grid, tp.spec, dtype="float64",
                            device="cpu")[0]
    ju, jinfo = jit_.iterative_solve(jlev, jp.rhs(jnp.float64),
                                     method=method, tol=1e-6)
    u, info = tit.iterative_solve(lev, tp.rhs(F64, "cpu"), method=method,
                                  tol=1e-6)
    assert info["converged"] and jinfo["converged"]
    assert info["iterations"] == jinfo["iterations"]
    assert info["omega"] == jinfo["omega"]
    assert _hist_rel(info["history"], jinfo["history"]) <= 1e-6
    assert _rel(u, interop.field_from_jax(ju, jp.grid)) <= 1e-6


def test_spectral_helpers_match_jax():
    for nx, ny in ((17, 17), (33, 65)):
        assert tit.jacobi_spectral_radius(nx, ny) == \
            jit_.jacobi_spectral_radius(nx, ny)
        assert tit.optimal_weighted_jacobi_omega(nx, ny) == \
            jit_.optimal_weighted_jacobi_omega(nx, ny)
        assert tit._default_omega("weighted_jacobi", nx, ny) == \
            jit_.optimal_weighted_jacobi_omega(nx, ny)
        assert tit.laplacian_condition_number(nx, ny, 1 / (nx - 1),
                                              1 / (ny - 1)) == \
            jit_.laplacian_condition_number(nx, ny, 1 / (nx - 1),
                                            1 / (ny - 1))
    assert tsolvers.pcg is tkr.pcg and tsolvers.gmres is tkr.gmres
    assert T.preconditioning.multigrid_preconditioner is \
        tpc.multigrid_preconditioner
