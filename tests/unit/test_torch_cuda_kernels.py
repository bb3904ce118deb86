"""The hand-written CUDA kernels against their plain PyTorch twins, on a card.

Imports no JAX, so it runs on a machine with a GPU and no JAX:

    python -m pytest tests/unit/test_torch_cuda_kernels.py -m cuda

Every test needs a CUDA device and skips without one. Tolerance: 1e-5
relative to the largest twin value. Both sides compute in fp32, but the
kernels multiply by 1/c where the twins divide, nvcc contracts multiply-adds
into FMAs, and the tail chains about a hundred dependent phases. The
non-power-of-two domain below makes those roundings differ for real: on the
unit square the coefficients are powers of two and the two agree bit for bit.
The 3D kernels E, F and G round every product and sum explicitly in their
twins' order; E still multiplies by 1/c where the twin divides.

The coefficient-plane kernels H, I and J and kernel C round every operation
in their twins' order and divide as the twins do, so they are held to their
twins bit for bit. So are the parity-plane kernel K, the parity layout L and
the microbenchmark's probe and copy kernels M, whose twins multiply by the
same fp32 1/c; L and A agree bit for bit as well.
"""

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking import (
    kernel_microbench as kmicro,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (
    planes,
    stencil,
    stencil3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    smooth as ksmooth,
    smooth3d as ksmooth3d,
    smooth_planes as ksmooth_planes,
    smooth_var as ksmooth_var,
    tail as ktail,
    transfer as ktransfer,
    transfer3d as ktransfer3d,
)

pytestmark = pytest.mark.cuda

TOL = 1e-5
DOMAINS = {"unit": (0.0, 1.0, 0.0, 1.0), "skew": (0.0, 1.3, 0.0, 0.7)}
DOMAINS3D = {"unit": (0.0, 1.0) * 3, "skew": (0.0, 1.3, 0.0, 0.7, 0.0, 1.1)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _field(shape, seed, dev, scale=1.0, ring=False):
    """Random field of any rank; zero on the boundary unless ``ring``."""
    rng = np.random.default_rng(seed)
    a = np.zeros(shape, np.float32)
    if ring:
        a[:] = scale * rng.standard_normal(shape)
    else:
        a[(slice(1, -1),) * len(shape)] = scale * rng.standard_normal(
            tuple(n - 2 for n in shape))
    return torch.from_numpy(a).to(dev)


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    scale = max(ref.abs().max().item(), 1e-30)
    err = (got - ref).abs().max().item()
    assert err <= TOL * scale, (err, scale)


def _stencil(n, domain):
    g = T.Grid(n, n, DOMAINS[domain])
    return g, stencil.make_stencil(g)


@pytest.mark.parametrize("domain", list(DOMAINS))
@pytest.mark.parametrize("method", ["rbgs", "rbgs_rev", "sor", "jacobi"])
@pytest.mark.parametrize("n,sweeps", [(257, 2), (129, 3)])
def test_multisweep_matches_twin(dev, n, sweeps, method, domain):
    g, st = _stencil(n, domain)
    u, f = _field(g.shape, 1, dev), _field(g.shape, 2, dev, st.c)
    omega = {"jacobi": 0.8, "sor": 1.3}.get(method, 1.0)
    before = ksmooth.multisweep.launches
    got = ksmooth.multisweep(st, u.clone(), f, method=method, sweeps=sweeps,
                             omega=omega)
    per_sweep = 1 if method == "jacobi" else 2
    assert ksmooth.multisweep.launches - before == per_sweep * sweeps
    ref = ksmooth.multisweep_plain(st, u.clone(), f, method=method,
                                   sweeps=sweeps, omega=omega)
    _close(got, ref)
    assert torch.equal(got[0], u[0]) and torch.equal(got[:, -1], u[:, -1])


@pytest.mark.parametrize("domain", list(DOMAINS))
@pytest.mark.parametrize("n", [1025, 65, 5])
def test_residual_restrict_matches_twin(dev, n, domain):
    g, st = _stencil(n, domain)
    u, f = _field(g.shape, 3, dev), _field(g.shape, 4, dev, st.c)
    got = ktransfer.residual_restrict(st, u, f)
    _close(got, ktransfer.residual_restrict_plain(st, u, f))
    assert not got[0].any() and not got[:, -1].any()


@pytest.mark.parametrize("n", [1025, 65, 5])
def test_prolong_correct_matches_twin(dev, n):
    nc = (n - 1) // 2 + 1
    u = _field((n, n), 5, dev, ring=True)
    ec = _field((nc, nc), 6, dev, ring=True)
    got = ktransfer.prolong_correct(ec, u.clone())
    _close(got, ktransfer.prolong_correct_plain(ec, u.clone()))
    assert torch.equal(got[-1], u[-1])


@pytest.mark.parametrize("domain", list(DOMAINS))
@pytest.mark.parametrize("entry,method,symmetric", [
    (129, "rbgs", False), (129, "rbgs", True), (65, "jacobi", False),
    (3, "rbgs", False)])
def test_tail_vcycle_matches_twin(dev, entry, method, symmetric, domain):
    sizes = [entry]
    while sizes[-1] > 3:
        sizes.append((sizes[-1] - 1) // 2 + 1)
    grids = [T.Grid(n, n, DOMAINS[domain]) for n in sizes]
    sts = [stencil.make_stencil(g) for g in grids]
    u, f = _field(grids[0].shape, 7, dev), _field(grids[0].shape, 8, dev,
                                                  sts[0].c)
    kw = dict(shapes=[g.shape for g in grids], pre=2, post=2,
              omega=0.8 if method == "jacobi" else 1.0, method=method,
              coarse_sweeps=32, symmetric=symmetric)
    before = ktail.tail_vcycle.launches
    got = ktail.tail_vcycle(sts, u.clone(), f, **kw)
    assert ktail.tail_vcycle.launches == before + 1
    _close(got, ktail.tail_vcycle_plain(sts, u.clone(), f, **kw))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    g, st = _stencil(33, "unit")
    u = torch.zeros(g.shape, device=dev)
    with pytest.raises(TypeError):
        ksmooth.multisweep(st, u.double(), u.double())
    with pytest.raises(ValueError):
        ksmooth.multisweep(st, u.t(), u)  # a transposed view is not contiguous
    with pytest.raises(ValueError):
        ktransfer.prolong_correct(torch.zeros(5, 5, device=dev), u)
    with pytest.raises(TypeError):
        ktransfer.residual_restrict(st, u, u, out_dtype=torch.float64)


def _stencil3d(shape, domain):
    g = T.Grid3D(*shape, DOMAINS3D[domain])
    return g, stencil3d.make_stencil3d(g)


@pytest.mark.parametrize("domain", list(DOMAINS3D))
@pytest.mark.parametrize("sweeps,omega,reverse", [(2, 1.0, False),
                                                  (1, 1.3, False),
                                                  (2, 1.0, True)])
@pytest.mark.parametrize("shape", [(65, 65, 65), (9, 33, 17), (5, 5, 5)])
def test_rbgs3d_matches_twin(dev, shape, sweeps, omega, reverse, domain):
    g, st = _stencil3d(shape, domain)
    u, f = _field(shape, 21, dev), _field(shape, 22, dev, st.c)
    before = ksmooth3d.rbgs3d.launches
    got = ksmooth3d.rbgs3d(st, u.clone(), f, sweeps=sweeps, omega=omega,
                           reverse=reverse)
    assert ksmooth3d.rbgs3d.launches - before == 2 * sweeps
    ref = ksmooth3d.rbgs3d_plain(st, u.clone(), f, sweeps=sweeps,
                                 omega=omega, reverse=reverse)
    _close(got, ref)
    assert torch.equal(got[0], u[0]) and torch.equal(got[:, :, -1],
                                                     u[:, :, -1])


@pytest.mark.parametrize("domain", list(DOMAINS3D))
@pytest.mark.parametrize("shape", [(65, 65, 65), (9, 33, 17), (5, 5, 5)])
def test_residual_restrict3d_matches_twin(dev, shape, domain):
    g, st = _stencil3d(shape, domain)
    u, f = _field(shape, 23, dev), _field(shape, 24, dev, st.c)
    before = ktransfer3d.residual_restrict3d.launches
    got = ktransfer3d.residual_restrict3d(st, u, f)
    assert ktransfer3d.residual_restrict3d.launches == before + 1
    _close(got, ktransfer3d.residual_restrict3d_plain(st, u, f))
    assert not got[0].any() and not got[:, -1].any() and not got[..., 0].any()


@pytest.mark.parametrize("shape", [(65, 65, 65), (9, 33, 17), (5, 5, 5)])
def test_prolong_correct3d_matches_twin(dev, shape):
    nc = tuple((n - 1) // 2 + 1 for n in shape)
    u = _field(shape, 25, dev, ring=True)
    ec = _field(nc, 26, dev, ring=True)  # the coarse shell interpolates too
    got = ktransfer3d.prolong_correct3d(ec, u.clone())
    _close(got, ktransfer3d.prolong_correct3d_plain(ec, u.clone()))
    assert torch.equal(got[-1], u[-1]) and torch.equal(got[:, 0], u[:, 0])


def test_3d_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    g, st = _stencil3d((9, 9, 9), "unit")
    u = torch.zeros(g.shape, device=dev)
    with pytest.raises(TypeError):
        ksmooth3d.rbgs3d(st, u.double(), u.double())
    with pytest.raises(ValueError, match="3-D"):
        ksmooth3d.rbgs3d(st, u[0], u[0])
    with pytest.raises(ValueError):
        ksmooth3d.rbgs3d(st, u.transpose(0, 2), u)  # not contiguous
    with pytest.raises(ValueError):
        ktransfer3d.prolong_correct3d(torch.zeros(4, 5, 5, device=dev), u)
    with pytest.raises(TypeError):
        ktransfer3d.residual_restrict3d(st, u, u, out_dtype=torch.float64)


def test_solve_poisson3d_kernel_path_matches_plain_path(dev):
    prob = T.poisson3d_mms_sinsinsin(65)
    out = {}
    for backend in ("auto", "torch"):
        cfg = T.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                                backend=backend)
        before = ksmooth3d.rbgs3d.launches
        out[backend] = T.solve_poisson3d(prob, precision="fp32", cfg=cfg,
                                         device=dev)
        launched = ksmooth3d.rbgs3d.launches - before
        assert (launched > 0) == (backend == "auto")
    k, p = out["auto"], out["torch"]
    assert k.converged and k.iterations == p.iterations == 5
    assert (k.u - p.u).abs().max().item() <= 1e-8
    np.testing.assert_allclose(k.errors["l2"], p.errors["l2"], rtol=1e-6)


def test_ir_solve_kernel_path_matches_plain_path(dev):
    prob = T.poisson_mms_sinsin(257)
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                            max_iterations=40)
    levels = T.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                               device=dev, cfg=cfg)
    f = prob.rhs(torch.float64, dev)
    u0 = prob.initial_guess(torch.float64, dev)
    out = {}
    for backend in ("auto", "torch"):
        out[backend] = T.ir_solve(levels, f, u0, cfg.replace(backend=backend),
                                  inner_cycles=2, use_fmg=True)
    (u_k, info_k), (u_p, info_p) = out["auto"], out["torch"]
    assert info_k["converged"] and info_k["iterations"] == info_p["iterations"]
    assert (u_k - u_p).abs().max().item() <= 1e-8


# ---------------------------------------------------------------------------
# coefficient planes: H, I, C with sides, J

ROBIN = bc.BCSide(bc.BCKind.ROBIN, alpha=1.0, beta=1.0)
SIDE_SETS = {"dirichlet": bc.dirichlet(),
             "east_robin": bc.BoundarySpec(east=ROBIN),
             "south_robin": bc.BoundarySpec(south=ROBIN),
             "west_north_neumann": bc.mixed(west="neumann", north="neumann")}


def _exact(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert torch.equal(got, ref), (got - ref).abs().max().item()


def _coef(g, coef):
    X, Y = g.coordinates()
    return np.where(X < 0.5, 1.0, 1e3) if coef == "jump" else 1.0 + X + Y


def _var_stencil(n, coef, dev, spec=bc.dirichlet()):
    g = T.Grid(n, n)
    return g, stencil.make_stencil(g, spec, a=_coef(g, coef), device=dev)


@pytest.mark.parametrize("coef", ["smooth", "jump"])
@pytest.mark.parametrize("method,omega", [("rbgs", 1.0), ("rbgs_rev", 1.0),
                                          ("sor", 1.3), ("jacobi", 0.8)])
@pytest.mark.parametrize("n,sweeps", [(257, 2), (129, 3), (5, 1)])
def test_multisweep_var_matches_twin(dev, n, sweeps, method, omega, coef):
    g, st = _var_stencil(n, coef, dev)
    u, f = _field(g.shape, 31, dev), _field(g.shape, 32, dev, 1e3)
    before = ksmooth_var.multisweep_var.launches
    got = ksmooth_var.multisweep_var(st, u.clone(), f, method=method,
                                     sweeps=sweeps, omega=omega)
    per_sweep = 1 if method == "jacobi" else 2
    assert ksmooth_var.multisweep_var.launches - before == per_sweep * sweeps
    _exact(got, ksmooth.multisweep_plain(st, u.clone(), f, method=method,
                                         sweeps=sweeps, omega=omega))
    assert torch.equal(got[0], u[0]) and torch.equal(got[:, -1], u[:, -1])


@pytest.mark.parametrize("side_set", list(SIDE_SETS))
@pytest.mark.parametrize("n", [1025, 65, 5])
def test_residual_restrict_var_and_prolong_sides_match_twins(dev, n,
                                                             side_set):
    spec = SIDE_SETS[side_set]
    g, st = _var_stencil(n, "smooth", dev, spec)
    sides = spec.dirichlet_sides
    u = _field(g.shape, 33, dev, ring=True)
    f = _field(g.shape, 34, dev, 50.0, ring=True)
    before = ktransfer.residual_restrict_var.launches
    got = ktransfer.residual_restrict_var(st, u, f, sides=sides)
    assert ktransfer.residual_restrict_var.launches == before + 1
    _exact(got, ktransfer.residual_restrict_plain(st, u, f, sides=sides))
    nc = got.shape[0]
    assert not got[~bc.unknown_mask(nc, nc, spec, device=dev)].any()
    ec = _field((nc, nc), 35, dev, ring=True)
    got_u = ktransfer.prolong_correct(ec, u.clone(), sides=sides)
    _exact(got_u, ktransfer.prolong_correct_plain(ec, u.clone(), sides=sides))
    fixed = ~bc.unknown_mask(n, n, spec, device=dev)
    assert torch.equal(got_u[fixed], u[fixed])


@pytest.mark.parametrize("coef", ["smooth", "jump"])
@pytest.mark.parametrize("entry,method,symmetric", [
    (129, "rbgs", False), (129, "rbgs", True), (65, "jacobi", False),
    (3, "rbgs", False)])
def test_tail_vcycle_var_matches_twin(dev, entry, method, symmetric, coef):
    g = T.Grid(entry, entry)
    levels = T.build_hierarchy(g, a=_coef(g, coef), device=dev)
    sts = [lev.stencil for lev in levels]
    u, f = _field((entry, entry), 36, dev), _field((entry, entry), 37, dev,
                                                   1e3)
    kw = dict(shapes=[lev.grid.shape for lev in levels], pre=2, post=2,
              omega=0.8 if method == "jacobi" else 1.0, method=method,
              coarse_sweeps=32, symmetric=symmetric)
    before = ktail.tail_vcycle_var.launches
    got = ktail.tail_vcycle_var(sts, u.clone(), f, **kw)
    assert ktail.tail_vcycle_var.launches == before + 1
    _exact(got, ktail.tail_vcycle_plain(sts, u.clone(), f, **kw))


def test_var_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    g, st = _var_stencil(33, "smooth", dev)
    u = torch.zeros(g.shape, device=dev)
    with pytest.raises(TypeError):
        ksmooth_var.multisweep_var(st.astype(torch.float64), u, u)
    with pytest.raises(ValueError):
        ksmooth_var.multisweep_var(st, u[:, :17].contiguous(),
                                   u[:, :17].contiguous())
    with pytest.raises(ValueError):
        ktransfer.residual_restrict_var(st, u.t(), u)
    with pytest.raises(ValueError):
        ktransfer.prolong_correct(torch.zeros(17, 17, device=dev), u,
                                  sides=(True, False))
    with pytest.raises(ValueError):
        ktail.tail_vcycle_var([st, st], u, u, shapes=[(33, 33), (17, 17)],
                              pre=1, post=1, omega=1.0)


@pytest.mark.parametrize("problem", ["varcoef", "jump", "robin"])
def test_solve_poisson_varcoef_kernel_path_matches_plain_path(dev, problem):
    prob = {"varcoef": T.variable_coefficient_mms,
            "jump": T.jump_coefficient_problem,
            "robin": T.robin_test_problem}[problem](257)
    wrappers = {"H": ksmooth_var.multisweep_var,
                "I": ktransfer.residual_restrict_var,
                "C": ktransfer.prolong_correct, "J": ktail.tail_vcycle_var}
    out = {}
    for backend in ("auto", "torch"):
        for w in wrappers.values():
            w.launches = 0
        cfg = T.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                                backend=backend)
        out[backend] = T.solve_poisson(prob, precision="fp32", cfg=cfg,
                                       device=dev)
        launched = {k: w.launches for k, w in wrappers.items()}
        if backend == "torch":
            assert not any(launched.values())
        elif problem == "robin":
            assert launched["I"] and launched["C"]
            assert not launched["H"] and not launched["J"]
        else:
            assert all(launched.values()), launched
    k, p = out["auto"], out["torch"]
    assert k.converged and k.iterations == p.iterations
    assert (k.u - p.u).abs().max().item() <= 1e-8 * p.u.abs().max().item()


# ---------------------------------------------------------------------------
# parity planes (K), the parity layout of A (L), the microbenchmark probes
# and copy (M): each rounds every operation explicitly in its twin's order,
# so each is held to its twin bit for bit; L and A (which now rounds the
# same way) agree bit for bit too.


@pytest.mark.parametrize("domain", list(DOMAINS))
@pytest.mark.parametrize("sweeps,omega", [(2, 1.0), (1, 1.3), (3, 1.3)])
@pytest.mark.parametrize("nx,ny", [(257, 257), (129, 65), (5, 5)])
def test_multisweep_planes_matches_twin(dev, nx, ny, sweeps, omega, domain):
    g = T.Grid(nx, ny, DOMAINS[domain])
    st = stencil.make_stencil(g)
    u, f = _field(g.shape, 41, dev), _field(g.shape, 42, dev, st.c)
    up, fp = planes.split_field(u), planes.split_field(f)
    before = ksmooth_planes.multisweep_planes.launches
    got = ksmooth_planes.multisweep_planes(st, up.clone(), fp, nx=nx, ny=ny,
                                           sweeps=sweeps, omega=omega)
    assert ksmooth_planes.multisweep_planes.launches - before == 2 * sweeps
    _exact(got, ksmooth_planes.multisweep_planes_plain(
        st, up.clone(), fp, nx=nx, ny=ny, sweeps=sweeps, omega=omega))


@pytest.mark.parametrize("domain", list(DOMAINS))
@pytest.mark.parametrize("sweeps,omega", [(1, 1.0), (2, 1.0), (3, 1.3),
                                          (30, 1.0)])
@pytest.mark.parametrize("nx,ny", [(257, 257), (129, 65), (70, 37), (5, 5)])
def test_multisweep_parity_matches_twin_and_kernel_a(dev, nx, ny, sweeps,
                                                     omega, domain):
    g = T.Grid(nx, ny, DOMAINS[domain])
    st = stencil.make_stencil(g)
    u, f = _field(g.shape, 43, dev), _field(g.shape, 44, dev, st.c)
    before = ksmooth.multisweep_parity.launches, ksmooth.multisweep.launches
    got = ksmooth.multisweep(st, u.clone(), f, sweeps=sweeps, omega=omega,
                             layout="parity")
    chunks = -(-sweeps // ksmooth.MAX_PARITY_SWEEPS)
    assert (ksmooth.multisweep_parity.launches,
            ksmooth.multisweep.launches) == (before[0] + chunks, before[1])
    _exact(got, ksmooth.multisweep_parity_plain(st, u.clone(), f,
                                                sweeps=sweeps, omega=omega))
    _exact(got, ksmooth.multisweep(st, u.clone(), f, sweeps=sweeps,
                                   omega=omega, layout="direct"))
    assert torch.equal(got[0], u[0]) and torch.equal(got[:, -1], u[:, -1])


@pytest.mark.parametrize("mode", kmicro.MODES)
@pytest.mark.parametrize("n", [513, 65, 5])
def test_probe_matches_twin(dev, n, mode):
    u, f = _field((n, n), 45, dev, ring=True), _field((n, n), 46, dev)
    before = kmicro.probe.launches
    got = kmicro.probe(u, f, mode=mode, sweeps=3)
    assert kmicro.probe.launches - before == 6
    _exact(got, kmicro.probe_plain(u, f, mode=mode, sweeps=3))


@pytest.mark.parametrize("shape", [(1025, 1025), (5, 7), (3, 3)])
def test_copy2x_and_parity_probe_match_twins(dev, shape):
    u = _field(shape, 47, dev, ring=True)
    before = kmicro.copy2x.launches
    _exact(kmicro.copy2x(u), kmicro.copy2x_plain(u))
    assert kmicro.copy2x.launches == before + 1
    nx, ny = shape
    if min(shape) >= 5:
        up = planes.split_field(u)
        fp = planes.split_field(_field(shape, 48, dev))
        _exact(kmicro.parity(up.clone(), fp, nx=nx, ny=ny, sweeps=3),
               ksmooth_planes.multisweep_planes_plain(
                   kmicro.PROBE_STENCIL, up.clone(), fp, nx=nx, ny=ny,
                   sweeps=3))


def test_plane_and_probe_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    g, st = _stencil(33, "unit")
    u = torch.zeros(g.shape, device=dev)
    up = planes.split_field(u)
    with pytest.raises(TypeError):
        ksmooth_planes.multisweep_planes(st, up.double(), up.double(),
                                         nx=33, ny=33)
    with pytest.raises(ValueError):
        ksmooth_planes.multisweep_planes(st, up, up[:, :16].contiguous(),
                                         nx=33, ny=33)
    with pytest.raises(TypeError):
        ksmooth.multisweep_parity(st, u.double(), u.double())
    with pytest.raises(ValueError):
        ksmooth.multisweep_parity(st, u.t(), u)
    with pytest.raises(ValueError, match="mode"):
        kmicro.probe(u, u, mode="diagonal")
    flat = torch.zeros(1026 * 1026 + 1, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        kmicro.copy2x(flat)


def test_plane_ir_solve_kernel_path_matches_plain_and_standard_paths(dev):
    prob = T.poisson_mms_sinsin(257)
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    levels = T.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                               device=dev, cfg=cfg)
    f = prob.rhs(torch.float64, dev)
    u0 = prob.initial_guess(torch.float64, dev)
    out = {}
    for backend in ("auto", "torch"):
        before = ksmooth_planes.multisweep_planes.launches
        out[backend] = T.plane_ir_solve(levels, f, u0,
                                        cfg.replace(backend=backend))
        launched = ksmooth_planes.multisweep_planes.launches - before
        assert (launched > 0) == (backend == "auto")
    std = T.ir_solve(levels, f, u0, cfg, inner_cycles=2, use_fmg=False)
    (u_k, info_k), (u_p, info_p) = out["auto"], out["torch"]
    assert info_k["converged"] and info_k["method"] == "plane_ir"
    assert info_k["iterations"] == info_p["iterations"] == std[1][
        "iterations"]
    assert (u_k - u_p).abs().max().item() <= 1e-8
    assert (u_k - std[0]).abs().max().item() <= 1e-8


def test_parity_default_main_path_takes_kernel_l(dev, monkeypatch):
    """PARITY_DEFAULT on: every smoothing call above the tail launches L
    and none A's RB-GS, and the solve equals the direct layout's."""
    prob = T.poisson_mms_sinsin(257)
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                            max_iterations=40)
    levels = T.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                               device=dev, cfg=cfg)
    f = prob.rhs(torch.float64, dev)
    u0 = prob.initial_guess(torch.float64, dev)
    out = {}
    for parity in (False, True):
        monkeypatch.setattr(ksmooth, "PARITY_DEFAULT", parity)
        ksmooth.multisweep.launches = ksmooth.multisweep_parity.launches = 0
        out[parity] = T.ir_solve(levels, f, u0, cfg, inner_cycles=2,
                                 use_fmg=True)
        counts = (ksmooth.multisweep.launches,
                  ksmooth.multisweep_parity.launches)
        assert (counts[0] == 0) == parity and (counts[1] > 0) == parity
    assert out[True][1]["iterations"] == out[False][1]["iterations"]
    _exact(out[True][0], out[False][0])
