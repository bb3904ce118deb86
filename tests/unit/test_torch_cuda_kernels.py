"""The hand-written CUDA kernels against their plain PyTorch twins, on a card.

Imports no JAX, so it runs on a machine with a GPU and no JAX:

    python -m pytest tests/unit/test_torch_cuda_kernels.py -m cuda

Every test needs a CUDA device and skips without one. Tolerance: 1e-5
relative to the largest twin value. Both sides compute in fp32, but nvcc
contracts multiply-adds into FMAs in B and D, and the tail chains about a
hundred dependent phases. The non-power-of-two domain below makes those
roundings differ for real: on the unit square the coefficients are powers
of two and the two agree bit for bit. The smoothing kernels A, D, E, K and
L divide by c, as their twins do on every device (``stencil.divide``: a
CUDA division by a Python number would multiply by its reciprocal). The 3D
kernels E, F and G round every product, sum and quotient explicitly in
their twins' order, so they are held to their twins bit for bit on the
card, at shapes where their tiles and x-chunks do not divide the grid too.

The coefficient-plane kernels H, I and J and kernel C round every operation
in their twins' order and divide as the twins do, so they are held to their
twins bit for bit. So are the parity-plane kernel K and the parity layout
L, and the microbenchmark's probe and copy kernels M, whose twins multiply
by the same fp32 1/c as M; A's red-then-black sweeps and L agree with L's
twin bit for bit as well, and the tail kernel D with the same V-cycle run
through A, B and C launches.

On bf16 storage A, B, C and D widen what they load, compute in fp32 and
round once per call; their twins widen, run the fp32 twin and round once.
On the unit square (powers of two in every coefficient) the fp32 bodies
equal their twins bit for bit, so the bf16 ones are held to them bit for
bit too. E, F and G do the same on bf16 storage (E rounds once per call
however many launches it takes), and since their fp32 bodies equal their
twins on any domain, the bf16 ones are held to them bit for bit on the
skewed box.

Kernel N, the float64 step of ``ir_solve3d``, rounds every operation in its
twin's order, so its iterate and its cast residual are held to the twin bit
for bit; its norms sum in another order (per block, then over the blocks)
and are held to the twin's to 1e-13 relative.
"""

import numpy as np
import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking import (
    kernel_microbench as kmicro,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (
    dispatch,
    planes,
    stencil,
    stencil3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    _build,
    refine3d as krefine3d,
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
    u_in = u.clone()
    got = ksmooth.multisweep(st, u_in, f, method=method, sweeps=sweeps,
                             omega=omega)
    assert ksmooth.multisweep.launches - before == len(
        ksmooth.plan_passes(sweeps))
    assert got is not u_in and torch.equal(u_in, u)  # out of place
    ref = ksmooth.multisweep_plain(st, u.clone(), f, method=method,
                                   sweeps=sweeps, omega=omega)
    _close(got, ref)
    assert torch.equal(got[0], u[0]) and torch.equal(got[:, -1], u[:, -1])


@pytest.mark.parametrize("omega", [1.0, 1.3])
@pytest.mark.parametrize("shape", [(1025, 1025), (513, 513), (257, 257),
                                   (1025, 263), (71, 515), (3, 3)])
def test_multisweep_equals_parity_twin_and_kernel_l(dev, shape, omega):
    """Red then black at the main path's levels and at ragged ones: A equals
    L and L's twin bit for bit, in one launch per 2-sweep call."""
    g = T.Grid(*shape, DOMAINS["skew"])
    st = stencil.make_stencil(g)
    u = _field(g.shape, 47, dev, ring=True)
    f = _field(g.shape, 48, dev, st.c)
    before = ksmooth.multisweep.launches
    got = ksmooth.multisweep(st, u, f, sweeps=2, omega=omega,
                             layout="direct")
    assert ksmooth.multisweep.launches == before + 1
    _exact(got, ksmooth.multisweep_parity_plain(st, u.clone(), f, sweeps=2,
                                                omega=omega))
    _exact(got, ksmooth.multisweep_parity(st, u.clone(), f, sweeps=2,
                                          omega=omega))


@pytest.mark.parametrize("method", ["rbgs_rev", "jacobi"])
@pytest.mark.parametrize("shape", [(1025, 1025), (257, 257), (71, 515)])
def test_multisweep_other_orders_match_twin(dev, shape, method):
    g = T.Grid(*shape, DOMAINS["skew"])
    st = stencil.make_stencil(g)
    u, f = _field(g.shape, 49, dev), _field(g.shape, 50, dev, st.c)
    omega = 0.8 if method == "jacobi" else 1.0
    for sweeps in (2, 4, 5):
        got = ksmooth.multisweep(st, u, f, method=method, sweeps=sweeps,
                                 omega=omega)
        _close(got, ksmooth.multisweep_plain(st, u.clone(), f, method=method,
                                             sweeps=sweeps, omega=omega))


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


@pytest.mark.parametrize("method,omega,symmetric", [
    ("rbgs", 1.0, False), ("sor", 1.3, True), ("jacobi", 0.8, False)])
@pytest.mark.parametrize("entry,levels", [
    ((129, 65), None), ((65, 129), None), ((97, 49), None), ((129, 129), 1),
    ((129, 129), 2), ((17, 33), 1)])
def test_tail_vcycle_ragged_matches_twin(dev, entry, levels, method, omega,
                                         symmetric):
    cfg = T.MultigridConfig(max_levels=levels or 16)
    hier = T.build_hierarchy(T.Grid(*entry, DOMAINS["skew"]), device=dev,
                             cfg=cfg)
    sts = [lev.stencil for lev in hier]
    shapes = [lev.grid.shape for lev in hier]
    u, f = _field(entry, 51, dev), _field(entry, 52, dev, sts[0].c)
    kw = dict(shapes=shapes, pre=2, post=2, omega=omega, method=method,
              coarse_sweeps=32, symmetric=symmetric)
    before = ktail.tail_vcycle.launches
    got = ktail.tail_vcycle(sts, u.clone(), f, **kw)
    assert ktail.tail_vcycle.launches == before + 1
    _close(got, ktail.tail_vcycle_plain(sts, u.clone(), f, **kw))


@pytest.mark.parametrize("method,symmetric", [("rbgs", False),
                                              ("rbgs", True),
                                              ("jacobi", False)])
def test_tail_vcycle_equals_the_abc_recursion(dev, monkeypatch, method,
                                              symmetric):
    """D from 129^2 against the same V-cycle through A, B and C launches
    (the tail gate shut, the coarsest sweeps on A): D uses A's updates and
    B's and C's device functions, so the two agree bit for bit."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import \
        multigrid
    cfg = T.MultigridConfig(smoother=method, symmetric=symmetric,
                            omega=0.8 if method == "jacobi" else 1.0)
    hier = T.build_hierarchy(T.Grid(129, 129, DOMAINS["skew"]), device=dev,
                             cfg=cfg)
    u, f = _field((129, 129), 53, dev), _field((129, 129), 54, dev,
                                               hier[0].stencil.c)
    got = dispatch.tail_vcycle(hier, 0, u.clone(), f, cfg)
    monkeypatch.setattr(dispatch, "TAIL_MAX_ENTRY", 0)
    before = ktail.tail_vcycle.launches, ksmooth.multisweep.launches
    ref = multigrid.mg_cycle(hier, u.clone(), f, cfg)
    assert ktail.tail_vcycle.launches == before[0]
    assert ksmooth.multisweep.launches > before[1]
    _exact(got, ref)


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


def test_2d_wrappers_refuse_a_stencil9(dev):
    """A Galerkin level's 9-point stencil reaches no 2D kernel: every 2D
    wrapper that takes a stencil raises on one and launches nothing."""
    prob = T.jump_coefficient_problem(65)
    cfg = T.MultigridConfig(coarsening="galerkin")
    levels = T.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                               dtype="float32", device=dev, cfg=cfg)
    st9, lev = levels[1].stencil, levels[1]
    assert isinstance(st9, stencil.Stencil9)
    u, f = lev.zeros(), lev.zeros()
    shapes = [x.grid.shape for x in levels[1:]]
    calls = {
        "multisweep": lambda: ksmooth.multisweep(st9, u, f),
        "multisweep_parity": lambda: ksmooth.multisweep_parity(st9, u, f),
        "multisweep_var": lambda: ksmooth_var.multisweep_var(st9, u, f),
        "multisweep_planes": lambda: ksmooth_planes.multisweep_planes(
            st9, planes.split_field(u), planes.split_field(f), nx=33, ny=33,
            sweeps=2, omega=1.0),
        "residual_restrict": lambda: ktransfer.residual_restrict(st9, u, f),
        "residual_restrict_var": lambda: ktransfer.residual_restrict_var(
            st9, u, f),
        "tail_vcycle": lambda: ktail.tail_vcycle(
            [x.stencil for x in levels[1:]], u, f, shapes=shapes, pre=2,
            post=2, omega=1.0),
        "tail_vcycle_var": lambda: ktail.tail_vcycle_var(
            [x.stencil for x in levels[1:]], u, f, shapes=shapes, pre=2,
            post=2, omega=1.0),
    }
    before = {name: w.launches for name, w in (
        ("A", ksmooth.multisweep), ("H", ksmooth_var.multisweep_var),
        ("B", ktransfer.residual_restrict), ("D", ktail.tail_vcycle))}
    for name, call in calls.items():
        with pytest.raises(ValueError, match="Stencil9"):
            call()
    assert before == {name: w.launches for name, w in (
        ("A", ksmooth.multisweep), ("H", ksmooth_var.multisweep_var),
        ("B", ktransfer.residual_restrict), ("D", ktail.tail_vcycle))}


def _stencil3d(shape, domain):
    g = T.Grid3D(*shape, DOMAINS3D[domain])
    return g, stencil3d.make_stencil3d(g)


@pytest.mark.parametrize("domain", list(DOMAINS3D))
@pytest.mark.parametrize("sweeps,omega,reverse", [(2, 1.0, False),
                                                  (1, 1.3, False),
                                                  (2, 1.0, True),
                                                  (3, 1.3, True)])
@pytest.mark.parametrize("shape", [(65, 65, 65), (9, 33, 17), (5, 5, 5),
                                   (37, 70, 131)])
def test_rbgs3d_matches_twin(dev, shape, sweeps, omega, reverse, domain):
    g, st = _stencil3d(shape, domain)
    u = _field(shape, 21, dev, ring=True)  # a non-zero shell is copied
    f = _field(shape, 22, dev, st.c)
    u0 = u.clone()
    before = ksmooth3d.rbgs3d.launches
    got = ksmooth3d.rbgs3d(st, u, f, sweeps=sweeps, omega=omega,
                           reverse=reverse)
    assert ksmooth3d.rbgs3d.launches - before == len(
        ksmooth3d.plan_passes(shape, sweeps))
    ref = ksmooth3d.rbgs3d_plain(st, u.clone(), f, sweeps=sweeps,
                                 omega=omega, reverse=reverse)
    _exact(got, ref)
    assert got is not u and torch.equal(u, u0)  # out of place
    for shell in ((0,), (-1,), (slice(None), 0), (slice(None), -1),
                  (Ellipsis, 0), (Ellipsis, -1)):
        assert torch.equal(got[shell], u[shell])


@pytest.mark.parametrize("n", [3, 5, 17])
def test_rbgs3d_coarse_solve_is_one_launch(dev, n):
    """The 32-sweep coarsest solve: one launch of the one-block kernel."""
    g, st = _stencil3d((n,) * 3, "skew")
    u, f = _field((n,) * 3, 27, dev), _field((n,) * 3, 28, dev, st.c)
    before = ksmooth3d.rbgs3d.launches
    got = ksmooth3d.rbgs3d(st, u, f, sweeps=32)
    assert ksmooth3d.rbgs3d.launches == before + 1
    _exact(got, ksmooth3d.rbgs3d_plain(st, u.clone(), f, sweeps=32))


@pytest.mark.parametrize("sweeps", [4, 5])
def test_rbgs3d_several_passes(dev, sweeps):
    """Sweeps above MAX_WAVE_SWEEPS run in passes between two buffers."""
    shape = (33, 33, 65)
    g, st = _stencil3d(shape, "skew")
    u, f = _field(shape, 29, dev), _field(shape, 30, dev, st.c)
    before = ksmooth3d.rbgs3d.launches
    got = ksmooth3d.rbgs3d(st, u, f, sweeps=sweeps, omega=1.3)
    assert ksmooth3d.rbgs3d.launches - before == -(-sweeps // 2)
    _exact(got, ksmooth3d.rbgs3d_plain(st, u.clone(), f, sweeps=sweeps,
                                       omega=1.3))


# (37, 69, 131) and (17, 129, 65): F's 8 x 32 coarse tiles and x-chunks and
# G's 256-wide k blocks do not divide the interior; (11, 9, 7): five coarse
# x-steps, so G's last thread takes one step of its two
SHAPES_TRANSFER3D = [(65, 65, 65), (9, 33, 17), (5, 5, 5), (37, 69, 131),
                     (17, 129, 65), (11, 9, 7)]


@pytest.mark.parametrize("domain", list(DOMAINS3D))
@pytest.mark.parametrize("shape", SHAPES_TRANSFER3D)
def test_residual_restrict3d_matches_twin(dev, shape, domain):
    g, st = _stencil3d(shape, domain)
    u = _field(shape, 23, dev, ring=True)  # the fine shell is read too
    f = _field(shape, 24, dev, st.c)
    fc = torch.full(ktransfer3d.coarse_shape3d(*shape), float("nan"),
                    device=dev)
    del fc  # a NaN-filled allocation first: every coarse node is written
    before = ktransfer3d.residual_restrict3d.launches
    got = ktransfer3d.residual_restrict3d(st, u, f)
    assert ktransfer3d.residual_restrict3d.launches == before + 1
    _exact(got, ktransfer3d.residual_restrict3d_plain(st, u, f))
    for shell in ((0,), (-1,), (slice(None), 0), (slice(None), -1),
                  (Ellipsis, 0), (Ellipsis, -1)):
        assert not got[shell].any()


@pytest.mark.parametrize("shape", SHAPES_TRANSFER3D)
def test_prolong_correct3d_matches_twin(dev, shape):
    nc = tuple((n - 1) // 2 + 1 for n in shape)
    u = _field(shape, 25, dev, ring=True)
    ec = _field(nc, 26, dev, ring=True)  # the coarse shell interpolates too
    before = ktransfer3d.prolong_correct3d.launches
    got = ktransfer3d.prolong_correct3d(ec, u.clone())
    assert ktransfer3d.prolong_correct3d.launches == before + 1
    _exact(got, ktransfer3d.prolong_correct3d_plain(ec, u.clone()))
    for shell in ((0,), (-1,), (slice(None), 0), (slice(None), -1),
                  (Ellipsis, 0), (Ellipsis, -1)):
        assert torch.equal(got[shell], u[shell])


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


def _bf16(t):
    return t.to(torch.bfloat16)


@pytest.mark.parametrize("sweeps,omega,reverse", [(2, 1.0, False),
                                                  (1, 1.3, True),
                                                  (3, 1.0, False),
                                                  (5, 1.3, False),
                                                  (32, 1.0, False)])
@pytest.mark.parametrize("shape", [(65, 65, 65), (33, 33, 33), (17, 17, 17),
                                   (9, 33, 17), (37, 70, 131)])
def test_rbgs3d_bf16_matches_twin(dev, shape, sweeps, omega, reverse):
    """E on bf16 storage (one launch, or fp32 passes before a last bf16
    one) equals its twin (fp32 sweeps, one rounding) bit for bit."""
    g, st = _stencil3d(shape, "skew")
    u = _bf16(_field(shape, 31, dev, ring=True))
    f = _bf16(_field(shape, 32, dev, st.c))
    u0 = u.clone()
    before = (ksmooth3d.rbgs3d.launches, ksmooth3d.rbgs3d.launches_bf16)
    got = ksmooth3d.rbgs3d(st, u, f, sweeps=sweeps, omega=omega,
                           reverse=reverse)
    n = len(ksmooth3d.plan_passes(shape, sweeps))
    assert (ksmooth3d.rbgs3d.launches - before[0],
            ksmooth3d.rbgs3d.launches_bf16 - before[1]) == (n, n)
    assert got.dtype == torch.bfloat16 and torch.equal(u, u0)
    _exact(got, ksmooth3d.rbgs3d_plain(st, u.clone(), f, sweeps=sweeps,
                                       omega=omega, reverse=reverse))


@pytest.mark.parametrize("types", [("bf16", "bf16"), ("fp32", "bf16"),
                                   ("bf16", "fp32")])
@pytest.mark.parametrize("shape", SHAPES_TRANSFER3D)
def test_residual_restrict3d_bf16_matches_twin(dev, shape, types):
    """F with bf16 fine fields and/or a bf16 coarse output equals its twin
    bit for bit."""
    g, st = _stencil3d(shape, "skew")
    cast = {"bf16": _bf16, "fp32": lambda t: t}
    u = cast[types[0]](_field(shape, 33, dev, ring=True))
    f = cast[types[0]](_field(shape, 34, dev, st.c))
    out = torch.bfloat16 if types[1] == "bf16" else torch.float32
    before = ktransfer3d.residual_restrict3d.launches_bf16
    got = ktransfer3d.residual_restrict3d(st, u, f, out_dtype=out)
    assert ktransfer3d.residual_restrict3d.launches_bf16 == before + 1
    assert got.dtype == out
    _exact(got, ktransfer3d.residual_restrict3d_plain(st, u, f,
                                                      out_dtype=out))


@pytest.mark.parametrize("types", [("bf16", "fp32"), ("bf16", "bf16"),
                                   ("fp32", "bf16")])
@pytest.mark.parametrize("shape", SHAPES_TRANSFER3D)
def test_prolong_correct3d_bf16_matches_twin(dev, shape, types):
    """G with a bf16 ec and/or a bf16 u (one rounding per node) equals its
    twin bit for bit."""
    nc = tuple((n - 1) // 2 + 1 for n in shape)
    cast = {"bf16": _bf16, "fp32": lambda t: t}
    ec = cast[types[0]](_field(nc, 35, dev, ring=True))
    u = cast[types[1]](_field(shape, 36, dev, ring=True))
    before = ktransfer3d.prolong_correct3d.launches_bf16
    got = ktransfer3d.prolong_correct3d(ec, u.clone())
    assert ktransfer3d.prolong_correct3d.launches_bf16 == before + 1
    _exact(got, ktransfer3d.prolong_correct3d_plain(ec, u.clone()))


def _at_offset(t, offset, dtype):
    """``t`` as ``dtype`` in a view at element ``offset`` of a larger
    storage: at an odd offset a bf16 field starts in the upper half of a
    4-byte word."""
    buf = torch.empty(t.numel() + offset, dtype=dtype, device=t.device)
    v = buf[offset:].view(t.shape)
    v.copy_(t)
    return v


def _bf16_at(t, offset):
    return _at_offset(t, offset, torch.bfloat16)


@pytest.mark.parametrize("sweeps,omega,reverse", [(2, 1.0, False),
                                                  (1, 1.3, True),
                                                  (5, 1.3, False)])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("shape", [(37, 66, 70), (33, 34, 131),
                                   (65, 65, 65)])
def test_rbgs3d_bf16_word_pairs_equal_twin(dev, shape, offsets, sweeps,
                                           omega, reverse):
    """E's bf16 planes come in as 4-byte word pairs: nz even and odd, u and
    f views at odd storage offsets (the kernel takes them; no wrapper sends
    a bf16 tensor to the twin), and 5 sweeps (the First, Mid and Last
    storage of a multi-launch bf16 call) equal the twin bit for bit."""
    g, st = _stencil3d(shape, "skew")
    u = _bf16_at(_field(shape, 41, dev, ring=True), offsets[0])
    f = _bf16_at(_field(shape, 42, dev, st.c), offsets[1])
    assert u.data_ptr() % 4 == 2 * offsets[0]
    u0 = u.clone()
    before = ksmooth3d.rbgs3d.launches_bf16
    got = ksmooth3d.rbgs3d(st, u, f, sweeps=sweeps, omega=omega,
                           reverse=reverse)
    assert ksmooth3d.rbgs3d.launches_bf16 - before == len(
        ksmooth3d.plan_passes(shape, sweeps))
    assert got.dtype == torch.bfloat16 and torch.equal(u, u0)
    _exact(got, ksmooth3d.rbgs3d_plain(st, u0.clone(), f, sweeps=sweeps,
                                       omega=omega, reverse=reverse))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(37, 66, 70), (33, 34, 131)])
def test_rbgs3d_fp32_u_bf16_f_equals_twin(dev, shape, offset):
    """An fp32 u with a bf16 f (E's Mid storage in one launch): f's word
    pairs beside u's fp32 copies."""
    g, st = _stencil3d(shape, "skew")
    u = _field(shape, 43, dev, ring=True)
    f = _bf16_at(_field(shape, 44, dev, st.c), offset)
    got = ksmooth3d.rbgs3d(st, u, f, sweeps=2, omega=1.3)
    assert got.dtype == torch.float32
    _exact(got, ksmooth3d.rbgs3d_plain(st, u.clone(), f, sweeps=2,
                                       omega=1.3))


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("types", [("bf16", "fp32"), ("fp32", "bf16")])
@pytest.mark.parametrize("shape", [(9, 10, 11), (37, 66, 70)])
def test_rbgs3d_mixed_u_f_storage_every_sweep_count(dev, shape, types,
                                                    sweeps):
    """E takes a bf16 u over an fp32 f and an fp32 u over a bf16 f at every
    sweep count, on a one-block field and a wave-sized one (storages 5, 1
    and 4; 2 at 1 and 3 sweeps), and equals its twin bit for bit."""
    g, st = _stencil3d(shape, "skew")
    assert ksmooth3d.one_block(shape) == (shape == (9, 10, 11))
    cast = {"bf16": lambda t: _bf16_at(t, 1), "fp32": lambda t: t}
    u = cast[types[0]](_field(shape, 45, dev, ring=True))
    f = cast[types[1]](_field(shape, 46, dev, st.c))
    u0 = u.clone()
    before = ksmooth3d.rbgs3d.launches_bf16
    got = ksmooth3d.rbgs3d(st, u, f, sweeps=sweeps, omega=1.3)
    assert ksmooth3d.rbgs3d.launches_bf16 - before == len(
        ksmooth3d.plan_passes(shape, sweeps))
    assert got.dtype == u.dtype and torch.equal(u, u0)
    _exact(got, ksmooth3d.rbgs3d_plain(st, u0.clone(), f, sweeps=sweeps,
                                       omega=1.3))


@pytest.mark.parametrize("types", [("bf16", "bf16"), ("bf16", "fp32"),
                                   ("fp32", "bf16")])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(37, 69, 131), (65, 65, 65), (11, 9, 7)])
def test_residual_restrict3d_bf16_word_pairs_equal_twin(dev, shape, offset,
                                                        types):
    """F's bf16 planes as 4-byte word pairs, u and f views at opposite
    storage offsets (the kernel takes them), and the fp32 -> bf16 and
    bf16 -> fp32 crossings: equal to the twin bit for bit."""
    g, st = _stencil3d(shape, "skew")
    cast = {"bf16": _bf16_at, "fp32": lambda t, _: t}
    u = cast[types[0]](_field(shape, 45, dev, ring=True), offset)
    f = cast[types[0]](_field(shape, 46, dev, st.c), 1 - offset)
    out = torch.bfloat16 if types[1] == "bf16" else torch.float32
    before = ktransfer3d.residual_restrict3d.launches_bf16
    got = ktransfer3d.residual_restrict3d(st, u, f, out_dtype=out)
    assert ktransfer3d.residual_restrict3d.launches_bf16 == before + 1
    assert got.dtype == out
    _exact(got, ktransfer3d.residual_restrict3d_plain(st, u, f,
                                                      out_dtype=out))


def test_3d_wrappers_refuse_coefficient_and_27_point_stencils(dev):
    """E and F read seven scalars: a coefficient field, a Stencil27 or a
    periodic stencil is refused before any launch."""
    g = T.Grid3D(9, 9, 9)
    u = torch.zeros(g.shape, device=dev)
    var = stencil3d.make_stencil3d(g, a=np.ones(g.shape), device=dev)
    s27 = stencil3d.Stencil27(u.clone(), torch.zeros((26, *g.shape),
                                                     device=dev))
    per = stencil3d.make_stencil3d(g, T.core.bc3d.BoundarySpec3D(
        *(T.core.bc.BCSide(kind=T.core.bc.BCKind.PERIODIC),) * 6))
    before = (ksmooth3d.rbgs3d.launches,
              ktransfer3d.residual_restrict3d.launches)
    for st in (var, s27, per):
        with pytest.raises(ValueError, match="7-point"):
            ksmooth3d.rbgs3d(st, u, u)
        with pytest.raises(ValueError, match="7-point"):
            ktransfer3d.residual_restrict3d(st, u, u)
    assert before == (ksmooth3d.rbgs3d.launches,
                      ktransfer3d.residual_restrict3d.launches)


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
    """The stencil of an n x n grid, or of an (nx, ny) grid when n is a
    pair."""
    g = T.Grid(*((n, n) if isinstance(n, int) else n))
    return g, stencil.make_stencil(g, spec, a=_coef(g, coef), device=dev)


# (70, 133): H's tiles divide neither axis; 5 sweeps take two launches
# (MAX_SWEEPS per launch); 1025^2 takes its 32 x 64 tiles and (257, 513) its
# 16 x 64 tiles, the other shapes 8 x 64
@pytest.mark.parametrize("coef", ["smooth", "jump"])
@pytest.mark.parametrize("method,omega", [("rbgs", 1.0), ("rbgs_rev", 1.0),
                                          ("sor", 1.3), ("jacobi", 0.8)])
@pytest.mark.parametrize("n,sweeps", [(257, 2), (129, 3), (5, 1),
                                      ((70, 133), 5), (1025, 2),
                                      ((257, 513), 5)])
def test_multisweep_var_matches_twin(dev, n, sweeps, method, omega, coef):
    g, st = _var_stencil(n, coef, dev)
    u, f = _field(g.shape, 31, dev), _field(g.shape, 32, dev, 1e3)
    before = ksmooth_var.multisweep_var.launches
    got = ksmooth_var.multisweep_var(st, u.clone(), f, method=method,
                                     sweeps=sweeps, omega=omega)
    assert ksmooth_var.multisweep_var.launches - before == len(
        ksmooth_var.plan_passes(sweeps))
    assert len(ksmooth_var.plan_passes(2)) == 1
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


# I's plans (transfer.var_plan: a tile of VAR_TILES per level, the direct
# plan for bf16 at 1025 -> 513); the tiles divide none of these coarse grids
# but 1025's; u at ``offset``, f at the other parity, the planes alternating
@pytest.mark.parametrize("side_set", list(SIDE_SETS))
@pytest.mark.parametrize("n", [5, 9, 17, 65, (37, 69), 257, 1025])
def test_residual_restrict_var_every_pairing_and_offset(dev, n, side_set):
    """I in all four in/out storage pairings, on views at storage offsets 0
    and 1, equals its twin bit for bit."""
    spec = SIDE_SETS[side_set]
    g, st = _var_stencil(n, "jump", dev, spec)
    sides = spec.dirichlet_sides
    u = _field(g.shape, 36, dev, ring=True)
    f = _field(g.shape, 37, dev, 50.0, ring=True)
    for tin in (torch.float32, torch.bfloat16):
        for out in (torch.float32, torch.bfloat16):
            for offset in (0, 1):
                stv = stencil.Stencil(*(_at_offset(x, (k + offset) % 2, tin)
                                        for k, x in enumerate(st.coefs)))
                uv, fv = _at_offset(u, offset, tin), _at_offset(f, 1 - offset,
                                                                tin)
                before = ktransfer.residual_restrict_var.launches
                got = ktransfer.residual_restrict_var(stv, uv, fv,
                                                      sides=sides,
                                                      out_dtype=out)
                assert ktransfer.residual_restrict_var.launches == before + 1
                assert got.dtype == out
                _exact(got, ktransfer.residual_restrict_plain(
                    stv, uv, fv, sides=sides, out_dtype=out))


@pytest.mark.parametrize("side_set", ["dirichlet", "west_north_neumann"])
@pytest.mark.parametrize("shape", [(37, 69), (65, 65)])
def test_residual_restrict_var_every_plan_equals_twin(dev, shape, side_set):
    """Each of I's plans, launched directly (every tile of VAR_TILES and the
    direct plan), in all four storage pairings, equals the twin bit for
    bit."""
    spec = SIDE_SETS[side_set]
    g, st = _var_stencil(shape, "jump", dev, spec)
    sides = spec.dirichlet_sides
    u = _field(g.shape, 38, dev, ring=True)
    f = _field(g.shape, 39, dev, 50.0, ring=True)
    nc = ktransfer.coarse_shape(*shape)
    for tin in (torch.float32, torch.bfloat16):
        stv = stencil.Stencil(*(x.to(tin) for x in st.coefs))
        uv, fv = u.to(tin), f.to(tin)
        for out in (torch.float32, torch.bfloat16):
            want = ktransfer.residual_restrict_plain(stv, uv, fv, sides=sides,
                                                     out_dtype=out)
            for plan in range(ktransfer.VAR_DIRECT + 1):
                fc = torch.empty(nc, dtype=out, device=dev)
                _build.launch("mg_residual_restrict_var", uv.data_ptr(),
                              fv.data_ptr(),
                              *(x.data_ptr() for x in stv.coefs),
                              fc.data_ptr(), *shape, *nc,
                              ktransfer.side_bits(sides), _build.bf16(uv),
                              _build.bf16(fc), plan, dev.index,
                              _build.stream_of(uv))
                _exact(fc, want)


# J's cluster plan: from 129^2 and (129, 65) two split levels, from 65^2 and
# (65, 129) one, from 17^2 and 3^2 none (CTA 0 walks them all); (49, 129)
# and (121, 129) split one more level than the row rule, to fit shared
# memory
@pytest.mark.parametrize("coef", ["smooth", "jump"])
@pytest.mark.parametrize("entry,method,symmetric", [
    (129, "rbgs", False), (129, "rbgs", True), (65, "jacobi", False),
    (3, "rbgs", False), (65, "rbgs", True), (17, "rbgs", False),
    ((129, 65), "rbgs", False), ((65, 129), "jacobi", False),
    ((49, 129), "rbgs", True), ((121, 129), "jacobi", False)])
def test_tail_vcycle_var_matches_twin(dev, entry, method, symmetric, coef):
    shape = (entry, entry) if isinstance(entry, int) else entry
    g = T.Grid(*shape)
    levels = T.build_hierarchy(g, a=_coef(g, coef), device=dev)
    sts = [lev.stencil for lev in levels]
    u, f = _field(shape, 36, dev), _field(shape, 37, dev, 1e3)
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
@pytest.mark.parametrize("sweeps,omega", [(2, 1.0), (1, 1.3), (3, 1.3),
                                          (5, 1.0)])
@pytest.mark.parametrize("nx,ny", [(257, 257), (129, 65), (70, 37), (5, 5)])
def test_multisweep_planes_matches_twin(dev, nx, ny, sweeps, omega, domain):
    """K: one launch per call of up to MAX_SWEEPS sweeps, out of place (the
    input planes untouched), the twin bit for bit, padding included."""
    g = T.Grid(nx, ny, DOMAINS[domain])
    st = stencil.make_stencil(g)
    u, f = _field(g.shape, 41, dev), _field(g.shape, 42, dev, st.c)
    up, fp = planes.split_field(u), planes.split_field(f)
    up_in = up.clone()
    before = ksmooth_planes.multisweep_planes.launches
    got = ksmooth_planes.multisweep_planes(st, up_in, fp, nx=nx, ny=ny,
                                           sweeps=sweeps, omega=omega)
    assert ksmooth_planes.multisweep_planes.launches - before == len(
        ksmooth.plan_passes(sweeps))
    assert got is not up_in and torch.equal(up_in, up)
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
    u_in = u.clone()
    before = ksmooth.multisweep_parity.launches, ksmooth.multisweep.launches
    got = ksmooth.multisweep(st, u_in, f, sweeps=sweeps, omega=omega,
                             layout="parity")
    passes = len(ksmooth.plan_passes(sweeps))
    assert (ksmooth.multisweep_parity.launches,
            ksmooth.multisweep.launches) == (before[0] + passes, before[1])
    assert got is not u_in and torch.equal(u_in, u)  # out of place
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
    assert kmicro.probe.launches - before == 1  # one launch per call
    _exact(got, kmicro.probe_plain(u, f, mode=mode, sweeps=3))


@pytest.mark.parametrize("sweeps", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("mode", kmicro.MODES)
@pytest.mark.parametrize("shape", [(513, 513), (1000, 771)])
def test_probe_every_sweep_count_matches_twin(dev, shape, mode, sweeps):
    """The probe runs every sweep of a call of up to MAX_SWEEPS sweeps in
    one launch (5 sweeps: two), out of place, equal to its twin bit for bit
    with the wrapped reads of sub and lane at the ring."""
    u, f = _field(shape, 55, dev, ring=True), _field(shape, 56, dev)
    u_in = u.clone()
    before = kmicro.probe.launches
    got = kmicro.probe(u_in, f, mode=mode, sweeps=sweeps)
    assert kmicro.probe.launches - before == len(ksmooth.plan_passes(sweeps))
    assert torch.equal(u_in, u)
    _exact(got, kmicro.probe_plain(u, f, mode=mode, sweeps=sweeps))


@pytest.mark.parametrize("shape", [(1025, 1025), (5, 7), (3, 3),
                                   (3,), (6,), (4097,), (1025, 1023)])
def test_copy2x_and_parity_probe_match_twins(dev, shape):
    u = _field(shape, 47, dev, ring=True)  # ragged tails too
    before = kmicro.copy2x.launches
    _exact(kmicro.copy2x(u), kmicro.copy2x_plain(u))
    assert kmicro.copy2x.launches == before + 1
    if len(shape) == 2 and min(shape) >= 5:
        nx, ny = shape
        up = planes.split_field(u)
        fp = planes.split_field(_field(shape, 48, dev))
        _exact(kmicro.parity(up.clone(), fp, nx=nx, ny=ny, sweeps=3),
               ksmooth_planes.multisweep_planes_plain(
                   kmicro.PROBE_STENCIL, up.clone(), fp, nx=nx, ny=ny,
                   sweeps=3))


def test_copy2x_beyond_l2_matches_twin(dev):
    """A copy larger than L2 takes the kernel's other grid (one float4 per
    thread), with a ragged tail."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    u = _field((l2 // 8 + 3,), 49, dev, ring=True)
    _exact(kmicro.copy2x(u), kmicro.copy2x_plain(u))


def test_rbgs3d_geometry_matches_the_library(dev):
    ksmooth3d.check_geometry.cache_clear()
    ksmooth3d.check_geometry()


@pytest.mark.parametrize("shape", [(1025, 1025), (257, 513), (513, 513),
                                   (257, 257), (5, 5)])
def test_smooth_var_geometry_matches_the_library(dev, shape):
    ksmooth_var.check_geometry.cache_clear()
    ksmooth_var.check_geometry(*shape)


@pytest.mark.parametrize("shape", [(1025, 1025), (513, 513), (257, 257),
                                   (1025, 263), (5, 5)])
def test_smooth_geometry_matches_the_library(dev, shape):
    ksmooth.check_geometry.cache_clear()
    ksmooth.check_geometry(*shape)


@pytest.mark.parametrize("entry,levels", [
    ((129, 129), None), ((129, 65), None), ((65, 129), None),
    ((97, 49), None), ((17, 17), None), ((3, 3), None), ((129, 129), 1),
    ((33, 17), 1)])
def test_tail_plan_matches_the_library(dev, entry, levels):
    cfg = T.MultigridConfig(max_levels=levels or 16)
    hier = T.build_hierarchy(T.Grid(*entry), device=dev, cfg=cfg)
    shapes = tuple(lev.grid.shape for lev in hier)
    ktail.check_plan.cache_clear()
    ktail.check_plan(shapes)


@pytest.mark.parametrize("entry", [(129, 129), (129, 65), (65, 129),
                                   (97, 49), (17, 17), (3, 3), (49, 129),
                                   (121, 129), (51, 115)])
def test_tail_var_plan_matches_the_library(dev, entry):
    levels = T.build_hierarchy(T.Grid(*entry), a=_coef(T.Grid(*entry),
                                                      "smooth"), device=dev)
    shapes = tuple(lev.grid.shape for lev in levels)
    ktail.check_var_plan.cache_clear()
    ktail.check_var_plan(shapes)


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


BF16 = torch.bfloat16


@pytest.mark.parametrize("method,sweeps", [("rbgs", 2), ("rbgs_rev", 2),
                                           ("jacobi", 3), ("rbgs", 9)])
@pytest.mark.parametrize("n", [1025, 513, 257, 3])
def test_multisweep_bf16_equals_twin(dev, n, method, sweeps):
    """A on bf16 storage: one rounding per call, the passes of a call longer
    than one launch kept in fp32 scratch."""
    g, st = _stencil(n, "unit")
    u = _field(g.shape, 61, dev, ring=True).to(BF16)
    f = _field(g.shape, 62, dev, st.c).to(BF16)
    omega = 0.8 if method == "jacobi" else 1.0
    before = ksmooth.multisweep.launches_bf16
    got = ksmooth.multisweep(st, u, f, method=method, sweeps=sweeps,
                             omega=omega)
    assert ksmooth.multisweep.launches_bf16 - before == len(
        ksmooth.plan_passes(sweeps))
    assert got.dtype == BF16 and got is not u
    _exact(got, ksmooth.multisweep_plain(st, u.clone(), f, method=method,
                                         sweeps=sweeps, omega=omega))


@pytest.mark.parametrize("tin,tout", [(BF16, BF16), (torch.float32, BF16),
                                      (BF16, torch.float32)])
@pytest.mark.parametrize("n", [1025, 65, 5])
def test_residual_restrict_bf16_equals_twin(dev, n, tin, tout):
    g, st = _stencil(n, "unit")
    u = _field(g.shape, 63, dev).to(tin)
    f = _field(g.shape, 64, dev, st.c).to(tin)
    before = ktransfer.residual_restrict.launches_bf16
    got = ktransfer.residual_restrict(st, u, f, out_dtype=tout)
    assert ktransfer.residual_restrict.launches_bf16 == before + 1
    assert got.dtype == tout
    _exact(got, ktransfer.residual_restrict_plain(st, u, f, out_dtype=tout))


@pytest.mark.parametrize("tec,tu", [(BF16, BF16), (BF16, torch.float32),
                                    (torch.float32, BF16)])
@pytest.mark.parametrize("n", [1025, 65, 5])
def test_prolong_correct_bf16_equals_twin(dev, n, tec, tu):
    nc = (n - 1) // 2 + 1
    u = _field((n, n), 65, dev, ring=True).to(tu)
    ec = _field((nc, nc), 66, dev, ring=True).to(tec)
    got = ktransfer.prolong_correct(ec, u.clone())
    assert got.dtype == tu
    _exact(got, ktransfer.prolong_correct_plain(ec, u.clone()))


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
@pytest.mark.parametrize("entry,method", [(129, "rbgs"), (65, "jacobi"),
                                          (3, "rbgs")])
def test_tail_vcycle_bf16_equals_twin(dev, entry, method, mode):
    """D on a bf16 tail, and on a mixed one (an fp32 entry, bf16 levels
    below it, as the 'mixed' policy builds them at 1025^2), computes every
    level in fp32."""
    pol = T.policy(mode)
    hier = T.build_hierarchy(T.Grid(1025, 1025), policy=pol, device=dev)
    tail = [lev for lev in hier if lev.grid.nx <= entry]
    if mode == "mixed" and entry == 129:
        assert tail[0].dtype == torch.float32 and tail[2].dtype == BF16
    sts, shapes = [lev.stencil for lev in tail], [lev.grid.shape
                                                  for lev in tail]
    u = _field(shapes[0], 67, dev).to(tail[0].dtype)
    f = _field(shapes[0], 68, dev, sts[0].c).to(tail[0].dtype)
    kw = dict(shapes=shapes, pre=2, post=2, omega=0.8 if method == "jacobi"
              else 1.0, method=method, coarse_sweeps=32, symmetric=False)
    got = ktail.tail_vcycle(sts, u.clone(), f, **kw)
    assert got.dtype == tail[0].dtype
    _exact(got, ktail.tail_vcycle_plain(sts, u.clone(), f, **kw))


def test_bf16_levels_take_kernels_a_to_d(dev):
    """A cycle on a bf16 hierarchy launches A, B, C and D on bf16 storage,
    and a mixed one D on its fp32 entry."""
    wrappers = (ksmooth.multisweep, ktransfer.residual_restrict,
                ktransfer.prolong_correct, ktail.tail_vcycle)
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0)
    for mode in ("bf16", "mixed"):
        hier = T.build_hierarchy(T.Grid(1025, 1025), policy=T.policy(mode),
                                 device=dev, cfg=cfg)
        for w in wrappers:
            w.launches = w.launches_bf16 = 0
        f = _field((1025, 1025), 69, dev, hier[0].stencil.c).to(hier[0].dtype)
        T.mg_cycle(hier, hier[0].zeros(), f, cfg)
        got = [(w.launches, w.launches_bf16) for w in wrappers]
        if mode == "bf16":
            assert all(n == nb > 0 for n, nb in got), got
        else:  # fp32 above 129^2 and at it: D's entry is fp32
            assert got[3] == (1, 0) and all(n > 0 for n, _ in got), got


@pytest.mark.parametrize("name", ["pure_diffusion", "neumann_heat"])
def test_heat_kernels_match_plain(dev, name):
    """A float32 Crank-Nicolson run at 257^2 on the shifted hierarchy
    (c + lam on every level): through A-D (pure diffusion) within TOL of
    the plain path on the card, through I and C (Neumann sides) bit for
    bit."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.applications import (
        heat,
        heat_problems,
    )

    def run(backend):
        cfg = heat.HeatConfig(mg=T.MultigridConfig(
            smoother="rbgs", omega=1.0, backend=backend))
        return heat.solve_heat(heat_problems.CATALOGUE[name](257), 5e-4,
                               1e-4, cfg, device=dev).u

    got, ref = run("auto"), run("torch")
    if name == "neumann_heat":
        _exact(got, ref)
    else:
        _close(got, ref)


def test_heat3d_kernels_match_plain(dev):
    """A float32 Crank-Nicolson run at 33^3 through E, F and G equals the
    plain path on the card bit for bit."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.applications import (
        heat,
        heat3d,
    )

    def run(backend):
        cfg = heat.HeatConfig(mg=T.MultigridConfig(
            smoother="rbgs", omega=1.0, backend=backend))
        return heat3d.solve_heat3d(heat3d.oscillating3d(33), 5e-3, 1e-3,
                                   cfg, device=dev)["u"]

    _exact(run("auto"), run("torch"))


# ---------------------------------------------------------------------------
# L on bf16 storage takes each window row as aligned 4-byte words whose
# shift is read from the row's element address (H takes 2-byte loads): views
# at storage offset 1 (a field that starts in the upper half of a word), odd
# and even ny, and narrow fields whose windows are clamped at both edges
# equal their twins bit for bit. (5, 9) and (9, 6) are narrower than any tile; 1025^2 is the
# main path's level.
BF16_ROW_SHAPES = [(70, 133), (69, 130), (1025, 1025), (5, 9), (9, 6)]


def _planes_at(st, offset):
    """``st``'s planes as bf16 views at storage ``offset`` ('alt': plane k
    at offset k % 2, so the five planes' rows start at both parities)."""
    return stencil.Stencil(*(
        _bf16_at(x, k % 2 if offset == "alt" else offset)
        for k, x in enumerate(st.coefs)))


@pytest.mark.parametrize("method,omega,sweeps", [("rbgs", 1.0, 2),
                                                 ("jacobi", 0.8, 2),
                                                 ("sor", 1.3, 5)])
@pytest.mark.parametrize("offsets", [(1, 1, 1), (0, 1, 0), (1, 0, "alt")])
@pytest.mark.parametrize("shape", BF16_ROW_SHAPES)
def test_multisweep_var_bf16_offset_views_equal_twin(dev, shape, offsets,
                                                     method, omega, sweeps):
    """H on bf16 u, f and planes at storage offsets (u, f, planes): one
    launch (RB-GS, Jacobi) or two (5 SOR sweeps: bf16 u into an fp32 pass,
    then an fp32 u over bf16 planes) equal the twin bit for bit."""
    g, st = _var_stencil(shape, "jump", dev)
    stb = _planes_at(st, offsets[2])
    u = _bf16_at(_field(shape, 51, dev, ring=True), offsets[0])
    f = _bf16_at(_field(shape, 52, dev, 1e3), offsets[1])
    assert u.data_ptr() % 4 == 2 * offsets[0]
    u0 = u.clone()
    before = ksmooth_var.multisweep_var.launches_bf16
    got = ksmooth_var.multisweep_var(stb, u, f, method=method,
                                     sweeps=sweeps, omega=omega)
    assert ksmooth_var.multisweep_var.launches_bf16 - before == len(
        ksmooth_var.plan_passes(sweeps))
    _exact(got, ksmooth.multisweep_plain(stb, u0, f, method=method,
                                         sweeps=sweeps, omega=omega))


@pytest.mark.parametrize("sweeps,omega", [(2, 1.0), (5, 1.3)])
@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("shape", BF16_ROW_SHAPES)
def test_multisweep_parity_bf16_word_rows_equal_twin(dev, shape, offsets,
                                                     sweeps, omega):
    """L on bf16 u and f at storage offsets (u, f): equal to its twin and
    to A bit for bit, one launch or two (5 sweeps)."""
    st = stencil.make_stencil(T.Grid(*shape))
    u = _bf16_at(_field(shape, 53, dev, ring=True), offsets[0])
    f = _bf16_at(_field(shape, 54, dev, st.c), offsets[1])
    u_in = u.clone()
    before = ksmooth.multisweep_parity.launches_bf16
    got = ksmooth.multisweep(st, u, f, sweeps=sweeps, omega=omega,
                             layout="parity")
    assert ksmooth.multisweep_parity.launches_bf16 - before == len(
        ksmooth.plan_passes(sweeps))
    assert got.dtype == torch.bfloat16 and torch.equal(u, u_in)
    _exact(got, ksmooth.multisweep_parity_plain(st, u_in.clone(), f,
                                                sweeps=sweeps, omega=omega))
    _exact(got, ksmooth.multisweep(st, u_in.clone(), f, sweeps=sweeps,
                                   omega=omega, layout="direct"))


# ---------------------------------------------------------------------------
# u and f in two storages: A, L and H take every pairing of fp32 and bf16, as
# the Pallas kernels cast u and f each on its own; the output keeps u's dtype
# and equals the twin (which widens f to fp32 exactly) bit for bit

PAIRINGS = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
            (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)]


@pytest.mark.parametrize("sweeps", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("pairing", PAIRINGS,
                         ids=lambda p: f"u_{str(p[0])[6:]}_f_{str(p[1])[6:]}")
@pytest.mark.parametrize("shape", [(9, 61), (1025, 1025)])
@pytest.mark.parametrize("kernel", ["A", "A_jacobi", "L", "H"])
def test_every_storage_pairing_equals_twin(dev, kernel, shape, pairing,
                                           sweeps):
    """A one-block field and one that fills the card, 1-5 sweeps (5: two
    launches, the first on the input storage, the second into u's)."""
    tu, tf = pairing
    if kernel == "H":
        st = _var_stencil(shape, "jump", dev)[1].astype(tu)
        scale, wrapper = 1e3, ksmooth_var.multisweep_var
    else:
        st = stencil.make_stencil(T.Grid(*shape))
        scale = st.c
        wrapper = (ksmooth.multisweep_parity if kernel == "L"
                   else ksmooth.multisweep)
    method = "jacobi" if kernel == "A_jacobi" else "rbgs"
    omega = 0.8 if kernel == "A_jacobi" else 1.0
    layout = {"L": dict(layout="parity"), "H": {}}.get(kernel,
                                                       dict(layout="direct"))
    u = _field(shape, 57, dev, ring=True).to(tu)
    f = _field(shape, 58, dev, scale).to(tf)
    u_in = u.clone()
    before = wrapper.launches
    call = (ksmooth_var.multisweep_var if kernel == "H"
            else ksmooth.multisweep)
    got = call(st, u_in, f, method=method, sweeps=sweeps, omega=omega,
               **layout)
    assert wrapper.launches - before == len(ksmooth.plan_passes(sweeps))
    assert got.dtype == tu
    if kernel != "H":
        assert torch.equal(u_in, u)  # A and L work out of place
    _exact(got, ksmooth.multisweep_plain(st, u.clone(), f, method=method,
                                         sweeps=sweeps, omega=omega))


# ---------------------------------------------------------------------------
# N: the float64 step of ir_solve3d

# (33, 65, 17): N's 8 x 32 tiles and its x-chunks do not divide the interior
SHAPES_REFINE3D = [(33, 33, 33), (65, 65, 65), (129, 129, 129),
                   (513, 513, 513), (33, 65, 17)]
# N's norms sum in another order than torch.sum (per block, then over the
# blocks), so they equal the twin's to round-off of the sum, not bit for bit
NORM_RTOL = 1e-13


def _refine_inputs(shape, lo, dev, e_offset=0):
    """The skewed box's fp64 stencil and spacings, u_in with a non-zero
    shell, e in the level's dtype (non-zero on the shell too, which N must
    not add), f."""
    g, st = _stencil3d(shape, "skew")
    gen = torch.Generator(dev).manual_seed(sum(shape))
    u = torch.randn(shape, dtype=torch.float64, device=dev, generator=gen)
    e = 1e-3 * torch.randn(shape, device=dev, generator=gen)
    f = st.c * torch.randn(shape, dtype=torch.float64, device=dev,
                           generator=gen)
    return (st.astype(torch.float64), (g.hx, g.hy, g.hz), u,
            _at_offset(e, e_offset, lo), f)


def _norm_close(got, ref):
    assert abs(got.item() - ref.item()) <= NORM_RTOL * abs(ref.item()), \
        (got.item(), ref.item())


@pytest.mark.parametrize("lo", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES_REFINE3D)
def test_refine_step3d_matches_twin(dev, shape, lo):
    """Step and start: u_out and r_lo bit for bit, the norms to 1e-13;
    u_in untouched; one launch each."""
    st, h, u, e, f = _refine_inputs(shape, lo, dev)
    u_in = u.clone()
    before = krefine3d.refine_step3d.launches
    out = torch.full_like(u, float("nan"))
    r_lo = torch.full(shape, float("nan"), dtype=lo, device=dev)
    got = krefine3d.refine_step3d(st, u, e, f, h=h, out=out, r_lo=r_lo)
    ref = krefine3d.refine_step3d_plain(st, u, e, f, h=h)
    _exact(got[0], ref[0])
    _exact(got[1], ref[1])
    _norm_close(got[2], ref[2])
    assert got[0] is out and got[1] is r_lo and got[3] is None
    assert torch.equal(u, u_in)
    r_lo.fill_(float("nan"))
    got = krefine3d.refine_step3d(st, u, None, f, h=h, r_lo=r_lo)
    ref = krefine3d.refine_step3d_plain(st, u, None, f, h=h,
                                        r_lo=torch.empty_like(r_lo))
    _exact(got[1], ref[1])
    _norm_close(got[2], ref[2])
    _norm_close(got[3], ref[3])
    assert got[0] is u and torch.equal(u, u_in)
    assert krefine3d.refine_step3d.launches == before + 2


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(37, 66, 70), (33, 34, 131)])
def test_refine_step3d_bf16_words_equal_twin(dev, shape, offset):
    """bf16 e read as the aligned words that hold it, at storage offsets 0
    and 1 (rows start in either half of a word); reruns give the same
    norm bits."""
    st, h, u, e, f = _refine_inputs(shape, torch.bfloat16, dev, offset)
    got = krefine3d.refine_step3d(st, u, e, f, h=h)
    ref = krefine3d.refine_step3d_plain(st, u, e, f, h=h)
    _exact(got[0], ref[0])
    _exact(got[1], ref[1])
    _norm_close(got[2], ref[2])
    again = krefine3d.refine_step3d(st, u, e, f, h=h)
    assert again[2].item() == got[2].item()


@pytest.mark.parametrize("shape", [(33, 65, 17), (129, 129, 129)])
def test_refine_step3d_one_scratch_serves_every_launch(dev, shape):
    """A solve's one scratch, zeroed once: a start and three steps that
    ping-pong between two buffers give the norm bits of launches on fresh
    scratch each, and the iterate bit for bit."""
    st, h, u, e, f = _refine_inputs(shape, torch.float32, dev)
    scratch = krefine3d.new_scratch(shape, dev)
    r_lo = torch.empty(shape, device=dev)
    kept = krefine3d.refine_step3d(st, u, None, f, h=h, r_lo=r_lo,
                                   scratch=scratch)
    fresh = krefine3d.refine_step3d(st, u, None, f, h=h,
                                    r_lo=torch.empty_like(r_lo))
    assert [x.item() for x in kept[2:]] == [x.item() for x in fresh[2:]]
    bufs, ref = [torch.empty_like(u), torch.empty_like(u)], u
    for k in range(3):
        kept = krefine3d.refine_step3d(st, u, e, f, h=h, out=bufs[k % 2],
                                       r_lo=r_lo, scratch=scratch)
        fresh = krefine3d.refine_step3d(st, ref, e, f, h=h)
        _exact(kept[0], fresh[0])
        assert kept[2].item() == fresh[2].item()
        u, ref = kept[0], fresh[0]


def test_refine_step3d_refuses_what_it_does_not_take(dev):
    st, h, u, e, f = _refine_inputs((9, 9, 9), torch.float32, dev)
    with pytest.raises(ValueError, match="alias"):
        krefine3d.refine_step3d(st, u, e, f, h=h, out=u)
    with pytest.raises(TypeError):
        krefine3d.refine_step3d(st, u.float(), e, f, h=h)
    with pytest.raises(TypeError):
        krefine3d.refine_step3d(st, u, e.double(), f, h=h)
    with pytest.raises(TypeError):
        krefine3d.refine_step3d(st, u, e, f, h=h,
                                r_lo=e.to(torch.bfloat16))
    with pytest.raises(ValueError):
        krefine3d.refine_step3d(st, u, e[:, :, :-1].contiguous(), f, h=h)
    with pytest.raises(ValueError, match="scratch"):
        krefine3d.refine_step3d(st, u, e, f, h=h, scratch=krefine3d
                                .new_scratch((9, 129, 129), dev))


def _refine_levels(n, dev):
    prob = T.poisson3d_mms_sinsinsin(n)
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    levels = T.build_hierarchy3d(prob.grid, prob.spec, dtype="float32",
                                 device=dev, cfg=cfg)
    return (levels, prob.rhs(torch.float64, dev),
            prob.initial_guess(torch.float64, dev), cfg)


def test_ir_solve3d_takes_n(dev, monkeypatch):
    """65^3: one launch of N at the start and one a step; the iterate
    equals the plain step's (N closed) bit for bit and the count and
    history equal backend 'torch''s, the history to 1e-12."""
    levels, f, u0, cfg = _refine_levels(65, dev)
    kept = u0.clone()
    before = krefine3d.refine_step3d.launches
    u_k, info_k = T.ir_solve3d(levels, f, u0, cfg, inner_cycles=2)
    assert krefine3d.refine_step3d.launches - before == \
        1 + info_k["iterations"]
    assert info_k["converged"] and torch.equal(u0, kept)
    u_t, info_t = T.ir_solve3d(levels, f, u0, cfg.replace(backend="torch"),
                               inner_cycles=2)
    assert info_k["iterations"] == info_t["iterations"]
    np.testing.assert_allclose(info_k["history"], info_t["history"],
                               rtol=1e-12, atol=0)
    monkeypatch.setattr(dispatch, "refine3d_ok", lambda *a: False)
    u_p, info_p = T.ir_solve3d(levels, f, u0, cfg, inner_cycles=2)
    assert krefine3d.refine_step3d.launches - before == \
        1 + info_k["iterations"]
    assert torch.equal(u_k, u_p) and \
        info_k["iterations"] == info_p["iterations"]
    np.testing.assert_allclose(info_k["history"], info_p["history"],
                               rtol=1e-12, atol=0)


def test_solve_poisson3d_mixed_takes_n(dev):
    """A 'mixed' 33^3 solve through N keeps its error bound: the 7-point
    discretisation error of the closed form."""
    prob = T.poisson3d_mms_sinsinsin(33)
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    before = krefine3d.refine_step3d.launches
    res = T.solve_poisson3d(prob, precision="mixed", cfg=cfg, device=dev)
    assert res.converged
    assert krefine3d.refine_step3d.launches - before == 1 + res.iterations
    h = 1.0 / 32
    lam_h = 12.0 / h**2 * np.sin(np.pi * h / 2) ** 2
    np.testing.assert_allclose(res.errors["l2"],
                               abs(3 * np.pi**2 / lam_h - 1) / np.sqrt(8),
                               rtol=1e-4)
