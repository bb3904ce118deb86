"""Each CUDA kernel's plain twin against the JAX package's Pallas kernel.

The Pallas kernels run in interpret mode on the CPU, as
tests/unit/test_pallas_kernels.py runs them. Inputs are numpy arrays from a
seed, padded to the JAX layout for the Pallas side. Tolerance: rtol = atol =
1e-5 relative to the largest reference value. Both sides compute in fp32, but
the Pallas kernels multiply by 1/c where the twins divide by c, restrict
separably ([1 2 1] along x, then y) where the twins sum centre, edges and
corners, and interpolate in two half-weight passes where the twins average
four corners at once; the tail chains about a hundred such steps.
The smoothers' u and f may be stored in two dtypes (fp32 and bf16): both
sides widen each exactly, compute in fp32 and round once into u's dtype.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (  # noqa: E402
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    stencil as jst,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.pallas_kernels import (  # noqa: E402
    smooth as psmooth,
    tail as ptail,
    transfer as ptransfer,
)
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core.grid import (  # noqa: E402
    Grid,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    stencil,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (  # noqa: E402
    smooth as ksmooth,
    smooth_var as ksmooth_var,
    tail as ktail,
    transfer as ktransfer,
)

TOL = 1e-5


def _field(shape, seed, scale=1.0, ring=False):
    rng = np.random.default_rng(seed)
    a = np.zeros(shape, np.float32)
    if ring:
        a[:] = scale * rng.standard_normal(shape)
    else:
        a[1:-1, 1:-1] = scale * rng.standard_normal(
            (shape[0] - 2, shape[1] - 2))
    return a


def _jax(a, grid):
    return jnp.asarray(interop.field_to_jax_layout(torch.from_numpy(a), grid))


def _assert_close(got, ref_padded, grid):
    ref = np.asarray(ref_padded)[: grid.nx, : grid.ny]
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL * scale)


def _stencils(n):
    g = Grid(n, n)
    return g, stencil.make_stencil(g), jst.make_stencil(JGrid(n, n))


@pytest.mark.parametrize("method,sweeps", [("jacobi", 1), ("jacobi", 3),
                                           ("rbgs", 1), ("rbgs", 3)])
def test_multisweep_twin_matches_pallas_whole_grid(method, sweeps):
    g, st, jstc = _stencils(17)
    u, f = _field(g.shape, 1), _field(g.shape, 2, st.c)
    omega = 0.8 if method == "jacobi" else 1.0
    ref = psmooth.multisweep(jstc, _jax(u, g), _jax(f, g), nx=17, ny=17,
                             method=method, sweeps=sweeps, omega=omega,
                             interpret=True)
    got = ksmooth.multisweep_plain(st, torch.from_numpy(u),
                                   torch.from_numpy(f), method=method,
                                   sweeps=sweeps, omega=omega)
    _assert_close(got, ref, g)


@pytest.mark.parametrize("method", ["jacobi", "rbgs"])
def test_multisweep_twin_matches_pallas_strips(method):
    g, st, jstc = _stencils(65)
    u, f = _field(g.shape, 3), _field(g.shape, 4, st.c)
    omega = 0.8 if method == "jacobi" else 1.0
    ref = psmooth.multisweep_strips(jstc, _jax(u, g), _jax(f, g), nx=65,
                                    ny=65, method=method, sweeps=2,
                                    omega=omega, strip=16, interpret=True)
    got = ksmooth.multisweep_plain(st, torch.from_numpy(u),
                                   torch.from_numpy(f), method=method,
                                   sweeps=2, omega=omega)
    _assert_close(got, ref, g)


@pytest.mark.parametrize("n", [33, 65])
def test_residual_restrict_twin_matches_pallas(n):
    g, st, jstc = _stencils(n)
    gc = g.coarsen()
    u, f = _field(g.shape, n), _field(g.shape, n + 1, st.c)
    ref = ptransfer.residual_restrict(
        jstc, _jax(u, g), _jax(f, g), nxf=n, nyf=n, ncx=gc.nx, ncy=gc.ny,
        pshape_coarse=JGrid(gc.nx, gc.ny).shape_padded, interpret=True)
    got = ktransfer.residual_restrict_plain(st, torch.from_numpy(u),
                                            torch.from_numpy(f))
    assert got.shape == gc.shape
    _assert_close(got, ref, gc)


@pytest.mark.parametrize("n", [33, 65])
def test_prolong_correct_twin_matches_pallas(n):
    g = Grid(n, n)
    gc = g.coarsen()
    u = _field(g.shape, n + 2, ring=True)
    ec = _field(gc.shape, n + 3, ring=True)  # the ring interpolates too
    ref = ptransfer.prolong_correct(_jax(ec, gc), _jax(u, g), ncx=gc.nx,
                                    ncy=gc.ny, nxf=n, nyf=n, interpret=True)
    ut = torch.from_numpy(u.copy())
    got = ktransfer.prolong_correct_plain(torch.from_numpy(ec), ut)
    assert got is ut
    assert np.array_equal(got.numpy()[0], u[0])  # ring stays fixed
    _assert_close(got, ref, g)


@pytest.mark.parametrize("entry,symmetric", [(65, False), (65, True),
                                             (3, False)])
def test_tail_twin_matches_pallas(entry, symmetric):
    """From a 65^2 entry (6 levels, colour order reversed in post-smoothing
    when symmetric) and the single-level tail FMG runs at 3^2."""
    sizes = [entry]
    while sizes[-1] > 3:
        sizes.append((sizes[-1] - 1) // 2 + 1)
    grids = [Grid(n, n) for n in sizes]
    sts = [stencil.make_stencil(g) for g in grids]
    jsts = [jst.make_stencil(JGrid(n, n)) for n in sizes]
    meta = tuple((n, n) + JGrid(n, n).shape_padded for n in sizes)
    u, f = _field(grids[0].shape, 11), _field(grids[0].shape, 12, sts[0].c)
    kw = dict(pre=2, post=2, omega=1.0, method="rbgs", coarse_sweeps=32,
              symmetric=symmetric)
    ref = ptail.tail_vcycle(jsts, _jax(u, grids[0]), _jax(f, grids[0]),
                            meta=meta, interpret=True, **kw)
    got = ktail.tail_vcycle_plain(sts, torch.from_numpy(u),
                                  torch.from_numpy(f),
                                  shapes=[g.shape for g in grids], **kw)
    _assert_close(got, ref, grids[0])


# u and f in two storages: (u, f)
MIXED = [(torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
_JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _pair(a, b, dtypes):
    """numpy u and f as torch tensors of ``dtypes`` and as JAX arrays of
    the same values in the JAX layout."""
    g = Grid(*a.shape)
    ts = [torch.from_numpy(x).to(dt) for x, dt in zip((a, b), dtypes)]
    js = [jnp.asarray(interop.field_to_jax_layout(t.float(), g), _JDT[dt])
          for t, dt in zip(ts, dtypes)]
    return ts, js


@pytest.mark.parametrize("dtypes", MIXED, ids=["bf16u_fp32f", "fp32u_bf16f"])
@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("layout", ["direct", "parity"])
def test_mixed_storage_twins_match_pallas(dtypes, sweeps, layout):
    """A's twin (direct) and L's (parity) on a u and an f of two storages:
    the output keeps u's dtype, as the Pallas kernel's out_shape does."""
    n = 33
    g, st, jstc = _stencils(n)
    (u, f), (ju, jf) = _pair(_field(g.shape, 70 + sweeps),
                             _field(g.shape, 80 + sweeps, st.c), dtypes)
    ref = psmooth.multisweep(jstc, ju, jf, nx=n, ny=n, method="rbgs",
                             sweeps=sweeps, omega=1.0, layout=layout,
                             interpret=True)
    assert ref.dtype == _JDT[dtypes[0]]
    twin = (ksmooth.multisweep_plain if layout == "direct"
            else ksmooth.multisweep_parity_plain)
    got = twin(st, u.clone(), f, sweeps=sweeps)
    assert got.dtype == dtypes[0]
    _assert_close(got.float(), np.asarray(ref, np.float32), g)


@pytest.mark.parametrize("dtypes", MIXED, ids=["bf16u_fp32f", "fp32u_bf16f"])
@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_mixed_storage_var_twin_matches_pallas(dtypes, sweeps):
    """H's twin on a u and an f of two storages, its planes in u's dtype
    (the port's gate keeps them so), a = 1 + x + y."""
    n = 33
    g = Grid(n, n)
    X, Y = g.coordinates()
    st = stencil.make_stencil(g, a=1.0 + X + Y).astype(dtypes[0])
    jstc = jst.Stencil(*(jnp.asarray(interop.field_to_jax_layout(
        x.float(), g), _JDT[dtypes[0]]) for x in st.coefs))
    (u, f), (ju, jf) = _pair(_field(g.shape, 90 + sweeps),
                             _field(g.shape, 95 + sweeps, 1e3), dtypes)
    ref = psmooth.multisweep(jstc, ju, jf, nx=n, ny=n, method="rbgs",
                             sweeps=sweeps, omega=1.0, interpret=True)
    assert ref.dtype == _JDT[dtypes[0]]
    got = ksmooth_var.multisweep_var(st, u.clone(), f, sweeps=sweeps)
    assert got.dtype == dtypes[0]
    _assert_close(got.float(), np.asarray(ref, np.float32), g)
