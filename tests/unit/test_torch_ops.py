"""The PyTorch port's plain operators against the JAX package's XLA ones.

Same inputs (numpy, from a seed) go through both packages at 17^2 and 33^2,
in fp32 and fp64, and are compared on the logical (nx, ny) region. Both
sides run the same arithmetic in the same order on the CPU, so the
tolerances only allow for a last-bit difference: 1e-6 relative in fp32 and
1e-13 in fp64.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (  # noqa: E402
    bc as jbc,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (  # noqa: E402
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (  # noqa: E402
    norms as jnorms,
    smooth as jsmooth,
    stencil as jst,
    transfer as jtransfer,
)
from mixed_precision_multigrid_solvers_for_pdes_torch import interop  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core.grid import (  # noqa: E402
    Grid,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.ops import (  # noqa: E402
    norms,
    smooth,
    stencil,
    transfer,
)

SIZES = [17, 33]
DTYPES = {"float32": (np.float32, torch.float32, 1e-6),
          "float64": (np.float64, torch.float64, 1e-13)}


def _fields(n, np_dtype, seed, count=2):
    """``count`` random (n, n) fields with a zero ring."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = np.zeros((n, n), np_dtype)
        a[1:-1, 1:-1] = rng.standard_normal((n - 2, n - 2))
        out.append(a)
    return out


def _jax(a, grid):
    return jnp.asarray(interop.field_to_jax_layout(torch.from_numpy(a), grid))


def _assert_close(port, ref_padded, grid, tol):
    ref = np.asarray(ref_padded)[: grid.nx, : grid.ny]
    got = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("n", [3, 5, 17, 33, 65])
def test_grid_coarsen_matches_jax(n):
    g, jg = Grid(n, n + 2 * (n > 3)), JGrid(n, n + 2 * (n > 3))
    assert g.can_coarsen() == jg.can_coarsen()
    assert (g.hx, g.hy, g.num_interior) == (jg.hx, jg.hy, jg.num_interior)
    assert g.shape == (g.nx, g.ny)
    if g.can_coarsen():
        c, jc = g.coarsen(), jg.coarsen()
        assert (c.nx, c.ny, c.hx, c.hy) == (jc.nx, jc.ny, jc.hx, jc.hy)
    else:
        with pytest.raises(ValueError):
            g.coarsen()


@pytest.mark.parametrize("n", SIZES)
def test_unknown_mask_matches_jax(n):
    g = Grid(n, n)
    ref = jbc.unknown_mask(n, n, JGrid(n, n).shape_padded, jbc.dirichlet())
    got = bc.unknown_mask(n, n, bc.dirichlet())
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(ref)[:n, :n])
    assert int(got.sum()) == g.num_interior


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_stencil_apply_residual_match_jax(n, dtype):
    np_dt, t_dt, tol = DTYPES[dtype]
    g, jg = Grid(n, n), JGrid(n, n)
    jstc = jst.make_stencil(jg, dtype=np_dt)
    st = stencil.make_stencil(g, dtype=t_dt)
    assert st == interop.stencil_from_jax(jstc)
    u, f = _fields(n, np_dt, seed=n)
    unknown = bc.unknown_mask(n, n)
    junknown = jbc.unknown_mask(n, n, jg.shape_padded, jbc.dirichlet())
    ju, jf = _jax(u, g), _jax(f, g)
    au = stencil.apply(st, torch.from_numpy(u))
    ref_au = jnp.where(junknown, jst.apply(jstc, ju), 0.0)
    _assert_close(au, ref_au, g, tol)
    r = stencil.residual(st, torch.from_numpy(u), torch.from_numpy(f),
                         unknown)
    _assert_close(r, jst.residual(jstc, ju, jf, junknown), g, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_norms_match_jax(n, dtype):
    np_dt, t_dt, tol = DTYPES[dtype]
    g = Grid(n, n)
    (r,) = _fields(n, np_dt, seed=2 * n, count=1)
    r[0, :] = 3.0  # a non-zero ring: the masked norm must drop it
    mask = bc.unknown_mask(n, n)
    jmask = jbc.unknown_mask(n, n, JGrid(n, n).shape_padded, jbc.dirichlet())
    jr = _jax(r, g)
    got = norms.scaled_l2(torch.from_numpy(r), g.hx, g.hy)
    got_m = norms.masked_scaled_l2(torch.from_numpy(r), mask, g.hx, g.hy)
    assert got.dtype == got_m.dtype == torch.float64
    np.testing.assert_allclose(got.item(),
                               float(jnorms.scaled_l2(jr, g.hx, g.hy)),
                               rtol=1e-13)
    np.testing.assert_allclose(
        got_m.item(), float(jnorms.masked_scaled_l2(jr, jmask, g.hx, g.hy)),
        rtol=1e-13)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_max_norm_matches_jax(n, dtype):
    """max |r| in r's dtype, the ring included (the JAX layout's padding
    is zero, so it does not change the maximum)."""
    np_dt, t_dt, _ = DTYPES[dtype]
    g = Grid(n, n)
    (r,) = _fields(n, np_dt, seed=3 * n, count=1)
    r[0, 1] = -7.5  # the largest magnitude, negative, on the ring
    got = norms.max_norm(torch.from_numpy(r))
    ref = jnorms.max_norm(_jax(r, g))
    assert got.dtype == t_dt and got.item() == float(ref) == 7.5
    (r,) = _fields(n, np_dt, seed=3 * n + 1, count=1)
    assert norms.max_norm(torch.from_numpy(r)).item() == float(
        jnorms.max_norm(_jax(r, g)))


def test_omega_helpers_match_jax():
    assert smooth.optimal_jacobi_omega() == jsmooth.optimal_jacobi_omega()
    for nx, ny in ((17, 17), (33, 65), (1025, 1025)):
        assert smooth.optimal_sor_omega(nx, ny) == \
            jsmooth.optimal_sor_omega(nx, ny)


@pytest.mark.parametrize("method", ["jacobi", "rbgs", "rbgs_rev"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_smooth_matches_jax(n, dtype, method):
    np_dt, t_dt, tol = DTYPES[dtype]
    g, jg = Grid(n, n), JGrid(n, n)
    st = stencil.make_stencil(g, dtype=t_dt)
    jstc = jst.make_stencil(jg, dtype=np_dt)
    u, f = _fields(n, np_dt, seed=3 * n)
    f *= st.c  # keep f/c and the neighbour average the same size
    omega = 0.8 if method == "jacobi" else 1.0
    junknown = jbc.unknown_mask(n, n, jg.shape_padded, jbc.dirichlet())
    ref = jsmooth.smooth(jstc, _jax(u, g), _jax(f, g), junknown,
                         method=method, sweeps=2, omega=omega)
    ut = torch.from_numpy(u.copy())
    got = smooth.smooth(st, ut, torch.from_numpy(f), bc.unknown_mask(n, n),
                        method=method, sweeps=2, omega=omega)
    assert got is ut  # updated in place
    _assert_close(got, ref, g, tol)


@pytest.mark.parametrize("boundary", ["zero", "inject"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_restrict_matches_jax(n, dtype, boundary):
    np_dt, t_dt, tol = DTYPES[dtype]
    g, gc = Grid(n, n), Grid(n, n).coarsen()
    (r,) = _fields(n, np_dt, seed=5 * n, count=1)
    r[:, 0] = np.linspace(1.0, 2.0, n)  # ring values matter for 'inject'
    ref = jtransfer.restrict(_jax(r, g), gc.nx, gc.ny,
                             JGrid(gc.nx, gc.ny).shape_padded,
                             boundary=boundary, dtype=np_dt)
    got = transfer.restrict(torch.from_numpy(r), gc.nx, gc.ny,
                            boundary=boundary, dtype=t_dt)
    assert got.shape == gc.shape and got.dtype == t_dt
    _assert_close(got, ref, gc, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_prolong_matches_jax(n, dtype):
    np_dt, t_dt, tol = DTYPES[dtype]
    g, gc = Grid(n, n), Grid(n, n).coarsen()
    rng = np.random.default_rng(7 * n)
    ec = rng.standard_normal(gc.shape).astype(np_dt)  # ring included
    ref = jtransfer.prolong(_jax(ec, gc), gc.nx, gc.ny, n, n,
                            JGrid(n, n).shape_padded, dtype=np_dt)
    got = transfer.prolong(torch.from_numpy(ec), n, n, dtype=t_dt)
    assert got.shape == g.shape
    _assert_close(got, ref, g, tol)
