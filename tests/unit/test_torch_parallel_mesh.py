"""The port's mesh and sharding rules and halo-solve plans against the JAX
package's, on the CPU, with no process group: every rule is integer logic
that decides which levels are split and which agglomerated, so it must
equal the reference exactly over a table of grids, meshes and sides.

JAX meshes come from the 8-device virtual CPU mesh (tests/conftest.py);
plans for meshes of more than 8 ranks are compared on stand-ins that carry
only the mesh shape, the one thing ``make_plan`` reads.
"""

import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu import (  # noqa: E402
    parallel as jpar,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (  # noqa: E402
    bc as jbc,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import (  # noqa: E402
    Grid as JGrid,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid3d import (  # noqa: E402
    Grid3D as JGrid3D,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.parallel import (  # noqa: E402
    halo_solve as jhs,
    mesh as jmesh,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import parallel  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import (  # noqa: E402
    halo_solve as hs,
    mesh as pmesh,
    multihost,
)

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (2, 4), (4, 2),
          (8, 1), (3, 2), (4, 4), (8, 8), (16, 1)]
SIZES = [17, 33, 65, 129, 257, 513, 1025, 2049, 4097]


def _specs(name):
    """(port spec, JAX spec) of a side set."""
    if name == "dirichlet":
        return bc.BoundarySpec(), jbc.BoundarySpec()
    if name == "neumann":
        return bc.neumann(), jbc.neumann()
    per, jper = bc.BCSide(bc.BCKind.PERIODIC), jbc.BCSide(jbc.BCKind.PERIODIC)
    if name == "periodic":
        return (bc.BoundarySpec(per, per, per, per),
                jbc.BoundarySpec(jper, jper, jper, jper))
    if name == "periodic_x":
        return (bc.BoundarySpec(west=per, east=per),
                jbc.BoundarySpec(west=jper, east=jper))
    raise ValueError(name)


def _levels(nx, ny, spec, grid_cls):
    """Stand-in levels (grid and spec: what make_plan reads), finest
    first."""
    out = []
    while True:
        out.append(types.SimpleNamespace(grid=grid_cls(nx, ny), spec=spec))
        if (nx - 1) % 2 or (ny - 1) % 2 or (nx - 1) // 2 + 1 < 3 \
                or (ny - 1) // 2 + 1 < 3:
            return tuple(out)
        nx, ny = (nx - 1) // 2 + 1, (ny - 1) // 2 + 1


@pytest.mark.parametrize("sides", ["dirichlet", "neumann", "periodic",
                                   "periodic_x"])
@pytest.mark.parametrize("min_points", [16, 8])
def test_make_plan_matches_jax(sides, min_points):
    spec, jspec = _specs(sides)
    checked = 0
    for mx, my in MESHES:
        stand_in = types.SimpleNamespace(shape={"x": mx, "y": my})
        for nx in SIZES:
            for ny in (nx, max(17, (nx - 1) // 2 + 1)):
                want = jhs.make_plan(_levels(nx, ny, jspec, JGrid),
                                     stand_in, min_points=min_points)
                got = hs.make_plan(_levels(nx, ny, spec, T.Grid),
                                   pmesh.Mesh((mx, my)),
                                   min_points=min_points)
                assert dataclasses_tuple(got) == dataclasses_tuple(want), \
                    (mx, my, nx, ny)
                if got.n_sharded:
                    assert got.hshape(0) == want.hshape(0)
                checked += got.n_sharded > 0
    assert checked > 20


def dataclasses_tuple(plan):
    return (plan.mx, plan.my, plan.n_sharded, tuple(plan.blocks))


def test_choose_mesh_shape_matches_jax():
    for n in range(1, 65):
        assert pmesh.choose_mesh_shape(n) == jmesh.choose_mesh_shape(n)
        for nx, ny in ((129, 65), (65, 129), (33, 33)):
            assert pmesh.choose_mesh_shape(n, T.Grid(nx, ny)) == \
                jmesh.choose_mesh_shape(n, JGrid(nx, ny)), (n, nx, ny)


def _jax_mesh(shape):
    return jpar.make_mesh(jax.devices()[:shape[0] * shape[1]], shape=shape)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 1), (1, 4),
                                   (2, 4), (4, 2), (8, 1)])
def test_grid_sharding_matches_jax(shape):
    jm, pm = _jax_mesh(shape), pmesh.Mesh(shape)
    for nx in (5, 17, 33, 65, 129, 257, 1025):
        for ny in (5, 17, 65, 129, 513):
            for mp in (16, 8, 4):
                want = jpar.grid_sharding(jm, JGrid(nx, ny), mp).spec
                got = parallel.grid_sharding(pm, T.Grid(nx, ny), mp).spec
                assert got == tuple(want), (nx, ny, mp)
            want = jmesh.grid_sharding3d(jm, JGrid3D(nx, ny, 33)).spec
            got = pmesh.grid_sharding3d(pm, T.Grid3D(nx, ny, 33)).spec
            assert got == tuple(want), (nx, ny)
    assert parallel.replicated(pm).spec == tuple(jpar.replicated(jm).spec)


@pytest.mark.parametrize("n_devices", [8, 4, 2, 6])
def test_graded_sharding_matches_jax(n_devices):
    jm = jpar.make_graded_mesh(jax.devices()[:n_devices])
    pm = parallel.make_graded_mesh(tuple(range(n_devices)))
    assert jm.axis_names == pm.axis_names
    assert dict(jm.shape) == pm.shape
    for n in (5, 9, 17, 33, 65, 129, 257, 513):
        for mp in (16, 8):
            want = jpar.graded_sharding(jm, JGrid(n, n), mp).spec
            got = parallel.graded_sharding(pm, T.Grid(n, n), mp).spec
            assert got == tuple(want), (n, mp)


def test_block_extent_is_the_jax_padded_shape():
    for nx, ny in ((3, 3), (17, 129), (1025, 1025), (513, 100)):
        assert pmesh.block_extent(nx, ny) == JGrid(nx, ny).shape_padded
        assert pmesh.block_extent3d(nx, ny, 33) == \
            JGrid3D(nx, ny, 33).shape_padded


def test_blocks_tile_the_extent():
    """Every rank's block of a graded or a plain mesh, from its own
    coordinates, and together they tile the block extent once."""
    grid = T.Grid(257, 129)
    whole = torch.arange(np.prod(pmesh.block_extent(257, 129)),
                         dtype=torch.float64).reshape(
        pmesh.block_extent(257, 129))
    for mesh in (pmesh.Mesh((2, 4)), pmesh.Mesh((2, 2, 1, 2),
                                                pmesh.GRADED_AXES)):
        sh = (parallel.grid_sharding if mesh.axis_names == pmesh.AXES
              else parallel.graded_sharding)(mesh, grid, 16)
        seen = torch.zeros_like(whole)
        for idx in range(mesh.size):
            mesh.coords = dict(zip(mesh.axis_names, pmesh._unravel(
                idx, tuple(mesh.shape.values()))))
            seen[sh.block_slices(whole.shape)] += 1
            assert torch.equal(sh.block(whole),
                               whole[sh.block_slices(whole.shape)])
        assert torch.equal(seen, torch.ones_like(seen))


def test_single_process_mesh_and_launch_records():
    """Without a process group: a mesh of one rank, the global mesh and a
    sharded field are the whole level, and the summary says one process."""
    assert not torch.distributed.is_initialized()
    multihost.initialize_distributed()  # nothing to bring up
    assert not torch.distributed.is_initialized()
    mesh = multihost.make_global_mesh()
    assert mesh.shape == {"x": 1, "y": 1} and mesh.coords == {"x": 0, "y": 0}
    grid = T.Grid(33, 33)
    sf = multihost.make_sharded_field(mesh, grid, lambda X, Y: X + 2 * Y,
                                      device="cpu")
    X, Y = grid.coordinates()
    assert torch.equal(sf.gather(), torch.from_numpy(X + 2 * Y))
    assert multihost.process_summary()["process_count"] == 1
    with pytest.raises(ValueError):
        multihost.make_global_mesh(shape=(2, 1))


def test_make_sharded_field_defaults_to_the_card():
    """``device=None`` is this rank's card, as for every entry point: a
    CUDA block where a card exists, else an error, never a CPU block."""
    mesh = multihost.make_global_mesh()
    grid = T.Grid(33, 33)
    if torch.cuda.is_available():
        sf = multihost.make_sharded_field(mesh, grid, None)
        assert sf.block.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multihost.make_sharded_field(mesh, grid, None)


def test_parallel_modules_import_no_jax():
    """The rank functions run in spawned children that must not import JAX
    or the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[2])
    mods = ["parallel", "parallel.halo_solve", "parallel.mesh",
            "parallel.multihost", "parallel.launch", "parallel.checks",
            "parallel.blocks", "parallel.distributed"]
    code = ("import sys, importlib; "
            + "; ".join(f"importlib.import_module('mixed_precision_multigrid_"
                        f"solvers_for_pdes_torch.{m}')" for m in mods)
            + "; bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', "
            "'mixed_precision_multigrid_solvers_for_pdes_tpu'))); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
