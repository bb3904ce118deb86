"""Separate OS processes forming one ``torch.distributed`` world, as
torchrun forms one: the port's counterpart of the JAX package's
tests/unit/test_multihost.py and tests/multihost_worker.py.

Each test starts N copies of this file as a script (``python
test_torch_multihost.py <scenario>``) with torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT`` on a free localhost port, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``); each process brings gloo up through
``parallel.multihost.initialize_distributed`` (the ``env://``
rendezvous) and imports the port alone. Every process runs the GSPMD
path (``sharded_solve``, or ``solve_poisson3d(mesh=)``) and the explicit
path (``halo_solve``) on a mesh over every process and holds its own block
of each result against the same block of a process-local single-device
solve (the counterpart of the JAX worker's ``check_vs_local``: atol 1e-11,
the JAX worker's, and equal iteration counts); it also checks that
``make_sharded_field`` builds its block without the global array.

The scenarios: ``two`` (2 processes, mesh (2, 1), 65^2; unmarked, so that
tier-1 runs the launch path), ``base`` (4 processes, mesh (2, 2),
``poisson_mms_sinsin(65)``), ``topo`` (8 processes, mesh (2, 4)),
``segments`` (4 processes, ``mixed_segment_mms(65)``: a Neumann segment on
a side split across processes) and ``3d`` (4 processes, mesh (2, 2),
``solve_poisson3d(mesh=)`` at 33^3, whose finest level splits). All but
``two`` are marked slow, as the JAX package marks its own.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve()
REPO = HERE.parents[2]
SCENARIOS = {"two": (2, (2, 1)), "base": (4, (2, 2)), "topo": (8, (2, 4)),
             "segments": (4, (2, 2)), "3d": (4, (2, 2))}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(scenario: str, timeout: float) -> list:
    nproc, _ = SCENARIOS[scenario]
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE=str(nproc),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=f"{REPO}{os.pathsep}"
                   f"{os.environ.get('PYTHONPATH', '')}")
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE), scenario], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO)))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-3000:]}"
    return outs


def test_two_process_launch_path():
    """2 processes, mesh (2, 1): GSPMD and halo_solve at 65^2, each block
    equal to the process-local solve's."""
    outs = _launch("two", timeout=60)
    assert "MULTIHOST_TWO_OK" in outs[0], outs[0][-3000:]


@pytest.mark.slow
def test_four_process_sharded_solve():
    outs = _launch("base", timeout=300)
    assert "MULTIHOST_BASE_OK" in outs[0], outs[0][-3000:]


@pytest.mark.slow
def test_eight_process_topology():
    """8 processes, mesh (2, 4): more halo edges cross processes."""
    outs = _launch("topo", timeout=300)
    assert "MULTIHOST_TOPO_OK" in outs[0], outs[0][-3000:]


@pytest.mark.slow
def test_four_process_mixed_segments():
    """Per-segment mixed sides across process boundaries, both paths."""
    outs = _launch("segments", timeout=300)
    assert "MULTIHOST_SEGMENTS_OK" in outs[0], outs[0][-3000:]


@pytest.mark.slow
def test_four_process_poisson3d():
    """solve_poisson3d(mesh=) on (x, y) blocks of whole z-lines."""
    outs = _launch("3d", timeout=300)
    assert "MULTIHOST_3D_OK" in outs[0], outs[0][-3000:]


# ---------------------------------------------------------------------------
# the worker: one process of the world


def _worker(scenario: str) -> int:
    import numpy as np
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.applications \
        import poisson3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.core.grid import (
        Grid,
    )
    from mixed_precision_multigrid_solvers_for_pdes_torch.models import (
        problems as P,
        problems3d as P3,
    )
    from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import (
        distributed,
        halo_solve as hs,
        mesh as mesh_mod,
        multihost,
    )
    from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (
        multigrid as mg_mod,
        multigrid3d as mg3,
    )

    torch.set_num_threads(1)
    nproc, shape = SCENARIOS[scenario]
    multihost.initialize_distributed()
    info = multihost.process_summary()
    assert info["process_count"] == nproc and info["backend"] == "gloo", info
    mesh = multihost.make_global_mesh(shape=shape)
    tag = scenario.upper()
    cfg = mg_mod.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-8,
                                 backend="torch", max_iterations=30)

    def check_vs_local(u, u_local, grid, what, atol=1e-11):
        """This process's block of the result against the same block of
        the process-local solve."""
        got, ref = (mesh_mod.shard_level_arrays(mesh, grid, x.double())
                    for x in (u, u_local))
        worst = float((got - ref).abs().max())
        assert worst < atol, f"{tag}/{what}: block off the local solve by " \
                             f"{worst}"
        return worst

    if scenario == "3d":
        prob = P3.poisson3d_mms_sinsinsin(33)
        local = poisson3d.solve_poisson3d(prob, precision="fp64", cfg=cfg,
                                          device="cpu")
        res = poisson3d.solve_poisson3d(prob, precision="fp64", cfg=cfg,
                                        mesh=mesh, device="cpu")
        assert res.converged and res.iterations == local.iterations
        levels = mg3.build_hierarchy3d(prob.grid, prob.spec, cfg=cfg,
                                       dtype="float64", device="cpu")
        tiers = distributed.make_tilings(mesh, levels, dims=3)
        assert len(tiers) == 1, tiers  # 33^3 splits; 17^3 keeps < 16
        plane = Grid(prob.grid.nx, prob.grid.ny)
        worst = max(check_vs_local(res.u[:, :, k], local.u[:, :, k], plane,
                                   "3d")
                    for k in range(prob.grid.nz))  # each z-plane's blocks
        if multihost.process_summary()["process_index"] == 0:
            print(f"MULTIHOST_3D_OK iters={res.iterations} "
                  f"diff={worst:.2e}", flush=True)
        return 0

    prob = (P.mixed_segment_mms(65) if scenario == "segments"
            else P.poisson_mms_sinsin(65))
    levels = mg_mod.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                    lam=prob.lam, dtype="float64", cfg=cfg,
                                    device="cpu")
    f = prob.rhs(torch.float64)
    u0 = prob.initial_guess(torch.float64)
    # the no-global-array data path: a field evaluated on this block only
    fn = (lambda X, Y: np.sin(np.pi * X) * np.sin(np.pi * Y))
    sf = multihost.make_sharded_field(mesh, prob.grid, fn, device="cpu")
    whole = torch.from_numpy(fn(*prob.grid.coordinates()))
    assert torch.equal(sf.block, mesh_mod.shard_level_arrays(
        mesh, prob.grid, whole))
    u_local, info_local = mg_mod.mg_solve(levels, f, u0, cfg)
    assert info_local["converged"], info_local
    u, info_g = distributed.sharded_solve(mesh, levels, f, u0, cfg)
    assert info_g["converged"], info_g
    assert info_g["iterations"] == info_local["iterations"], (info_g,
                                                               info_local)
    w1 = check_vs_local(u, u_local, prob.grid, "gspmd")
    u_h, info_h = hs.halo_solve(mesh, levels, f, u0, cfg)
    assert info_h["converged"], info_h
    assert info_h["iterations"] == info_local["iterations"]
    w2 = check_vs_local(u_h, u_local, prob.grid, "halo")
    if scenario == "segments":
        err = prob.error_norms(u_local)["linf"]
        assert err < 1e-3, err
    if multihost.process_summary()["process_index"] == 0:
        print(f"MULTIHOST_{tag}_OK iters={info_g['iterations']} "
              f"gspmd_diff={w1:.2e} halo_diff={w2:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    code = _worker(sys.argv[1])
    import torch.distributed as dist

    dist.barrier()  # no process leaves while another still needs it
    dist.destroy_process_group()
    sys.exit(code)
