"""Run a function on N processes that form one ``torch.distributed`` world.

``run(fn, world_size, *args)`` starts ``world_size`` processes
(``torch.multiprocessing``, start method 'spawn'), each of which brings the
process group up with a ``FileStore`` rendezvous in a temporary directory
(``initialize_distributed``: gloo on the CPU, or NCCL with rank r on card
r), calls ``fn(*args)`` and sends its result back. It returns the results
in rank order and raises if any rank raises, dies or outlasts ``timeout``.
A file rendezvous needs no TCP port, so several worlds (pytest-xdist
workers) run side by side on one host.

``fn`` and ``args`` are pickled into the children by reference: ``fn``
must be a module-level function of an importable module, and the
children import nothing else (no test module, no JAX). Under NCCL the
parent builds the CUDA kernel library first, so that the ranks do not
race ``nvcc`` on the build directory.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .multihost import initialize_distributed

BACKENDS = ("gloo", "nccl")


def _rank_main(fn, rank: int, world_size: int, store: str, backend: str,
               args, results) -> None:
    try:
        if backend == "gloo":
            torch.set_num_threads(1)  # world_size ranks share the host
        initialize_distributed(f"file://{store}", world_size, rank, rank,
                               backend=backend)
        out = fn(*args)
        results.put((rank, True, out))
        dist.barrier()  # no rank leaves while another still needs it
    except Exception:  # the rank's boundary: report and let run() raise
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, world_size: int, *args, backend: str = "gloo",
        timeout: float = 600.0) -> list:
    """``fn(*args)`` on ``world_size`` ranks; the results in rank order."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "nccl":
        from ..ops.cuda_kernels import _build

        _build.library()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, failures = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, store, backend, args,
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(failures) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in got]
                    if dead:
                        failures.append(f"rank {dead[0]} exited with code "
                                        f"{procs[dead[0]].exitcode}")
                        break
                    if time.monotonic() > deadline:
                        failures.append(f"timed out after {timeout} s with "
                                        f"results from ranks {sorted(got)}")
                        break
                    continue
                if ok:
                    got[rank] = value
                else:
                    failures.append(f"rank {rank} raised:\n{value}")
                    break
            for p in procs:
                p.join(timeout=30.0 if not failures else 1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    if failures:
        raise RuntimeError("; ".join(failures))
    return [got[r] for r in range(world_size)]
