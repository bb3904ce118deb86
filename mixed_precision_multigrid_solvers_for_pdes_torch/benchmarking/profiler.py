"""Per-stage multigrid profiling with FLOP and bandwidth estimates.

Counterpart of ``_stage_flops_bytes`` and ``MultigridProfiler`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/benchmarking/profiler.py``.
Each stage of a cycle runs alone on each level, on the level's device,
timed to the end of its device work (``utils.timing.benchmark_function``):
the smoothing stage through ``ops.dispatch.smooth``, so with
``backend='auto'`` on a card it times kernel A (H on a level with
coefficient planes); the residual, restriction and prolongation stages are
the plain operations, as in the JAX package. A solve runs its transfers
fused into kernels B and C instead, so these stages time the parts, not
the solve. The counts are of the logical nodes: fields here have no tile
padding.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from ..ops import dispatch, stencil as st_mod, transfer
from ..solvers.multigrid import Level, MultigridConfig
from ..utils.timing import benchmark_function


def _stage_flops_bytes(lev: Level, stage: str, sweeps: int = 1
                       ) -> Tuple[float, float]:
    """Rough per-stage FLOP / device-memory byte counts for the 5-point
    operations on the level's nx * ny nodes."""
    n = lev.grid.nx * lev.grid.ny
    itemsize = lev.dtype.itemsize
    if stage == "smooth":
        return 10.0 * n * sweeps, 3.0 * n * itemsize * sweeps
    if stage == "residual":
        return 11.0 * n, 3.0 * n * itemsize
    if stage == "restrict":
        return 17.0 * n / 4, (n + n / 4) * itemsize
    if stage == "prolong":
        return 3.0 * n, (n + n / 4) * itemsize
    return 0.0, 0.0


class MultigridProfiler:
    """Profile each multigrid stage per level on real tensors."""

    def __init__(self, levels: Tuple[Level, ...],
                 cfg: MultigridConfig = MultigridConfig()):
        self.levels = levels
        self.cfg = cfg
        self.records: Dict[str, Dict[str, Any]] = {}

    def profile_level(self, lvl: int, *, runs: int = 10) -> Dict[str, Any]:
        lev = self.levels[lvl]
        g = lev.grid
        u = lev.zeros()
        f = torch.ones_like(u)
        cfg = self.cfg

        def smooth_fn(u, f):
            return dispatch.smooth(lev.stencil, u, f, lev,
                                   method=cfg.smoother, sweeps=cfg.pre_sweeps,
                                   omega=cfg.omega, backend=cfg.backend)

        def resid_fn(u, f):
            return st_mod.residual(lev.stencil, u, f, lev.unknown)

        stages: Dict[str, Any] = {
            "smooth": (smooth_fn, (u, f), cfg.pre_sweeps),
            "residual": (resid_fn, (u, f), 1),
        }
        if lvl + 1 < len(self.levels):
            nxt = self.levels[lvl + 1]

            def restrict_fn(r):
                return transfer.restrict(r, nxt.grid.nx, nxt.grid.ny,
                                         method=cfg.restriction,
                                         dtype=nxt.dtype)

            def prolong_fn(ec):
                return transfer.prolong(ec, g.nx, g.ny,
                                        method=cfg.prolongation,
                                        dtype=lev.dtype)

            stages["restrict"] = (restrict_fn, (f,), 1)
            stages["prolong"] = (prolong_fn, (nxt.zeros(),), 1)

        rec: Dict[str, Any] = {"n": g.nx,
                               "dtype": str(lev.dtype).removeprefix("torch.")}
        for name, (fn, args, sweeps) in stages.items():
            stats = benchmark_function(fn, *args, warmup=2, runs=runs)
            flops, bytes_ = _stage_flops_bytes(lev, name, sweeps)
            t = stats["min_s"]
            rec[name] = {
                **stats,
                "gflops": flops / t / 1e9,
                "gbytes_per_s": bytes_ / t / 1e9,
            }
        self.records[f"level_{lvl}"] = rec
        return rec

    def profile_all(self, *, runs: int = 10) -> Dict[str, Any]:
        for lvl in range(len(self.levels)):
            self.profile_level(lvl, runs=runs)
        return self.records

    def bottlenecks(self) -> Dict[str, Any]:
        """Which (level, stage) dominates one cycle's time budget."""
        total = 0.0
        worst = ("", 0.0)
        for key, rec in self.records.items():
            for stage in ("smooth", "residual", "restrict", "prolong"):
                if stage not in rec:
                    continue
                t = rec[stage]["min_s"]
                weight = 2.0 if stage == "smooth" else 1.0  # pre+post
                total += weight * t
                if weight * t > worst[1]:
                    worst = (f"{key}/{stage}", weight * t)
        return {
            "cycle_estimate_s": total,
            "dominant": worst[0],
            "dominant_fraction": worst[1] / max(total, 1e-12),
        }

    def export(self, path) -> None:
        Path(path).write_text(json.dumps(
            {"records": self.records, "bottlenecks": self.bottlenecks()},
            indent=2))
