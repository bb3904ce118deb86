"""Mixed-precision trade-offs (accuracy, speed, memory) and the measured
per-problem precision choice.

Counterpart of ``_hierarchy_bytes``, ``PrecisionRecord``,
``MixedPrecisionAnalyzer``, ``_AUTOTUNE_CACHE`` and ``autotune`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/applications/precision_analysis.py``.
Every number is measured on ``device`` (the card when None); fields are
stored at their logical shape, so the byte counts use it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..core.precision import Precision, PrecisionPolicy, as_dtype
from ..models.problems import Problem
from ..solvers.multigrid import MultigridConfig
from ..utils.timing import benchmark_function
from .poisson import solve_poisson


def _hierarchy_bytes(problem: Problem, dtypes: Sequence) -> int:
    """Bytes of (u, f, r) on each level of the hierarchy at ``dtypes``."""
    total = 0
    g = problem.grid
    for dt in dtypes:
        total += 3 * g.nx * g.ny * as_dtype(dt).itemsize
        if not g.can_coarsen():
            break
        g = g.coarsen()
    return total


@dataclasses.dataclass
class PrecisionRecord:
    precision: str
    wall_s: float
    iterations: int
    converged: bool
    error_l2: Optional[float]
    hierarchy_bytes: int

    def to_dict(self):
        return dataclasses.asdict(self)


class MixedPrecisionAnalyzer:
    """Run one problem at several precisions and tabulate the trade-offs."""

    CONFIGS = ("fp64", "fp32", "mixed", "adaptive")

    def __init__(self, cfg: MultigridConfig = MultigridConfig(
            smoother="rbgs", omega=1.0, tol=1e-8), device=None):
        self.cfg = cfg
        self.device = device
        self.records: List[PrecisionRecord] = []

    def analyze(self, problem: Problem, *, runs: int = 3,
                configs: Sequence[str] = CONFIGS) -> List[PrecisionRecord]:
        """Solve ``problem`` at each of ``configs`` once, then time
        ``runs`` more solves of each (minimum wall time)."""
        for precision in configs:
            res = solve_poisson(problem, precision=precision, cfg=self.cfg,
                                device=self.device)
            stats = benchmark_function(
                lambda p=precision: solve_poisson(problem, precision=p,
                                                  cfg=self.cfg,
                                                  device=self.device),
                warmup=0, runs=runs)
            if precision == "mixed":
                # 10 levels bound the bytes: the fine levels dominate them
                dtypes = PrecisionPolicy(mode=Precision.MIXED).level_dtypes(
                    10)
            elif precision == "adaptive":
                dtypes = (torch.float32,) * 10
            else:
                dtypes = (as_dtype(precision),) * 10
            self.records.append(PrecisionRecord(
                precision=precision,
                wall_s=stats["min_s"],
                iterations=res.iterations,
                converged=res.converged,
                error_l2=res.errors["l2"] if res.errors else None,
                hierarchy_bytes=_hierarchy_bytes(problem, dtypes),
            ))
        return self.records

    def tradeoffs(self) -> Dict[str, Any]:
        """Speed-up, memory saving and iteration and error ratios of each
        precision against the fp64 run."""
        by = {r.precision: r for r in self.records}
        if "fp64" not in by:
            raise ValueError("analyze() must include the fp64 reference run")
        ref = by["fp64"]
        out: Dict[str, Any] = {}
        for p, r in by.items():
            if p == "fp64":
                continue
            entry = {
                "speedup_vs_fp64": ref.wall_s / r.wall_s,
                "memory_saving": 1.0 - r.hierarchy_bytes / ref.hierarchy_bytes,
                "iterations_ratio": r.iterations / max(ref.iterations, 1),
            }
            if r.error_l2 is not None and ref.error_l2:
                entry["error_ratio_vs_fp64"] = r.error_l2 / ref.error_l2
            out[p] = entry
        return out

    def report(self) -> Dict[str, Any]:
        return {
            "records": [r.to_dict() for r in self.records],
            "tradeoffs": self.tradeoffs(),
        }


_AUTOTUNE_CACHE: Dict[Any, str] = {}


def autotune(problem: Problem, *,
             cfg: MultigridConfig = MultigridConfig(smoother="rbgs",
                                                    omega=1.0, tol=1e-8),
             candidates: Sequence[str] = ("fp32", "mixed", "adaptive"),
             runs: int = 3, accuracy_factor: float = 10.0,
             use_cache: bool = True, device=None) -> str:
    """The fastest of ``candidates`` that holds accuracy on ``problem``.

    Each candidate is solved once, then timed over ``runs`` more solves.
    A candidate is admissible when it converged and, where the problem has
    an exact solution, its l2 error is within ``accuracy_factor`` of the
    best candidate's; the admissible one of least (minimum) wall time wins.
    Results are cached per (problem name, shape, candidates, cfg); pass
    ``use_cache=False`` to measure again."""
    key = (problem.name, problem.grid.nx, problem.grid.ny,
           tuple(candidates), cfg)
    if use_cache and key in _AUTOTUNE_CACHE:
        return _AUTOTUNE_CACHE[key]

    rows = []
    for precision in candidates:
        res = solve_poisson(problem, precision=precision, cfg=cfg,
                            device=device)
        stats = benchmark_function(
            lambda p=precision: solve_poisson(problem, precision=p, cfg=cfg,
                                              device=device),
            warmup=0, runs=runs)
        rows.append({
            "precision": precision,
            "wall_s": stats["min_s"],
            "converged": res.converged,
            "error_l2": res.errors["l2"] if res.errors else None,
        })

    errs = [r["error_l2"] for r in rows
            if r["converged"] and r["error_l2"] is not None]
    best_err = min(errs) if errs else None
    admissible = [
        r for r in rows
        if r["converged"] and (
            best_err is None or r["error_l2"] is None
            or r["error_l2"] <= accuracy_factor * max(best_err, 1e-300))
    ]
    pool = admissible or [r for r in rows if r["converged"]] or rows
    winner = min(pool, key=lambda r: r["wall_s"])["precision"]
    _AUTOTUNE_CACHE[key] = winner
    return winner
