"""Benchmark suite: sizes x backends x precisions, measured solves.

Counterpart of ``BenchmarkRecord``, ``system_info`` and ``BenchmarkSuite``
in ``mixed_precision_multigrid_solvers_for_pdes_tpu/benchmarking/suite.py``.
Reports hold DoF/s, iteration counts, convergence factors, precision and
backend speedups and scaling exponents. Every solve runs on ``device`` (the
card when None) and is timed to the end of its device work, the first call
(the kernels' build at first use included) excluded. The backends are this
package's: 'auto' (the CUDA kernels where they apply) and 'torch' (the
plain path, the JAX package's 'xla').
"""

from __future__ import annotations

import dataclasses
import json
import platform
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import policy as make_policy
from ..models.problems import Problem
from ..solvers import multigrid as mg_mod, refinement
from ..solvers.multigrid import MultigridConfig
from ..utils.timing import benchmark_function


@dataclasses.dataclass
class BenchmarkRecord:
    name: str
    n: int
    precision: str
    backend: str
    wall_s: float
    std_s: float
    iterations: int
    converged: bool
    convergence_factor: float
    # what the factor measures: 'cycle' = per V/W/F cycle; 'ir_outer' = per
    # iterative-refinement outer step (inner_cycles cycles each)
    rho_kind: str
    dof_per_s: float
    error_l2: Optional[float]

    def to_dict(self):
        return dataclasses.asdict(self)


def _power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them, or None
    where nvidia-smi is absent or fails."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else None


def system_info() -> Dict[str, Any]:
    """The environment: platform, Python, torch and its CUDA, and the card
    (its name, the number of cards, and on a card the power limit, which
    bounds its speed) or the CPU."""
    cuda = torch.cuda.is_available()
    return {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device": (torch.cuda.get_device_name(0) if cuda
                   else platform.processor() or "cpu"),
        "n_devices": torch.cuda.device_count(),
        "power_limit": _power_limit() if cuda else None,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }


class BenchmarkSuite:
    def __init__(
        self,
        problem_factory: Callable[[int], Problem],
        cfg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0,
                                               tol=1e-8),
        *,
        device=None,
    ):
        self.problem_factory = problem_factory
        self.cfg = cfg
        self.device = device
        self.records: List[BenchmarkRecord] = []

    def run_one(self, n: int, precision: str, *, runs: int = 5,
                warmup: int = 1, backend: Optional[str] = None
                ) -> BenchmarkRecord:
        """Time the solve only: the hierarchy, right-hand side and start are
        built once outside the timed region, and the error norms are
        computed after timing."""
        dev = resolve_device(self.device)
        prob = self.problem_factory(n)
        cfg = self.cfg if backend is None else self.cfg.replace(backend=backend)
        f64 = torch.float64
        if precision == "mixed":
            pol = make_policy("mixed")
            levels = mg_mod.build_hierarchy(
                prob.grid, prob.spec, a=prob.a, lam=prob.lam,
                domain=prob.domain, policy=pol, device=dev, cfg=cfg)
            f = prob.rhs(f64, dev)
            u0 = prob.initial_guess(f64, dev)

            def solve():
                return refinement.ir_solve(levels, f, u0, cfg, inner_cycles=2)

            rho_kind = "ir_outer"
        else:
            dt = make_policy(precision).mode.dtype
            levels = mg_mod.build_hierarchy(
                prob.grid, prob.spec, a=prob.a, lam=prob.lam,
                domain=prob.domain, dtype=dt, device=dev, cfg=cfg)
            if dt == torch.float32 and cfg.tol < 1e-6:
                f = prob.rhs(f64, dev)
                u0 = prob.initial_guess(f64, dev)

                def solve():
                    return refinement.ir_solve(levels, f, u0, cfg,
                                               inner_cycles=2)

                rho_kind = "ir_outer"
            else:
                f = prob.rhs(dt, dev)
                u0 = prob.initial_guess(dt, dev)

                def solve():
                    return mg_mod.mg_solve(levels, f, u0, cfg)

                rho_kind = "cycle"

        u, info = solve()  # the kernels' build at first use + correctness
        stats = benchmark_function(solve, warmup=max(warmup - 1, 0), runs=runs)
        dofs = (n - 2) ** 2
        errors = prob.error_norms(u) if prob.exact is not None else None
        rec = BenchmarkRecord(
            name=prob.name, n=n, precision=precision, backend=cfg.backend,
            wall_s=stats["min_s"], std_s=stats["std_s"],
            iterations=info["iterations"], converged=info["converged"],
            convergence_factor=info.get("convergence_factor", float("nan")),
            rho_kind=rho_kind,
            dof_per_s=dofs / stats["min_s"],
            error_l2=errors["l2"] if errors else None,
        )
        self.records.append(rec)
        return rec

    def run(self, sizes: Sequence[int] = (129, 257, 513, 1025),
            precisions: Sequence[str] = ("fp32", "fp64", "mixed"),
            *, runs: int = 5,
            backends: Sequence[Optional[str]] = (None,)
            ) -> List[BenchmarkRecord]:
        """``backends``: list of cfg.backend overrides per (size, precision)
        cell; ("auto", "torch") gives the solve-level A/B of the kernels
        against the plain path."""
        for n in sizes:
            for p in precisions:
                for b in backends:
                    self.run_one(n, p, runs=runs, backend=b)
        return self.records

    # ---- analyses -----------------------------------------------------------

    def precision_speedups(self) -> Dict[int, Dict[str, float]]:
        """Speedup of each precision vs fp64 at the same size.
        Uses each size's fastest backend per precision."""
        out: Dict[int, Dict[str, float]] = {}
        by_n: Dict[int, Dict[str, float]] = {}
        for r in self.records:
            d = by_n.setdefault(r.n, {})
            d[r.precision] = min(d.get(r.precision, np.inf), r.wall_s)
        for n, d in by_n.items():
            if "fp64" in d:
                out[n] = {p: d["fp64"] / t for p, t in d.items() if p != "fp64"}
        return out

    def backend_speedups(self) -> Dict[str, float]:
        """The kernel layer's end-to-end win: t_torch / t_fastest other
        backend per (size, precision) where both were run."""
        by_cell: Dict[tuple, Dict[str, float]] = {}
        for r in self.records:
            by_cell.setdefault((r.n, r.precision), {})[r.backend] = r.wall_s
        out: Dict[str, float] = {}
        for (n, p), d in sorted(by_cell.items()):
            fast = [v for k, v in d.items() if k != "torch"]
            if "torch" in d and fast:
                out[f"{n}/{p}"] = d["torch"] / min(fast)
        return out

    def scaling_exponent(self, precision: str = "fp32") -> float:
        """Fit wall_s ~ N^p — ideal multigrid is p=1 (O(N))."""
        rows = [r for r in self.records if r.precision == precision]
        if len(rows) < 2:
            return float("nan")
        N = np.array([(r.n - 2) ** 2 for r in rows], float)
        t = np.array([r.wall_s for r in rows], float)
        return float(np.polyfit(np.log(N), np.log(t), 1)[0])

    def report(self) -> Dict[str, Any]:
        return {
            "system": system_info(),
            "config": dataclasses.asdict(self.cfg),
            "records": [r.to_dict() for r in self.records],
            "precision_speedups": self.precision_speedups(),
            "backend_speedups": self.backend_speedups(),
            "scaling_exponents": {
                p: self.scaling_exponent(p)
                for p in {r.precision for r in self.records}
            },
        }

    def report_markdown(self) -> str:
        lines = [
            "# Benchmark report (measured; no simulated data)",
            "",
            f"system: `{system_info()}`",
            "",
            "| problem | n | precision | backend | time (s) | iters | rho (kind) | MDoF/s | l2 error |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for r in self.records:
            err = f"{r.error_l2:.2e}" if r.error_l2 is not None else "-"
            lines.append(
                f"| {r.name} | {r.n} | {r.precision} | {r.backend} | "
                f"{r.wall_s:.4f} | "
                f"{r.iterations} | {r.convergence_factor:.3f} ({r.rho_kind}) | "
                f"{r.dof_per_s / 1e6:.2f} | {err} |"
            )
        lines += [
            "",
            "rho kinds: `cycle` = contraction per multigrid cycle; "
            "`ir_outer` = contraction per iterative-refinement outer step "
            "(2 inner cycles each) — not comparable to per-cycle factors.",
        ]
        return "\n".join(lines)

    def save(self, path) -> None:
        path = Path(path)
        if path.suffix == ".md":
            path.write_text(self.report_markdown())
        else:
            path.write_text(json.dumps(self.report(), indent=2))
