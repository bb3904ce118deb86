"""Performance plots: throughput, scaling, precision trade-offs.

Counterpart of ``PerformancePlotter`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/visualization/
performance_plots.py``. Inputs are ``benchmarking.suite`` /
``validation.baselines`` reports.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ._backend import finish, get_plt


class PerformancePlotter:
    def plot_throughput(self, records: List[Dict[str, Any]], *,
                        title: str = "solver throughput",
                        save=None, show=False):
        """DoF/s vs grid size per precision (BenchmarkSuite records)."""
        plt = get_plt()
        fig, ax = plt.subplots(figsize=(6.5, 4.5))
        by_p: Dict[str, List] = {}
        for r in records:
            by_p.setdefault(r["precision"], []).append(r)
        for p, rows in sorted(by_p.items()):
            rows = sorted(rows, key=lambda r: r["n"])
            ax.loglog([r["n"] for r in rows],
                      [r["dof_per_s"] for r in rows], "o-", label=p)
        ax.set_xlabel("grid size n"); ax.set_ylabel("DoF/s")
        ax.set_title(title); ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        return finish(fig, save, show)

    def plot_solve_times(self, records: List[Dict[str, Any]], *,
                         title: str = "solve time scaling",
                         save=None, show=False):
        """Wall time vs unknowns with an O(N) guide (multigrid ideal)."""
        plt = get_plt()
        fig, ax = plt.subplots(figsize=(6.5, 4.5))
        by_p: Dict[str, List] = {}
        for r in records:
            by_p.setdefault(r["precision"], []).append(r)
        for p, rows in sorted(by_p.items()):
            rows = sorted(rows, key=lambda r: r["n"])
            N = np.array([(r["n"] - 2) ** 2 for r in rows], float)
            t = np.array([r["wall_s"] for r in rows], float)
            ax.loglog(N, t, "o-", label=p)
        if rows:
            ax.loglog(N, t[0] * N / N[0], "--", c="gray", label="O(N) guide")
        ax.set_xlabel("unknowns N"); ax.set_ylabel("wall time (s)")
        ax.set_title(title); ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        return finish(fig, save, show)

    def plot_precision_speedup(self, speedups: Dict[int, Dict[str, float]], *,
                               title: str = "speedup vs fp64",
                               save=None, show=False):
        """Mixed/fp32/bf16 speedups over fp64 per grid size."""
        plt = get_plt()
        fig, ax = plt.subplots(figsize=(6.5, 4))
        sizes = sorted(speedups)
        precisions = sorted({p for d in speedups.values() for p in d})
        width = 0.8 / max(len(precisions), 1)
        for k, p in enumerate(precisions):
            vals = [speedups[n].get(p, np.nan) for n in sizes]
            ax.bar(np.arange(len(sizes)) + k * width, vals, width, label=p)
        ax.axhline(1.0, ls="--", c="gray")
        ax.set_xticks(np.arange(len(sizes)) + 0.4 - width / 2)
        ax.set_xticklabels([str(n) for n in sizes])
        ax.set_xlabel("grid size n"); ax.set_ylabel("speedup vs fp64")
        ax.set_title(title); ax.legend()
        return finish(fig, save, show)

    def plot_scaling_efficiency(self, n_devices: Sequence[int],
                                efficiency: Sequence[float], *,
                                kind: str = "weak",
                                target: Optional[float] = 0.8,
                                save=None, show=False):
        """Weak/strong scaling efficiency vs device count."""
        plt = get_plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(n_devices, np.asarray(efficiency) * 100, "o-")
        if target is not None:
            ax.axhline(target * 100, ls="--", c="r",
                       label=f"target {target:.0%}")
            ax.legend()
        ax.set_xscale("log", base=2)
        ax.set_xlabel("devices"); ax.set_ylabel("efficiency (%)")
        ax.set_ylim(0, 105)
        ax.set_title(f"{kind} scaling efficiency")
        ax.grid(True, alpha=0.3)
        return finish(fig, save, show)

    def plot_baseline_comparison(self, rows: List[Dict[str, Any]], *,
                                 title: str = "solver comparison",
                                 save=None, show=False):
        """Grouped wall-time bars: ours vs scipy/pyamg per grid size
        (validation.baselines report rows)."""
        plt = get_plt()
        rows = [r for r in rows if r.get("available", True)
                and np.isfinite(r["wall_s"])]
        sizes = sorted({r["n"] for r in rows})
        solvers = sorted({r["solver"] for r in rows})
        fig, ax = plt.subplots(figsize=(7, 4.5))
        width = 0.8 / max(len(solvers), 1)
        for k, s in enumerate(solvers):
            vals = []
            for n in sizes:
                match = [r["wall_s"] for r in rows
                         if r["solver"] == s and r["n"] == n]
                vals.append(match[0] if match else np.nan)
            ax.bar(np.arange(len(sizes)) + k * width, vals, width, label=s)
        ax.set_yscale("log")
        ax.set_xticks(np.arange(len(sizes)) + 0.4 - width / 2)
        ax.set_xticklabels([str(n) for n in sizes])
        ax.set_xlabel("grid size n"); ax.set_ylabel("wall time (s)")
        ax.set_title(title); ax.legend(fontsize=8)
        return finish(fig, save, show)
