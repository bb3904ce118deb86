"""The work of a solve's stages, counted from shapes: the yardstick of the
roofline metrics.

Compulsory bytes of each multigrid stage, whatever kernels carry it:

- smoothing call: reads u and f once and writes u once (3 fields of the
  level), whatever the number of sweeps;
- residual-restriction from level l: reads u and f of level l and writes
  the coarse right-hand side of level l + 1;
- prolongation-correction into level l: reads the coarse correction of
  level l + 1, reads and writes u of level l.

A cycle started on level s smooths twice (before and after the coarse
correction) on every level from s down to the last level above the tail,
restricts and prolongs between each of those levels and the next, and
either hands the level below to the tail (2D: one tail call covers the
whole V-recursion from the tail's entry down, and is counted apart) or
solves the coarsest level with one smoothing call (3D). The cycles of a
solve: one started on each level by a full-multigrid start (``fmg``), and
``cycles_per_iteration`` started on level 0 for each outer iteration. The
full-multigrid start's own restriction of f and prolongation of each
level's start are plain-torch passes and are not counted here.
"""

from __future__ import annotations

from typing import Dict, List


def level_sizes(n: int) -> List[int]:
    """Nodes per axis of every level, finest first: 2:1 coarsening while
    the coarse level keeps an interior node."""
    sizes = [n]
    while (sizes[-1] - 1) % 2 == 0 and (sizes[-1] - 1) // 2 + 1 >= 3:
        sizes.append((sizes[-1] - 1) // 2 + 1)
    return sizes


def storage_bytes(dtype: str) -> int:
    return {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]


def upper_levels(conf: Dict) -> int:
    """Levels above the coarse tail (2D), or every level but the coarsest
    (3D, which has no tail)."""
    sizes = level_sizes(conf["n"])
    entry = conf.get("tail_entry")
    if entry is None:
        return len(sizes) - 1
    return sum(1 for m in sizes if m > entry)


def cycle_bytes(conf: Dict, start: int) -> Dict[str, int]:
    """Compulsory bytes by stage of one cycle started on level ``start``."""
    sizes = level_sizes(conf["n"])
    dims, b = conf["dims"], storage_bytes(conf["level_dtype"])
    nodes = [m ** dims for m in sizes]
    upper = upper_levels(conf)
    out = {"smooth": 0, "transfer": 0}
    if start >= upper:
        if conf.get("tail_entry") is None:  # 3D: the coarsest solve alone
            out["smooth"] += 3 * nodes[-1] * b
        return out
    for lvl in range(start, upper):
        out["smooth"] += 2 * 3 * nodes[lvl] * b
        out["transfer"] += (2 * nodes[lvl] + nodes[lvl + 1]) * b  # restrict
        out["transfer"] += (nodes[lvl + 1] + 2 * nodes[lvl]) * b  # prolong
    if conf.get("tail_entry") is None:
        out["smooth"] += 3 * nodes[-1] * b
    return out


def cycle_starts(conf: Dict, mix: Dict, iterations: float) -> List[float]:
    """Cycles started on each level in one solve of ``iterations`` outer
    iterations (a mean may be fractional)."""
    plan = mix["plan"]
    starts = [0.0] * len(level_sizes(conf["n"]))
    if plan["fmg"]:
        starts = [s + 1.0 for s in starts]
    starts[0] += iterations * plan["cycles_per_iteration"]
    return starts


def solve_bytes(conf: Dict, mix: Dict, iterations: float) -> Dict[str, float]:
    """Compulsory bytes by stage of one solve."""
    out = {"smooth": 0.0, "transfer": 0.0}
    for lvl, n_starts in enumerate(cycle_starts(conf, mix, iterations)):
        if n_starts:
            for stage, nbytes in cycle_bytes(conf, lvl).items():
                out[stage] += n_starts * nbytes
    return out
