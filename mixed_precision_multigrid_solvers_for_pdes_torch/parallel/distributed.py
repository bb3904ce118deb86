"""Sharded multigrid solves over a mesh of ranks: the GSPMD path.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/parallel/
distributed.py`` (``_sharding_fn``, ``make_constrainer``, ``shard_inputs``
and ``sharded_solve``). There the whole solve is one jitted SPMD
computation: each level's arrays carry a sharding constraint, block-split
('x', 'y') while every device keeps at least ``min_points_per_device``
logical rows and columns and replicated below (agglomeration), and XLA
inserts the halo collectives.

PyTorch has no sharding constraint for a hook to set, so the port's hook is
an explicit SPMD program run by every rank of a ``torch.distributed``
process group:

- every rank of the mesh calls the same entry point with the same global
  (nx, ny) inputs, or with level-0 blocks from ``shard_inputs``
  (``multihost.ShardedField``);
- each level is block-split or replicated by the JAX package's per-level
  rule (``mesh.grid_sharding``, or ``mesh.graded_sharding`` on a
  ``make_graded_mesh`` mesh, whose mid tier is split over the outer
  factors and replicated over the inner ones); every rank holds only its
  blocks of the split levels, in the 2:1-aligned layouts of
  ``make_tilings``, and runs the cycle on them (``blocks.BlockCycle``:
  halos exchanged between neighbours, line smoothers on gathered slabs of
  whole lines, agglomeration gathers);
- every rank returns the global result, gathered as ``halo_solve``
  returns it.

As under the JAX hook, the cycles take no tail kernel and no fused
transfer (``solvers.multigrid._cycle`` with an array hook), and smoothing
goes where ``cfg.backend`` sends it: with 'auto', kernel A (H on
coefficient planes) smooths the replicated levels whole and each split
level's blocks on haloed windows. A mesh of one rank, or a grid too small
for the rule to split, splits nothing: every rank then runs the
single-device solve under that hook (``solvers.multigrid.whole``).
``make_constrainer3d`` (3D) is not ported yet (ROADMAP item 14b).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..solvers import multigrid as mg_mod
from ..solvers.multigrid import MultigridConfig
from . import blocks as bk, mesh as mesh_mod
from .multihost import ShardedField


def _sharding_fn(mesh):
    """The per-level sharding rule of the mesh's axis names: graded
    three-tier for ``make_graded_mesh`` meshes, two-tier otherwise."""
    if set(mesh.axis_names) == set(mesh_mod.GRADED_AXES):
        return mesh_mod.graded_sharding
    return mesh_mod.grid_sharding


def _split_names(mesh, entry) -> bk.Names:
    """A sharding spec entry as the mesh axes that really split (size > 1),
    major first."""
    return tuple(a for a in bk.axis_names(entry) if mesh.shape[a] > 1)


def _extent(n0: int, wrap: bool, counts) -> int:
    """Level 0's layout extent along one axis split into ``counts[l]``
    blocks on each sharded level l: every block even and each layout
    exactly twice the next, every level's logical nodes plus one inside
    (the coarse halves gathered below the last sharded level hold the
    first replicated level); a periodic axis stores its unique nodes,
    which must tile."""
    q = 1
    for lvl, k in enumerate(counts):
        q = math.lcm(q, (2 << lvl) * k)
    if wrap:
        if (n0 - 1) % q:
            raise NotImplementedError(
                f"sharded solve: a periodic axis of {n0 - 1} unique nodes "
                f"does not tile {len(counts)} sharded levels split into "
                f"{list(counts)} blocks")
        return n0 - 1
    return -(-(n0 - 1 + (1 << len(counts))) // q) * q


def make_tilings(mesh, levels, min_points_per_device: int = 16
                 ) -> Tuple[bk.Tiling, ...]:
    """The layouts of the levels the rule splits (finest first; the
    coarser ones are replicated). Raises ``NotImplementedError`` where the
    rule splits a level along an axis in a way its finer level does not
    (the blocks need every coarser split to be a prefix of the finer
    one)."""
    rule = _sharding_fn(mesh)
    splits = []
    for lev in levels:
        spec = tuple(rule(mesh, lev.grid, min_points_per_device).spec)
        spec = spec + (None,) * (2 - len(spec))
        splits.append(tuple(_split_names(mesh, e) for e in spec[:2]))
    S = 0
    while S < len(splits) and splits[S] != ((), ()):
        S += 1
    for lvl in range(1, len(splits)):
        for axis in (0, 1):
            fine, coarse = splits[lvl - 1][axis], splits[lvl][axis]
            if coarse != fine[:len(coarse)]:
                raise NotImplementedError(
                    f"sharded solve: level {lvl} is split along axis {axis} "
                    f"by {coarse} below a level split by {fine}")
    if S == 0:
        return ()
    lev0 = levels[0]
    extents = [_extent(n, w, [bk.axis_count(mesh, s[axis])
                              for s in splits[:S]])
               for axis, (n, w) in enumerate(zip(lev0.grid.shape,
                                                 lev0.spec.wrap))]
    return tuple(bk.Tiling(splits[lvl], (extents[0] >> lvl,
                                         extents[1] >> lvl))
                 for lvl in range(S))


def _level0_sharding(mesh, tilings) -> mesh_mod.BlockSharding:
    """The ``BlockSharding`` of level 0's blocks."""
    if not tilings:
        return mesh_mod.BlockSharding(mesh, (None, None))
    return mesh_mod.BlockSharding(mesh, tuple(
        (names[0] if len(names) == 1 else names) if names else None
        for names in tilings[0].names))


def _field_block(mesh, tilings, lev0, sharding, x):
    """This rank's level-0 block of ``x``: a global (nx, ny) tensor's, or a
    ``ShardedField``'s own when it has the hierarchy's layout."""
    if not isinstance(x, ShardedField):
        x = x.to(lev0.device)
        return bk.cut_block(mesh, tilings[0], lev0.grid, x) if tilings else x
    want = (tuple(s.stop - s.start for s in bk.tiling_slices(
        mesh, tilings[0])) if tilings else lev0.grid.shape)
    if tuple(x.sharding.spec) != tuple(sharding.spec) or \
            tuple(x.block.shape) != tuple(want):
        raise ValueError(
            f"a sharded field of spec {x.sharding.spec} and block "
            f"{tuple(x.block.shape)} is not in this hierarchy's layout "
            f"(spec {sharding.spec}, block {tuple(want)}): make it with "
            "shard_inputs")
    return x.block


class Constrainer(mg_mod.BlockHook):
    """The port's ``make_constrainer`` hook: the solvers' ``constrain=``
    argument. It holds the mesh and the per-level rule, and for each
    hierarchy it meets (by identity) the ``blocks.BlockCycle`` of its
    layouts; the solvers hand their work to it (``mg_cycle``, ``fmg``,
    ``mg_solve``, ``ir_solve``), which runs on this rank's blocks. Fields
    pass as global (nx, ny) tensors, gathered back, or as ``ShardedField``
    level-0 blocks, returned as blocks."""

    def __init__(self, mesh, min_points_per_device: int = 16):
        self.mesh = mesh
        self.min_points_per_device = min_points_per_device
        self._cycles: Dict[int, Tuple[Any, bk.BlockCycle, Any]] = {}

    def blocks(self, levels) -> bk.BlockCycle:
        """The block cycle of ``levels`` (built once per hierarchy)."""
        return self._entry(levels)[1]

    def _entry(self, levels):
        hit = self._cycles.get(id(levels))
        if hit is None or hit[0] is not levels:
            tilings = make_tilings(self.mesh, levels,
                                   self.min_points_per_device)
            hit = (levels, bk.BlockCycle(self.mesh, levels, tilings),
                   _level0_sharding(self.mesh, tilings))
            self._cycles[id(levels)] = hit
        return hit

    def _in(self, levels, x):
        _, cycle, sharding = self._entry(levels)
        return _field_block(self.mesh, cycle.tilings, levels[0], sharding,
                            x)

    def _out(self, levels, block, like):
        _, cycle, sharding = self._entry(levels)
        if isinstance(like, ShardedField):
            return ShardedField(block, sharding, levels[0].grid,
                                cycle.blocks[0] if cycle.S else None)
        return cycle.gather(block)

    # -- the hooks the solvers call -------------------------------------------

    def mg_cycle(self, levels, u, f, cfg: MultigridConfig):
        out = self.blocks(levels).cycle(0, self._in(levels, u),
                                        self._in(levels, f), cfg, cfg.cycle)
        return self._out(levels, out, u)

    def fmg(self, levels, f, cfg: MultigridConfig, cycles_per_level: int):
        out = self.blocks(levels).fmg(self._in(levels, f), cfg,
                                      cycles_per_level)
        return self._out(levels, out, f)

    def mg_solve(self, levels, f, u0, cfg: MultigridConfig, *,
                 use_fmg: bool = False):
        return self.blocks(levels).solve(
            self._in(levels, f), None if u0 is None else self._in(levels, u0),
            cfg, use_fmg=use_fmg)

    def ir_solve(self, levels, f, u0, cfg: MultigridConfig, *,
                 inner_cycles: int, max_outer: int, use_fmg: bool):
        return self.blocks(levels).ir_solve(
            self._in(levels, f), None if u0 is None else self._in(levels, u0),
            cfg, inner_cycles=inner_cycles, max_outer=max_outer,
            use_fmg=use_fmg)


def make_constrainer(mesh, min_points_per_device: int = 16) -> Constrainer:
    """The per-level sharding hook for ``mg_cycle``, ``fmg``, ``mg_solve``,
    ``ir_solve`` and ``multigrid_preconditioner`` (``constrain=``)."""
    return Constrainer(mesh, min_points_per_device)


def shard_inputs(mesh, levels, *arrays, min_points_per_device: int = 16):
    """Each global (nx, ny) array as this rank's level-0 block
    (``ShardedField``) in the hierarchy's layout, with the level-0
    ``blocks.Block`` its operator runs on."""
    tilings = make_tilings(mesh, levels, min_points_per_device)
    sharding = _level0_sharding(mesh, tilings)
    lev0 = levels[0]
    blk = bk.make_block(mesh, lev0, tilings[0]) if tilings else None
    out = tuple(ShardedField(_field_block(mesh, tilings, lev0, sharding, a),
                             sharding, lev0.grid, blk)
                for a in arrays)
    return out if len(out) > 1 else out[0]


def sharded_solve(mesh, levels, f, u0=None,
                  cfg: MultigridConfig = MultigridConfig(), *,
                  min_points_per_device: int = 16, **kw
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``mg_solve`` with inputs sharded over ``mesh`` and the per-level
    hook; ``kw`` (``use_fmg``) goes to ``mg_solve``. Every rank of the
    mesh calls it and gets the global solution."""
    constrain = make_constrainer(mesh, min_points_per_device)
    f = shard_inputs(mesh, levels, f,
                     min_points_per_device=min_points_per_device)
    if u0 is not None:
        u0 = shard_inputs(mesh, levels, u0,
                          min_points_per_device=min_points_per_device)
    return mg_mod.mg_solve(levels, f, u0, cfg, constrain=constrain, **kw)
