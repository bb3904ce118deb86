"""Level 0 of a time loop's hierarchy as its steps see it: the whole field
on one device, or this rank's blocks under a sharding hook.

The heat steppers (``applications/heat.py``, ``applications/heat3d.py``)
run one program on either: ``fields_for(constrain, levels0)`` gives a
``WholeFields`` (no hook, or an array hook such as ``multigrid.whole``)
or a ``BlockFields`` (the hook of ``distributed.make_constrainer`` or
``make_constrainer3d``). With blocks, as in the JAX package's SPMD scan,
the whole time loop runs on this rank's blocks:

- the state is a level-0 ``multihost.ShardedField`` in the hierarchy's
  layout; the steps take and return such fields (a global tensor is cut);
- source and boundary terms are evaluated on the block's own coordinates
  (``coords``) or cut from their global values, the masks are the
  block's;
- ``A_sp u`` is a halo matvec, and the cycles run on the hook's block
  cycle of each (shifted) hierarchy;
- the step's readbacks (a residual norm, the adaptive error) are scalar
  ``all_reduce``s, so every rank takes the same branch.

No step gathers the global field: ``gather`` (counted by
``blocks.BlockCycle.gathers``) is for the run's end, its checkpoints and
its snapshots.
"""

from __future__ import annotations

import torch

from ..ops import norms, stencil as st_mod, stencil3d as st3
from ..solvers import multigrid as mg_mod, multigrid3d as mg3
from . import blocks as bk, blocks3d as bk3, distributed
from .multihost import ShardedField


def _spacings(grid):
    return tuple(getattr(grid, a) for a in ("hx", "hy", "hz")[
        :len(grid.shape)])


class WholeFields:
    """The single-device field: every operation as the unsharded stepper
    computes it (``constrain``, an array hook or None, goes to the
    cycles)."""

    def __init__(self, levels0, constrain=None):
        lev0 = levels0[0]
        self.lev0 = lev0
        self.three_d = len(lev0.grid.shape) == 3
        self.constrain = constrain
        self.unknown = lev0.unknown
        self.fixed = ~self.unknown
        self.h = _spacings(lev0.grid)
        self.writer = True

    def coords(self, *c):
        return c

    def cut(self, x):
        return x

    def field(self, x):
        return x

    def gather(self, x):
        return x

    def barrier(self) -> None:
        pass

    def wrap(self, step):
        return step

    def apply(self, u):
        """A_sp u on the stencil's region (zero elsewhere)."""
        return (st3 if self.three_d else st_mod).apply(self.lev0.stencil, u)

    def mg_cycle(self, levels, u, f, cfg):
        if self.three_d:
            return mg3.mg_cycle3d(levels, u, f, cfg, self.constrain)
        return mg_mod.mg_cycle(levels, u, f, cfg, self.constrain)

    def masked_norm(self, f):
        return norms.masked_scaled_l2(f, self.unknown, *self.h)

    def residual_norm(self, levels, u, f):
        l0 = levels[0]
        st = st3 if self.three_d else st_mod
        return norms.scaled_l2(st.residual(l0.stencil, u, f, l0.unknown),
                               *self.h)

    def max_abs(self, x):
        return torch.max(torch.abs(x))


class BlockFields(WholeFields):
    """Level 0 on this rank's blocks under the block hook ``hook`` (see the
    module docstring). A hierarchy the rule leaves whole (S = 0, a one-rank
    mesh) keeps the single-device operations, with the cycles under the
    hook."""

    def __init__(self, hook, levels0):
        super().__init__(levels0, mg_mod.whole)
        self.hook = hook
        self.mesh = hook.mesh
        self.cycle, self.sharding = hook.layout(levels0)
        self.blk = self.cycle.blocks[0] if self.cycle.S else None
        if self.blk is not None:
            self.unknown = self.blk.unknown
            self.fixed = self.blk.logical & ~self.blk.unknown
        self.writer = self.mesh.rank == self.mesh.ranks[0]

    def coords(self, *c):
        """Coordinate tensors (whole meshes, or broadcastable axes) cut to
        the block: each split axis laid out to the layout's extent (zero
        past the logical nodes) and sliced."""
        if self.blk is None:
            return c
        out = []
        for x in c:
            for axis, sl in enumerate(self.blk.slices):
                if x.shape[axis] == 1:
                    continue
                n, e = x.shape[axis], self.blk.extent[axis]
                if n < e:
                    pad = list(x.shape)
                    pad[axis] = e - n
                    x = torch.cat([x, x.new_zeros(pad)], dim=axis)
                x = x.narrow(axis, sl.start, sl.stop - sl.start)
            out.append(x.contiguous())
        return tuple(out)

    def cut(self, x):
        """This rank's block of a global tensor, or a ``ShardedField``'s own
        block (in this hierarchy's layout)."""
        return distributed._field_block(self.mesh, self.cycle.tilings,
                                        self.lev0, self.sharding, x)

    def field(self, block):
        return ShardedField(block, self.sharding, self.lev0.grid, self.blk)

    def gather(self, x):
        """The global field of a ``ShardedField`` (or a block), on every
        rank."""
        if isinstance(x, ShardedField):
            x = x.block
        return self.cycle.gather(x)

    def barrier(self) -> None:
        self.mesh.psum(torch.zeros((), dtype=torch.float64,
                                   device=self.lev0.device))

    def wrap(self, step):
        """``step`` on blocks as a step on fields: tensor and field
        arguments cut to blocks, the result a field."""
        def on_fields(*args, **kw):
            args = [self.cut(a) if isinstance(a, (torch.Tensor, ShardedField))
                    else a for a in args]
            return self.field(step(*args, **kw))

        return on_fields

    def apply(self, u):
        if self.blk is None:
            return super().apply(u)
        if self.three_d:
            return bk3.apply_block3d(self.mesh, self.blk, u)
        uh = bk.with_halo(self.mesh, u, self.blk.names, self.lev0.spec.wrap)
        return self.blk.st.c * u - bk.nbsum_ext(self.blk.st, uh)

    def mg_cycle(self, levels, u, f, cfg):
        return self.hook.blocks(levels).cycle(0, u, f, cfg, cfg.cycle)

    def masked_norm(self, f):
        if self.blk is None:
            return super().masked_norm(f)
        return self.cycle.norm(torch.where(self.unknown, f, torch.zeros(
            (), dtype=f.dtype, device=f.device)))

    def residual_norm(self, levels, u, f):
        if self.blk is None:
            return super().residual_norm(levels, u, f)
        cycle = self.hook.blocks(levels)
        return cycle.norm(cycle.residual(0, u, f))

    def max_abs(self, x):
        """max |x| over the mesh (every rank the same 0-d tensor)."""
        if isinstance(x, ShardedField):
            x = x.block
        return self.mesh.pmax(torch.max(torch.abs(x)))


def fields_for(constrain, levels0) -> WholeFields:
    """The fields of a time loop on ``levels0`` under ``constrain``."""
    if isinstance(constrain, mg_mod.BlockHook):
        return BlockFields(constrain, levels0)
    return WholeFields(levels0, constrain)
