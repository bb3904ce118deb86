"""The whole multigrid solve over a mesh of ranks, with explicit halos.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/parallel/
halo_solve.py``, whose one ``shard_map`` region becomes one SPMD program
run by every rank of a ``torch.distributed`` process group: the outer loop,
every smoothing sweep, residual, restriction and prolongation, and the
coarse-level agglomeration. Neighbour halos are point-to-point sends and
receives (``dist.batch_isend_irecv``, one batch per exchange, posted in the
same order on every rank), norms an ``all_reduce`` of per-block float64
sums, agglomeration an ``all_gather`` along each mesh axis.

Design, as in the JAX package:

- **Sharded levels** (fine): every rank owns a (bx, by) block of a
  "halo layout" array of shape (mx*bx, my*by) with the logical region at
  the origin. ``make_plan`` chooses the blocks so that a fine level's are
  exactly twice its coarse child's (bx_l = bx_0 / 2^l, multiples of 8):
  2:1 transfers are then local but for a one-node halo.
- **Replicated levels** (coarse): below ``min_points`` logical rows or
  columns per rank, a level is gathered onto every rank (``all_gather``
  along x, then y) and every rank runs the single-device cycle on it,
  redundantly: the port's plain ``solvers.multigrid._cycle``.
- **Interior-first overlap**: a smoothing update starts its halo exchange,
  updates the nodes off the block's ring from local data while the
  exchange is in flight, waits, and updates the ring from the haloed
  block; the merge equals ``overlap=False`` bit for bit.
- **Coefficient fields, Galerkin 9-point stencils, Neumann/Robin sides,
  mixed segments and irregular domains**: coefficient planes are blocked
  like u (neighbour values need halos, neighbour coefficients do not),
  unknown masks are rebuilt from global indices per block, and the
  Neumann/Robin 'reflect' restriction installs reflected values on the
  haloed residual (x, then y: the corner rule).
- **Periodic axes are the torus case**: a periodic axis stores its unique
  nodes only, which must tile the mesh axis exactly (else ``make_plan``
  shards fewer levels, down to none), and its halo exchange is a cyclic
  shift; replicated levels keep the duplicate node and its sync.

The blocks run the port's plain arithmetic, operation for operation as
``ops/smooth.py``, ``ops/stencil.py`` and ``ops/transfer.py`` compute it,
and take no kernel, as the JAX module runs plain ops and never
``ops/dispatch``. The transfers compute the bilinear interpolation
directly, where the JAX module used selection products for the TPU's
matrix unit. The block machinery (tilings, exchanges, smoothers,
transfers, the cycle and the outer loop) lives in ``parallel/blocks.py``,
shared with the GSPMD path (``parallel/distributed.py``); this module
plans its layout (``make_plan``) and refuses what the JAX ``halo_solve``
refuses.

Line, ADI and Chebyshev smoothers and transfers other than full weighting
and bilinear raise ``NotImplementedError``, as in the JAX package: they
take the GSPMD path (``parallel.distributed.sharded_solve``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..core.bc import BCKind
from ..solvers.multigrid import Level, MultigridConfig
from . import blocks as bk
from .mesh import Mesh, block_extent, pad_to_extent

_RBGS = bk.RBGS
_XY = (("x",), ("y",))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static layout plan: which levels are sharded and their block
    shapes."""

    mx: int
    my: int
    n_sharded: int                       # levels [0, n_sharded) are sharded
    blocks: Tuple[Tuple[int, int], ...]  # (bx, by) per sharded level

    def hshape(self, lvl: int) -> Tuple[int, int]:
        bx, by = self.blocks[lvl]
        return (self.mx * bx, self.my * by)

    def tilings(self) -> Tuple[bk.Tiling, ...]:
        """The sharded levels' layouts, split over the mesh's x and y."""
        return tuple(bk.Tiling(_XY, self.hshape(lvl))
                     for lvl in range(self.n_sharded))


def make_plan(levels, mesh: Mesh, *, min_points: int = 16) -> HaloPlan:
    """Sharded depth and 2:1-aligned block shapes, as the JAX package plans
    them (its halo_solve.py:101-175): a level stays sharded while every
    rank keeps at least ``min_points`` logical rows and columns; the finest
    blocks are multiples of 8 * 2^(S-1), so every sharded level's block is
    a multiple of 8 and exactly half its parent's; a periodic axis's unique
    nodes must tile the mesh axis exactly, else fewer levels are sharded,
    down to none."""
    mx = mesh.shape["x"]
    my = mesh.shape["y"]
    spec0 = levels[0].spec
    wx = spec0.west.kind == BCKind.PERIODIC
    wy = spec0.south.kind == BCKind.PERIODIC
    S = 0
    for lev in levels:
        if lev.grid.nx // mx >= min_points and lev.grid.ny // my >= min_points:
            S += 1
        else:
            break
    if mx * my == 1:
        S = 0
    nx0, ny0 = levels[0].grid.nx, levels[0].grid.ny

    def axis_b0(n0: int, m: int, w: bool, S: int):
        """Finest-level block extent along one axis (None: infeasible)."""
        quant = 8 * (1 << (S - 1))
        if w:
            # periodic: the unique nodes 0..n0-2 tile the axis exactly
            if (n0 - 1) % m:
                return None
            b0 = (n0 - 1) // m
            return b0 if b0 % quant == 0 else None
        # every sharded level's extent covers its logical nodes plus one
        # even row of slack for the 2:1 transfer reads
        b0 = _round_up(-(-n0 // m), quant)

        def ok(b0):
            for lvl in range(S):
                if (b0 >> lvl) * m < ((n0 - 1) >> lvl) + 2:
                    return False
            return True

        while not ok(b0):
            b0 += quant
        return b0

    while S > 0:
        bx0 = axis_b0(nx0, mx, wx, S)
        by0 = axis_b0(ny0, my, wy, S)
        if bx0 is not None and by0 is not None:
            break
        S -= 1
    if S == 0:
        return HaloPlan(mx, my, 0, ())
    blocks = tuple((bx0 >> lvl, by0 >> lvl) for lvl in range(S))
    return HaloPlan(mx, my, S, blocks)


# ---------------------------------------------------------------------------
# the solve


def _check_config(cfg: MultigridConfig) -> None:
    if cfg.smoother not in ("jacobi",) + _RBGS:
        raise NotImplementedError(
            f"halo_solve: smoother {cfg.smoother!r} takes the GSPMD path "
            "(parallel.distributed.sharded_solve)")
    if cfg.restriction != "full_weighting" or cfg.prolongation != "bilinear":
        raise NotImplementedError(
            "halo_solve: the blockwise transfers are full weighting and "
            "bilinear only (the GSPMD path, parallel.distributed."
            "sharded_solve, covers the rest)")


def halo_solve(mesh: Mesh, levels: Tuple[Level, ...], f, u0=None,
               cfg: MultigridConfig = MultigridConfig(), *,
               min_points: int = 16, overlap: bool = True
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``mg_solve`` run by every rank of ``mesh`` as one SPMD program.

    Every rank calls it with the same global (nx, ny) ``f`` and ``u0`` (the
    counterpart of ``shard_map`` splitting a global array) and takes its
    blocks; every rank returns the global solution, gathered at the end
    (``all_gather`` along x, then y), and ``mg_solve``'s info dict. The
    stopping test reads the float64 norm, summed over the mesh
    (``all_reduce``), back once per iteration on every rank, so every rank
    takes the same branch. ``levels`` live on this rank's device: the CPU
    under gloo, its card under NCCL. ``overlap`` computes each update's
    interior while its halos are in flight; it changes the schedule, not
    the result. When the plan splits no level (S = 0, as on every mesh of
    one rank), every rank runs the plain single-device ``mg_solve``."""
    _check_config(cfg)
    plan = make_plan(levels, mesh, min_points=min_points)
    cycle = bk.BlockCycle(mesh, levels, plan.tilings(), overlap=overlap)
    lev0 = levels[0]
    if plan.n_sharded:
        f = cycle.to_blocks(f.to(device=lev0.device))
        u0 = None if u0 is None else cycle.to_blocks(u0.to(lev0.device))
    # plain ops throughout, as the JAX module never reaches ops/dispatch
    return cycle.solve(f, u0, cfg.replace(backend="torch"))


# ---------------------------------------------------------------------------
# explicit-path utilities on the level's own blocks


def _standard_blocks(mesh: Mesh, lev: Level):
    """(bx, by) of the level's blocks over its block extent."""
    mx, my = mesh.shape["x"], mesh.shape["y"]
    px, py = block_extent(lev.grid.nx, lev.grid.ny)
    if px % mx or py % my:
        raise ValueError(f"block extent {(px, py)} not divisible by mesh "
                         f"{(mx, my)}")
    if lev.spec.any_periodic:
        raise NotImplementedError(
            "explicit halo utilities: periodic sides take halo_solve's "
            "torus layout")
    if not lev.stencil.scalar:
        raise NotImplementedError(
            "explicit halo utilities: constant stencil only (coefficient "
            "planes take halo_solve)")
    return px // mx, py // my


def _standard_block(mesh: Mesh, lev: Level):
    """The level's block over its block extent and that block's slices."""
    bx, by = _standard_blocks(mesh, lev)
    blk = bk.make_block(mesh, lev, bk.Tiling(_XY, block_extent(
        lev.grid.nx, lev.grid.ny)))
    (ox, oy) = blk.offset
    return blk, (slice(ox, ox + bx), slice(oy, oy + by))


def shard_smooth(mesh: Mesh, lev: Level, u, f, *, method: str = "rbgs",
                 sweeps: int = 2, omega: float = 1.0, overlap: bool = True):
    """``sweeps`` smoothing sweeps with explicit halo exchange, once per
    colour: true Gauss-Seidel ordering across rank boundaries. Every rank
    passes the global (nx, ny) ``u`` and ``f`` and gets the global result;
    equal to the single-device plain smoother bit for bit. Weighted Jacobi
    and the RB-GS smoothers, as in the JAX package."""
    if method not in ("jacobi", "rbgs_rev") + _RBGS:
        raise NotImplementedError(
            f"shard_smooth: smoother {method!r} takes the GSPMD path")
    blk, slices = _standard_block(mesh, lev)
    extent = block_extent(lev.grid.nx, lev.grid.ny)
    u_b = pad_to_extent(u, extent)[slices].contiguous()
    f_b = pad_to_extent(f, extent)[slices].contiguous()
    out = bk.smooth_block(mesh, blk, u_b, f_b, method=method, sweeps=sweeps,
                          omega=omega, wrap=(False, False), overlap=overlap)
    return bk.gather_axes(mesh, out, _XY)[:lev.grid.nx,
                                          :lev.grid.ny].contiguous()


def global_residual_norm(mesh: Mesh, lev: Level, u, f) -> torch.Tensor:
    """Scaled l2 of the residual from per-block float64 sums and one
    ``all_reduce`` (a 0-d float64 tensor on every rank)."""
    blk, slices = _standard_block(mesh, lev)
    extent = block_extent(lev.grid.nx, lev.grid.ny)
    u_b = pad_to_extent(u, extent)[slices].contiguous()
    f_b = pad_to_extent(f, extent)[slices].contiguous()
    r = bk.residual_block(mesh, blk, u_b, f_b, (False, False)).to(
        torch.float64)
    total = mesh.psum(torch.sum(r * r))
    return torch.sqrt(math.prod((lev.grid.hx, lev.grid.hy)) * total)
