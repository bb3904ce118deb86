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
matrix unit.

Line, ADI and Chebyshev smoothers and transfers other than full weighting
and bilinear raise ``NotImplementedError``, as in the JAX package (they
take the GSPMD path there, which is not ported yet).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import bc as bc_mod
from ..core.bc import BCKind
from ..ops import stencil as st_mod
from ..ops.stencil import Stencil, Stencil9, _S9_FIELDS
from ..solvers import multigrid as mg_mod
from ..solvers.multigrid import Level, MultigridConfig
from .mesh import Mesh, block_extent, pad_to_extent

_S5_FIELDS = ("c", "w", "e", "s", "n")
_RBGS = ("rbgs", "gauss_seidel", "red_black", "sor")


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
# block helpers (every rank runs them on its own block)


class _Exchange:
    """Shifts of tensors along one mesh axis, in flight: constructing it
    posts every send and receive in one batch; ``wait`` returns what
    arrived."""

    def __init__(self, mesh: Mesh, axis: str, sends, wrap: bool):
        self.out, self.works = [], []
        m, c = mesh.shape[axis], mesh.coords[axis]
        ops = []
        for tag, (x, shift) in enumerate(sends):
            x = x.contiguous()
            if m == 1:
                # no peer: with wrap the halo is the block's own far edge
                self.out.append(x if wrap else torch.zeros_like(x))
                continue
            dst, src = c + shift, c - shift
            if wrap:
                dst, src = dst % m, src % m
            buf = torch.zeros_like(x)
            if 0 <= dst < m:
                ops.append(dist.P2POp(dist.isend, x,
                                      mesh.rank_at(**{axis: dst}), tag=tag))
            if 0 <= src < m:
                ops.append(dist.P2POp(dist.irecv, buf,
                                      mesh.rank_at(**{axis: src}), tag=tag))
            self.out.append(buf)
        if ops:
            self.works = dist.batch_isend_irecv(ops)

    def wait(self):
        for w in self.works:
            w.wait()
        return self.out


def _start_x(mesh, blk, wrap):
    """The x stage of a one-node halo, in flight: the last row goes to the
    next rank along x (it is that rank's row -1), the first row to the
    previous one."""
    return _Exchange(mesh, "x", [(blk[-1:, :], +1), (blk[:1, :], -1)],
                     wrap[0])


def _finish_halo(mesh, blk, pending, wrap):
    """(bx, by) -> (bx + 2, by + 2) with one-node halos: the x stage's rows,
    then the y stage on the x-extended block, which routes the corner
    values (across periodic wraps too)."""
    top, bot = pending.wait()
    ext = torch.cat([top, blk, bot], dim=0)
    left, right = _Exchange(mesh, "y", [(ext[:, -1:], +1), (ext[:, :1], -1)],
                            wrap[1]).wait()
    return torch.cat([left, ext, right], dim=1)


def _with_halo(mesh, blk, wrap):
    return _finish_halo(mesh, blk, _start_x(mesh, blk, wrap), wrap)


def _block_slices(mesh, bx: int, by: int):
    """This rank's (bx, by) block of a blocked global array."""
    i, j = mesh.coords["x"], mesh.coords["y"]
    return (slice(i * bx, (i + 1) * bx), slice(j * by, (j + 1) * by))


def _gidx(mesh, bx: int, by: int, device, ext: bool = False):
    """Global (i, j) index tensors ((bx, 1) and (1, by), or one node wider
    on each side with ``ext``) of this rank's block."""
    off = 1 if ext else 0
    gi = (mesh.coords["x"] * bx - off
          + torch.arange(bx + 2 * off, device=device))[:, None]
    gj = (mesh.coords["y"] * by - off
          + torch.arange(by + 2 * off, device=device))[None, :]
    return gi, gj


def _block_unknown(lev: Level, gi, gj):
    """The unknown mask of ``lev`` at global indices (``bc.unknown_mask_at``
    and the domain's interior): Dirichlet rings fixed, Neumann/Robin rings
    unknown, a periodic axis owning nodes 0..n-2, nodes past the logical
    extent fixed."""
    mask = bc_mod.unknown_mask_at(lev.spec, lev.grid.nx, lev.grid.ny, gi, gj)
    if lev.domain is not None:
        mask = mask & lev.domain.interior_mask_at(lev.grid, gi, gj)
    return mask.expand(gi.shape[0], gj.shape[1]).contiguous()


def _nbsum_ext(stb, uh):
    """Off-diagonal coupling sum on the (bx, by) core of a haloed block, in
    ``ops.stencil.neighbor_sum``'s order (corners last for a Stencil9)."""
    out = (stb.w * uh[:-2, 1:-1] + stb.e * uh[2:, 1:-1]
           + stb.s * uh[1:-1, :-2] + stb.n * uh[1:-1, 2:])
    if isinstance(stb, Stencil9):
        out = out + (stb.sw * uh[:-2, :-2] + stb.se * uh[2:, :-2]
                     + stb.nw * uh[:-2, 2:] + stb.ne * uh[2:, 2:])
    return out


def _ring_mask(bx: int, by: int, device):
    ring = torch.ones((bx, by), dtype=torch.bool, device=device)
    ring[1:-1, 1:-1] = False
    return ring


@dataclasses.dataclass
class _Block:
    """What a sharded level's block needs: its stencil leaves, unknowns,
    colours and ring."""

    lev: Level
    st: Any
    unknown: torch.Tensor
    red: torch.Tensor
    ring: torch.Tensor


def _nbsum(mesh, blk: _Block, u, wrap, overlap: bool):
    """Neighbour sum of the block; with ``overlap`` the nodes off the ring
    from local data while the halo exchange is in flight."""
    if not overlap:
        return _nbsum_ext(blk.st, _with_halo(mesh, u, wrap))
    pending = _start_x(mesh, u, wrap)
    local = _nbsum_ext(blk.st, F.pad(u, (1, 1, 1, 1)))
    halo = _nbsum_ext(blk.st, _finish_halo(mesh, u, pending, wrap))
    return torch.where(blk.ring, halo, local)


def _smooth_block(mesh, blk: _Block, u, f, *, method: str, sweeps: int,
                  omega: float, wrap, overlap: bool = True):
    """``sweeps`` sweeps of weighted Jacobi or RB-GS ('rbgs_rev': black
    first) on the block, with a halo exchange per colour (per Jacobi
    sweep): the operations of ``ops.smooth.jacobi_sweep`` and
    ``rb_color_update``."""
    st = blk.st
    if method == "jacobi":
        for _ in range(sweeps):
            r = f - (st.c * u - _nbsum(mesh, blk, u, wrap, overlap))
            u = torch.where(blk.unknown, u + st_mod.divide(omega * r, st.c),
                            u)
        return u
    if method not in _RBGS + ("rbgs_rev",):
        raise NotImplementedError(
            f"halo_solve: smoother {method!r} is not supported on the "
            "explicit path (line and Chebyshev smoothers take the GSPMD "
            "path, not ported yet)")
    colours = ((~blk.red, blk.red) if method == "rbgs_rev"
               else (blk.red, ~blk.red))
    for _ in range(sweeps):
        for colour in colours:
            u_gs = st_mod.divide(f + _nbsum(mesh, blk, u, wrap, overlap),
                                 st.c)
            u = torch.where(colour & blk.unknown, u + omega * (u_gs - u), u)
    return u


def _residual_block(mesh, blk: _Block, u, f, wrap):
    r = f - (blk.st.c * u - _nbsum_ext(blk.st, _with_halo(mesh, u, wrap)))
    return torch.where(blk.unknown, r, torch.zeros((), dtype=r.dtype,
                                                   device=r.device))


def _install_reflection(mesh, rh, spec, nx: int, ny: int, bx: int, by: int):
    """Reflected values on the haloed residual where it leaves the domain
    (gi = -1 reads gi = 1, gi = nx reads nx - 2; x first, then y): the
    'reflect' restriction of Neumann/Robin rings, blockwise."""
    gih, gjh = _gidx(mesh, bx, by, rh.device, ext=True)
    no_refl = (BCKind.DIRICHLET, BCKind.PERIODIC)

    def refl(side):
        # any Neumann/Robin presence (default or segment) reflects; on the
        # Dirichlet portions the coarse ring is masked afterwards
        return any(k not in no_refl for k in side.kinds)

    if refl(spec.west):
        rh = torch.where(gih == -1, torch.roll(rh, -2, 0), rh)
    if refl(spec.east):
        rh = torch.where(gih == nx, torch.roll(rh, 2, 0), rh)
    if refl(spec.south):
        rh = torch.where(gjh == -1, torch.roll(rh, -2, 1), rh)
    if refl(spec.north):
        rh = torch.where(gjh == ny, torch.roll(rh, 2, 1), rh)
    return rh


def _restrict_block(mesh, r, lev_f: Level, lev_c: Level, unknown_c, wrap):
    """Full weighting of the block's residual onto its (bx/2, by/2) coarse
    block, in ``ops.transfer.restrict``'s order (centre, edges, corners),
    cast to the coarse dtype first; zero off ``unknown_c``."""
    bx, by = r.shape
    rh = _with_halo(mesh, r, wrap)
    if not lev_f.spec.plain:
        rh = _install_reflection(mesh, rh, lev_f.spec, lev_f.grid.nx,
                                 lev_f.grid.ny, bx, by)
    rh = rh.to(lev_c.dtype)

    def win(di, dj):  # fine (2I + di, 2J + dj) for every coarse (I, J)
        return rh[1 + di: 1 + di + bx: 2, 1 + dj: 1 + dj + by: 2]

    fc = (4.0 * win(0, 0)
          + 2.0 * (win(1, 0) + win(-1, 0) + win(0, 1) + win(0, -1))
          + (win(1, 1) + win(-1, 1) + win(1, -1) + win(-1, -1))) / 16.0
    return torch.where(unknown_c, fc, torch.zeros((), dtype=fc.dtype,
                                                  device=fc.device))


def _interpolate(c, bx: int, by: int, dtype):
    """Bilinear interpolation of a (bx/2 + 1, by/2 + 1) coarse window onto
    the (bx, by) fine block it covers, in ``ops.transfer.prolong``'s
    order."""
    c = c.to(dtype)
    out = torch.empty((bx, by), dtype=dtype, device=c.device)
    out[0::2, 0::2] = c[:-1, :-1]
    out[0::2, 1::2] = 0.5 * (c[:-1, :-1] + c[:-1, 1:])
    out[1::2, 0::2] = 0.5 * (c[:-1, :-1] + c[1:, :-1])
    out[1::2, 1::2] = 0.25 * (c[:-1, :-1] + c[1:, :-1] + c[:-1, 1:]
                              + c[1:, 1:])
    return out


def _prolong_block(mesh, ec, lev_f: Level, bx: int, by: int, wrap):
    """Bilinear prolongation of the coarse block: its east/north one-node
    halo (the parents of the block's last odd rows and columns; cyclic on a
    periodic axis), then the interpolation."""
    (bot,) = _Exchange(mesh, "x", [(ec[:1, :], -1)], wrap[0]).wait()
    extx = torch.cat([ec, bot], dim=0)
    (right,) = _Exchange(mesh, "y", [(extx[:, :1], -1)], wrap[1]).wait()
    return _interpolate(torch.cat([extx, right], dim=1), bx, by,
                        lev_f.dtype)


def _to_layout(x, grid, hshape):
    """An (nx, ny) field in the halo layout: its logical region (the unique
    nodes of a periodic axis) at the origin of ``hshape``."""
    return pad_to_extent(x[:min(grid.nx, hshape[0]), :min(grid.ny,
                                                          hshape[1])],
                         hshape)


def _block_stencil(st, grid, hshape, slices):
    """The rank's block of a level's stencil in the halo layout: scalar
    leaves as they are, planes cut from their halo layout."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        return _to_layout(x, grid, hshape)[slices].contiguous()

    if isinstance(st, Stencil9):
        return Stencil9(*(leaf(getattr(st, k)) for k in _S9_FIELDS))
    return Stencil(*(leaf(getattr(st, k)) for k in _S5_FIELDS))


def _from_layout(x, grid):
    """A halo-layout field back to (nx, ny); a periodic axis's duplicate
    nodes are left at zero for the level's sync."""
    out = torch.zeros(grid.shape, dtype=x.dtype, device=x.device)
    nx, ny = min(grid.nx, x.shape[0]), min(grid.ny, x.shape[1])
    out[:nx, :ny] = x[:nx, :ny]
    return out


def _gather(mesh, blk):
    """The global halo-layout array from every rank's block."""
    return mesh.all_gather(mesh.all_gather(blk, "x", 0), "y", 1)


# ---------------------------------------------------------------------------
# the solve


def _check_config(cfg: MultigridConfig) -> None:
    if cfg.smoother not in ("jacobi",) + _RBGS:
        raise NotImplementedError(
            f"halo_solve: smoother {cfg.smoother!r} takes the GSPMD path "
            "(not ported yet)")
    if cfg.restriction != "full_weighting" or cfg.prolongation != "bilinear":
        raise NotImplementedError(
            "halo_solve: the blockwise transfers are full weighting and "
            "bilinear only (the GSPMD path covers the rest, not ported yet)")


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
    lev0 = levels[0]
    plan = make_plan(levels, mesh, min_points=min_points)
    S = plan.n_sharded
    plain = cfg.replace(backend="torch")
    if S == 0:  # nothing split: the single-device solve on every rank
        return mg_mod.mg_solve(levels, f, u0, plain)
    wrap = lev0.spec.wrap
    dev = lev0.device
    f = f.to(device=dev, dtype=lev0.dtype)
    u = (lev0.zeros() if u0 is None
         else u0.to(device=dev, dtype=lev0.dtype, copy=True))

    blocks = []
    for lvl in range(S):
        lev = levels[lvl]
        bx, by = plan.blocks[lvl]
        gi, gj = _gidx(mesh, bx, by, dev)
        blocks.append(_Block(
            lev, _block_stencil(lev.stencil, lev.grid, plan.hshape(lvl),
                                _block_slices(mesh, bx, by)),
            _block_unknown(lev, gi, gj), ((gi + gj) & 1) == 0,
            _ring_mask(bx, by, dev)))

    def smooth(lvl, u, f, sweeps, method, omega):
        if sweeps <= 0:
            return u
        return _smooth_block(mesh, blocks[lvl], u, f, method=method,
                             sweeps=sweeps, omega=omega, wrap=wrap,
                             overlap=overlap)

    def to_coarse(lvl, r):
        lev_f, lev_c = levels[lvl], levels[lvl + 1]
        if lvl + 1 < S:  # sharded -> sharded
            return _restrict_block(mesh, r, lev_f, lev_c,
                                   blocks[lvl + 1].unknown, wrap)
        # sharded -> replicated: restrict every coarse node of the block,
        # gather, and mask onto the coarse level (agglomeration)
        bx, by = plan.blocks[lvl]
        virt = _restrict_block(mesh, r, lev_f, lev_c, torch.ones(
            (bx // 2, by // 2), dtype=torch.bool, device=dev), wrap)
        out = _from_layout(_gather(mesh, virt), lev_c.grid)
        return torch.where(lev_c.unknown, out, torch.zeros(
            (), dtype=out.dtype, device=dev))

    def to_fine(lvl, ec):
        lev_f, lev_c = levels[lvl], levels[lvl + 1]
        bx, by = plan.blocks[lvl]
        if lvl + 1 < S:  # sharded -> sharded
            return _prolong_block(mesh, ec, lev_f, bx, by, wrap)
        # replicated -> sharded: this block's coarse window, interpolated
        if lev_c.sync is not None:
            lev_c.sync(ec)  # the last window reads the coarse duplicate
        bxc, byc = bx // 2, by // 2
        need = (plan.mx * bxc + 1, plan.my * byc + 1)
        ec = F.pad(ec, (0, max(0, need[1] - ec.shape[1]),
                        0, max(0, need[0] - ec.shape[0])))
        i0, j0 = mesh.coords["x"] * bxc, mesh.coords["y"] * byc
        return _interpolate(ec[i0:i0 + bxc + 1, j0:j0 + byc + 1], bx, by,
                            lev_f.dtype)

    def cycle(lvl, u, f, cycle_type):
        if lvl >= S:  # replicated: the single-device cycle on every rank
            return mg_mod._cycle(levels, u, f, lvl, plain, cycle_type)
        if cycle_type not in ("V", "W", "F"):
            raise ValueError(f"unknown cycle {cycle_type!r}")
        if lvl == len(levels) - 1:
            return smooth(lvl, u, f, cfg.coarse_sweeps, "rbgs", 1.0)
        u = smooth(lvl, u, f, cfg.pre_sweeps, cfg.smoother, cfg.omega)
        fc = to_coarse(lvl, _residual_block(mesh, blocks[lvl], u, f, wrap))
        lev_c = levels[lvl + 1]
        shape = plan.blocks[lvl + 1] if lvl + 1 < S else lev_c.grid.shape
        ec = torch.zeros(shape, dtype=lev_c.dtype, device=dev)
        branch = cycle_type if lvl + 1 < cfg.w_depth else "V"
        if branch == "V":
            ec = cycle(lvl + 1, ec, fc, "V")
        elif branch == "W":
            ec = cycle(lvl + 1, ec, fc, "W")
            ec = cycle(lvl + 1, ec, fc, "W")
        else:  # F: an F-recursion, then a V-recursion
            ec = cycle(lvl + 1, ec, fc, "F")
            ec = cycle(lvl + 1, ec, fc, "V")
        e = to_fine(lvl, ec)
        u = torch.where(blocks[lvl].unknown, u + e, u)
        post = ("rbgs_rev" if cfg.symmetric and cfg.smoother in _RBGS
                else cfg.smoother)
        return smooth(lvl, u, f, cfg.post_sweeps, post, cfg.omega)

    h = math.prod((lev0.grid.hx, lev0.grid.hy))
    hshape = plan.hshape(0)
    slices = _block_slices(mesh, *plan.blocks[0])
    f_b = _to_layout(f, lev0.grid, hshape)[slices].contiguous()
    u_b = _to_layout(u, lev0.grid, hshape)[slices].contiguous()

    def res_norm(u):
        r = _residual_block(mesh, blocks[0], u, f_b, wrap)
        r64 = r.to(torch.float64)
        return torch.sqrt(h * mesh.psum(torch.sum(r64 * r64)))

    f64 = torch.where(blocks[0].unknown, f_b, torch.zeros(
        (), dtype=f_b.dtype, device=dev)).to(torch.float64)
    fnorm = torch.sqrt(h * mesh.psum(torch.sum(f64 * f64)))
    rnorm0 = res_norm(u_b)
    tol_eff = mg_mod.tolerance(cfg, torch.maximum(fnorm, rnorm0))
    state = {"u": u_b}

    def step():
        state["u"] = cycle(0, state["u"], f_b, cfg.cycle)
        return res_norm(state["u"])

    info = mg_mod.outer_iterate(step, rnorm0, tol_eff, fnorm,
                                cfg.max_iterations)
    u = _from_layout(_gather(mesh, state["u"]), lev0.grid)
    if lev0.sync is not None:
        lev0.sync(u)  # the periodic duplicates, as mg_solve leaves them
    return u, info


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
    bx, by = _standard_blocks(mesh, lev)
    gi, gj = _gidx(mesh, bx, by, lev.device)
    blk = _Block(lev, lev.stencil, _block_unknown(lev, gi, gj),
                 ((gi + gj) & 1) == 0, _ring_mask(bx, by, lev.device))
    return blk, _block_slices(mesh, bx, by)


def shard_smooth(mesh: Mesh, lev: Level, u, f, *, method: str = "rbgs",
                 sweeps: int = 2, omega: float = 1.0, overlap: bool = True):
    """``sweeps`` smoothing sweeps with explicit halo exchange, once per
    colour: true Gauss-Seidel ordering across rank boundaries. Every rank
    passes the global (nx, ny) ``u`` and ``f`` and gets the global result;
    equal to the single-device plain smoother bit for bit."""
    blk, slices = _standard_block(mesh, lev)
    extent = block_extent(lev.grid.nx, lev.grid.ny)
    u_b = pad_to_extent(u, extent)[slices].contiguous()
    f_b = pad_to_extent(f, extent)[slices].contiguous()
    out = _smooth_block(mesh, blk, u_b, f_b, method=method, sweeps=sweeps,
                        omega=omega, wrap=(False, False), overlap=overlap)
    return _gather(mesh, out)[:lev.grid.nx, :lev.grid.ny].contiguous()


def global_residual_norm(mesh: Mesh, lev: Level, u, f) -> torch.Tensor:
    """Scaled l2 of the residual from per-block float64 sums and one
    ``all_reduce`` (a 0-d float64 tensor on every rank)."""
    blk, slices = _standard_block(mesh, lev)
    extent = block_extent(lev.grid.nx, lev.grid.ny)
    u_b = pad_to_extent(u, extent)[slices].contiguous()
    f_b = pad_to_extent(f, extent)[slices].contiguous()
    r = _residual_block(mesh, blk, u_b, f_b, (False, False)).to(
        torch.float64)
    total = mesh.psum(torch.sum(r * r))
    return torch.sqrt(math.prod((lev.grid.hx, lev.grid.hy)) * total)
