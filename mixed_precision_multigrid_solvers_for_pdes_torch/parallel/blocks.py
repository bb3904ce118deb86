"""Blocks of a level split over a mesh of ranks, and the multigrid cycle run
on them: the machinery that the explicit path (``halo_solve``) and the
GSPMD path (``distributed``) share.

Every rank of a ``torch.distributed`` process group runs the same program
on its own blocks:

- **Tilings**: a sharded level lives in a "layout" array (its logical
  region at the origin, padding past it) of which every rank holds one
  block. Along each array axis a tuple of mesh axes splits the layout
  (major first: ``('x',)``, ``('xo', 'xi')``, ``('xo',)``); an empty tuple
  keeps the axis whole on every rank, and ranks that differ only in mesh
  axes no name lists hold the same block (replicas). A fine layout is
  exactly twice its coarse child's, so 2:1 transfers are local but for a
  one-node halo. Along an axis whose split shrinks from one level to the
  next (a graded mesh's mid tier), the coarse block is the concatenation
  of the fine blocks' coarse halves over the mesh axes the coarse level
  drops; below the last sharded level every level is replicated.
- **Halos** are point-to-point sends and receives
  (``dist.batch_isend_irecv``, one batch per exchange, posted in the same
  order on every rank) between the ranks that hold neighbouring blocks;
  an axis kept whole takes a zero halo, or its own far edge when periodic.
  Norms are an ``all_reduce`` of per-block float64 sums (replicas add
  zero); agglomeration an ``all_gather`` along each dropped mesh axis,
  minor first.
- **Smoothers**: where ``ops.dispatch``'s kernel gate passes (backend
  'auto', a point smoother on a 5-point all-Dirichlet rectangle, fp32 or
  bf16 storage), kernel A (H on coefficient planes) runs on a window of
  the block with a halo as wide as the call's colour phases, one exchange
  for the call. On the plain path weighted Jacobi and red-black
  Gauss-Seidel take a halo exchange per sweep or colour, with the interior
  updated while the exchange is in flight (``overlap``); Chebyshev one per
  stencil
  application; the line smoothers (line_x, line_y, ADI) gather the slab of
  whole lines through the block (``Mesh.all_gather`` along the line axis's
  mesh axes) with a one-line halo across, run the plain smoother's line
  update on it (``ops.smooth._line_update``: PCR, or the cyclic solve on a
  periodic axis) and keep the block.
- **Transfers**: full weighting, half weighting and injection restriction
  (zero, 'reflect' and the FMG 'inject' rings), bilinear and injection
  prolongation.

The blocks run the single-device arithmetic, operation for operation as
``ops/smooth.py``, ``ops/stencil.py`` and ``ops/transfer.py`` (or the
smoothing kernel) compute it, so a cycle equals the single-device cycle
under a hook (``solvers.multigrid._cycle`` with an array hook: no tail
kernel, no fused transfer, as in the JAX package) bit for bit; only the
norms' all_reduce order differs. Replicated levels run that cycle itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import bc as bc_mod
from ..core.bc import BCKind
from ..ops import dispatch, smooth as smooth_mod, stencil as st_mod, \
    transfer
from ..ops.stencil import Stencil, Stencil9, _S9_FIELDS
from ..solvers import multigrid as mg_mod, refinement
from ..solvers.multigrid import Level, MultigridConfig
from .mesh import Mesh, pad_to_extent

_S5_FIELDS = ("c", "w", "e", "s", "n")
RBGS = smooth_mod.RBGS_METHODS
Names = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Tiling:
    """A sharded level's layout: per array axis (x, y) the mesh axes that
    split it, major first (() keeps the axis whole), and the layout
    extent the blocks tile."""

    names: Tuple[Names, Names]
    extent: Tuple[int, int]


def axis_count(mesh: Mesh, names: Names) -> int:
    return math.prod(mesh.shape[a] for a in names)


def axis_index(mesh: Mesh, names: Names) -> int:
    """This rank's block index along an axis split by ``names``."""
    idx = 0
    for a in names:
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def _peer(mesh: Mesh, names: Names, idx: int) -> int:
    """The rank holding block ``idx`` along ``names``, every other
    coordinate as this rank's."""
    coords = {}
    for a in reversed(names):
        coords[a] = idx % mesh.shape[a]
        idx //= mesh.shape[a]
    return mesh.rank_at(**coords)


class _Exchange:
    """Shifts of tensors between the blocks of one axis, in flight:
    constructing it posts every send and receive in one batch; ``wait``
    returns what arrived."""

    def __init__(self, mesh: Mesh, names: Names, sends, wrap: bool):
        self.out, self.works = [], []
        m, c = axis_count(mesh, names), axis_index(mesh, names)
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
                ops.append(dist.P2POp(dist.isend, x, _peer(mesh, names, dst),
                                      tag=tag))
            if 0 <= src < m:
                ops.append(dist.P2POp(dist.irecv, buf,
                                      _peer(mesh, names, src), tag=tag))
            self.out.append(buf)
        if ops:
            self.works = dist.batch_isend_irecv(ops)

    def wait(self):
        for w in self.works:
            w.wait()
        return self.out


def _start_x(mesh, blk, names, wrap):
    """The x stage of a one-node halo, in flight: the last row goes to the
    next block along x (it is that block's row -1), the first row to the
    previous one."""
    return _Exchange(mesh, names[0], [(blk[-1:, :], +1), (blk[:1, :], -1)],
                     wrap[0])


def _finish_halo(mesh, blk, pending, names, wrap):
    """(bx, by) -> (bx + 2, by + 2) with one-node halos: the x stage's rows,
    then the y stage on the x-extended block, which routes the corner
    values (across periodic wraps too)."""
    top, bot = pending.wait()
    ext = torch.cat([top, blk, bot], dim=0)
    left, right = _Exchange(mesh, names[1], [(ext[:, -1:], +1),
                                             (ext[:, :1], -1)],
                            wrap[1]).wait()
    return torch.cat([left, ext, right], dim=1)


def with_halos(mesh, fields, names, wrap, width: int = 1):
    """Blocks of one shape, (bx, by) -> (bx + 2 width, by + 2 width), with
    ``width``-node halos: the x stage, then the y stage on the x-extended
    blocks, which routes the corner values (across periodic wraps too);
    one batch of sends and receives per stage for all of them."""
    def stage(xs, axis, name):
        sends = [s for x in xs for s in (
            (x.narrow(axis, x.size(axis) - width, width), +1),
            (x.narrow(axis, 0, width), -1))]
        got = _Exchange(mesh, name, sends, wrap[axis]).wait()
        return [torch.cat([got[2 * i], x, got[2 * i + 1]], dim=axis)
                for i, x in enumerate(xs)]

    return stage(stage(list(fields), 0, names[0]), 1, names[1])


def with_halo(mesh, blk, names, wrap):
    return with_halos(mesh, (blk,), names, wrap)[0]


def axis_names(entry) -> Names:
    """A sharding spec entry (None, a mesh axis name, or a tuple of them)
    as a tuple of names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def primary(mesh: Mesh, names) -> bool:
    """True on the one rank of each block's replicas that adds the block to
    a sum: coordinate 0 along every mesh axis that ``names`` (per array
    axis) does not list."""
    used = {a for axis in names for a in axis}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in used)


def gather_axes(mesh: Mesh, x, names) -> torch.Tensor:
    """The blocks of every rank along ``names`` (per array axis)
    concatenated: an ``all_gather`` per mesh axis, minor first, x then
    y."""
    for dim, axis_names in enumerate(names):
        for a in reversed(axis_names):
            x = mesh.all_gather(x, a, dim)
    return x


def _block_unknown(lev: Level, gi, gj):
    """The unknown mask of ``lev`` at global indices (``bc.unknown_mask_at``
    and the domain's interior): Dirichlet rings fixed, Neumann/Robin rings
    unknown, a periodic axis owning nodes 0..n-2, nodes past the logical
    extent fixed."""
    mask = bc_mod.unknown_mask_at(lev.spec, lev.grid.nx, lev.grid.ny, gi, gj)
    if lev.domain is not None:
        mask = mask & lev.domain.interior_mask_at(lev.grid, gi, gj)
    return mask.expand(gi.shape[0], gj.shape[1]).contiguous()


def nbsum_ext(stb, uh):
    """Off-diagonal coupling sum on the (bx, by) core of a haloed block, in
    ``ops.stencil.neighbor_sum``'s order (corners last for a Stencil9)."""
    out = (stb.w * uh[:-2, 1:-1] + stb.e * uh[2:, 1:-1]
           + stb.s * uh[1:-1, :-2] + stb.n * uh[1:-1, 2:])
    if isinstance(stb, Stencil9):
        out = out + (stb.sw * uh[:-2, :-2] + stb.se * uh[2:, :-2]
                     + stb.nw * uh[:-2, 2:] + stb.ne * uh[2:, 2:])
    return out


def to_layout(x, grid, extent):
    """An (nx, ny) field in a layout of ``extent``: its logical region (the
    unique nodes of a periodic axis) at the origin."""
    return pad_to_extent(x[:min(grid.nx, extent[0]), :min(grid.ny,
                                                          extent[1])],
                         extent)


def from_layout(x, grid):
    """A layout field back to (nx, ny); a periodic axis's duplicate nodes
    are left at zero for the level's sync."""
    out = torch.zeros(grid.shape, dtype=x.dtype, device=x.device)
    nx, ny = min(grid.nx, x.shape[0]), min(grid.ny, x.shape[1])
    out[:nx, :ny] = x[:nx, :ny]
    return out


def block_stencil(st, grid, extent, slices):
    """A block of a level's stencil: scalar leaves as they are, planes cut
    from their layout."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        return to_layout(x, grid, extent)[slices].contiguous()

    if isinstance(st, Stencil9):
        return Stencil9(*(leaf(getattr(st, k)) for k in _S9_FIELDS))
    return Stencil(*(leaf(getattr(st, k)) for k in _S5_FIELDS))


@dataclasses.dataclass
class Block:
    """What a rank needs of one sharded level: its tiling's names, the
    block's offset in the layout and global indices, its stencil leaves,
    unknowns, colours, ring and logical nodes (``extent``: the layout's)."""

    lev: Level
    names: Tuple[Names, Names]
    extent: Tuple[int, int]
    offset: Tuple[int, int]
    gi: torch.Tensor      # (bx, 1) global row indices
    gj: torch.Tensor      # (1, by) global column indices
    st: Any
    unknown: torch.Tensor
    red: torch.Tensor
    ring: torch.Tensor
    logical: torch.Tensor

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.unknown.shape)

    @property
    def slices(self) -> Tuple[slice, slice]:
        """The block's part of the layout."""
        return tuple(slice(o, o + b) for o, b in zip(self.offset,
                                                     self.shape))


def tiling_slices(mesh: Mesh, tiling: Tiling) -> Tuple[slice, slice]:
    """This rank's block of a layout under ``tiling``."""
    out = []
    for names, e in zip(tiling.names, tiling.extent):
        b = e // axis_count(mesh, names)
        o = axis_index(mesh, names) * b
        out.append(slice(o, o + b))
    return tuple(out)


def cut_block(mesh: Mesh, tiling: Tiling, grid, x) -> torch.Tensor:
    """This rank's block of a global (nx, ny) field under ``tiling``."""
    return to_layout(x, grid, tiling.extent)[tiling_slices(
        mesh, tiling)].contiguous()


def make_block(mesh: Mesh, lev: Level, tiling: Tiling, stencil=None) -> Block:
    """This rank's block of ``lev`` under ``tiling`` (``stencil`` in place
    of the level's own, e.g. widened to float64)."""
    slices = tiling_slices(mesh, tiling)
    (ox, oy) = (s.start for s in slices)
    bx, by = (s.stop - s.start for s in slices)
    dev = lev.device
    gi = (ox + torch.arange(bx, device=dev))[:, None]
    gj = (oy + torch.arange(by, device=dev))[None, :]
    ring = torch.ones((bx, by), dtype=torch.bool, device=dev)
    ring[1:-1, 1:-1] = False
    st = lev.stencil if stencil is None else stencil
    return Block(lev, tiling.names, tiling.extent, (ox, oy), gi, gj,
                 block_stencil(st, lev.grid, tiling.extent, slices),
                 _block_unknown(lev, gi, gj), ((gi + gj) & 1) == 0, ring,
                 ((gi < lev.grid.nx) & (gj < lev.grid.ny)).expand(bx, by))


# ---------------------------------------------------------------------------
# operators and smoothers on a block


def _nbsum(mesh, blk: Block, u, wrap, overlap: bool):
    """Neighbour sum of the block; with ``overlap`` the nodes off the ring
    from local data while the halo exchange is in flight."""
    if not overlap:
        return nbsum_ext(blk.st, with_halo(mesh, u, blk.names, wrap))
    pending = _start_x(mesh, u, blk.names, wrap)
    local = nbsum_ext(blk.st, F.pad(u, (1, 1, 1, 1)))
    halo = nbsum_ext(blk.st, _finish_halo(mesh, u, pending, blk.names, wrap))
    return torch.where(blk.ring, halo, local)


def residual_block(mesh, blk: Block, u, f, wrap):
    r = f - (blk.st.c * u - nbsum_ext(blk.st, with_halo(mesh, u, blk.names,
                                                         wrap)))
    return torch.where(blk.unknown, r, torch.zeros((), dtype=r.dtype,
                                                   device=r.device))


def _line_slab_rows(x, axis: int, n: int, wrap: bool):
    """The gathered layout rows along ``axis`` as the level's n logical
    ones: a periodic axis's unique nodes and a zero duplicate (no line
    update reads it), else the first n."""
    if wrap:
        shape = list(x.shape)
        shape[axis] = 1
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    return x.narrow(axis, 0, n)


class _LineSlab:
    """The lines along ``axis`` through a block, whole: u, f, the stencil
    and the unknowns over (the n logical nodes along ``axis``) x (the
    block's extent across plus a one-node halo on each side), and the
    line system of ``ops.smooth._line_system`` built on them."""

    def __init__(self, mesh, blk: Block, axis: int, u, f):
        lev = blk.lev
        self.mesh, self.blk, self.axis = mesh, blk, axis
        self.wrap = lev.spec.wrap
        self.n = lev.grid.shape[axis]
        cross = 1 - axis
        size = blk.shape[cross]
        dev = u.device
        idx = [torch.arange(self.n, device=dev), blk.offset[cross] - 1
               + torch.arange(size + 2, device=dev)]
        if axis == 1:
            idx.reverse()
        gi, gj = idx[0][:, None], idx[1][None, :]
        inner = torch.zeros(size + 2, dtype=torch.bool, device=dev)
        inner[1:-1] = True
        inner = inner[None, :] if axis == 0 else inner[:, None]
        self.unknown = _block_unknown(lev, gi, gj) & inner
        lines = gj if axis == 0 else gi
        self.even = ((lines % 2) == 0).expand(self.unknown.shape)
        wrap = list(self.wrap)
        wrap[cross] = False  # the halo holds the wrap neighbours across
        self.st = self._stencil(lev, idx[cross], cross, tuple(wrap))
        self.f = self._gather(f, halo=False)
        # the system reads the shape and dtype of u's slab, not its values
        self.system = smooth_mod._line_system(
            self.st, self.unknown, axis,
            u.new_empty(self.unknown.shape))

    def _stencil(self, lev, cross_idx, cross, wrap):
        """The level's stencil over the slab (planes zero on the halo
        lines, which no update reads) with its wrap across turned off."""
        st = lev.stencil
        n_cross = lev.grid.shape[cross] - (1 if self.wrap[cross] else 0)
        ok = (cross_idx >= 0) & (cross_idx < n_cross)
        pos = torch.where(ok, cross_idx, torch.zeros_like(cross_idx))

        def leaf(x):
            if not isinstance(x, torch.Tensor):
                return x
            cut = x.index_select(cross, pos)
            keep = ok[None, :] if cross == 1 else ok[:, None]
            return torch.where(keep, cut, torch.zeros((), dtype=cut.dtype,
                                                      device=cut.device))

        if isinstance(st, Stencil9):
            return Stencil9(*(leaf(getattr(st, k)) for k in _S9_FIELDS))
        return Stencil(*(leaf(getattr(st, k)) for k in _S5_FIELDS),
                       wrap=wrap)

    def _gather(self, x, halo: bool):
        """The slab of a block field: a one-node halo across (zeros for f,
        whose halo no update reads), then the gather of the lines."""
        axis, cross, blk = self.axis, 1 - self.axis, self.blk
        if halo:
            lo, hi = _Exchange(self.mesh, blk.names[cross], [
                (x.narrow(cross, x.shape[cross] - 1, 1), +1),
                (x.narrow(cross, 0, 1), -1)], self.wrap[cross]).wait()
        else:
            pad = list(x.shape)
            pad[cross] = 1
            lo = hi = x.new_zeros(pad)
        x = torch.cat([lo, x, hi], dim=cross)
        names = [(), ()]
        names[axis] = blk.names[axis]
        return _line_slab_rows(gather_axes(self.mesh, x, names), axis,
                               self.n, self.wrap[axis])

    def sweep(self, u):
        """One zebra sweep: the even lines, then the odd ones; u's new
        block."""
        for colour in (self.even, ~self.even):
            slab = self._gather(u, halo=True)
            smooth_mod._line_update(self.st, slab, self.f, self.unknown,
                                    self.axis, colour, self.system)
            u = self._keep(u, slab)
        return u

    def _keep(self, u, slab):
        """The block's part of the updated slab: the block's logical rows
        along the line axis, the slab's inner lines across."""
        axis, blk = self.axis, self.blk
        valid = self.n - (1 if self.wrap[axis] else 0)
        o, b = blk.offset[axis], blk.shape[axis]
        k = max(0, min(b, valid - o))
        part = slab.narrow(axis, o, k).narrow(1 - axis, 1, blk.shape[1 - axis])
        u = u.clone()
        u.narrow(axis, 0, k).copy_(part)
        return u


def _chebyshev_block(mesh, blk: Block, u, f, *, degree: int, wrap,
                     spectrum_fraction: float = 0.25):
    """``ops.smooth.chebyshev_smooth`` on the block: a halo exchange per
    stencil application. D^-1 r is zeroed off the unknowns (the plain
    smoother's 0/c there; a block's padding holds c = 0)."""
    lmax = 2.0
    lmin = spectrum_fraction * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    st = blk.st
    zero = torch.zeros((), dtype=u.dtype, device=u.device)

    def apply(x):
        return st.c * x - nbsum_ext(st, with_halo(mesh, x, blk.names, wrap))

    def dinv_a(x):
        return torch.where(blk.unknown, apply(x) / st.c, zero)

    r = torch.where(blk.unknown, f - apply(u), zero)
    dinv_r = torch.where(blk.unknown, r / st.c, zero)
    rho_old = 1.0 / sigma
    z = (1.0 / theta) * dinv_r
    d = z
    for _ in range(degree - 1):
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = (rho * rho_old) * d + (2.0 * rho / delta) * (dinv_r - dinv_a(z))
        z = z + d
        rho_old = rho
    return torch.where(blk.unknown, u + z, u)


def _window_smooth(mesh, blk: Block, u, f, *, method: str, sweeps: int,
                   omega: float):
    """``dispatch.smooth_kernel`` (kernel A, or H on coefficient planes) on
    the block: u and f with a halo as wide as the sweeps' colour phases
    (one exchange each), clipped to the level's rectangle, go to the
    kernel, which holds the window's border fixed; a stale border value
    travels one node per phase, so the block's nodes come back exact, and
    equal to the kernel on the whole level bit for bit. The window's
    colours are the level's: where its origin has odd parity, the colour
    order is swapped. Sweeps beyond what one halo covers take further
    windows, in fp32 for bf16 storage, which is rounded once, as the
    kernel's own passes are."""
    lev = blk.lev
    per = 1 if method == "jacobi" else 2  # halo nodes per sweep
    chunk = max(1, min(sweeps, min(blk.shape) // per))
    dtype = u.dtype
    wide = dtype == torch.bfloat16 and chunk < sweeps
    st = lev.stencil.astype(torch.float32) if wide else lev.stencil
    if wide:
        u, f = u.float(), f.float()
    nowrap = (False, False)  # the gate takes all-Dirichlet levels only
    (ox, oy), (bx, by) = blk.offset, blk.shape
    for done in range(0, sweeps, chunk):
        k = min(chunk, sweeps - done)
        width = per * k
        lo = (max(ox - width, 0), max(oy - width, 0))
        hi = (min(ox + bx + width, lev.grid.nx),
              min(oy + by + width, lev.grid.ny))
        uh, fh = with_halos(mesh, (u, f), blk.names, nowrap, width)
        if hi[0] - lo[0] < 3 or hi[1] - lo[1] < 3:
            continue  # no unknown in the block (the layout's padding)
        win = (slice(lo[0] - ox + width, hi[0] - ox + width),
               slice(lo[1] - oy + width, hi[1] - oy + width))
        glob = (slice(lo[0], hi[0]), slice(lo[1], hi[1]))
        m = method
        if (lo[0] + lo[1]) % 2 and m != "jacobi":
            m = "rbgs" if m == "rbgs_rev" else "rbgs_rev"
        st_win = st if st.scalar else Stencil(
            *(x[glob].contiguous() for x in st.coefs), wrap=st.wrap)
        out = dispatch.smooth_kernel(st_win, uh[win].contiguous(),
                                     fh[win].contiguous(), method=m,
                                     sweeps=k, omega=omega)
        core = (slice(max(ox, lo[0]), min(ox + bx, hi[0])),
                slice(max(oy, lo[1]), min(oy + by, hi[1])))
        u = u.clone()
        u[core[0].start - ox:core[0].stop - ox,
          core[1].start - oy:core[1].stop - oy] = out[
            core[0].start - lo[0]:core[0].stop - lo[0],
            core[1].start - lo[1]:core[1].stop - lo[1]]
    return u.to(dtype)


def smooth_block(mesh, blk: Block, u, f, *, method: str, sweeps: int,
                 omega: float, wrap, overlap: bool = True,
                 backend: str = "torch"):
    """``sweeps`` sweeps of ``method`` on the block, the operations of
    ``ops.dispatch.smooth`` with ``backend``: where its kernel gate passes
    (a point smoother on a 5-point all-Dirichlet rectangle, fp32 or bf16),
    the kernel on a haloed window of the block; else ``ops.smooth.smooth``'s:
    weighted Jacobi or RB-GS ('rbgs_rev': black first) with a halo exchange
    per sweep or colour, a line smoother on slabs of whole lines, or
    Chebyshev (degree 2 * sweeps)."""
    if sweeps > 0 and f.dtype == u.dtype and dispatch.kernel_smooth_ok(
            u, blk.lev, backend, method):
        return _window_smooth(mesh, blk, u, f, method=method, sweeps=sweeps,
                              omega=omega)
    st = blk.st
    if method == "jacobi":
        for _ in range(sweeps):
            r = f - (st.c * u - _nbsum(mesh, blk, u, wrap, overlap))
            u = torch.where(blk.unknown, u + st_mod.divide(omega * r, st.c),
                            u)
        return u
    if method in RBGS + ("rbgs_rev",):
        colours = ((~blk.red, blk.red) if method == "rbgs_rev"
                   else (blk.red, ~blk.red))
        for _ in range(sweeps):
            for colour in colours:
                u_gs = st_mod.divide(f + _nbsum(mesh, blk, u, wrap, overlap),
                                     st.c)
                u = torch.where(colour & blk.unknown, u + omega * (u_gs - u),
                                u)
        return u
    if method == "chebyshev":
        return _chebyshev_block(mesh, blk, u, f, degree=2 * sweeps, wrap=wrap)
    if method in smooth_mod.LINE_METHODS:
        # ADI: along y, then along x; each slab's system built once a call
        axes = {"line_x": (0,), "line_y": (1,), "adi": (1, 0)}[method]
        slabs = [_LineSlab(mesh, blk, axis, u, f) for axis in axes]
        for _ in range(sweeps):
            for slab in slabs:
                u = slab.sweep(u)
        return u
    raise ValueError(f"unknown smoother {method!r}")


# ---------------------------------------------------------------------------
# transfers


def _install_reflection(rh, spec, blk: Block):
    """Reflected values on the haloed residual where it leaves the domain
    (gi = -1 reads gi = 1, gi = nx reads nx - 2; x first, then y): the
    'reflect' restriction of Neumann/Robin rings, blockwise."""
    nx, ny = blk.lev.grid.shape
    (ox, oy), (bx, by) = blk.offset, blk.shape
    gih = (ox - 1 + torch.arange(bx + 2, device=rh.device))[:, None]
    gjh = (oy - 1 + torch.arange(by + 2, device=rh.device))[None, :]
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


def restrict_block(mesh, blk: Block, r, dtype, *, method: str,
                   boundary: str, wrap):
    """Restriction of the block's field onto every node of its
    (bx/2, by/2) coarse half, in ``ops.transfer.restrict``'s order (cast
    to the coarse dtype first): full weighting (centre, edges, corners),
    half weighting (centre, edges) or injection. 'reflect' folds the
    Neumann/Robin rings' windows back; 'inject' copies the coincident fine
    node onto the coarse ring and zeroes the coarse padding (the FMG
    right-hand side); 'zero' leaves the ring to the caller's mask."""
    if method not in transfer.RESTRICTIONS:
        raise ValueError(f"unknown restriction {method!r}")
    bx, by = r.shape
    rh = with_halo(mesh, r, blk.names, wrap)
    if boundary == "reflect":
        rh = _install_reflection(rh, blk.lev.spec, blk)
    rh = rh.to(dtype)

    def win(di, dj):  # fine (2I + di, 2J + dj) for every coarse (I, J)
        return rh[1 + di: 1 + di + bx: 2, 1 + dj: 1 + dj + by: 2]

    if method == "full_weighting":
        fc = (4.0 * win(0, 0)
              + 2.0 * (win(1, 0) + win(-1, 0) + win(0, 1) + win(0, -1))
              + (win(1, 1) + win(-1, 1) + win(1, -1) + win(-1, -1))) / 16.0
    elif method == "half_weighting":
        fc = (4.0 * win(0, 0) + win(1, 0) + win(-1, 0) + win(0, 1)
              + win(0, -1)) / 8.0
    else:
        fc = win(0, 0).contiguous()
    if boundary == "inject":
        gi, gj = blk.gi[0::2] // 2, blk.gj[:, 0::2] // 2
        ncx, ncy = ((n - 1) // 2 + 1 for n in blk.lev.grid.shape)
        ring = (gi == 0) | (gi == ncx - 1) | (gj == 0) | (gj == ncy - 1)
        fc = torch.where(ring, win(0, 0), fc)
        fc = torch.where((gi < ncx) & (gj < ncy), fc,
                         torch.zeros((), dtype=fc.dtype, device=fc.device))
    return fc


def interpolate(c, bx: int, by: int, dtype, method: str = "bilinear"):
    """Prolongation of a (bx/2 + 1, by/2 + 1) coarse window onto the
    (bx, by) fine block it covers, in ``ops.transfer.prolong``'s order:
    bilinear, or injection (coincident nodes copied, the rest zero)."""
    if method not in transfer.PROLONGATIONS:
        raise ValueError(f"unknown prolongation {method!r}")
    c = c.to(dtype)
    if method == "injection":
        out = torch.zeros((bx, by), dtype=dtype, device=c.device)
        out[0::2, 0::2] = c[:-1, :-1]
        return out
    out = torch.empty((bx, by), dtype=dtype, device=c.device)
    out[0::2, 0::2] = c[:-1, :-1]
    out[0::2, 1::2] = 0.5 * (c[:-1, :-1] + c[:-1, 1:])
    out[1::2, 0::2] = 0.5 * (c[:-1, :-1] + c[1:, :-1])
    out[1::2, 1::2] = 0.25 * (c[:-1, :-1] + c[1:, :-1] + c[:-1, 1:]
                              + c[1:, 1:])
    return out


# ---------------------------------------------------------------------------
# the cycle on blocks


class BlockCycle:
    """The multigrid cycle of ``levels`` on this rank's blocks: levels
    [0, S) split by ``tilings`` (one per sharded level, each layout exactly
    twice the next), levels from S on replicated on every rank, where every
    rank runs the single-device cycle under the ``whole`` hook
    redundantly. Fields of a sharded level are its blocks, of a replicated
    one the whole (nx, ny) array. With no tiling (S = 0) every level is
    replicated and the solves are the single-device ones under that
    hook."""

    def __init__(self, mesh: Mesh, levels, tilings, *, overlap: bool = True):
        self.mesh = mesh
        self.levels = tuple(levels)
        self.tilings = tuple(tilings)
        self.S = len(self.tilings)
        self.overlap = overlap
        self.wrap = self.levels[0].spec.wrap
        self.blocks = [make_block(mesh, self.levels[lvl], t)
                       for lvl, t in enumerate(self.tilings)]
        # one rank of each block's replicas adds its block to a norm
        self.primary = primary(mesh, self.tilings[0].names if self.S
                               else ())
        grid = self.levels[0].grid
        self.h = math.prod((grid.hx, grid.hy))
        self._wide: Optional[Block] = None

    # -- layout of level 0 -------------------------------------------------

    def to_blocks(self, x):
        """This rank's level-0 block of a global (nx, ny) field."""
        if self.S == 0:
            return x
        return cut_block(self.mesh, self.tilings[0], self.levels[0].grid, x)

    def gather(self, x):
        """The global (nx, ny) level-0 field from every rank's block, its
        periodic duplicates synced."""
        if self.S == 0:
            return x
        lev0 = self.levels[0]
        out = from_layout(gather_axes(self.mesh, x, self.tilings[0].names),
                          lev0.grid)
        if lev0.sync is not None:
            lev0.sync(out)
        return out

    def zeros(self, lvl: int, dtype=None):
        lev = self.levels[lvl]
        shape = self.blocks[lvl].shape if lvl < self.S else lev.grid.shape
        return torch.zeros(shape, dtype=dtype or lev.dtype, device=lev.device)

    def norm(self, x) -> torch.Tensor:
        """sqrt(hx hy sum x^2) of a level-0 block field, the float64 block
        sums added over the mesh."""
        x64 = x.to(torch.float64)
        s = torch.sum(x64 * x64)
        if not self.primary:
            s = torch.zeros_like(s)
        return torch.sqrt(self.h * self.mesh.psum(s))

    # -- level steps -------------------------------------------------------

    def smooth(self, lvl, u, f, sweeps, method, omega, backend="torch"):
        if sweeps <= 0:
            return u
        return smooth_block(self.mesh, self.blocks[lvl], u, f, method=method,
                            sweeps=sweeps, omega=omega, wrap=self.wrap,
                            overlap=self.overlap, backend=backend)

    def residual(self, lvl, u, f, blk: Optional[Block] = None):
        return residual_block(self.mesh, blk or self.blocks[lvl], u, f,
                              self.wrap)

    def _dropped(self, lvl):
        """Per array axis, the mesh axes level ``lvl`` splits and level
        ``lvl + 1`` does not (a suffix: the coarse split is a prefix)."""
        fine = self.tilings[lvl].names
        coarse = (self.tilings[lvl + 1].names if lvl + 1 < self.S
                  else ((), ()))
        return tuple(f[len(c):] for f, c in zip(fine, coarse))

    def restrict(self, lvl, r, method, boundary):
        """Level ``lvl``'s block field onto level ``lvl + 1``: each rank
        restricts onto its block's coarse half, the halves are gathered
        along the dropped mesh axes (agglomeration), and the result is
        masked onto the coarse unknowns (but for 'inject')."""
        lev_c = self.levels[lvl + 1]
        fc = restrict_block(self.mesh, self.blocks[lvl], r, lev_c.dtype,
                            method=method, boundary=boundary, wrap=self.wrap)
        fc = gather_axes(self.mesh, fc, self._dropped(lvl))
        if lvl + 1 < self.S:
            unknown = self.blocks[lvl + 1].unknown
        else:
            fc = from_layout(fc, lev_c.grid)
            unknown = lev_c.unknown
        if boundary == "inject":
            return fc
        return torch.where(unknown, fc, torch.zeros((), dtype=fc.dtype,
                                                    device=fc.device))

    def prolong(self, lvl, ec, method):
        """Level ``lvl + 1``'s field onto level ``lvl``'s block: the coarse
        block's east/north one-node halo (cyclic on a periodic axis), then
        this block's window of it, interpolated. A replicated coarse field
        is first laid out as one block."""
        bx, by = self.blocks[lvl].shape
        if lvl + 1 < self.S:
            names = self.tilings[lvl + 1].names
        else:
            names = ((), ())
            ec = to_layout(ec, self.levels[lvl + 1].grid,
                           tuple(e // 2 for e in self.tilings[lvl].extent))
        (bot,) = _Exchange(self.mesh, names[0], [(ec[:1, :], -1)],
                           self.wrap[0]).wait()
        ext = torch.cat([ec, bot], dim=0)
        (right,) = _Exchange(self.mesh, names[1], [(ext[:, :1], -1)],
                             self.wrap[1]).wait()
        ext = torch.cat([ext, right], dim=1)
        dx, dy = self._dropped(lvl)
        ox = axis_index(self.mesh, dx) * (bx // 2)
        oy = axis_index(self.mesh, dy) * (by // 2)
        return interpolate(ext[ox:ox + bx // 2 + 1, oy:oy + by // 2 + 1], bx,
                           by, self.levels[lvl].dtype, method)

    # -- cycles ------------------------------------------------------------

    def cycle(self, lvl, u, f, cfg: MultigridConfig, cycle_type: str):
        """``solvers.multigrid._cycle`` from level ``lvl`` under a hook:
        smoothing as ``cfg.backend`` routes it, no tail kernel and no fused
        transfer."""
        levels = self.levels
        if lvl >= self.S:  # replicated: the single-device cycle
            return mg_mod._cycle(levels, u, f, lvl, cfg, cycle_type,
                                 mg_mod.whole)
        if cycle_type not in ("V", "W", "F"):
            raise ValueError(f"unknown cycle {cycle_type!r}")
        be = cfg.backend
        if lvl == len(levels) - 1:
            return self.smooth(lvl, u, f, cfg.coarse_sweeps, "rbgs", 1.0, be)
        u = self.smooth(lvl, u, f, cfg.pre_sweeps, cfg.smoother, cfg.omega,
                        be)
        boundary = "zero" if levels[lvl].spec.plain else "reflect"
        fc = self.restrict(lvl, self.residual(lvl, u, f), cfg.restriction,
                           boundary)
        ec = self.zeros(lvl + 1)
        branch = cycle_type if lvl + 1 < cfg.w_depth else "V"
        if branch == "V":
            ec = self.cycle(lvl + 1, ec, fc, cfg, "V")
        elif branch == "W":
            ec = self.cycle(lvl + 1, ec, fc, cfg, "W")
            ec = self.cycle(lvl + 1, ec, fc, cfg, "W")
        else:  # F: an F-recursion, then a V-recursion
            ec = self.cycle(lvl + 1, ec, fc, cfg, "F")
            ec = self.cycle(lvl + 1, ec, fc, cfg, "V")
        e = self.prolong(lvl, ec, cfg.prolongation)
        u = torch.where(self.blocks[lvl].unknown, u + e, u)
        post = ("rbgs_rev" if cfg.symmetric and cfg.smoother in RBGS
                else cfg.smoother)
        return self.smooth(lvl, u, f, cfg.post_sweeps, post, cfg.omega, be)

    def fmg(self, f, cfg: MultigridConfig, cycles_per_level: int = 1):
        """``solvers.multigrid.fmg`` from level 0's block right-hand side:
        its 'inject' restriction to every level, the coarsest solve, then
        prolongation and cycles upward."""
        levels = self.levels
        rhs = [f.to(levels[0].dtype)]
        for lvl, nxt in enumerate(levels[1:]):
            if lvl < self.S:
                rhs.append(self.restrict(lvl, rhs[-1], cfg.restriction,
                                         "inject"))
            else:
                rhs.append(transfer.restrict(
                    rhs[-1], nxt.grid.nx, nxt.grid.ny,
                    method=cfg.restriction, boundary="inject",
                    dtype=nxt.dtype))
        last = len(levels) - 1
        u = self.cycle(last, self.zeros(last), rhs[-1], cfg, "V")
        for lvl in range(last - 1, -1, -1):
            lev = levels[lvl]
            if lvl < self.S:
                u = self.prolong(lvl, u, cfg.prolongation)
                u = torch.where(self.blocks[lvl].logical, u, torch.zeros(
                    (), dtype=u.dtype, device=u.device))
            else:
                if levels[lvl + 1].sync is not None:
                    levels[lvl + 1].sync(u)
                u = transfer.prolong(u, lev.grid.nx, lev.grid.ny,
                                     method=cfg.prolongation, dtype=lev.dtype)
            for _ in range(cycles_per_level):
                u = self.cycle(lvl, u, rhs[lvl], cfg, cfg.cycle)
        return u

    # -- outer solves ------------------------------------------------------

    def solve(self, f, u0, cfg: MultigridConfig, *, use_fmg: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``mg_solve`` on the blocks: ``f`` and ``u0`` are level-0 blocks,
        the result the global solution on every rank. The stopping test
        reads the float64 norm, summed over the mesh, once per iteration on
        every rank, so every rank takes the same branch."""
        lev0 = self.levels[0]
        if self.S == 0:  # nothing split: the single-device solve, hooked
            return mg_mod.mg_solve(self.levels, f, u0, cfg, use_fmg=use_fmg,
                                   constrain=mg_mod.whole)
        blk = self.blocks[0]
        f = f.to(device=lev0.device, dtype=lev0.dtype)
        u = (self.zeros(0) if u0 is None
             else u0.to(device=lev0.device, dtype=lev0.dtype, copy=True))
        zero = torch.zeros((), dtype=f.dtype, device=f.device)
        fnorm = self.norm(torch.where(blk.unknown, f, zero))
        rnorm0 = self.norm(self.residual(0, u, f))
        tol_eff = mg_mod.tolerance(cfg, torch.maximum(fnorm, rnorm0))
        if use_fmg:
            u = self.fmg(f, cfg)
            rnorm0 = self.norm(self.residual(0, u, f))
        state = {"u": u}

        def step():
            state["u"] = self.cycle(0, state["u"], f, cfg, cfg.cycle)
            return self.norm(self.residual(0, state["u"], f))

        info = mg_mod.outer_iterate(step, rnorm0, tol_eff, fnorm,
                                    cfg.max_iterations)
        return self.gather(state["u"]), info

    def ir_solve(self, f, u0, cfg: MultigridConfig, *, inner_cycles: int = 1,
                 max_outer: int = 100, use_fmg: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``refinement.ir_solve`` on the blocks: the float64 solution and
        residual live in level-0 blocks, the residual on the float64-widened
        level-0 stencil's blocks; each outer step's norm is one all_reduce
        of float64 block sums. Returns the global solution on every
        rank."""
        lev0 = self.levels[0]
        if self.S == 0:
            return refinement.ir_solve(self.levels, f, u0, cfg,
                                       inner_cycles=inner_cycles,
                                       max_outer=max_outer, use_fmg=use_fmg,
                                       constrain=mg_mod.whole)
        f64, lo = torch.float64, lev0.dtype
        blk = self.blocks[0]
        if self._wide is None:
            self._wide = make_block(self.mesh, lev0, self.tilings[0],
                                    lev0.stencil.astype(f64))
        wide = self._wide
        f = f.to(device=lev0.device, dtype=f64)
        u = (self.zeros(0, f64) if u0 is None
             else u0.to(device=lev0.device, dtype=f64, copy=True))
        fnorm = self.norm(torch.where(blk.unknown, f, torch.zeros(
            (), dtype=f64, device=f.device)))
        tol_eff = mg_mod.tolerance(cfg, torch.maximum(
            fnorm, self.norm(self.residual(0, u, f, wide))))
        if use_fmg:
            u = u + self.fmg(f.to(lo), cfg).to(f64)
        state = {"u": u, "r": self.residual(0, u, f, wide)}

        def step():
            e = self.zeros(0)
            r_lo = state["r"].to(lo)
            for _ in range(inner_cycles):
                e = self.cycle(0, e, r_lo, cfg, cfg.cycle)
            u = torch.where(blk.unknown, state["u"] + e.to(f64), state["u"])
            state["u"] = u
            state["r"] = self.residual(0, u, f, wide)
            return self.norm(state["r"])

        info = mg_mod.outer_iterate(step, self.norm(state["r"]), tol_eff,
                                    fnorm, max_outer)
        info["method"] = "iterative_refinement"
        return self.gather(state["u"]), info
