"""3D levels split over a mesh of ranks into (x, y) blocks of whole
z-lines, and the 3D multigrid cycle run on them: the block machinery of
``make_constrainer3d``.

The JAX package's 3D rule (its ``parallel/mesh.py`` ``grid_sharding3d``)
splits x and y over the mesh and keeps z local, so every z-line, the
direction ``line_z`` solves along, stays on one device. Here a 3D block is
(bx, by, nz): the x and y tilings are the 2D ones (``blocks.Tiling``, the
layouts of ``distributed.make_tilings``), halos cross the mesh in x and y
only (``blocks.with_halos`` carries whole z-lines), and z is handled on
the block as the single-device operators handle it (zero planes around a
tensor stencil, wrap planes on a periodic z axis).

On the blocks run, operation for operation as ``ops/stencil3d.py``,
``ops/smooth3d.py`` and ``ops/transfer3d.py`` compute them on the whole
level:

- the neighbour sums of a ``Stencil3D`` (scalar or coefficient fields) and
  of a ``Stencil27`` (the x-then-y halo stages bring the edge nodes along),
  the residual and the operator;
- weighted Jacobi, RB-GS/SOR (colour by global index parity) and the zebra
  ``line_z`` smoother (each z-line solved whole on its block, the x/y
  couplings read across the halo); where ``ops.dispatch``'s E gate passes
  (backend 'auto', RB-GS on a scalar 7-point all-Dirichlet level, fp32 or
  bf16), kernel E on a haloed window (``_window_smooth3d``);
- full-weighting and injection restriction ('zero', and 'reflect' with the
  Neumann/Robin fold, x, y and z alike) and trilinear prolongation.

``BlockCycle3D`` is ``blocks.BlockCycle`` with these operators and the
JAX package's ``_cycle3`` (V and W; an F-cycle is a V-cycle): levels
[0, S) on blocks, the rest replicated, where every rank runs the
single-device 3D cycle under the ``whole`` hook (no fused transfer,
smoothing dispatched). Its solves are ``mg_solve3d`` and ``ir_solve3d``
with the float64 outer state on the blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..core import bc3d
from ..core.bc import BCKind
from ..ops import dispatch, smooth3d as sm3, transfer3d
from ..ops.cuda_kernels import smooth3d as k_smooth3d
from ..ops.smooth import RBGS_METHODS
from ..ops.stencil import divide
from ..ops.stencil3d import OFFSETS27, Stencil3D, Stencil27
from ..solvers import multigrid as mg_mod, multigrid3d as mg3
from . import blocks as bk
from .mesh import Mesh

RBGS = RBGS_METHODS + ("rbgs_rev",)


@dataclasses.dataclass
class Block3D:
    """What a rank needs of one sharded 3D level: its tiling's names, the
    block's offset in the layout, its stencil leaves, unknowns, colours
    (red: i + j + k even; ``even``: the z-lines of even i + j) and logical
    nodes (``extent``: the layout's, along x and y)."""

    lev: Any
    names: Tuple[bk.Names, bk.Names]
    extent: Tuple[int, int]
    offset: Tuple[int, int]
    st: Any
    unknown: torch.Tensor
    red: torch.Tensor
    even: torch.Tensor    # (bx, by, 1)
    logical: torch.Tensor

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.unknown.shape)

    @property
    def slices(self) -> Tuple[slice, slice]:
        """The block's part of the layout (x and y)."""
        return tuple(slice(o, o + b) for o, b in zip(self.offset,
                                                     self.shape[:2]))


def unknown_at3d(spec, grid, gi, gj, gk):
    """``bc3d.unknown_mask3d`` at global indices (broadcasting index
    tensors): nodes past the logical extent are fixed."""
    mask = (gi < grid.nx) & (gj < grid.ny)
    for idx, n, (lo, hi) in zip((gi, gj, gk), grid.shape, bc3d._PAIRS):
        if spec.side(lo).kind == BCKind.PERIODIC:
            mask = mask & (idx < n - 1)
            continue
        if spec.side(lo).kind == BCKind.DIRICHLET:
            mask = mask & (idx > 0)
        if spec.side(hi).kind == BCKind.DIRICHLET:
            mask = mask & (idx < n - 1)
    return mask


def block_stencil3d(st, grid, extent, slices):
    """A block of a 3D level's stencil: scalar leaves as they are, fields
    (a ``Stencil27``'s 26 couplings each) cut from their layout."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        return bk.to_layout(x, grid, extent)[slices].contiguous()

    if isinstance(st, Stencil27):
        return Stencil27(leaf(st.c), torch.stack([leaf(x) for x in st.off]))
    return Stencil3D(*(leaf(x) for x in st.coefs), wrap=st.wrap)


def make_block3d(mesh: Mesh, lev, tiling: bk.Tiling, stencil=None
                 ) -> Block3D:
    """This rank's block of the 3D level ``lev`` under ``tiling`` (whole
    z-lines; ``stencil`` in place of the level's own)."""
    slices = bk.tiling_slices(mesh, tiling)
    (ox, oy) = (s.start for s in slices)
    bx, by = (s.stop - s.start for s in slices)
    nz = lev.grid.nz
    dev = lev.device
    gi = (ox + torch.arange(bx, device=dev)).reshape(-1, 1, 1)
    gj = (oy + torch.arange(by, device=dev)).reshape(1, -1, 1)
    gk = torch.arange(nz, device=dev).reshape(1, 1, -1)
    shape = (bx, by, nz)
    st = lev.stencil if stencil is None else stencil
    return Block3D(
        lev, tiling.names, tiling.extent, (ox, oy),
        block_stencil3d(st, lev.grid, tiling.extent, slices),
        unknown_at3d(lev.spec, lev.grid, gi, gj, gk).expand(
            shape).contiguous(),
        (((gi + gj + gk) & 1) == 0).expand(shape).contiguous(),
        ((gi + gj) & 1) == 0,
        ((gi < lev.grid.nx) & (gj < lev.grid.ny)).expand(shape).contiguous())


# ---------------------------------------------------------------------------
# operators and smoothers on a block


def pad_z(p, wrap_z: bool):
    """One plane below and above along z: zeros, or on a periodic axis the
    wrap neighbours of the unique nodes 0..n-2 (node n-2 below node 0, node
    0 above node n-2; the duplicate n-1, which no update reads, sees node
    1)."""
    if not wrap_z:
        return F.pad(p, (1, 1))
    core = p[..., :-1]
    return torch.cat([core[..., -1:], core, core[..., :2]], dim=2)


def _shifted(p, d):
    return p[tuple(slice(1 + di, p.shape[ax] - 1 + di)
                   for ax, di in enumerate(d))]


def nbsum_ext3d(st, p):
    """The off-diagonal coupling sum on the (bx, by, nz) core of ``p``, a
    block with one halo plane on every side, in
    ``ops.stencil3d.neighbor_sum``'s order."""
    if isinstance(st, Stencil27):
        acc = None
        for i, d in enumerate(OFFSETS27):
            term = st.off[i] * _shifted(p, d)
            acc = term if acc is None else acc + term
        return acc
    return (st.w * _shifted(p, (-1, 0, 0)) + st.e * _shifted(p, (1, 0, 0))
            + st.s * _shifted(p, (0, -1, 0)) + st.n * _shifted(p, (0, 1, 0))
            + st.b * _shifted(p, (0, 0, -1)) + st.t * _shifted(p, (0, 0, 1)))


def nbsum_block3d(mesh, blk: Block3D, u):
    """The neighbour sum of the block: a one-node x/y halo exchange, z
    planes added on the block."""
    wrap = blk.lev.spec.wrap
    uh = bk.with_halo(mesh, u, blk.names, wrap[:2])
    return nbsum_ext3d(blk.st, pad_z(uh, wrap[2]))


def apply_block3d(mesh, blk: Block3D, u):
    """A u on the block (``ops.stencil3d.apply``'s operations; meaningful
    on the unknowns)."""
    return blk.st.c * u - nbsum_block3d(mesh, blk, u)


def residual_block3d(mesh, blk: Block3D, u, f):
    r = f - (blk.st.c * u - nbsum_block3d(mesh, blk, u))
    return torch.where(blk.unknown, r, torch.zeros((), dtype=r.dtype,
                                                   device=r.device))


def _window_smooth3d(mesh, blk: Block3D, u, f, *, sweeps: int, omega: float,
                     reverse: bool):
    """Kernel E (``k_smooth3d.rbgs3d``) on the block: u and f with an
    x/y halo as wide as the sweeps' colour phases (one exchange each) and
    full z extent, clipped to the level's box, go to the kernel, which
    holds the window's border fixed; a stale border value travels one node
    per phase, so the block's nodes come back exact, and equal to E on the
    whole level bit for bit. The window's colours are the level's: where
    x0 + y0 of its origin is odd the colour order is swapped. Sweeps beyond
    what one halo covers take further windows, in fp32 for bf16 storage,
    which is rounded once, as E's own passes are."""
    lev = blk.lev
    (ox, oy), (bx, by, _) = blk.offset, blk.shape
    chunk = max(1, min(sweeps, min(bx, by) // 2))
    dtype = u.dtype
    if dtype == torch.bfloat16 and chunk < sweeps:
        u, f = u.float(), f.float()
    for done in range(0, sweeps, chunk):
        k = min(chunk, sweeps - done)
        width = 2 * k
        lo = (max(ox - width, 0), max(oy - width, 0))
        hi = (min(ox + bx + width, lev.grid.nx),
              min(oy + by + width, lev.grid.ny))
        uh, fh = bk.with_halos(mesh, (u, f), blk.names, (False, False),
                               width)
        if hi[0] - lo[0] < 3 or hi[1] - lo[1] < 3:
            continue  # no unknown in the block (the layout's padding)
        win = (slice(lo[0] - ox + width, hi[0] - ox + width),
               slice(lo[1] - oy + width, hi[1] - oy + width))
        rev = reverse != bool((lo[0] + lo[1]) % 2)
        out = k_smooth3d.rbgs3d(lev.stencil, uh[win].contiguous(),
                                fh[win].contiguous(), sweeps=k, omega=omega,
                                reverse=rev)
        u = u.clone()
        cx = slice(max(ox, lo[0]), min(ox + bx, hi[0]))
        cy = slice(max(oy, lo[1]), min(oy + by, hi[1]))
        u[cx.start - ox:cx.stop - ox, cy.start - oy:cy.stop - oy] = out[
            cx.start - lo[0]:cx.stop - lo[0],
            cy.start - lo[1]:cy.stop - lo[1]]
    return u.to(dtype)


def smooth_block3d(mesh, blk: Block3D, u, f, *, method: str, sweeps: int,
                   omega: float, reverse: bool = False,
                   backend: str = "torch"):
    """``sweeps`` sweeps of ``method`` on the block, the operations of
    ``ops.dispatch.smooth3d`` with ``backend``: kernel E on a haloed window
    where its gate passes, else ``ops.smooth3d.smooth3d``'s weighted
    Jacobi, RB-GS ('rbgs_rev' or ``reverse``: black first) with a halo
    exchange per sweep or colour, or ``line_z`` (each colour's z-lines
    solved whole, their x/y couplings read across a halo)."""
    if sweeps <= 0:
        return u
    if dispatch.kernel_smooth3d_ok(u, blk.lev, backend, method, f):
        return _window_smooth3d(mesh, blk, u, f, sweeps=sweeps, omega=omega,
                                reverse=reverse or method == "rbgs_rev")
    st = blk.st
    if method == "jacobi":
        for _ in range(sweeps):
            r = f - (st.c * u - nbsum_block3d(mesh, blk, u))
            u = torch.where(blk.unknown, u + divide(omega * r, st.c), u)
        return u
    if method in RBGS:
        rev = reverse or method == "rbgs_rev"
        colours = (~blk.red, blk.red) if rev else (blk.red, ~blk.red)
        for _ in range(sweeps):
            for colour in colours:
                u_gs = divide(f + nbsum_block3d(mesh, blk, u), st.c)
                u = torch.where(colour & blk.unknown, u + omega * (u_gs - u),
                                u)
        return u
    if method in sm3.LINE_METHODS:
        system = sm3._line_z_system(st, blk.unknown, u)
        u = u.clone()
        for _ in range(sweeps):
            for lines in (blk.even, ~blk.even):
                sm3._line_z_update(st, u, f, blk.unknown,
                                   lines.expand(u.shape), system,
                                   nb=nbsum_block3d(mesh, blk, u))
        return u
    raise ValueError(f"unknown 3D smoother {method!r}")


# ---------------------------------------------------------------------------
# transfers


def restrict_block3d(mesh, blk: Block3D, r, dtype, *, method: str,
                     boundary: str):
    """``ops.transfer3d.restrict3d`` of the block's field onto every node of
    its (bx/2, by/2, ncz) coarse half, in its order (cast to the coarse
    dtype, the 27 terms in ``RESTRICT_TERMS`` order, divided by 64): the
    fine window around (2I, 2J, 2K) across a one-node x/y halo and z
    planes on the block (wrap neighbours on a periodic axis; 'reflect'
    folds the Neumann/Robin faces' windows back, x, then y, then z). The
    coarse nodes off the core are the caller's to mask."""
    if method not in ("full_weighting", "injection"):
        raise ValueError(f"unknown restriction {method!r}")
    if boundary not in ("zero", "reflect"):
        raise ValueError(f"unknown restriction boundary {boundary!r}")
    spec = blk.lev.spec
    bx, by, nz = r.shape
    rh = bk.with_halo(mesh, r.to(dtype), blk.names, spec.wrap[:2])
    if boundary == "reflect":
        rh = bk.install_reflection(rh, spec, blk)
    p = F.pad(rh, (1, 1))
    if spec.wrap[2]:  # ghost -1 = fine nz-2, ghost nz = fine 1
        p[..., 0], p[..., -1] = p[..., -3], p[..., 2]
    elif boundary == "reflect":  # ghost -1 = 1, ghost nz = nz-2
        p[..., 0], p[..., -1] = p[..., 2], p[..., -3]

    def win(d):  # fine (2I + dx, 2J + dy, 2K + dz) for every coarse node
        return p[1 + d[0]:1 + d[0] + bx:2, 1 + d[1]:1 + d[1] + by:2,
                 1 + d[2]:1 + d[2] + nz:2]

    if method == "injection":
        return win((0, 0, 0)).contiguous()
    acc = None
    for wgt, d in transfer3d.RESTRICT_TERMS:
        term = wgt * win(d)
        acc = term if acc is None else acc + term
    return acc / 64.0


def interpolate3d(c, bx: int, by: int, nz: int, dtype):
    """``ops.transfer3d.prolong3d`` of a (bx/2 + 1, by/2 + 1, ncz) coarse
    window onto the (bx, by, nz) fine block it covers: cast, then linear
    along z, y and x."""
    c = c.to(dtype)
    for axis in (2, 1, 0):
        c = transfer3d._refine_axis(c, axis)
    return c[:bx, :by, :nz]


# ---------------------------------------------------------------------------
# the cycle on blocks


class BlockCycle3D(bk.BlockCycle):
    """The 3D multigrid cycle of ``levels`` on this rank's (x, y) blocks of
    whole z-lines: ``blocks.BlockCycle``'s layouts, agglomeration, norms
    and outer solves, with the 3D operators and ``solvers.multigrid3d``'s
    cycle (V and W; 'F' is a V-cycle, as there)."""

    _make_block = staticmethod(make_block3d)
    _ir_method = "iterative_refinement_3d"

    def __init__(self, mesh: Mesh, levels, tilings):
        super().__init__(mesh, levels, tilings, overlap=False)

    def smooth(self, lvl, u, f, sweeps, method, omega, backend="torch",
               reverse: bool = False):
        return smooth_block3d(self.mesh, self.blocks[lvl], u, f,
                              method=method, sweeps=sweeps, omega=omega,
                              reverse=reverse, backend=backend)

    def residual(self, lvl, u, f, blk=None):
        return residual_block3d(self.mesh, blk or self.blocks[lvl], u, f)

    def _restrict_block(self, lvl, r, dtype, method, boundary):
        return restrict_block3d(self.mesh, self.blocks[lvl], r, dtype,
                                method=method, boundary=boundary)

    def _interpolate(self, lvl, window, method):
        return interpolate3d(window, *self.blocks[lvl].shape,
                             self.levels[lvl].dtype)

    def _coarse(self, lvl, ec):
        if not self.wrap[2]:
            return ec
        ec = ec.clone()  # the z duplicate enters the interpolation
        ec[..., -1] = ec[..., 0]
        return ec

    def cycle(self, lvl, u, f, cfg, cycle_type: str):
        """``solvers.multigrid3d._cycle3`` from level ``lvl`` under a hook:
        smoothing as ``cfg.backend`` routes it (E on the windows), no fused
        transfer."""
        levels = self.levels
        if lvl >= self.S:  # replicated: the single-device cycle
            return mg3._cycle3(levels, u, f, lvl, cfg, cycle_type,
                               mg_mod.whole)
        if cycle_type not in ("V", "W", "F"):
            raise ValueError(f"unknown cycle {cycle_type!r}")
        be = cfg.backend
        if lvl == len(levels) - 1:
            return self.smooth(lvl, u, f, cfg.coarse_sweeps, "rbgs", 1.0, be)
        u = self.smooth(lvl, u, f, cfg.pre_sweeps, cfg.smoother, cfg.omega,
                        be)
        boundary = "zero" if levels[lvl].spec.plain else "reflect"
        fc = self.restrict(lvl, self.residual(lvl, u, f), "full_weighting",
                           boundary)
        branch = cycle_type if lvl + 1 < cfg.w_depth else "V"
        ec = self.cycle(lvl + 1, self.zeros(lvl + 1), fc, cfg, branch)
        if cycle_type == "W" and branch == "W":
            ec = self.cycle(lvl + 1, ec, fc, cfg, "W")
        e = self.prolong(lvl, ec, "trilinear")
        u = torch.where(self.blocks[lvl].unknown, u + e, u)
        return self.smooth(lvl, u, f, cfg.post_sweeps, cfg.smoother,
                           cfg.omega, be,
                           reverse=cfg.symmetric and cfg.smoother in
                           RBGS_METHODS)

    def fmg(self, f, cfg, cycles_per_level: int = 1):
        raise ValueError("the 3D solvers take no FMG start")

    def _single_solve(self, f, u0, cfg, use_fmg):
        return mg3.mg_solve3d(self.levels, f, u0, cfg, constrain=mg_mod.whole)

    def _single_ir(self, f, u0, cfg, inner_cycles, max_outer, use_fmg):
        return mg3.ir_solve3d(self.levels, f, u0, cfg,
                              inner_cycles=inner_cycles, max_outer=max_outer,
                              constrain=mg_mod.whole)
