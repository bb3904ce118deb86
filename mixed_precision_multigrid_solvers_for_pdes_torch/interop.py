"""Carry state between the JAX package and this port as numpy arrays.

The JAX package stores every 2D field padded to (16, 128) tiles, and every 3D
field padded to an even x, y to a multiple of 16 and z to a multiple of 128,
with the logical region at the origin, and each 2D parity plane padded to
(8, 128) tiles; this port stores the logical region only.
These helpers read JAX objects through their attributes and ``numpy`` (JAX
arrays convert with ``np.asarray``), so this module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.bc import SIDES, BCKind, BCSide, BoundarySpec
from .core.bc3d import BoundarySpec3D
from .core.grid import Grid
from .core.grid3d import Grid3D
from .core.precision import as_dtype
from .models.problems import Problem
from .models.problems3d import Problem3D
from .ops.planes import plane_shape
from .ops.stencil import Stencil
from .ops.stencil3d import Stencil3D
from .solvers.multigrid import Level
from .solvers.multigrid3d import Level3D

JAX_TILE = (16, 128)  # the JAX package's storage tile (sublane, lane)
JAX_TILE3D = (2, 16, 128)  # its 3D rounding of (x, y, z)


def jax_padded_shape(nx: int, ny: int):
    """The JAX package's storage shape for a logical (nx, ny) grid."""
    return tuple(-(-n // t) * t for n, t in zip((nx, ny), JAX_TILE))


def grid_from_jax(g) -> Grid:
    return Grid(int(g.nx), int(g.ny), tuple(float(x) for x in g.domain))


def stencil_from_jax(st, grid=None, *, device="cpu") -> Stencil:
    """Port Stencil from a JAX Stencil: 0-d leaves become floats; padded
    2-d leaves (coefficient planes) become (nx, ny) tensors of their dtype
    on ``device``, which needs the ``grid``."""
    if type(st).__name__ != "Stencil":
        raise NotImplementedError("the 9-point Galerkin stencil is not "
                                  "ported yet (ROADMAP item 10)")
    vals = [np.asarray(getattr(st, k)) for k in ("c", "w", "e", "s", "n")]
    if not any(v.ndim for v in vals):
        return Stencil(*(float(v) for v in vals))
    return Stencil(*(field_from_jax(np.broadcast_to(v, grid.shape_padded),
                                    grid, device=device) for v in vals))


def spec_from_jax(spec) -> BoundarySpec:
    """Port BoundarySpec from a JAX one with whole-side conditions."""
    sides = {}
    for name in SIDES:
        s = spec.side(name)
        sides[name] = BCSide(kind=BCKind(s.kind.value), alpha=s.alpha,
                             beta=s.beta, segments=tuple(s.segments))
    return BoundarySpec(**sides)


def levels_from_jax(levels, *, device="cpu"):
    """Port hierarchy from a tuple of JAX Levels on rectangles."""
    out = []
    for lev in levels:
        if getattr(lev, "domain", None):
            raise NotImplementedError("irregular domains are not ported yet "
                                      "(ROADMAP item 8)")
        out.append(Level(stencil=stencil_from_jax(lev.stencil, lev.grid,
                                                  device=device),
                         grid=grid_from_jax(lev.grid),
                         spec=spec_from_jax(lev.spec),
                         dtype=as_dtype(np.dtype(lev.dtype)),
                         device=torch.device(device)))
    return tuple(out)


def field_from_jax(arr, grid, *, dtype=None, device="cpu") -> torch.Tensor:
    """(nx, ny) tensor from a padded JAX field (or any array whose logical
    region sits at the origin)."""
    a = np.asarray(arr)[: grid.nx, : grid.ny]
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def field_to_jax_layout(t: torch.Tensor, grid) -> np.ndarray:
    """Zero-padded numpy array in the JAX package's storage shape."""
    a = t.detach().cpu().numpy()
    if a.shape != (grid.nx, grid.ny):
        raise ValueError(f"field shape {a.shape} != grid shape "
                         f"{(grid.nx, grid.ny)}")
    out = np.zeros(jax_padded_shape(grid.nx, grid.ny), dtype=a.dtype)
    out[: grid.nx, : grid.ny] = a
    return out


def jax_plane_shape(nx: int, ny: int):
    """The JAX package's (hx, hy) storage shape of one parity plane: half
    its padded field, rounded up to its (8, 128) plane tile."""
    px, py = jax_padded_shape(nx, ny)
    return tuple(-(-(p // 2) // t) * t for p, t in zip((px, py), (8, 128)))


def planes_from_jax(arr, grid, *, dtype=None, device="cpu") -> torch.Tensor:
    """(4, hx, hy) parity planes from JAX (4, hx_pad, hy_pad) planes: the
    logical region at each plane's origin."""
    hx, hy = plane_shape(grid.shape)
    a = np.asarray(arr)[:, :hx, :hy]
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def planes_to_jax_layout(t: torch.Tensor, grid) -> np.ndarray:
    """Zero-padded numpy planes in the JAX package's plane storage shape
    (the inverse of ``planes_from_jax``)."""
    a = t.detach().cpu().numpy()
    if a.shape != (4, *plane_shape(grid.shape)):
        raise ValueError(f"planes shape {a.shape} != (4, hx, hy) of grid "
                         f"{(grid.nx, grid.ny)}")
    out = np.zeros((4, *jax_plane_shape(grid.nx, grid.ny)), dtype=a.dtype)
    out[:, : a.shape[1], : a.shape[2]] = a
    return out


def problem_from_jax(prob) -> Problem:
    """Port Problem (f, a, lam, Dirichlet values, Neumann/Robin data g,
    exact solution) from a JAX one on a rectangle. Array data are sliced to
    the logical region; scalars stay scalars."""
    if prob.domain is not None:
        raise NotImplementedError("irregular domains are not ported yet "
                                  "(ROADMAP item 8)")
    g = grid_from_jax(prob.grid)

    def host(a):
        if a is None or np.ndim(a) == 0:
            return a if a is None else float(a)
        return np.asarray(a, np.float64)[: g.nx, : g.ny].copy()

    bc_values = (None if prob.bc_values is None
                 else {k: host(v) for k, v in prob.bc_values.items()})
    return Problem(name=prob.name, grid=g, spec=spec_from_jax(prob.spec),
                   f=host(prob.f), a=host(prob.a), lam=host(prob.lam),
                   dirichlet_values=host(prob.dirichlet_values),
                   bc_values=bc_values, exact=host(prob.exact))


# ---------------------------------------------------------------------------
# 3D


def jax_padded_shape3d(nx: int, ny: int, nz: int):
    """The JAX package's storage shape for a logical (nx, ny, nz) grid."""
    return tuple(-(-n // t) * t for n, t in zip((nx, ny, nz), JAX_TILE3D))


def grid3d_from_jax(g) -> Grid3D:
    return Grid3D(int(g.nx), int(g.ny), int(g.nz),
                  tuple(float(x) for x in g.domain))


def stencil3d_from_jax(st) -> Stencil3D:
    """Port Stencil3D from a JAX Stencil3D with 0-d leaves."""
    vals = [np.asarray(getattr(st, k, None)) for k in "cwesnbt"]
    if any(v.ndim for v in vals):
        raise NotImplementedError("variable-coefficient and 27-point 3D "
                                  "stencils are not ported yet (ROADMAP "
                                  "items 10 and 13)")
    return Stencil3D(*(float(v) for v in vals))


def levels3d_from_jax(levels, *, device="cpu"):
    """Port 3D hierarchy from a tuple of JAX Level3Ds (all-Dirichlet
    only)."""
    out = []
    for lev in levels:
        if not lev.spec.all_dirichlet:
            raise NotImplementedError("only all-Dirichlet boxes are ported "
                                      "yet (ROADMAP item 13)")
        out.append(Level3D(stencil=stencil3d_from_jax(lev.stencil),
                           grid=grid3d_from_jax(lev.grid),
                           spec=BoundarySpec3D(),
                           dtype=as_dtype(np.dtype(lev.dtype)),
                           device=torch.device(device)))
    return tuple(out)


def field3d_from_jax(arr, grid, *, dtype=None, device="cpu") -> torch.Tensor:
    """(nx, ny, nz) tensor from a padded JAX field (or any array whose
    logical region sits at the origin)."""
    a = np.asarray(arr)[: grid.nx, : grid.ny, : grid.nz]
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def field3d_to_jax_layout(t: torch.Tensor, grid) -> np.ndarray:
    """Zero-padded numpy array in the JAX package's 3D storage shape."""
    a = t.detach().cpu().numpy()
    if a.shape != tuple(grid.shape):
        raise ValueError(f"field shape {a.shape} != grid shape "
                         f"{tuple(grid.shape)}")
    out = np.zeros(jax_padded_shape3d(*a.shape), dtype=a.dtype)
    out[: grid.nx, : grid.ny, : grid.nz] = a
    return out


def problem3d_from_jax(prob) -> Problem3D:
    """Port Problem3D (f, lam, Dirichlet values, exact solution) from a JAX
    one."""
    if not prob.spec.all_dirichlet or prob.a is not None \
            or np.ndim(prob.lam) or prob.bc_values:
        raise NotImplementedError("only constant-coefficient all-Dirichlet "
                                  "3D problems are ported yet (ROADMAP item "
                                  "13)")
    g = grid3d_from_jax(prob.grid)

    def host(a):
        return None if a is None else np.asarray(
            a, np.float64)[: g.nx, : g.ny, : g.nz].copy()

    return Problem3D(name=prob.name, grid=g, f=host(prob.f),
                     lam=float(prob.lam), exact=host(prob.exact),
                     dirichlet_values=host(prob.dirichlet_values))
