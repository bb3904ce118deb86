"""Carry state between the JAX package and this port as numpy arrays.

The JAX package stores every 2D field padded to (16, 128) tiles, and every 3D
field padded to an even x, y to a multiple of 16 and z to a multiple of 128,
with the logical region at the origin, and each 2D parity plane padded to
(8, 128) tiles; this port stores the logical region only.
These helpers read JAX objects through their attributes and ``numpy`` (JAX
arrays convert with ``np.asarray``), so this module never imports JAX.
numpy has no bf16 of its own: bf16 data come across through float32, which
holds every bf16 value exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.bc import SIDES, BCKind, BCSegment, BCSide, BoundarySpec
from .core.bc3d import SIDES3D, BoundarySpec3D
from .core.domain import LShapedDomain
from .core.grid import Grid
from .core.grid3d import Grid3D
from .core.precision import Precision, PrecisionPolicy, as_dtype
from .applications import heat3d as heat3d_mod, heat_problems
from .applications.heat import HeatConfig, HeatProblem
from .applications.heat3d import HeatProblem3D
from .models.problems import Problem
from .models.problems3d import Problem3D
from .ops.planes import plane_shape
from .ops.stencil import _S9_FIELDS, Stencil, Stencil9
from .ops.stencil3d import Stencil27, Stencil3D
from .solvers.multigrid import Level, MultigridConfig
from .solvers.multigrid3d import Level3D

JAX_TILE = (16, 128)  # the JAX package's storage tile (sublane, lane)
JAX_TILE3D = (2, 16, 128)  # its 3D rounding of (x, y, z)


def jax_padded_shape(nx: int, ny: int):
    """The JAX package's storage shape for a logical (nx, ny) grid."""
    return tuple(-(-n // t) * t for n, t in zip((nx, ny), JAX_TILE))


def grid_from_jax(g) -> Grid:
    return Grid(int(g.nx), int(g.ny), tuple(float(x) for x in g.domain))


def stencil_from_jax(st, grid=None, *, device="cpu",
                     wrap=(False, False)):
    """Port Stencil or Stencil9 from a JAX one: 0-d leaves become floats;
    padded 2-d leaves (coefficient planes) become (nx, ny) tensors of their
    dtype on ``device``, which needs the ``grid``. ``wrap`` holds the
    periodic axes of the level's spec (JAX stencils carry them in their
    padding); a Stencil9 never wraps."""
    if type(st).__name__ == "Stencil9":
        if any(wrap):
            raise ValueError("a 9-point stencil takes no periodic axis")
        return Stencil9(*(field_from_jax(np.asarray(getattr(st, k)), grid,
                                         device=device)
                          for k in _S9_FIELDS))
    if type(st).__name__ != "Stencil":
        raise ValueError(f"unknown stencil {type(st).__name__!r}")
    vals = [np.asarray(getattr(st, k)) for k in ("c", "w", "e", "s", "n")]
    if not any(v.ndim for v in vals):
        return Stencil(*(float(v) for v in vals), wrap=tuple(wrap))
    return Stencil(*(field_from_jax(np.broadcast_to(v, grid.shape_padded),
                                    grid, device=device) for v in vals),
                   wrap=tuple(wrap))


def spec_from_jax(spec) -> BoundarySpec:
    """Port BoundarySpec from a JAX one, segments and periodic sides
    included."""
    sides = {}
    for name in SIDES:
        s = spec.side(name)
        segments = tuple(BCSegment(lo=g.lo, hi=g.hi, kind=BCKind(g.kind.value),
                                   alpha=g.alpha, beta=g.beta)
                         for g in s.segments)
        sides[name] = BCSide(kind=BCKind(s.kind.value), alpha=s.alpha,
                             beta=s.beta, segments=segments)
    return BoundarySpec(**sides)


def domain_from_jax(domain):
    """Port domain from a JAX one (None stays None)."""
    if domain is None:
        return None
    if type(domain).__name__ != "LShapedDomain":
        raise ValueError(f"unknown domain {domain!r}")
    return LShapedDomain(float(domain.x_cut), float(domain.y_cut))


def policy_from_jax(pol) -> PrecisionPolicy:
    """Port PrecisionPolicy from a JAX one, thresholds included."""
    fields = {f.name: getattr(pol, f.name)
              for f in dataclasses.fields(PrecisionPolicy)}
    for name in ("mode", "fine", "coarse"):
        fields[name] = Precision(fields[name].value)
    return PrecisionPolicy(**fields)


def levels_from_jax(levels, *, device="cpu"):
    """Port hierarchy from a tuple of JAX Levels, with their domains and
    per-level dtypes (bf16 included)."""
    out = []
    for lev in levels:
        spec = spec_from_jax(lev.spec)
        out.append(Level(stencil=stencil_from_jax(lev.stencil, lev.grid,
                                                  device=device,
                                                  wrap=spec.wrap),
                         grid=grid_from_jax(lev.grid),
                         spec=spec,
                         dtype=as_dtype(np.dtype(lev.dtype).name),
                         device=torch.device(device),
                         domain=domain_from_jax(getattr(lev, "domain",
                                                        None))))
    return tuple(out)


def field_from_jax(arr, grid, *, dtype=None, device="cpu") -> torch.Tensor:
    """(nx, ny) tensor from a padded JAX field (or any array whose logical
    region sits at the origin); a bf16 field stays bf16 unless ``dtype``
    says otherwise."""
    a = np.asarray(arr)[: grid.nx, : grid.ny]
    return _host_tensor(np.ascontiguousarray(a), device, dtype)


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
    exact solution, domain, expected order) from a JAX one, with segmented
    or periodic sides. Array data are sliced to the logical region (which
    drops a periodic field's wrap line in the padding); scalars stay
    scalars."""
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
                   bc_values=bc_values, exact=host(prob.exact),
                   domain=domain_from_jax(prob.domain),
                   expected_order=float(prob.expected_order))


# ---------------------------------------------------------------------------
# 3D


def jax_padded_shape3d(nx: int, ny: int, nz: int):
    """The JAX package's storage shape for a logical (nx, ny, nz) grid."""
    return tuple(-(-n // t) * t for n, t in zip((nx, ny, nz), JAX_TILE3D))


def grid3d_from_jax(g) -> Grid3D:
    return Grid3D(int(g.nx), int(g.ny), int(g.nz),
                  tuple(float(x) for x in g.domain))


def stencil3d_from_jax(st, grid=None, *, device="cpu",
                       wrap=(False, False, False)):
    """Port Stencil3D or Stencil27 from a JAX one: 0-d leaves become
    floats; padded 3-d leaves (coefficient fields) become (nx, ny, nz)
    tensors of their dtype on ``device``, which needs the ``grid``; a
    Stencil27's ``off`` becomes (26, nx, ny, nz). ``wrap`` holds the
    periodic axes of the level's spec; a Stencil27 never wraps."""
    if type(st).__name__ == "Stencil27":
        if any(wrap):
            raise ValueError("a 27-point stencil takes no periodic axis")
        off = np.asarray(st.off)[:, : grid.nx, : grid.ny, : grid.nz]
        return Stencil27(field3d_from_jax(np.asarray(st.c), grid,
                                          device=device),
                         _host_tensor(np.ascontiguousarray(off), device))
    if type(st).__name__ != "Stencil3D":
        raise ValueError(f"unknown 3D stencil {type(st).__name__!r}")
    vals = [np.asarray(getattr(st, k)) for k in "cwesnbt"]
    if not any(v.ndim for v in vals):
        return Stencil3D(*(float(v) for v in vals), wrap=tuple(wrap))
    return Stencil3D(*(field3d_from_jax(
        np.broadcast_to(v, grid.shape_padded), grid, device=device)
        for v in vals), wrap=tuple(wrap))


def spec3d_from_jax(spec) -> BoundarySpec3D:
    """Port BoundarySpec3D from a JAX one."""
    return BoundarySpec3D(**{
        name: BCSide(kind=BCKind(spec.side(name).kind.value),
                     alpha=spec.side(name).alpha, beta=spec.side(name).beta)
        for name in SIDES3D})


def levels3d_from_jax(levels, *, device="cpu"):
    """Port 3D hierarchy from a tuple of JAX Level3Ds, with their specs,
    coefficient fields, 27-point levels and per-level dtypes (bf16
    included)."""
    out = []
    for lev in levels:
        spec = spec3d_from_jax(lev.spec)
        out.append(Level3D(stencil=stencil3d_from_jax(lev.stencil, lev.grid,
                                                      device=device,
                                                      wrap=spec.wrap),
                           grid=grid3d_from_jax(lev.grid), spec=spec,
                           dtype=as_dtype(np.dtype(lev.dtype).name),
                           device=torch.device(device)))
    return tuple(out)


def _host_tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A tensor of numpy data; bf16 data (which numpy holds as ml_dtypes)
    come across through float32 and stay bf16 unless ``dtype`` says
    otherwise."""
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32), device=device).to(
            dtype or torch.bfloat16)
    return torch.as_tensor(a, dtype=dtype, device=device)


def field3d_from_jax(arr, grid, *, dtype=None, device="cpu") -> torch.Tensor:
    """(nx, ny, nz) tensor from a padded JAX field (or any array whose
    logical region sits at the origin); a bf16 field stays bf16 unless
    ``dtype`` says otherwise."""
    a = np.asarray(arr)[: grid.nx, : grid.ny, : grid.nz]
    return _host_tensor(np.ascontiguousarray(a), device, dtype)


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
    """Port Problem3D (f, a, lam, Dirichlet values, Neumann/Robin data g,
    exact solution) from a JAX one, whatever its faces. Array data are
    sliced to the logical region; scalars stay scalars."""
    g = grid3d_from_jax(prob.grid)

    def host(a):
        if a is None or np.ndim(a) == 0:
            return a if a is None else float(a)
        return np.asarray(a, np.float64)[: g.nx, : g.ny, : g.nz].copy()

    bc_values = (None if prob.bc_values is None
                 else {k: host(v) for k, v in prob.bc_values.items()})
    return Problem3D(name=prob.name, grid=g, spec=spec3d_from_jax(prob.spec),
                     f=host(prob.f), a=host(prob.a), lam=host(prob.lam),
                     exact=host(prob.exact),
                     dirichlet_values=host(prob.dirichlet_values),
                     bc_values=bc_values)


# ---------------------------------------------------------------------------
# heat equations


# the JAX package's backends -> the port's: its XLA path is the plain one
BACKEND_FROM_JAX = {"auto": "auto", "pallas": "auto", "xla": "torch"}


def mg_config_from_jax(cfg) -> MultigridConfig:
    """Port MultigridConfig from a JAX one: the fields both have, the
    backend mapped by ``BACKEND_FROM_JAX``."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(MultigridConfig)
              if hasattr(cfg, f.name)}
    fields["backend"] = BACKEND_FROM_JAX[cfg.backend]
    return MultigridConfig(**fields)


def heat_config_from_jax(cfg) -> HeatConfig:
    """Port HeatConfig from a JAX one, its MultigridConfig included; the
    dtype goes across by name."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(HeatConfig)}
    fields["mg"] = mg_config_from_jax(cfg.mg)
    fields["dtype"] = as_dtype(np.dtype(cfg.dtype).name)
    return HeatConfig(**fields)


def _catalogue_factory(name: str, catalogue: dict, by_name: dict):
    if name not in by_name:
        raise ValueError(f"no port problem for the JAX heat problem "
                         f"{name!r}; known: {sorted(by_name)}")
    return catalogue[by_name[name]]


def heat_problem_from_jax(prob) -> HeatProblem:
    """Port HeatProblem from a JAX catalogue problem: grid, alpha, spec,
    ``u0`` and ``a`` (padded -> logical, host float64) come across; the
    callables (written in jnp) are the port's own, from
    ``heat_problems.CATALOGUE`` by the problem's name at the same alpha
    (a factory's other parameters take their defaults). Raises for a name
    the catalogue does not hold."""
    make = _catalogue_factory(prob.name, heat_problems.CATALOGUE,
                              heat_problems.BY_NAME)
    g = grid_from_jax(prob.grid)
    if g.nx != g.ny or g.domain != (0.0, 1.0, 0.0, 1.0):
        raise ValueError(f"the heat catalogue builds unit squares, not "
                         f"{g}")

    def host(a):
        return None if a is None else np.asarray(
            a, np.float64)[: g.nx, : g.ny].copy()

    port = make(g.nx, alpha=float(prob.alpha))
    return dataclasses.replace(port, spec=spec_from_jax(prob.spec),
                               u0=host(prob.u0), a=host(prob.a))


HEAT3D_BY_NAME = {"heat3d_source": "heat_source3d",
                  "heat3d_oscillating": "oscillating3d",
                  "heat3d_pure_diffusion": "pure_diffusion3d"}


def heat_problem3d_from_jax(prob) -> HeatProblem3D:
    """Port HeatProblem3D from one of the JAX package's three 3D heat
    problems, as ``heat_problem_from_jax`` does in 2D."""
    make = _catalogue_factory(
        prob.name, {v: getattr(heat3d_mod, v)
                    for v in HEAT3D_BY_NAME.values()}, HEAT3D_BY_NAME)
    g = grid3d_from_jax(prob.grid)
    if not g.nx == g.ny == g.nz or g.domain != (0.0, 1.0) * 3:
        raise ValueError(f"the 3D heat problems are unit cubes, not {g}")
    port = make(g.nx, alpha=float(prob.alpha))
    u0 = None if prob.u0 is None else np.asarray(
        prob.u0, np.float64)[: g.nx, : g.ny, : g.nz].copy()
    a = None if prob.a is None else np.asarray(
        prob.a, np.float64)[: g.nx, : g.ny, : g.nz].copy()
    return dataclasses.replace(port, u0=u0, a=a)
