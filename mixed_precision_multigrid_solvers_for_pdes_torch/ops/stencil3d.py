"""The 7-point operator ``A u = -div(a grad u) + lam*u`` in 3D and the
27-point Galerkin stencil.

Counterpart of ``Stencil3D``, ``Stencil27``, ``OFFSETS27``, ``coupling``,
``make_stencil3d``, ``bc_rhs_correction3d``, ``neighbor_sum``, ``apply``
and ``residual`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/stencil3d.py``:

    A u[i,j,k] = c*u - w*u[i-1] - e*u[i+1] - s*u[j-1] - n*u[j+1]
                     - b*u[k-1] - t*u[k+1]

with 1/h^2 folded into the coefficients. A ``Stencil3D``'s leaves are
either Python floats (constant coefficients with every face Dirichlet or
periodic) or (nx, ny, nz) tensors: the coefficient planes of a coefficient
field ``a``, an array ``lam`` or Neumann/Robin ghost elimination. This is
the 2D design of ``ops/stencil.py`` in three dimensions: a stencil acts on
``region(st, .)``, per axis nodes 0..n-2 with wrap neighbours when the axis
is periodic (``Stencil3D.wrap``; the duplicate node n-1 is never read), else
the interior for a scalar stencil and every node for a tensor stencil,
whose neighbours outside the array read an explicit zero halo, as the JAX
package reads its zero padding. Sums run in the JAX package's order (w, e,
s, n, b, t), so fp32 operators agree bit for bit.

``Stencil27`` (Galerkin coarsening, ``ops/galerkin.py``) holds a diagonal
field ``c`` (nx, ny, nz) and the 26 off-diagonal couplings stacked as
``off`` (26, nx, ny, nz) in ``OFFSETS27`` order:
``A u = c*u - sum_i off[i] * u_{+OFFSETS27[i]}``. It never wraps (Galerkin
refuses periodic specs), acts on every node and reads zero outside the
array; its neighbour sum runs in ``OFFSETS27`` order, as the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import bc3d
from ..core.bc import BCKind
from ..core.bc3d import BoundarySpec3D
from ..core.grid3d import Grid3D
from ..core.precision import as_dtype
from .stencil import _round


@dataclasses.dataclass(frozen=True)
class Stencil3D:
    """7-point stencil. Leaves are all Python floats (values already rounded
    to the level's dtype) or all (nx, ny, nz) tensors of the level's dtype
    and device."""

    c: Any  # centre (diagonal)
    w: Any  # coupling to u[i-1, j, k]
    e: Any  # coupling to u[i+1, j, k]
    s: Any  # coupling to u[i, j-1, k]
    n: Any  # coupling to u[i, j+1, k]
    b: Any  # coupling to u[i, j, k-1]
    t: Any  # coupling to u[i, j, k+1]
    wrap: Tuple[bool, bool, bool] = (False, False, False)  # periodic axes

    @property
    def scalar(self) -> bool:
        return not isinstance(self.c, torch.Tensor)

    def astype(self, dtype) -> "Stencil3D":
        """Round every coefficient to ``dtype`` (exact when widening)."""
        dtype = as_dtype(dtype)
        if self.scalar:
            return Stencil3D(*(_round(x, dtype) for x in self.coefs),
                             wrap=self.wrap)
        return Stencil3D(*(x.to(dtype) for x in self.coefs), wrap=self.wrap)

    @property
    def coefs(self):
        return (self.c, self.w, self.e, self.s, self.n, self.b, self.t)


# the 26 off-centre offsets of a 3x3x3 box, in the JAX package's order
OFFSETS27 = tuple((dx, dy, dz)
                  for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
                  if (dx, dy, dz) != (0, 0, 0))


@dataclasses.dataclass(frozen=True)
class Stencil27:
    """27-point stencil: the diagonal field ``c`` (nx, ny, nz) and the
    couplings ``off`` (26, nx, ny, nz), the same sign convention as
    ``Stencil3D``."""

    c: Any
    off: Any

    wrap = (False, False, False)
    scalar = False

    def astype(self, dtype) -> "Stencil27":
        dtype = as_dtype(dtype)
        return Stencil27(self.c.to(dtype), self.off.to(dtype))


_FACES7 = {(-1, 0, 0): "w", (1, 0, 0): "e", (0, -1, 0): "s",
           (0, 1, 0): "n", (0, 0, -1): "b", (0, 0, 1): "t"}


def coupling(st, d):
    """The coupling leaf toward offset ``d = (dx, dy, dz)``."""
    if isinstance(st, Stencil27):
        return st.off[OFFSETS27.index(d)]
    return getattr(st, _FACES7[d])


def region_slices(st) -> tuple:
    """Per axis, the slice of the nodes ``st`` acts on: 0..n-2 when
    periodic, else the interior for a scalar stencil and every node for a
    tensor stencil."""
    return tuple(slice(0, -1) if w else slice(1, -1) if st.scalar
                 else slice(None) for w in st.wrap)


def region(st, x: torch.Tensor) -> torch.Tensor:
    """The nodes ``st`` acts on, as a view of ``x`` (``region_slices``)."""
    return x[region_slices(st)]


def coef(st, x):
    """A coefficient leaf over ``region(st, .)``: a float as it is, a
    coefficient field as its region's view."""
    return x if st.scalar else region(st, x)


def _halo(st, u: torch.Tensor) -> torch.Tensor:
    """``u`` with one neighbour plane on each side of each axis that the
    stencil's region reads past: the wrap neighbours on a periodic axis
    (nodes n-2 and 0 around the unique nodes 0..n-2), zeros around a tensor
    stencil's other axes."""
    for axis, wrap in enumerate(st.wrap):
        if wrap:
            core = u.narrow(axis, 0, u.shape[axis] - 1)
            u = torch.cat([core.narrow(axis, -1, 1), core,
                           core.narrow(axis, 0, 1)], dim=axis)
    if st.scalar or all(st.wrap):
        return u
    return F.pad(u, [0 if w else 1 for w in st.wrap[::-1] for _ in "lr"])


def _shifted(p: torch.Tensor, d) -> torch.Tensor:
    """p[i+dx, j+dy, k+dz] over the region, for a halo'd ``p``."""
    return p[tuple(slice(1 + di, p.shape[ax] - 1 + di)
                   for ax, di in enumerate(d))]


def neighbor_sum(st, u: torch.Tensor) -> torch.Tensor:
    """w*u[i-1] + e*u[i+1] + s*u[j-1] + n*u[j+1] + b*u[k-1] + t*u[k+1] over
    ``region(st, u)``, or the 26 terms of a ``Stencil27`` in ``OFFSETS27``
    order; a tensor stencil reads zero outside the array, and a periodic
    axis wraps."""
    p = _halo(st, u)
    if isinstance(st, Stencil27):
        acc = None
        for i, d in enumerate(OFFSETS27):
            term = st.off[i] * _shifted(p, d)
            acc = term if acc is None else acc + term
        return acc
    w, e, s, n, b, t = (coef(st, x) for x in st.coefs[1:])
    return (w * _shifted(p, (-1, 0, 0)) + e * _shifted(p, (1, 0, 0))
            + s * _shifted(p, (0, -1, 0)) + n * _shifted(p, (0, 1, 0))
            + b * _shifted(p, (0, 0, -1)) + t * _shifted(p, (0, 0, 1)))


def apply(st, u: torch.Tensor) -> torch.Tensor:
    """A u, shape (nx, ny, nz). Valid on unknown nodes; zero off the
    stencil's region."""
    out = torch.zeros_like(u)
    region(st, out)[...] = (coef(st, st.c) * region(st, u)
                            - neighbor_sum(st, u))
    return out


def residual(st, u: torch.Tensor, f: torch.Tensor,
             unknown: torch.Tensor) -> torch.Tensor:
    """r = f - A u on unknown nodes, zero on fixed nodes; shape
    (nx, ny, nz). A periodic axis reads its wrap neighbours, not the
    duplicate node, so ``u`` needs no sync first."""
    r = torch.zeros_like(f)
    region(st, r)[...] = region(st, f) - (coef(st, st.c) * region(st, u)
                                          - neighbor_sum(st, u))
    return torch.where(unknown, r, torch.zeros((), dtype=r.dtype,
                                               device=r.device))


_FACES = (("west", "hx", "w", "e"), ("east", "hx", "e", "w"),
          ("south", "hy", "s", "n"), ("north", "hy", "n", "s"),
          ("bottom", "hz", "b", "t"), ("top", "hz", "t", "b"))


def _face_terms(grid: Grid3D, spec: BoundarySpec3D, device):
    """(face, BCSide, mask, h, normal coefficient, opposite coefficient) for
    every Neumann/Robin face, in the JAX package's order."""
    for name, h, normal, opposite in _FACES:
        side = spec.side(name)
        if side.kind in (BCKind.NEUMANN, BCKind.ROBIN):
            yield (name, side, bc3d.side_mask3d(name, *grid.shape,
                                                device=device),
                   getattr(grid, h), normal, opposite)


def make_stencil3d(grid: Grid3D, spec: BoundarySpec3D = BoundarySpec3D(), *,
                   a=None, lam: Any = 0.0, dtype=torch.float32,
                   device="cpu") -> Stencil3D:
    """Stencil of ``-div(a grad u) + lam*u`` on ``grid``, in ``dtype``.

    ``a``: (nx, ny, nz) node field or None for a = 1. ``lam``: a scalar or
    an (nx, ny, nz) array. Without ``a``, an array ``lam`` or a
    Neumann/Robin face the leaves are floats; otherwise they are
    (nx, ny, nz) tensors on ``device``. Every value is computed in
    ``dtype`` in the JAX package's order: ``a`` is cast first, faces take
    the harmonic mean 2*a*a_nb/(a + a_nb) (0 where a + a_nb <= 0, and
    outside the domain), Neumann/Robin faces drop the outward coupling and
    double the inward one, Robin adds 2*alpha/(beta*h) to the diagonal, and
    the centre is ``w + e + s + n + b + t + lam (+ Robin)``. On a periodic
    axis the face means wrap (node 0 meets node n-2), as in 2D; the JAX
    package reads its zero padding there.
    """
    spec.validate()
    dtype = as_dtype(dtype)
    ih2 = {h: 1.0 / (getattr(grid, h) ** 2) for h in ("hx", "hy", "hz")}
    if a is None and spec.plain and np.ndim(lam) == 0:
        w = e = torch.tensor(ih2["hx"], dtype=dtype)
        s = n = torch.tensor(ih2["hy"], dtype=dtype)
        b = t = torch.tensor(ih2["hz"], dtype=dtype)
        c = w + e + s + n + b + t + torch.tensor(float(lam), dtype=dtype)
        return Stencil3D(*(x.item() for x in (c, w, e, s, n, b, t)),
                         wrap=spec.wrap)

    shape = grid.shape
    if a is None:
        faces = (torch.tensor(1.0, dtype=dtype, device=device),) * 6
    else:
        a = torch.as_tensor(a, dtype=dtype, device=device)
        ap = F.pad(a, (1, 1, 1, 1, 1, 1))
        for axis, wrap in enumerate(spec.wrap):
            if wrap:  # ghost 0 = node n-2; nodes n-1 and the ghost = 0, 1
                lo = [slice(1, -1)] * 3
                lo[axis] = 0
                hi = [slice(1, -1)] * 3
                hi[axis] = slice(-2, None)
                ap[tuple(lo)] = a.select(axis, -2)
                ap[tuple(hi)] = a.index_select(
                    axis, torch.tensor([0, 1], device=device))
        zero = torch.zeros((), dtype=dtype, device=device)

        def face(nb):
            s_ = a + nb
            return torch.where(s_ > 0, 2.0 * a * nb / torch.where(s_ > 0, s_,
                                                                  1.0), zero)

        faces = tuple(face(_shifted(ap, d)) for d in _FACES7)
    ones = torch.ones(shape, dtype=dtype, device=device)
    hs = ("hx", "hx", "hy", "hy", "hz", "hz")
    coefs = {k: ones * (f_ * ih2[h])
             for k, f_, h in zip("wesnbt", faces, hs)}

    robin = torch.zeros(shape, dtype=dtype, device=device)
    for _, side, m, h, normal, opposite in _face_terms(grid, spec, device):
        coefs[opposite] = torch.where(m, 2.0 * coefs[opposite],
                                      coefs[opposite])
        coefs[normal] = torch.where(m, 0.0, coefs[normal])
        if side.kind == BCKind.ROBIN:
            diag = torch.tensor(2.0 * side.alpha / (side.beta * h),
                                dtype=dtype)
            robin = robin + torch.where(m, diag.to(device), 0.0)

    w, e, s, n, b, t = (coefs[k] for k in "wesnbt")
    lam_t = torch.as_tensor(lam, dtype=dtype).to(device)
    c = w + e + s + n + b + t + lam_t + robin
    return Stencil3D(c, w, e, s, n, b, t, wrap=spec.wrap)


def bc_rhs_correction3d(grid: Grid3D, spec: BoundarySpec3D,
                        bc_values: Dict[str, Any], dtype=torch.float32,
                        device="cpu") -> torch.Tensor:
    """Additive right-hand-side term of the Neumann/Robin data g:
    2*g/(beta*h) on each such face's nodes, computed in ``dtype``.
    ``bc_values[face]`` is a scalar or an (nx, ny, nz) array holding g on
    that face."""
    dtype = as_dtype(dtype)
    out = torch.zeros(grid.shape, dtype=dtype, device=device)
    for name, side, m, h, _, _ in _face_terms(grid, spec, device):
        g = torch.as_tensor(bc_values.get(name, 0.0), dtype=dtype).to(device)
        out = out + torch.where(m, 2.0 * g / (side.beta * h), 0.0)
    return out
