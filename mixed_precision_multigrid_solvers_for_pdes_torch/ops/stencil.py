"""The 5-point operator ``A u = -div(a grad u) + lam*u``.

Counterpart of ``Stencil``, ``make_stencil``, ``bc_rhs_correction``,
``neighbor_sum``, ``apply`` and ``residual`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/ops/stencil.py``:

    A u[i,j] = c*u - w*u[i-1,j] - e*u[i+1,j] - s*u[i,j-1] - n*u[i,j+1]

with 1/h^2 folded into the coefficients. A stencil's leaves are either
Python floats (constant coefficients with every side Dirichlet or periodic)
or (nx, ny) tensors, the coefficient planes of a coefficient field ``a``, an
array ``lam`` or Neumann/Robin ghost elimination.

A stencil acts on a region of the nodes (``region``): along a periodic axis
(``Stencil.wrap``) on nodes 0..n-2, whose west/south neighbour of node 0 is
node n-2 and east/north neighbour of node n-2 is node 0, so the duplicate
node n-1 is never read; along any other axis a scalar stencil acts on the
interior 1..n-2 and a tensor stencil on every node, because a Neumann/Robin
ring holds unknowns: the neighbour outside the domain reads an explicit zero
halo, as the JAX package reads its zero padding, and its coupling is zero
there anyway. Sums run in the JAX package's order (w, e, s, n), so fp32
planes and residuals agree bit for bit.

``Stencil9`` adds the four corner couplings; Galerkin coarsening
(``ops/galerkin.py``) produces it. Its leaves are always (nx, ny) tensors
and it never wraps (Galerkin refuses periodic specs), so it acts on every
node and reads zero outside the array. Its neighbour sum keeps the JAX
package's order, (w, e, s, n) first and then the corners, so fp32
residuals agree bit for bit too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import bc as bc_mod
from ..core.bc import BCKind, BoundarySpec
from ..core.grid import Grid
from ..core.precision import as_dtype


def _round(x: float, dtype: torch.dtype) -> float:
    return torch.tensor(x, dtype=dtype).item()


def divide(x: torch.Tensor, c) -> torch.Tensor:
    """x / c, correctly rounded on every device. PyTorch's CUDA division by
    a Python number multiplies by the number's reciprocal rounded to x's
    dtype, which moves the quotient by up to an ulp, always the same way
    for one c: a Gauss-Seidel update (f + nb) / c then converges to the
    solution of a diagonal scaled by (1 + delta), a bias that an fp32 heat
    step (c = 4/h^2 + lam) shows as an l2 error 8x its rounding noise.
    Where c is a power of two (the 2D Poisson levels) the reciprocal is
    exact and the product is the quotient; elsewhere a 0-d tensor on x's
    device divides."""
    if (isinstance(c, torch.Tensor) or x.device.type == "cpu"
            or math.frexp(c)[0] == 0.5):
        return x / c
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class Stencil:
    """5-point stencil. Leaves are all Python floats (values already rounded
    to the level's dtype) or all (nx, ny) tensors of the level's dtype and
    device."""

    c: Any  # centre (diagonal)
    w: Any  # coupling to u[i-1, j]
    e: Any  # coupling to u[i+1, j]
    s: Any  # coupling to u[i, j-1]
    n: Any  # coupling to u[i, j+1]
    wrap: Tuple[bool, bool] = (False, False)  # periodic (x, y) axes

    @property
    def scalar(self) -> bool:
        return not isinstance(self.c, torch.Tensor)

    def astype(self, dtype) -> "Stencil":
        """Round every coefficient to ``dtype`` (exact when widening)."""
        dtype = as_dtype(dtype)
        if self.scalar:
            return Stencil(*(_round(x, dtype) for x in self.coefs),
                           wrap=self.wrap)
        return Stencil(*(x.to(dtype) for x in self.coefs), wrap=self.wrap)

    @property
    def coefs(self):
        return (self.c, self.w, self.e, self.s, self.n)


_S9_FIELDS = ("c", "w", "e", "s", "n", "sw", "se", "nw", "ne")


@dataclasses.dataclass(frozen=True)
class Stencil9:
    """9-point stencil, the same sign convention with corner couplings:
    ``A u = c*u - sum(coef_d * u_{+d})``. Leaves are (nx, ny) tensors of the
    level's dtype and device."""

    c: Any   # centre (diagonal)
    w: Any   # coupling to u[i-1, j]
    e: Any   # coupling to u[i+1, j]
    s: Any   # coupling to u[i, j-1]
    n: Any   # coupling to u[i, j+1]
    sw: Any  # coupling to u[i-1, j-1]
    se: Any  # coupling to u[i+1, j-1]
    nw: Any  # coupling to u[i-1, j+1]
    ne: Any  # coupling to u[i+1, j+1]

    wrap = (False, False)
    scalar = False

    def astype(self, dtype) -> "Stencil9":
        dtype = as_dtype(dtype)
        return Stencil9(*(x.to(dtype) for x in self.coefs))

    @property
    def coefs(self):
        return tuple(getattr(self, k) for k in _S9_FIELDS)


def region(st: Stencil, x: torch.Tensor) -> torch.Tensor:
    """The nodes ``st`` acts on, as a view of ``x``: per axis 0..n-2 when
    periodic, else the interior for a scalar stencil and every node for a
    tensor stencil."""
    return x[tuple(slice(0, -1) if w else slice(1, -1) if st.scalar
                   else slice(None) for w in st.wrap)]


def coef(st: Stencil, x):
    """A coefficient leaf over ``region(st, .)``: a float as it is, a
    coefficient plane as its region's view."""
    return x if st.scalar else region(st, x)


def _halo(st: Stencil, u: torch.Tensor) -> torch.Tensor:
    """``u`` with one neighbour line on each side of each axis that the
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


def neighbor_sum(st: Stencil, u: torch.Tensor) -> torch.Tensor:
    """w*u[i-1,j] + e*u[i+1,j] + s*u[i,j-1] + n*u[i,j+1] over
    ``region(st, u)``, plus sw*u[i-1,j-1] + se*u[i+1,j-1] + nw*u[i-1,j+1]
    + ne*u[i+1,j+1] for a ``Stencil9``; a tensor stencil reads zero outside
    the array, and a periodic axis wraps."""
    p = _halo(st, u)
    w, e, s, n = (coef(st, x) for x in (st.w, st.e, st.s, st.n))
    out = (w * p[:-2, 1:-1] + e * p[2:, 1:-1]
           + s * p[1:-1, :-2] + n * p[1:-1, 2:])
    if isinstance(st, Stencil9):
        out = out + (st.sw * p[:-2, :-2] + st.se * p[2:, :-2]
                     + st.nw * p[:-2, 2:] + st.ne * p[2:, 2:])
    return out


def apply(st: Stencil, u: torch.Tensor) -> torch.Tensor:
    """A u, shape (nx, ny). Valid on unknown nodes; zero off the
    stencil's region."""
    out = torch.zeros_like(u)
    region(st, out)[...] = (coef(st, st.c) * region(st, u)
                            - neighbor_sum(st, u))
    return out


def residual(st: Stencil, u: torch.Tensor, f: torch.Tensor,
             unknown: torch.Tensor) -> torch.Tensor:
    """r = f - A u on unknown nodes, zero on fixed nodes; shape (nx, ny).
    A periodic axis reads its wrap neighbours, not the duplicate node, so
    ``u`` needs no sync first."""
    r = torch.zeros_like(f)
    region(st, r)[...] = region(st, f) - (coef(st, st.c) * region(st, u)
                                          - neighbor_sum(st, u))
    return torch.where(unknown, r, torch.zeros((), dtype=r.dtype,
                                               device=r.device))


def _side_terms(grid: Grid, spec: BoundarySpec, device):
    """(side, BCSide, mask, h, normal coefficient, opposite coefficient) for
    every Neumann/Robin region of a side, in the JAX package's order."""
    for name, h, normal, opposite in (("west", grid.hx, "w", "e"),
                                      ("east", grid.hx, "e", "w"),
                                      ("south", grid.hy, "s", "n"),
                                      ("north", grid.hy, "n", "s")):
        for side, m in bc_mod.side_regions(name, *grid.shape, spec.side(name),
                                           device=device):
            if side.kind in (BCKind.NEUMANN, BCKind.ROBIN):
                yield name, side, m, h, normal, opposite


def make_stencil(grid: Grid, spec: BoundarySpec = BoundarySpec(), *,
                 a=None, lam: Any = 0.0, dtype=torch.float32,
                 device="cpu") -> Stencil:
    """Stencil of ``-div(a grad u) + lam*u`` on ``grid``, in ``dtype``.

    ``a``: (nx, ny) node field or None for a = 1. ``lam``: a scalar or an
    (nx, ny) array. Without ``a``, an array ``lam`` or a Neumann/Robin side
    the leaves are floats; otherwise they are (nx, ny) tensors on
    ``device``. Every value is computed in ``dtype`` in the JAX package's
    order: ``a`` is cast first, faces take the harmonic mean
    2*a*a_nb/(a + a_nb) (0 where a + a_nb <= 0, and outside the domain),
    Neumann/Robin sides drop the outward coupling and double the inward one,
    Robin adds 2*alpha/(beta*h) to the diagonal, and the centre is
    ``w + e + s + n + lam (+ Robin)``. On a periodic axis the face means
    wrap too: node 0 meets node n-2 (the JAX package reads its zero padding
    there, which cuts the seam).
    """
    spec.validate()
    dtype = as_dtype(dtype)
    ihx2 = 1.0 / (grid.hx * grid.hx)
    ihy2 = 1.0 / (grid.hy * grid.hy)
    if a is None and spec.plain and np.ndim(lam) == 0:
        w = e = torch.tensor(ihx2, dtype=dtype)
        s = n = torch.tensor(ihy2, dtype=dtype)
        c = w + e + s + n + torch.tensor(lam, dtype=dtype)
        return Stencil(c=c.item(), w=w.item(), e=e.item(), s=s.item(),
                       n=n.item(), wrap=spec.wrap)

    shape = grid.shape
    if a is None:
        faces = (torch.tensor(1.0, dtype=dtype, device=device),) * 4
    else:
        a = torch.as_tensor(a, dtype=dtype, device=device)
        ap = F.pad(a, (1, 1, 1, 1))
        if spec.wrap[0]:
            ap[0, 1:-1], ap[-2:, 1:-1] = a[-2], a[[0, 1]]
        if spec.wrap[1]:
            ap[:, 0], ap[:, -2:] = ap[:, -3], ap[:, [1, 2]]
        zero = torch.zeros((), dtype=dtype, device=device)

        def face(nb):
            s_ = a + nb
            return torch.where(s_ > 0, 2.0 * a * nb / torch.where(s_ > 0, s_,
                                                                  1.0), zero)

        faces = (face(ap[:-2, 1:-1]), face(ap[2:, 1:-1]),
                 face(ap[1:-1, :-2]), face(ap[1:-1, 2:]))
    ones = torch.ones(shape, dtype=dtype, device=device)
    coefs = dict(zip("wesn", (ones * (f_ * h) for f_, h in
                              zip(faces, (ihx2, ihx2, ihy2, ihy2)))))

    robin = torch.zeros(shape, dtype=dtype, device=device)
    for _, side, m, h, normal, opposite in _side_terms(grid, spec, device):
        coefs[opposite] = torch.where(m, 2.0 * coefs[opposite],
                                      coefs[opposite])
        coefs[normal] = torch.where(m, 0.0, coefs[normal])
        if side.kind == BCKind.ROBIN:
            diag = torch.tensor(2.0 * side.alpha / (side.beta * h),
                                dtype=dtype)
            robin = robin + torch.where(m, diag.to(device), 0.0)

    w, e, s, n = (coefs[k] for k in "wesn")
    lam_t = torch.as_tensor(lam, dtype=dtype).to(device)
    c = w + e + s + n + lam_t + robin
    return Stencil(c=c, w=w, e=e, s=s, n=n, wrap=spec.wrap)


def bc_rhs_correction(grid: Grid, spec: BoundarySpec,
                      bc_values: Dict[str, Any], dtype=torch.float32,
                      device="cpu") -> torch.Tensor:
    """Additive right-hand-side term of the Neumann/Robin data g: 2*g/(beta*h)
    on each such side's nodes, computed in ``dtype``.

    ``bc_values[side]`` is a scalar or an (nx, ny) array holding g on that
    side. Dirichlet sides contribute nothing (their values live in the
    solution array)."""
    dtype = as_dtype(dtype)
    out = torch.zeros(grid.shape, dtype=dtype, device=device)
    for name, side, m, h, _, _ in _side_terms(grid, spec, device):
        g = torch.as_tensor(bc_values.get(name, 0.0), dtype=dtype).to(device)
        out = out + torch.where(m, 2.0 * g / (side.beta * h), 0.0)
    return out
