"""3D heat-equation time stepping.

Counterpart of ``HeatProblem3D``, ``shift_hierarchy3d``, ``solve_heat3d``
and the problems ``heat_source3d``, ``oscillating3d`` and
``pure_diffusion3d`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/applications/heat3d.py``.
The same design as ``applications/heat.py``: implicit steps are exactly
``cycles_per_step`` shifted-operator V-cycles with the shift folded into
the 7-point diagonal (the 3D solver takes no tolerance-driven extra
cycles, as in the JAX package); BDF2 runs uniform steps, bootstrapped by
one Crank-Nicolson step. The time loop is a Python loop; ``HeatConfig`` is
shared with 2D.

The callables take broadcastable coordinate tensors (nx,1,1), (1,ny,1),
(1,1,nz) and a 0-d float64 host tensor ``t``: torch computes each node's
value with the same operations as on full meshes, and a 513^3 evaluation
builds no mesh of its own. They promote as the JAX package does (see
``heat_problems.py``). A coefficient field ``a`` makes the operator
-div(a grad u): its levels hold coefficient fields (``ops/stencil3d.py``)
and run the plain path, as in the JAX package, and the shift adds lam to
each level's diagonal field; a ``Stencil27`` level (Galerkin coarsening in
``HeatConfig.mg``) is shifted the same way. ``mesh=`` runs the whole
loop on this rank's (x, y) blocks of whole z-lines
(``parallel.distributed.make_constrainer3d``), as ``solve_heat`` runs on
2D blocks (``parallel.stepping``): the state is a level-0
``ShardedField``, the terms are evaluated on the block's coordinates and
the global field is gathered at the end and at each checkpoint save.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.grid3d import Grid3D
from ..core.precision import as_dtype
from ..ops import norms
from ..parallel import stepping
from ..solvers import multigrid3d as mg3
from .heat import HeatConfig, _carry_cache, _save, _time, shifted_diagonal, \
    theta_shift
from .heat_problems import _up


@dataclasses.dataclass
class HeatProblem3D:
    name: str
    grid: Grid3D
    alpha: float = 1.0
    u0: Any = None                     # (nx, ny, nz) initial condition
    q: Optional[Callable] = None       # q(X, Y, Z, t), torch ops
    exact: Optional[Callable] = None   # exact(X, Y, Z, t), torch ops
    a: Any = None                      # (nx, ny, nz) coefficient field

    def mesh(self, dtype=torch.float64, device="cpu"):
        """Broadcastable coordinates (nx,1,1), (1,ny,1), (1,1,nz)."""
        x, y, z = (torch.as_tensor(c, dtype=dtype, device=device)
                   for c in self.grid.axes())
        return x[:, None, None], y[None, :, None], z[None, None, :]

    def initial_state(self, dtype, device="cpu") -> torch.Tensor:
        dtype = as_dtype(dtype)
        shape = self.grid.shape
        if self.u0 is not None:
            return torch.as_tensor(self.u0, dtype=dtype, device=device)
        if self.exact is not None:
            X, Y, Z = self.mesh(dtype, device)
            u = self.exact(X, Y, Z, _time(0.0, dtype)).to(dtype)
            return torch.broadcast_to(u, shape).contiguous()
        return torch.zeros(shape, dtype=dtype, device=device)

    def error_norms(self, u: torch.Tensor, t: float) -> Dict[str, float]:
        g = self.grid
        X, Y, Z = self.mesh(torch.float64, u.device)
        diff = u.to(torch.float64) - self.exact(X, Y, Z, _time(t))
        return {"l2": norms.scaled_l2(diff, g.hx, g.hy, g.hz).item(),
                "linf": diff.abs().max().item()}


def shift_hierarchy3d(levels, lam):
    """Add a scalar shift to every 3D level's diagonal (c + lam, rounded
    once in the level's dtype): a float for a scalar stencil, a field for a
    coefficient or ``Stencil27`` level."""
    return tuple(
        _carry_cache(lev, dataclasses.replace(
            lev, stencil=dataclasses.replace(
                lev.stencil,
                c=shifted_diagonal(lev.stencil, lam, lev.dtype))))
        for lev in levels)


def solve_heat3d(
    problem: HeatProblem3D,
    t_final: float,
    dt: float,
    cfg: HeatConfig = HeatConfig(),
    *,
    mesh=None,
    checkpoint=None,
    checkpoint_every: int = 0,
    device=None,
) -> Dict[str, Any]:
    """Fixed-dt integration on ``device`` (the card when None): theta
    schemes, BDF2 with a Crank-Nicolson bootstrap, explicit. Returns
    {"u", "t", "steps"} and "errors" when the problem has an exact
    solution.

    With ``checkpoint`` (a utils.checkpoint.CheckpointManager) the loop runs
    in chunks of ``checkpoint_every`` steps with atomic (u_prev, u, t)
    saves and resumes bit-exactly from the latest checkpoint (BDF2 two-step
    history preserved). checkpoint_every=0 saves once at the end.

    ``mesh`` (``parallel.mesh.make_mesh``) runs the loop on this rank's
    blocks (``parallel.distributed.make_constrainer3d``); every rank calls
    with the same problem and gets the global result."""
    if cfg.adaptive_dt:
        raise ValueError("solve_heat3d is fixed-dt (adaptive_dt is 2D-only)")
    device = resolve_device(device)
    dtype = as_dtype(cfg.dtype)
    grid = problem.grid
    alpha = problem.alpha
    levels0 = mg3.build_hierarchy3d(grid, a=problem.a, lam=0.0, dtype=dtype,
                                    device=device, cfg=cfg.mg)
    constrain = None
    if mesh is not None:
        from ..parallel import distributed

        constrain = distributed.make_constrainer3d(mesh)
    fields = stepping.fields_for(constrain, levels0)
    unknown, fixed = fields.unknown, fields.fixed
    X, Y, Z = fields.coords(*problem.mesh(dtype, device))
    zero = torch.zeros((), dtype=dtype, device=device)
    shifted = {}

    def scalar(x) -> torch.Tensor:
        return torch.tensor(x, dtype=dtype)

    def shift(lam: torch.Tensor):
        key = lam.item()
        if key not in shifted:
            shifted.clear()  # a fixed-dt run shifts by one lam
            shifted[key] = shift_hierarchy3d(levels0, key)
        return shifted[key]

    def source(t: float):
        if problem.q is None:
            return None
        return problem.q(X, Y, Z, _time(t)).to(dtype)

    def install_bc(u, t: float):
        """A new tensor: ``u`` with the exact values at t on the shell."""
        if problem.exact is None:
            return u.clone()
        return torch.where(fixed, problem.exact(X, Y, Z, _time(t)).to(dtype),
                           u)

    def solve(levels, u, F):
        for _ in range(cfg.cycles_per_step):
            u = fields.mg_cycle(levels, u, F, cfg.mg)
        return u

    n_steps = max(1, int(round(t_final / dt)))
    dt_val = t_final / n_steps

    def theta_step(th):
        def step(u_prev, u, t, dt_):
            tn1 = t + dt_
            lam = theta_shift(alpha, th, dt_, dtype)
            levels = shift(lam)
            F = u * lam
            qn1 = source(tn1)
            if qn1 is not None:
                F = F + (th * qn1 + (1 - th) * source(t)) / (alpha * th)
            if th < 1.0:
                F = F - (1.0 - th) / th * fields.apply(u)
            F = torch.where(unknown, F, zero)
            return solve(levels, install_bc(u, tn1), F)

        return step

    if cfg.scheme == "explicit":
        limit = 1.0 / (2 * alpha * (1 / grid.hx**2 + 1 / grid.hy**2
                                    + 1 / grid.hz**2))
        if dt_val > limit * (1 + 1e-12):
            raise ValueError(f"explicit dt={dt_val:g} exceeds limit {limit:g}")

        def step(u_prev, u, t, dt_):
            rhs = alpha * -fields.apply(u)
            q = source(t)
            if q is not None:
                rhs = rhs + q
            u_new = torch.where(unknown, u + scalar(dt_) * rhs, u)
            return install_bc(u_new, t + dt_)

    elif cfg.scheme == "bdf2":
        # (3u^{n+1} - 4u^n + u^{n-1})/(2dt) = alpha(-A_sp u^{n+1}) + q^{n+1}
        # (uniform dt; the first step bootstrapped by Crank-Nicolson)
        def step(u_prev, u, t, dt_):
            tn1 = t + dt_
            dtc = scalar(dt_)
            lam = 3.0 / (2.0 * alpha * dtc)
            levels = shift(lam)
            F = (4.0 * u - u_prev) / (2.0 * alpha * dtc)
            q = source(tn1)
            if q is not None:
                F = F + q / alpha
            F = torch.where(unknown, F, zero)
            return solve(levels, install_bc(u, tn1), F)

    else:
        step = theta_step(cfg.effective_theta)

    def run(u_prev, u, t, n: int):
        for _ in range(n):
            u_prev, u, t = u, step(u_prev, u, t, dt_val), t + dt_val
        return u_prev, u, t

    u0 = fields.cut(problem.initial_state(dtype, device))
    t0 = 0.0
    u_prev0, start = u0, 0
    resumed = False
    if checkpoint is not None and checkpoint.latest_step() is not None:
        arrays, meta = checkpoint.restore()
        if abs(meta.get("dt", dt_val) - dt_val) > 1e-12 * max(abs(dt_val), 1.0):
            raise ValueError(
                f"checkpoint dt={meta.get('dt')} != requested dt={dt_val}; "
                "resume requires the same step size")
        if meta.get("scheme", cfg.scheme) != cfg.scheme:
            raise ValueError(
                f"checkpoint scheme={meta.get('scheme')!r} != requested "
                f"scheme={cfg.scheme!r}; resuming would continue from "
                "incompatible time-integration history")
        u_prev0, u0 = (fields.cut(torch.as_tensor(
            arrays[name], dtype=dtype, device=device))
            for name in ("u_prev", "u"))
        start = int(meta["k"])
        t0 = float(meta["t"])
        resumed = True
    if cfg.scheme == "bdf2" and n_steps >= 1 and not resumed:
        u1 = theta_step(0.5)(u0, u0, t0, dt_val)  # CN bootstrap
        u_prev0, u0 = u0, u1
        t0 = t0 + dt_val
        start = 1
    u_prev, u, t = u_prev0, u0, t0
    if checkpoint is not None:
        every = checkpoint_every if checkpoint_every > 0 else n_steps
        k = start
        while k < n_steps:
            m = min(every, n_steps - k)
            u_prev, u, t = run(u_prev, u, t, m)
            k += m
            _save(checkpoint, fields, k, u_prev, u,
                  {"t": float(t), "k": k, "dt": dt_val,
                   "scheme": cfg.scheme})
        if (checkpoint.latest_step() or 0) < n_steps:
            # n_steps fully covered by the bootstrap (bdf2, n_steps == 1):
            # the loop never ran; the run still saves at its end
            _save(checkpoint, fields, n_steps, u_prev, u,
                  {"t": float(t), "k": n_steps, "dt": dt_val,
                   "scheme": cfg.scheme})
    elif start < n_steps:
        u_prev, u, t = run(u_prev0, u0, t0, n_steps - start)
    u = fields.gather(u)
    out = {"u": u, "t": float(t), "steps": n_steps}
    if problem.exact is not None:
        out["errors"] = problem.error_norms(u, float(t))
    return out


def _sin3(X, Y, Z):
    return torch.sin(np.pi * X) * torch.sin(np.pi * Y) * torch.sin(np.pi * Z)


def heat_source3d(n: int, alpha: float = 1.0) -> HeatProblem3D:
    """Steady manufactured source: u = sin(pi x) sin(pi y) sin(pi z)
    (time-independent), q = 3 pi^2 alpha u."""
    PI = np.pi

    def exact(X, Y, Z, t):
        z = 0.0 * t
        return _up(_sin3(X, Y, Z), z) + z

    def q(X, Y, Z, t):
        return 3 * PI**2 * alpha * _sin3(X, Y, Z)

    return HeatProblem3D("heat3d_source", Grid3D(n, n, n), alpha=alpha,
                         exact=exact, q=q)


def oscillating3d(n: int, alpha: float = 1.0,
                  omega: float = 2 * np.pi) -> HeatProblem3D:
    """u = sin(pi x) sin(pi y) sin(pi z) cos(omega t);
    q = (-omega sin(omega t) + 3 pi^2 alpha cos(omega t)) * spatial."""
    PI = np.pi

    def exact(X, Y, Z, t):
        c = torch.cos(omega * t)
        return _up(_sin3(X, Y, Z), c) * c

    def q(X, Y, Z, t):
        f = (-omega * torch.sin(omega * t)
             + 3 * PI**2 * alpha * torch.cos(omega * t))
        return _up(_sin3(X, Y, Z), f) * f

    return HeatProblem3D("heat3d_oscillating", Grid3D(n, n, n), alpha=alpha,
                         exact=exact, q=q)


def pure_diffusion3d(n: int, alpha: float = 1.0) -> HeatProblem3D:
    """u = sin(pi x) sin(pi y) sin(pi z) e^{-3 pi^2 alpha t}, q = 0."""
    PI = np.pi

    def exact(X, Y, Z, t):
        e = torch.exp(-3 * PI**2 * alpha * t)
        return _up(_sin3(X, Y, Z), e) * e

    return HeatProblem3D("heat3d_pure_diffusion", Grid3D(n, n, n),
                         alpha=alpha, exact=exact)
