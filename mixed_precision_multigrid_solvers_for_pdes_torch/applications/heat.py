"""Heat-equation time stepping: u_t = alpha * div(a grad u) + q.

Counterpart of ``SCHEMES``, ``HeatConfig``, ``HeatProblem``, ``HeatResult``,
``stability_limit_dt``, ``shift_hierarchy``, ``make_step_fn``,
``solve_heat`` (with its BDF2 bootstrap, snapshots and checkpoint/resume),
``_solve_adaptive`` and ``heat_problem_from_callables`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/applications/heat.py``.

Every implicit step is a shifted-operator multigrid solve
``(A_sp + lam) u^{n+1} = F`` with ``A_sp = -div(a grad)`` and the scheme's
shift ``lam`` folded into every level's diagonal (``c + lam``), so the
kernels of the Poisson path run it unchanged. Schemes: explicit Euler (with
the dt <= h^2/(4 alpha) stability guard), backward Euler, Crank-Nicolson,
the theta-method and variable-step BDF2 (bootstrapped by one
Crank-Nicolson step); adaptive dt by step-doubling Richardson error control.

PyTorch runs eagerly, so the time loop is a Python loop over steps, and a
step's extra V-cycles (after ``cycles_per_step``, while the residual is
above ``step_rtol`` of the right-hand side) are a host loop that reads the
residual norm back once before each extra cycle. The adaptive controller
reads one error back per trial. Scalars of a step (``dt``, ``lam``, the BDF2
ratio) are computed as 0-d tensors in the state's dtype, as the JAX package
computes them, and ``t`` is a Python float (float64), as its traced time.

The callables ``q``, ``dirichlet`` and ``exact`` take coordinate tensors of
the state's dtype and a 0-d float64 tensor ``t`` on the host (of the state's
dtype for the t=0 Dirichlet values), and use torch ops; they reproduce the
JAX package's promotions, where a float32 mesh times a float64 time factor
is a float64 product (``heat_problems.py``). ``u0`` and ``a`` are host
arrays of shape (nx, ny).

``mesh=`` (``solve_heat``) and ``constrain=`` (``make_step_fn``) run the
whole time loop over a mesh of ranks, as the JAX package's SPMD scan does
(``parallel.stepping``): every rank calls with the same problem, the state
is this rank's level-0 block (``multihost.ShardedField``), the source,
boundary and Dirichlet terms are evaluated on the block's coordinates,
``A_sp u`` is a halo matvec and the cycles run on the hook's block cycle;
inside the loop only halos, the scalar all_reduces of the step's
readbacks and the cycles' coarse gathers cross ranks. The global field is
gathered at the end (every rank gets it) and at each checkpoint save,
which the mesh's first rank writes; a resume cuts the blocks again.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import bc as bc_mod
from ..core.bc import BCKind, BoundarySpec
from ..core.device import resolve_device
from ..core.grid import Grid
from ..core.precision import as_dtype
from ..models.problems import eval_on_grid
from ..ops import norms, stencil as st_mod
from ..parallel import stepping
from ..solvers import multigrid as mg_mod
from ..solvers.multigrid import Level, MultigridConfig

SCHEMES = ("explicit", "backward_euler", "crank_nicolson", "theta", "bdf2")


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    """Static time-stepping configuration."""

    scheme: str = "crank_nicolson"
    theta: float = 0.5               # used by scheme="theta"
    cycles_per_step: int = 2         # minimum V-cycles per implicit solve
    # After cycles_per_step fixed cycles, keep cycling while
    # ||r|| > step_rtol * ||F||, up to max_cycles_per_step in all. With
    # step_rtol=0 the count is exactly cycles_per_step.
    step_rtol: float = 1e-9
    max_cycles_per_step: int = 12
    mg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0)
    dtype: Any = torch.float32
    save_every: int = 0              # 0 = keep only the final state
    # adaptive dt (step-doubling Richardson)
    adaptive_dt: bool = False
    dt_tol: float = 1e-5
    dt_safety: float = 0.9
    dt_min: float = 1e-10
    dt_max: float = math.inf

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}; one of {SCHEMES}")
        if self.scheme == "theta" and not (0.0 < self.theta <= 1.0):
            raise ValueError("theta must be in (0, 1]")

    @property
    def effective_theta(self) -> float:
        return {"backward_euler": 1.0, "crank_nicolson": 0.5}.get(
            self.scheme, self.theta
        )

    @property
    def order(self) -> int:
        """Temporal accuracy order (for the Richardson exponent)."""
        if self.scheme in ("crank_nicolson", "bdf2"):
            return 2
        if self.scheme == "theta":
            return 2 if abs(self.theta - 0.5) < 1e-12 else 1
        return 1


def _time(t: float, dtype=torch.float64) -> torch.Tensor:
    """The time handed to a problem's callables: a 0-d host tensor."""
    return torch.tensor(t, dtype=dtype)


@dataclasses.dataclass
class HeatProblem:
    """Heat problem data: initial condition and time-dependent source and
    boundary data (see the module docstring for the callables)."""

    name: str
    grid: Grid
    alpha: float = 1.0
    spec: BoundarySpec = BoundarySpec()
    u0: Any = None                      # (nx, ny) initial condition
    a: Any = None                       # (nx, ny) coefficient field or None
    # q(X, Y, t) -> (nx, ny) source. None = 0.
    q: Optional[Callable] = None
    # g(X, Y, t) -> (nx, ny) array of Dirichlet values. None = 0.
    dirichlet: Optional[Callable] = None
    # Neumann/Robin side data: {side: g(t) scalar-or-array callable}
    bc_values: Optional[Dict[str, Callable]] = None
    # exact(X, Y, t) -> (nx, ny), for MMS error measurement. None = unknown.
    exact: Optional[Callable] = None

    def mesh(self, dtype=torch.float64, device="cpu"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        X, Y = self.grid.coordinates()
        return (torch.as_tensor(X, dtype=dtype, device=device),
                torch.as_tensor(Y, dtype=dtype, device=device))

    def initial_state(self, dtype, device="cpu") -> torch.Tensor:
        g = self.grid
        dtype = as_dtype(dtype)
        if self.u0 is not None:
            u = torch.as_tensor(self.u0, dtype=dtype, device=device)
        else:
            u = torch.zeros(g.shape, dtype=dtype, device=device)
        # install the t=0 Dirichlet data on the ring
        if self.dirichlet is not None:
            X, Y = self.mesh(dtype, device)
            fixed = _fixed_mask(g, self.spec, device)
            u = torch.where(fixed, self.dirichlet(X, Y, _time(0.0, dtype)
                                                  ).to(dtype), u)
        return u

    def error_norms(self, u: torch.Tensor, t: float) -> Dict[str, float]:
        if self.exact is None:
            raise ValueError(f"problem {self.name!r} has no exact solution")
        g = self.grid
        X, Y = self.mesh(torch.float64, u.device)
        diff = u.to(torch.float64) - self.exact(X, Y, _time(t))
        return {"l2": norms.scaled_l2(diff, g.hx, g.hy).item(),
                "linf": diff.abs().max().item()}


@dataclasses.dataclass
class HeatResult:
    u: Any                              # final (nx, ny) state
    t: float
    steps: int
    dt_history: np.ndarray              # per accepted step
    saved: Optional[List[Tuple[float, Any]]] = None  # (t, host array)
    errors: Optional[Dict[str, float]] = None


def _fixed_mask(grid: Grid, spec: BoundarySpec, device="cpu"):
    return ~bc_mod.unknown_mask(grid.nx, grid.ny, spec, device=device)


def stability_limit_dt(grid: Grid, alpha: float, a_max: float = 1.0) -> float:
    """Explicit-Euler stability bound dt <= 1/(2 alpha a_max (1/hx^2 +
    1/hy^2))."""
    return 1.0 / (2.0 * alpha * a_max * (1.0 / grid.hx**2 + 1.0 / grid.hy**2))


def _carry_cache(lev, shifted):
    """Hand ``lev``'s cached masks (``unknown``, ``sync``) to its shifted
    copy, which differs in the stencil's diagonal only."""
    for name in ("unknown", "sync"):
        if name in lev.__dict__:
            shifted.__dict__[name] = lev.__dict__[name]
    return shifted


def shifted_diagonal(st, lam, dtype: torch.dtype):
    """``st.c + lam`` in ``dtype``, rounded once: a float for a scalar
    stencil, a plane for a tensor stencil (``lam`` stays a host scalar
    there). ``lam`` is a number or a 0-d tensor."""
    lam_t = (lam.to(dtype) if isinstance(lam, torch.Tensor)
             else torch.tensor(lam, dtype=dtype))
    if not isinstance(st.c, torch.Tensor):
        return (torch.tensor(st.c, dtype=dtype) + lam_t).item()
    return st.c + lam_t


def shift_hierarchy(levels: Tuple[Level, ...], lam) -> Tuple[Level, ...]:
    """Add a scalar shift to every level's diagonal: (A_sp + lam). Valid
    because c = w+e+s+n at lam=0 by construction. Works for ``Stencil``
    and ``Stencil9`` levels; on Galerkin coarse levels c+lam approximates
    RAP(A+lam I) (exact on the fine level, where the residual is taken)."""
    return tuple(
        _carry_cache(lev, dataclasses.replace(
            lev, stencil=dataclasses.replace(
                lev.stencil,
                c=shifted_diagonal(lev.stencil, lam, lev.dtype))))
        for lev in levels)


# --------------------------------------------------------------------------
# single steps (t and dt are Python floats)
# --------------------------------------------------------------------------

def theta_shift(alpha: float, theta: float, dt: float,
                dtype) -> torch.Tensor:
    """The theta-method's shift 1/(alpha theta dt) as a 0-d host tensor,
    computed as the JAX package computes it: dt rounded to ``dtype``, then
    every operation in ``dtype`` with the Python numbers as weak scalars."""
    return 1.0 / (alpha * theta * torch.tensor(dt, dtype=as_dtype(dtype)))


def bdf2_shift(alpha: float, dt: float, dt_prev: Optional[float],
               dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lam, r) of a variable-step BDF2 step: r = dt/dt_prev (1 for the
    uniform step) rounded to ``dtype`` and lam = (1+2r)/((1+r) alpha dt),
    in ``dtype`` as ``theta_shift``."""
    dtype = as_dtype(dtype)
    r = torch.tensor(1.0 if dt_prev is None else dt / dt_prev, dtype=dtype)
    lam = (1.0 + 2.0 * r) / ((1.0 + r) * alpha * torch.tensor(dt,
                                                               dtype=dtype))
    return lam, r


def _source(problem: HeatProblem, X, Y, t: float, dtype):
    """q(t) in ``dtype``, or None for a problem without a source."""
    if problem.q is None:
        return None
    return problem.q(X, Y, _time(t)).to(dtype)


def _bc_correction(problem: HeatProblem, grid, spec, t: float, dtype,
                   device):
    """Neumann/Robin ghost-elimination right-hand-side term at time t (for
    A_sp), or None without side data."""
    if not problem.bc_values:
        return None
    vals = {side: fn(_time(t)) for side, fn in problem.bc_values.items()}
    return st_mod.bc_rhs_correction(grid, spec, vals, dtype, device=device)


def _install_dirichlet(problem: HeatProblem, u, X, Y, t: float, fixed):
    """A new tensor: ``u`` with the Dirichlet data at time t on its fixed
    nodes (the cycles then update it in place)."""
    if problem.dirichlet is None:
        return u.clone()
    return torch.where(fixed, problem.dirichlet(X, Y, _time(t)).to(u.dtype),
                       u)


def make_step_fn(
    problem: HeatProblem,
    levels0: Tuple[Level, ...],
    cfg: HeatConfig,
    constrain=None,
):
    """Build step(u_prev, u, t, dt) -> u_next for the configured scheme.

    ``levels0`` is the lam=0 hierarchy of A_sp = -div(a grad). ``u_prev`` is
    the n-1 state (used by BDF2 only; pass ``u`` for single-step schemes);
    BDF2 takes the previous step ``dt_prev`` as a fifth argument (None: the
    uniform step). ``t``, ``dt`` and ``dt_prev`` are Python floats. The step
    never writes into ``u_prev`` or ``u``. ``constrain``: an array hook goes
    to the cycles; ``parallel.distributed.make_constrainer``'s hook runs
    the step on this rank's blocks, taking level-0 ``ShardedField``s (or
    global tensors, cut) and returning one."""
    return _make_step(problem, levels0, cfg,
                      stepping.fields_for(constrain, levels0))


def _make_step(problem: HeatProblem, levels0: Tuple[Level, ...],
               cfg: HeatConfig, fields):
    """``make_step_fn`` on ``fields`` (``parallel.stepping``)."""
    grid, spec, alpha = problem.grid, problem.spec, problem.alpha
    dtype = as_dtype(cfg.dtype)
    device = levels0[0].device
    unknown, fixed = fields.unknown, fields.fixed
    X, Y = fields.coords(*problem.mesh(dtype, device))
    zero = torch.zeros((), dtype=dtype, device=device)

    def scalar(x) -> torch.Tensor:
        """A host 0-d tensor in the state's dtype (JAX's ``astype``)."""
        return torch.tensor(x, dtype=dtype)

    @functools.lru_cache(maxsize=4)
    def shifted(lam: float):
        # a fixed-dt run shifts by one lam; an adaptive trial by two
        return shift_hierarchy(levels0, lam)

    # A_sp u: the true operator, before the BC-elimination term
    apply_sp = fields.apply

    def bc_correction(t: float):
        cbc = _bc_correction(problem, grid, spec, t, dtype, device)
        return None if cbc is None else fields.cut(cbc)

    def cycles(levels, u, f):
        """cycles_per_step fixed cycles + tolerance-driven extras, each
        extra tested on the host first, as the JAX package's while_loop
        tests its condition: at most max_cycles_per_step in all."""
        for _ in range(cfg.cycles_per_step):
            u = fields.mg_cycle(levels, u, f, cfg.mg)
        extra = cfg.max_cycles_per_step - cfg.cycles_per_step
        if cfg.step_rtol <= 0.0 or extra <= 0:
            return u
        tol_eff = cfg.step_rtol * torch.clamp(fields.masked_norm(f),
                                              min=1e-300)

        def above_tol(u) -> bool:
            return bool(fields.residual_norm(levels, u, f) > tol_eff)

        k = 0
        while k < extra and above_tol(u):
            u = fields.mg_cycle(levels, u, f, cfg.mg)
            k += 1
        return u

    if cfg.scheme == "explicit":

        def step(u_prev, u, t, dt):
            tn1 = t + dt
            cbc = bc_correction(t)
            au = apply_sp(u)
            lap = -(au if cbc is None else au - cbc)  # div(a grad u) at t
            rhs = alpha * lap
            q = _source(problem, X, Y, t, dtype)
            if q is not None:
                rhs = rhs + q
            u_new = torch.where(unknown, u + scalar(dt) * rhs, u)
            return _install_dirichlet(problem, u_new, X, Y, tn1, fixed)

        return fields.wrap(step)

    if cfg.scheme == "bdf2":
        # Variable-step BDF2 with ratio r = dt/dt_prev (u_prev sits dt_prev
        # back):
        #   [(1+2r)/((1+r)dt)] u^{n+1} - [(1+r)/dt] u^n + [r^2/((1+r)dt)]
        #     u^{n-1} = alpha(-A_sp u^{n+1}) + q^{n+1}
        # r=1 reduces to the classic (3, -4, 1)/(2dt) coefficients.
        def step(u_prev, u, t, dt, dt_prev=None):
            tn1 = t + dt
            dt_ = scalar(dt)
            lam, r = bdf2_shift(alpha, dt, dt_prev, dtype)
            levels = shifted(lam.item())
            F = ((1.0 + r) * u - (r * r / (1.0 + r)) * u_prev) \
                / (alpha * dt_)
            q = _source(problem, X, Y, tn1, dtype)
            if q is not None:
                F = F + q / alpha
            cbc1 = bc_correction(tn1)
            if cbc1 is not None:
                F = F + cbc1
            F = torch.where(unknown, F, zero)
            u_new = _install_dirichlet(problem, u, X, Y, tn1, fixed)
            return cycles(levels, u_new, F)

        return fields.wrap(step)

    th = cfg.effective_theta

    # theta-method: [A_sp + 1/(alpha theta dt)] u^{n+1}
    #   = u^n/(alpha theta dt) - (1-theta)/theta * A_sp u^n
    #     + [theta q^{n+1} + (1-theta) q^n]/(alpha theta) + c_bc^{n+1}
    #     - (1-theta)/theta * (-c_bc^n)
    def step(u_prev, u, t, dt):
        tn1 = t + dt
        lam = theta_shift(alpha, th, dt, dtype)
        levels = shifted(lam.item())
        F = u * lam
        qn1 = _source(problem, X, Y, tn1, dtype)
        if qn1 is not None:
            qn = _source(problem, X, Y, t, dtype)
            F = F + (th * qn1 + (1.0 - th) * qn) / (alpha * th)
        cbc1 = bc_correction(tn1)
        if cbc1 is not None:
            F = F + cbc1
        if th < 1.0:
            au = apply_sp(u)
            cbc0 = bc_correction(t)
            F = F - (1.0 - th) / th * (au if cbc0 is None else au - cbc0)
        F = torch.where(unknown, F, zero)
        u_new = _install_dirichlet(problem, u, X, Y, tn1, fixed)
        return cycles(levels, u_new, F)

    return fields.wrap(step)


# --------------------------------------------------------------------------
# time loops
# --------------------------------------------------------------------------

def _run_steps(step, u_prev, u, t: float, dt: float, n_steps: int,
               save_every: int):
    """n_steps steps of ``step``; the states after every save_every-th
    step are kept (on the device) in ``saved``."""
    saved = []
    for k in range(n_steps):
        u_new = step(u_prev, u, t, dt)
        u_prev, u, t = u, u_new, t + dt
        if save_every and (k + 1) % save_every == 0:
            saved.append(u_new)
    return u_prev, u, t, saved


def _host(fields, x) -> np.ndarray:
    """A state as a host array (a sharded one gathered)."""
    return fields.gather(x).cpu().numpy()


def _snapshots(ks, saved, dt: float, fields):
    return [(float((k + 1) * dt), _host(fields, s))
            for k, s in zip(ks, saved)]


def _save(checkpoint, fields, k: int, u_prev, u, meta) -> None:
    """A checkpoint of the global states, written by the mesh's first
    rank, which every rank then waits for."""
    arrays = {"u_prev": fields.gather(u_prev), "u": fields.gather(u)}
    if fields.writer:
        checkpoint.save(k, arrays, meta)
    fields.barrier()


def _bootstrap_bdf2(problem, levels0, cfg, u0, t0, dt, fields):
    """First BDF2 step via one Crank-Nicolson step (standard bootstrap)."""
    cn = dataclasses.replace(cfg, scheme="crank_nicolson")
    step_cn = _make_step(problem, levels0, cn, fields)
    return step_cn(u0, u0, t0, dt)


def solve_heat(
    problem: HeatProblem,
    t_final: float,
    dt: Optional[float] = None,
    cfg: HeatConfig = HeatConfig(),
    *,
    n_steps: Optional[int] = None,
    mesh=None,
    checkpoint=None,
    checkpoint_every: int = 0,
    device=None,
) -> HeatResult:
    """Integrate the heat problem to ``t_final`` on ``device`` (the card
    when None).

    Fixed-dt path: a loop of ``n_steps`` steps of dt = t_final / n_steps.
    Adaptive path (``cfg.adaptive_dt``): an accept/reject loop around the
    same step (step-doubling Richardson).

    With ``checkpoint`` (a utils.checkpoint.CheckpointManager) the fixed-dt
    loop runs in chunks of ``checkpoint_every`` steps, saving (u_prev, u,
    t) at each chunk boundary; a run pointed at a non-empty directory
    resumes from its latest checkpoint. checkpoint_every=0 saves once at
    the end.

    ``mesh`` (``parallel.mesh.make_mesh``) runs the whole loop on this
    rank's blocks (``parallel.distributed.make_constrainer``; see the
    module docstring): every rank of the mesh calls with the same problem
    and gets the global result."""
    device = resolve_device(device)
    dtype = as_dtype(cfg.dtype)
    grid = problem.grid
    # one hierarchy and step per configuration, device and mesh, kept on
    # the problem for later calls
    cache = problem.__dict__.setdefault("_solver_cache", {})
    key = (cfg.mg, cfg.scheme, cfg.theta, cfg.cycles_per_step, cfg.step_rtol,
           cfg.max_cycles_per_step, dtype, device,
           None if mesh is None else id(mesh))
    hit = cache.get(key)
    if hit is not None and hit[3] is mesh:
        levels0, step, fields, _ = hit
    else:
        levels0 = mg_mod.build_hierarchy(
            grid, problem.spec, a=problem.a, lam=0.0, dtype=dtype,
            device=device, cfg=cfg.mg)
        constrain = None
        if mesh is not None:
            from ..parallel import distributed

            constrain = distributed.make_constrainer(mesh)
        fields = stepping.fields_for(constrain, levels0)
        step = _make_step(problem, levels0, cfg, fields)
        cache[key] = (levels0, step, fields, mesh)
    u0 = fields.field(fields.cut(problem.initial_state(dtype, device)))

    if cfg.scheme == "explicit":
        limit = stability_limit_dt(
            grid, problem.alpha,
            a_max=float(np.max(problem.a)) if problem.a is not None else 1.0,
        )
        if dt is not None and dt > limit * (1 + 1e-12):
            raise ValueError(
                f"explicit dt={dt:g} exceeds stability limit {limit:g}")
        if dt is None:
            dt = 0.9 * limit

    if cfg.adaptive_dt:
        return _solve_adaptive(problem, levels0, cfg, step, u0, t_final,
                               dt or t_final / 100.0, fields)

    if dt is None and n_steps is None:
        raise ValueError("provide dt or n_steps")
    if n_steps is None:
        n_steps = max(1, int(round(t_final / dt)))
    dt = t_final / n_steps  # land exactly on t_final

    t0 = 0.0
    u_prev0 = u0
    start = 0
    resumed = False
    if checkpoint is not None and checkpoint.latest_step() is not None:
        arrays, meta = checkpoint.restore()
        if abs(meta.get("dt", dt) - dt) > 1e-12 * max(abs(dt), 1.0):
            raise ValueError(
                f"checkpoint dt={meta.get('dt')} != requested dt={dt}; "
                "resume requires the same step size")
        if meta.get("scheme", cfg.scheme) != cfg.scheme:
            raise ValueError(
                f"checkpoint scheme={meta.get('scheme')!r} != requested "
                f"scheme={cfg.scheme!r}; resuming would continue from "
                "incompatible time-integration history")
        u_prev0, u0 = (fields.field(fields.cut(torch.as_tensor(
            arrays[name], dtype=dtype, device=device)))
            for name in ("u_prev", "u"))
        start = int(meta["k"])
        t0 = float(meta["t"])
        resumed = True
    if cfg.scheme == "bdf2" and n_steps >= 1 and not resumed:
        u1 = _bootstrap_bdf2(problem, levels0, cfg, u0, t0, dt, fields)
        u_prev0, u0 = u0, u1
        t0 = t0 + dt
        start = 1
    if checkpoint is not None:
        return _solve_checkpointed(
            problem, cfg, step, u_prev0, u0, t0, n_steps, start, dt,
            checkpoint, checkpoint_every, fields,
        )
    saved_list = None
    if start < n_steps:
        _, u, t, saved = _run_steps(step, u_prev0, u0, t0, dt,
                                    n_steps - start, cfg.save_every)
        if cfg.save_every:
            ks = np.arange(start, n_steps)[cfg.save_every - 1::cfg.save_every]
            saved_list = _snapshots(ks, saved, dt, fields)
    else:
        u, t = u0, t0

    u = fields.gather(u)
    result = HeatResult(
        u=u, t=float(t), steps=n_steps,
        dt_history=np.full(n_steps, dt), saved=saved_list,
    )
    if problem.exact is not None:
        result.errors = problem.error_norms(u, float(t))
    return result


def _solve_checkpointed(problem, cfg, step, u_prev0, u0, t0, n_steps, start,
                        dt, checkpoint, checkpoint_every, fields):
    """Chunked loop with checkpoint saves at chunk boundaries."""
    every = checkpoint_every if checkpoint_every > 0 else n_steps
    if cfg.save_every and every % cfg.save_every:
        raise ValueError(
            "checkpoint_every must be a multiple of save_every (snapshot "
            "phase would drift across chunk boundaries otherwise)")
    u_prev, u, t = u_prev0, u0, t0
    k = start
    saved_list: list = []
    while k < n_steps:
        m = min(every, n_steps - k)
        u_prev, u, t, saved = _run_steps(step, u_prev, u, t, dt, m,
                                         cfg.save_every)
        if cfg.save_every:
            ks = np.arange(k, k + m)[cfg.save_every - 1::cfg.save_every]
            saved_list += _snapshots(ks, saved, dt, fields)
        k += m
        _save(checkpoint, fields, k, u_prev, u,
              {"t": float(t), "k": k, "dt": dt, "scheme": cfg.scheme})
    u = fields.gather(u)
    result = HeatResult(
        u=u, t=float(t), steps=n_steps,
        dt_history=np.full(n_steps, dt), saved=saved_list or None,
    )
    if problem.exact is not None:
        result.errors = problem.error_norms(u, float(t))
    return result


def _solve_adaptive(problem, levels0, cfg, step, u0, t_final, dt0, fields):
    """Step-doubling: accept when |u_dt - u_{dt/2,x2}| / (2^p - 1) < dt_tol.

    BDF2 runs with variable-step coefficients (r = dt/dt_prev) and is
    bootstrapped by an error-controlled Crank-Nicolson first step (both order
    2, so one Richardson exponent serves the whole run). After an accepted
    step the kept history is (half-step state, two-half-steps state), so the
    next step's dt_prev is dt/2. Each trial runs three steps and reads one
    error back; the controller runs on Python floats."""
    p = cfg.order
    denom = 2.0**p - 1.0
    is_bdf2 = cfg.scheme == "bdf2"
    t, u, u_prev = 0.0, u0, u0
    dt = float(dt0)
    dt_prev = 0.0  # spacing of (u_prev, u); 0 until a bdf2 history exists
    dts: list = []
    saved: list = []
    nsteps = 0

    if is_bdf2:
        step_cn = _make_step(
            problem, levels0,
            dataclasses.replace(cfg, scheme="crank_nicolson"), fields)

    def error(big, two, d: float) -> float:
        """max|big - two| / d (over the mesh), divided in the state's dtype
        on the host."""
        return (fields.max_abs(big - two).cpu() / d).item()

    def try_step(u_prev, u, t, dt):
        big = step(u_prev, u, t, dt)
        half = step(u_prev, u, t, 0.5 * dt)
        two = step(u, half, t + 0.5 * dt, 0.5 * dt)
        # keep the more accurate two-half-steps state (+ its half history)
        return half, two, error(big, two, denom)

    def try_step_boot(u, t, dt):
        """One-step CN trial (bdf2 bootstrap: no valid u_prev yet)."""
        big = step_cn(u, u, t, dt)
        half = step_cn(u, u, t, 0.5 * dt)
        two = step_cn(half, half, t + 0.5 * dt, 0.5 * dt)
        return half, two, error(big, two, 3.0)  # CN is order 2

    def try_step_bdf(u_prev, u, t, dt, dt_prev):
        big = step(u_prev, u, t, dt, dt_prev)
        half = step(u_prev, u, t, 0.5 * dt, dt_prev)
        two = step(u, half, t + 0.5 * dt, 0.5 * dt, 0.5 * dt)
        return half, two, error(big, two, denom)

    while t < t_final - 1e-14:
        dt = min(dt, t_final - t, cfg.dt_max)
        if not is_bdf2:
            half, u_new, err = try_step(u_prev, u, t, dt)
        elif nsteps == 0:
            half, u_new, err = try_step_boot(u, t, dt)
        else:
            half, u_new, err = try_step_bdf(u_prev, u, t, dt, dt_prev)
        if err <= cfg.dt_tol or dt <= cfg.dt_min * (1 + 1e-12):
            u_prev, u = (half, u_new) if is_bdf2 else (u, u_new)
            dt_prev = 0.5 * dt
            t += dt
            nsteps += 1
            dts.append(dt)
            if cfg.save_every and nsteps % cfg.save_every == 0:
                saved.append((t, u))
        # PI-free classic controller
        factor = cfg.dt_safety * (cfg.dt_tol / max(err, 1e-300)) ** (1.0 / (p + 1))
        dt = float(np.clip(dt * np.clip(factor, 0.2, 5.0), cfg.dt_min, cfg.dt_max))

    u = fields.gather(u)
    result = HeatResult(
        u=u, t=t, steps=nsteps, dt_history=np.asarray(dts),
        saved=[(ts, _host(fields, s)) for ts, s in saved] or None,
    )
    if problem.exact is not None:
        result.errors = problem.error_norms(u, t)
    return result


# --------------------------------------------------------------------------
# problem factory
# --------------------------------------------------------------------------

def heat_problem_from_callables(
    name: str,
    grid: Grid,
    *,
    alpha: float = 1.0,
    spec: BoundarySpec = BoundarySpec(),
    u0: Optional[Callable] = None,
    exact: Optional[Callable] = None,
    q: Optional[Callable] = None,
    a: Optional[Callable] = None,
    bc_values: Optional[Dict[str, Callable]] = None,
) -> HeatProblem:
    """Assemble a HeatProblem. ``u0``/``a`` take (X, Y) numpy meshes;
    ``exact``/``q`` take (X, Y, t) tensors and use torch ops. Without
    ``u0`` the initial condition is ``exact`` at t=0 on float64 meshes."""
    if u0 is not None:
        u0_arr = eval_on_grid(grid, u0)
    elif exact is not None:
        X, Y = (torch.as_tensor(c) for c in grid.coordinates())
        u0_arr = np.array(torch.broadcast_to(
            exact(X, Y, _time(0.0)), grid.shape).numpy(), dtype=np.float64)
    else:
        u0_arr = None
    dirichlet = None
    if exact is not None and any(
        BCKind.DIRICHLET in spec.side(s).kinds for s in bc_mod.SIDES
    ):
        dirichlet = exact
    return HeatProblem(
        name=name, grid=grid, alpha=alpha, spec=spec,
        u0=u0_arr,
        a=eval_on_grid(grid, a) if a is not None else None,
        q=q, dirichlet=dirichlet, bc_values=bc_values, exact=exact,
    )
