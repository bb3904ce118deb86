"""Preconditioned Krylov solvers: CG, flexible CG, BiCGStab and flexible
restarted GMRES, plus a NumPy CG for host preconditioners.

Counterpart of ``mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/
krylov.py``. The JAX package runs each loop as one ``lax.while_loop``; here
each is a Python loop of whole-tensor operations on the vectors' device,
which tests its stopping rule before every body, as ``while_loop`` does, and
so reads the residual norm back to the host once per iteration (FGMRES once
per inner step, for its Hessenberg column). Dot products and norms
accumulate in float64 (``_dot``), and each step scalar is cast to the
iterate's dtype before it scales a vector, as in the JAX package. The
matvec is any callable, usually ``stencil_matvec``; the preconditioner any
callable z = M(r) (``preconditioning``). The tolerance is relative to
||b||. Every solver returns the iterate and an info dict with the JAX
package's keys: 'iterations', 'residual_norm', 'history' (the residual
norms from the start, its unused tail trimmed), 'converged' and 'method'.

The vectors may be ``parallel.multihost.ShardedField`` blocks
(``parallel.distributed.shard_inputs``), every rank of the mesh calling
the solver: their arithmetic acts on this rank's blocks,
``stencil_matvec`` exchanges halos, ``_dot`` is one all_reduce of float64
block sums, so every ``.item()`` reads the same value on every rank, and
the iterate comes back as blocks.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import stencil as st_mod, stencil3d as st3
from ..ops.stencil import Stencil9

_TINY = 1e-300


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) in float64, a 0-d tensor on the vectors' device (over the
    mesh for sharded fields)."""
    if not torch.is_tensor(a):
        return a.dot(b)
    return torch.sum(a.to(torch.float64) * b.to(torch.float64))


def _safe_div(num, den, tiny: float = _TINY):
    """num / den with a sign-preserving guard on tiny |den| (clamping with
    max() would flip a negative denominator's sign). Takes 0-d tensors or
    floats."""
    if torch.is_tensor(den):
        guard = torch.full_like(den, tiny)
        guard = torch.where(den < 0, -guard, guard)
        return num / torch.where(den.abs() < tiny, guard, den)
    if abs(den) < tiny:
        den = -tiny if den < 0 else tiny
    return num / den


def _identity(r):
    return r


def stencil_matvec(stencil, unknown) -> Callable:
    """The masked operator x -> A x on unknowns, zero elsewhere (a
    ``Stencil`` or a ``Stencil9``); on a sharded field, blockwise with a
    halo exchange."""
    def mv(x):
        if not torch.is_tensor(x):
            return x.apply_stencil(stencil, unknown)
        return torch.where(unknown, st_mod.apply(stencil, x),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    return mv


def stencil_matvec3d(stencil, unknown) -> Callable:
    """3D analogue of :func:`stencil_matvec` (7-point ``Stencil3D``)."""

    def mv(x):
        return torch.where(unknown, st3.apply(stencil, x),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    return mv


def _loop(step, rnorm0: torch.Tensor, tol: float, bnorm: torch.Tensor,
          maxiter: int):
    """Run ``step()`` (one iteration, returning the new residual norm as a
    0-d tensor) while the norm exceeds tol * max(||b||, tiny) and fewer than
    ``maxiter`` iterations ran. Returns (iterations, history, tol_eff)."""
    rnorm, bn = torch.stack([rnorm0, bnorm]).tolist()
    tol_eff = tol * max(bn, _TINY)
    hist = [rnorm]
    while hist[-1] > tol_eff and len(hist) <= maxiter:
        hist.append(step().item())
    return len(hist) - 1, hist, tol_eff


def _info(method: str, k: int, hist, tol_eff: float) -> Dict[str, Any]:
    return {"iterations": k, "residual_norm": hist[-1],
            "history": np.asarray(hist, dtype=np.float64),
            "converged": hist[-1] <= tol_eff, "method": method}


def _start(matvec, b, x0):
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    return x, b - matvec(x)


def pcg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
        *, precond: Optional[Callable] = None, tol: float = 1e-10,
        maxiter: int = 500) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Preconditioned conjugate gradients until ||r|| <= tol * ||b||."""
    M = precond or _identity
    x, r = _start(matvec, b, x0)
    z = M(r)
    s = {"x": x, "r": r, "p": z, "rz": _dot(r, z)}

    def step():
        x, r, p, rz = s["x"], s["r"], s["p"], s["rz"]
        Ap = matvec(p)
        alpha = _safe_div(rz, _dot(p, Ap)).to(x.dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = _safe_div(rz_new, rz).to(x.dtype)
        s.update(x=x, r=r, p=z + beta * p, rz=rz_new)
        return torch.sqrt(_dot(r, r))

    k, hist, tol_eff = _loop(step, torch.sqrt(_dot(r, r)), tol,
                             torch.sqrt(_dot(b, b)), maxiter)
    return s["x"], _info("pcg", k, hist, tol_eff)


def fcg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
        *, precond: Optional[Callable] = None, tol: float = 1e-10,
        maxiter: int = 500) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Flexible CG (Notay's IPCG): beta = z_new . (r_new - r) / (z . r),
    robust when the preconditioner is not symmetric or varies between
    iterations (a multigrid cycle whose post-smoothing keeps the red-black
    order). With a symmetric cycle ``pcg`` saves one inner product."""
    M = precond or _identity
    x, r = _start(matvec, b, x0)
    z = M(r)
    s = {"x": x, "r": r, "p": z, "rz": _dot(r, z)}

    def step():
        x, r, p, rz = s["x"], s["r"], s["p"], s["rz"]
        Ap = matvec(p)
        alpha = _safe_div(rz, _dot(p, Ap)).to(x.dtype)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = M(r_new)
        beta = _safe_div(_dot(z_new, r_new - r), rz).to(x.dtype)
        s.update(x=x, r=r_new, p=z_new + beta * p, rz=_dot(r_new, z_new))
        return torch.sqrt(_dot(r_new, r_new))

    k, hist, tol_eff = _loop(step, torch.sqrt(_dot(r, r)), tol,
                             torch.sqrt(_dot(b, b)), maxiter)
    return s["x"], _info("fcg", k, hist, tol_eff)


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *,
             precond: Optional[Callable] = None, tol: float = 1e-10,
             maxiter: int = 500) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Preconditioned BiCGStab, for nonsymmetric operators."""
    M = precond or _identity
    x, r = _start(matvec, b, x0)
    one = torch.ones((), dtype=torch.float64, device=b.device)
    s = {"x": x, "r": r, "v": torch.zeros_like(r), "p": torch.zeros_like(r),
         "rho": one, "alpha": one, "omega": one}
    rhat = r

    def step():
        x, r, v, p = s["x"], s["r"], s["v"], s["p"]
        rho, alpha, omega = s["rho"], s["alpha"], s["omega"]
        dt = r.dtype
        rho_new = _dot(rhat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta.to(dt) * (p - omega.to(dt) * v)
        phat = M(p)
        v = matvec(phat)
        alpha = _safe_div(rho_new, _dot(rhat, v))
        s_vec = r - alpha.to(dt) * v
        shat = M(s_vec)
        t = matvec(shat)
        omega = _safe_div(_dot(t, s_vec), _dot(t, t))
        x = x + alpha.to(x.dtype) * phat + omega.to(x.dtype) * shat
        r = s_vec - omega.to(dt) * t
        s.update(x=x, r=r, v=v, p=p, rho=rho_new, alpha=alpha, omega=omega)
        return torch.sqrt(_dot(r, r))

    k, hist, tol_eff = _loop(step, torch.sqrt(_dot(r, r)), tol,
                             torch.sqrt(_dot(b, b)), maxiter)
    return s["x"], _info("bicgstab", k, hist, tol_eff)


def _back_substitute(R: np.ndarray, g: np.ndarray) -> np.ndarray:
    """y with R y = g, R upper triangular."""
    m = len(g)
    y = np.zeros(m)
    for i in range(m - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:] @ y[i + 1:]) / R[i, i]
    return y


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, *,
          precond: Optional[Callable] = None, tol: float = 1e-10,
          restart: int = 30, maxiter: int = 300
          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Flexible restarted GMRES: right-preconditioned Arnoldi with modified
    Gram-Schmidt and Givens rotations, so the recurrence residuals are true
    residual norms and a varying preconditioner (a multigrid cycle) is
    safe.

    Each cycle runs all ``restart`` inner steps before the true residual is
    tested, so 'iterations' moves in multiples of ``restart``; 'history'
    holds ||r0|| and then every inner step's Givens estimate |g_{j+1}|. The
    basis vectors, the MGS updates and the solution update stay on the
    vectors' device; each inner step reads its Hessenberg column back (one
    transfer) and the rotations and the triangular solve run on the host
    in float64."""
    M = precond or _identity
    m = restart
    dtype = b.dtype
    total = max(1, -(-maxiter // restart)) * m
    x, r0 = _start(matvec, b, x0)
    rnorm, bnorm = torch.stack([torch.sqrt(_dot(r0, r0)),
                                torch.sqrt(_dot(b, b))]).tolist()
    tol_eff = tol * max(bnorm, _TINY)
    hist = [rnorm]
    k = 0
    while rnorm > tol_eff and k < total:
        r = b - matvec(x)
        beta = torch.sqrt(_dot(r, r))
        V = [r / torch.clamp(beta, min=_TINY).to(dtype)]
        Z = []
        H = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta.item()
        for j in range(m):
            z = M(V[j])
            w = matvec(z)
            Z.append(z)
            col = []
            for i in range(j + 1):  # modified Gram-Schmidt against V[0..j]
                h = _dot(w, V[i])
                w = w - h.to(dtype) * V[i]
                col.append(h)
            hnext = torch.sqrt(_dot(w, w))
            V.append(w / torch.clamp(hnext, min=_TINY).to(dtype))
            col = torch.stack(col + [hnext]).tolist()
            H[: j + 2, j] = col
            for i in range(j):  # the rotations so far, on column j
                hi = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = hi
            denom = math.sqrt(H[j, j] ** 2 + H[j + 1, j] ** 2)
            cs[j] = _safe_div(H[j, j], denom)
            sn[j] = _safe_div(H[j + 1, j], denom)
            H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
            H[j + 1, j] = 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            hist.append(abs(g[j + 1]))
        R = H[:m, :m].copy()
        diag = np.diag(R)
        R[np.diag_indices(m)] += np.where(np.abs(diag) < _TINY, _TINY, 0.0)
        y = torch.as_tensor(_back_substitute(R, g[:m]), device=b.device)
        y = y.to(dtype)
        for j in range(m):
            x = x + y[j] * Z[j]
        k += m
        r = b - matvec(x)
        rnorm = torch.sqrt(_dot(r, r)).item()
    return x, {"iterations": k, "residual_norm": rnorm,
               "history": np.asarray(hist, dtype=np.float64),
               "converged": rnorm <= tol_eff, "method": "fgmres"}


def stencil_matvec_np(stencil, unknown) -> Callable:
    """NumPy twin of :func:`stencil_matvec` for host Krylov loops (5-point
    ``Stencil`` only): a neighbour outside the array reads zero."""
    if isinstance(stencil, Stencil9):
        raise NotImplementedError("stencil_matvec_np takes 5-point "
                                  "stencils only")
    un = np.asarray(unknown.cpu() if torch.is_tensor(unknown) else unknown)

    def leaf(x):
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return np.broadcast_to(np.asarray(x, np.float64), un.shape)

    c, w, e, s, n = (leaf(x) for x in stencil.coefs)

    def mv(x):
        p = np.pad(np.asarray(x, np.float64), 1)
        ns = (w * p[:-2, 1:-1] + e * p[2:, 1:-1]
              + s * p[1:-1, :-2] + n * p[1:-1, 2:])
        return np.where(un, c * p[1:-1, 1:-1] - ns, 0.0)

    return mv


def pcg_host(matvec: Callable, b, x0=None, *,
             precond: Optional[Callable] = None, tol: float = 1e-10,
             maxiter: int = 500) -> Tuple[np.ndarray, Dict[str, Any]]:
    """:func:`pcg`'s method and stopping rule in NumPy on the host, for
    preconditioners that run there (ILU's triangular solves)."""
    b = np.asarray(b, np.float64)
    x = (np.zeros_like(b) if x0 is None
         else np.asarray(x0, np.float64).copy())
    M = precond if precond is not None else (lambda r: r)
    r = b - np.asarray(matvec(x), np.float64)
    z = np.asarray(M(r), np.float64)
    p = z.copy()
    rz = float((r * z).sum())
    tol_eff = tol * max(float(np.sqrt((b * b).sum())), _TINY)
    hist = [float(np.sqrt((r * r).sum()))]
    k = 0
    while hist[-1] > tol_eff and k < maxiter:
        Ap = np.asarray(matvec(p), np.float64)
        denom = float((p * Ap).sum())
        alpha = rz / denom if abs(denom) > _TINY else 0.0
        x += alpha * p
        r -= alpha * Ap
        hist.append(float(np.sqrt((r * r).sum())))
        z = np.asarray(M(r), np.float64)
        rz_new = float((r * z).sum())
        beta = rz_new / rz if abs(rz) > _TINY else 0.0
        rz = rz_new
        p = z + beta * p
        k += 1
    return x, {"iterations": k, "residual_norm": hist[-1],
               "history": np.asarray(hist), "converged": hist[-1] <= tol_eff,
               "method": "pcg_host"}
