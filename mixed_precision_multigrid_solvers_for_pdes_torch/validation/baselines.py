"""Performance baselines: this package's multigrid against scipy's direct
and Krylov solvers (and pyamg / petsc when installed) on the same discrete
systems.

Counterpart of ``_assemble_csr``, ``BaselineRow`` and
``PerformanceBaselines`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/validation/baselines.py``.
``run_ours`` times ``solve_poisson`` on ``device`` (the card when None:
kernels A-D on fp32 and mixed levels); the scipy, pyamg and petsc solvers
run on the host. Every number is measured.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..applications.poisson import solve_poisson
from ..core import bc as bc_mod
from ..models.problems import Problem
from ..ops import stencil as st_mod
from ..solvers.multigrid import MultigridConfig
from ..utils.timing import benchmark_function


def _plane(x, shape) -> np.ndarray:
    """A stencil leaf (a float or a tensor) as a float64 host array of
    ``shape``."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.broadcast_to(np.asarray(x, dtype=np.float64), shape)


def _assemble_csr(problem: Problem):
    """The masked 5-point matrix of ``problem`` in float64, its right-hand
    side (Dirichlet neighbours moved into it), the (i, j) indices of the
    unknowns and the start field with the Dirichlet values, for the scipy
    baselines.

    The JAX package's loop over every unknown and neighbour, done with index
    arithmetic on the logical (nx, ny) grid: the unknowns are numbered in the
    same row-major order, each row holds the diagonal and every unknown
    neighbour (W, E, S, N), and the Dirichlet neighbours are added into the
    right-hand side in that order, so the matrix is the JAX package's entry
    for entry. A neighbour off the grid contributes nothing (the JAX package
    reads its zero padding there)."""
    import scipy.sparse as sp

    grid, spec = problem.grid, problem.spec
    shape = grid.shape
    st = st_mod.make_stencil(grid, spec, a=problem.a, lam=problem.lam,
                             dtype=torch.float64)
    unknown = bc_mod.unknown_mask(grid.nx, grid.ny, spec).numpy()
    idx = np.full(shape, -1, dtype=np.int64)
    ii, jj = np.nonzero(unknown)
    k = np.arange(ii.size)
    idx[ii, jj] = k

    rhs = problem.rhs(torch.float64).numpy()
    u0 = problem.initial_guess(torch.float64).numpy()
    b = rhs[ii, jj].astype(np.float64).copy()
    rows, cols, vals = [k], [k], [_plane(st.c, shape)[ii, jj]]
    for di, dj, cf in ((-1, 0, st.w), (1, 0, st.e),
                       (0, -1, st.s), (0, 1, st.n)):
        ni, nj = ii + di, jj + dj
        inside = (ni >= 0) & (ni < shape[0]) & (nj >= 0) & (nj < shape[1])
        c = _plane(cf, shape)[ii, jj]
        nb = np.full(ii.size, -1, dtype=np.int64)
        nb[inside] = idx[ni[inside], nj[inside]]
        coupled = nb >= 0
        rows.append(k[coupled])
        cols.append(nb[coupled])
        vals.append(-c[coupled])
        fixed = inside & ~coupled  # Dirichlet neighbour into the RHS
        b[fixed] += c[fixed] * u0[ni[fixed], nj[fixed]]
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(ii.size, ii.size))
    return A, b, (ii, jj), u0


@dataclasses.dataclass
class BaselineRow:
    solver: str
    n: int
    wall_s: float
    iterations: int
    final_residual: float
    error_l2: Optional[float]
    available: bool = True

    def to_dict(self):
        return dataclasses.asdict(self)


class PerformanceBaselines:
    """Benchmark this package's multigrid (on ``device``, the card when
    None) against external solvers on the same discrete systems."""

    def __init__(self, cfg: MultigridConfig = MultigridConfig(
            smoother="rbgs", omega=1.0, tol=1e-8), *, device=None):
        self.cfg = cfg
        self.device = device
        self.rows: List[BaselineRow] = []

    # ---- individual baselines ----------------------------------------------

    def run_ours(self, problem: Problem, precision: str = "fp64",
                 runs: int = 3) -> BaselineRow:
        res = solve_poisson(problem, precision=precision, cfg=self.cfg,
                            device=self.device)
        stats = benchmark_function(
            lambda: solve_poisson(problem, precision=precision, cfg=self.cfg,
                                  device=self.device),
            warmup=0, runs=runs,
        )
        row = BaselineRow(
            solver=f"ours_{precision}", n=problem.grid.nx,
            wall_s=stats["min_s"], iterations=res.iterations,
            final_residual=res.info["residual_norm"],
            error_l2=res.errors["l2"] if res.errors else None,
        )
        self.rows.append(row)
        return row

    def _scipy_result(self, problem, name, solve_fn, runs: int = 3):
        A, b, (ii, jj), u0 = _assemble_csr(problem)
        iters_box = [0]
        x, info_iters = solve_fn(A, b, iters_box)
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            solve_fn(A, b, iters_box)
            times.append(time.perf_counter() - t0)
        r = b - A @ x
        u = u0.copy()
        u[ii, jj] = x
        err = None
        if problem.exact is not None:
            g = problem.grid
            diff = u - np.asarray(problem.exact)
            err = float(np.sqrt(g.hx * g.hy * np.sum(diff**2)))
        row = BaselineRow(
            solver=name, n=problem.grid.nx, wall_s=float(np.min(times)),
            iterations=info_iters, final_residual=float(np.linalg.norm(r)),
            error_l2=err,
        )
        self.rows.append(row)
        return row

    def run_scipy_direct(self, problem: Problem, runs: int = 3) -> BaselineRow:
        from scipy.sparse.linalg import spsolve

        def f(A, b, box):
            return spsolve(A.tocsc(), b), 1

        return self._scipy_result(problem, "scipy_spsolve", f, runs)

    def run_scipy_cg(self, problem: Problem, runs: int = 3) -> BaselineRow:
        from scipy.sparse.linalg import cg

        def f(A, b, box):
            box[0] = 0

            def cb(_):
                box[0] += 1

            x, _ = cg(A, b, rtol=self.cfg.tol, maxiter=20000, callback=cb)
            return x, box[0]

        return self._scipy_result(problem, "scipy_cg", f, runs)

    def run_scipy_gmres(self, problem: Problem, runs: int = 3) -> BaselineRow:
        from scipy.sparse.linalg import gmres

        def f(A, b, box):
            box[0] = 0

            def cb(_):
                box[0] += 1

            x, _ = gmres(A, b, rtol=self.cfg.tol, maxiter=20000,
                         restart=30, callback=cb,
                         callback_type="pr_norm")
            return x, box[0]

        return self._scipy_result(problem, "scipy_gmres", f, runs)

    def run_pyamg(self, problem: Problem, runs: int = 3) -> Optional[BaselineRow]:
        try:
            import pyamg  # noqa: F401
        except ImportError:
            self.rows.append(BaselineRow("pyamg", problem.grid.nx, float("nan"),
                                         0, float("nan"), None, available=False))
            return None

        def f(A, b, box):
            ml = pyamg.ruge_stuben_solver(A.tocsr())
            res: list = []
            x = ml.solve(b, tol=self.cfg.tol, residuals=res)
            return x, len(res) - 1

        return self._scipy_result(problem, "pyamg", f, runs)

    def run_petsc(self, problem: Problem, runs: int = 3) -> Optional[BaselineRow]:
        """PETSc KSP(CG)+GAMG baseline; a row marked unavailable and None
        when petsc4py is absent."""
        try:
            from petsc4py import PETSc  # noqa: F401
        except ImportError:
            self.rows.append(BaselineRow("petsc", problem.grid.nx, float("nan"),
                                         0, float("nan"), None, available=False))
            return None

        cache: Dict[str, Any] = {}

        def f(A, b, box):
            from petsc4py import PETSc

            if not cache:
                # assemble the AIJ matrix and the KSP/GAMG hierarchy ONCE
                # (outside the timed repeats): the ours_* rows time hot
                # solves, so the petsc row must too — the first (untimed)
                # warmup call in _scipy_result pays the setup.
                csr = A.tocsr()
                Ap = PETSc.Mat().createAIJ(
                    size=csr.shape, csr=(csr.indptr, csr.indices, csr.data))
                ksp = PETSc.KSP().create()
                ksp.setOperators(Ap)
                ksp.setType("cg")
                ksp.getPC().setType("gamg")
                ksp.setTolerances(rtol=self.cfg.tol, max_it=20000)
                ksp.setUp()
                cache["ksp"] = ksp
                cache["vecs"] = Ap.createVecs()
            ksp = cache["ksp"]
            xb, bb = cache["vecs"]
            xb.set(0.0)
            bb.setArray(b)
            ksp.solve(bb, xb)
            return xb.getArray().copy(), ksp.getIterationNumber()

        return self._scipy_result(problem, "petsc", f, runs)

    # ---- suite -------------------------------------------------------------

    def run_suite(
        self,
        problem_factory: Callable[[int], Problem],
        sizes: Sequence[int] = (65, 129, 257),
        *,
        include: Sequence[str] = ("ours_fp64", "ours_mixed", "scipy_spsolve",
                                  "scipy_cg", "pyamg", "petsc"),
        runs: int = 3,
    ) -> List[BaselineRow]:
        for n in sizes:
            prob = problem_factory(n)
            if "ours_fp64" in include:
                self.run_ours(prob, "fp64", runs)
            if "ours_mixed" in include:
                self.run_ours(prob, "mixed", runs)
            if "scipy_spsolve" in include:
                self.run_scipy_direct(prob, runs)
            if "scipy_cg" in include:
                self.run_scipy_cg(prob, runs)
            if "scipy_gmres" in include:
                self.run_scipy_gmres(prob, runs)
            if "pyamg" in include:
                self.run_pyamg(prob, runs)
            if "petsc" in include:
                self.run_petsc(prob, runs)
        return self.rows

    def complexity_exponents(self) -> Dict[str, float]:
        """Fit wall_s ~ N^p per solver."""
        out: Dict[str, float] = {}
        by_solver: Dict[str, List[BaselineRow]] = {}
        for r in self.rows:
            if r.available and np.isfinite(r.wall_s):
                by_solver.setdefault(r.solver, []).append(r)
        for s, rows in by_solver.items():
            if len(rows) < 2:
                continue
            N = np.array([(r.n - 2) ** 2 for r in rows], float)
            t = np.array([r.wall_s for r in rows], float)
            out[s] = float(np.polyfit(np.log(N), np.log(np.maximum(t, 1e-9)), 1)[0])
        return out

    def report(self) -> Dict[str, Any]:
        return {
            "rows": [r.to_dict() for r in self.rows],
            "complexity_exponents": self.complexity_exponents(),
        }

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=2))
