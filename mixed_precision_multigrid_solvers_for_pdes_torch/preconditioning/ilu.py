"""ILU preconditioners for the 5-point stencil (host NumPy path).

Counterpart of ``ILUPreconditioner`` and ``ILUKPreconditioner`` in
``mixed_precision_multigrid_solvers_for_pdes_tpu/preconditioning/ilu.py``,
a copy of its NumPy/SciPy code on the port's (nx, ny) layout: the JAX
module imports no JAX, but this package imports nothing of the JAX
package. Stencils are the port's (float or tensor leaves); ``unknown`` and
the vectors given to ``apply`` are NumPy arrays or CPU tensors, and
``apply`` returns a NumPy array of the input's dtype. For the 5-point
stencil ILU(0) reduces to a modified-diagonal recurrence

    d[i,j] = c[i,j] - w[i,j]*e[i-1,j]/d[i-1,j] - s[i,j]*n[i,j-1]/d[i,j-1]

with unit-lower / upper triangular solves swept over grid anti-diagonals
(wavefronts) so each sweep step is vectorized. Triangular substitution is
inherently sequential across wavefronts: a host path for parity and
CPU-side comparisons; on the card use ``chebyshev`` or
``multigrid_preconditioner`` (``solvers.krylov.pcg_host`` runs the CG loop
on the host around it).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

import torch

from ..core.grid import Grid
from ..ops.stencil import Stencil, Stencil9


def _require_5pt(stencil):
    if isinstance(stencil, Stencil9):
        # silently dropping the corner couplings would factorize the wrong
        # matrix; ILU setup is host-side and 5-point only
        raise NotImplementedError(
            "ILU preconditioners support 5-point stencils only "
            "(Galerkin 9-point levels: use diagonal/line/Chebyshev/MG "
            "preconditioners)"
        )


def _host(x) -> np.ndarray:
    """A NumPy view of a tensor (moved to the CPU), array or scalar."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _expand(x, shape) -> np.ndarray:
    x = np.asarray(_host(x), dtype=np.float64)
    return np.broadcast_to(x, shape).copy() if x.ndim == 0 else x.astype(np.float64)


class ILUPreconditioner:
    """ILU(0) of the masked 5-point stencil matrix, lexicographic order.

    apply() takes (nx, ny) arrays (NumPy or CPU tensors) and returns NumPy.
    """

    def __init__(self, grid: Grid, stencil: Stencil, unknown):
        _require_5pt(stencil)
        self.grid = grid
        pshape = grid.shape
        un = _host(unknown)
        self._un = un
        # masked coefficients: identity rows off the unknown set
        c = _expand(stencil.c, pshape)
        w = _expand(stencil.w, pshape) * un
        e = _expand(stencil.e, pshape) * un
        s = _expand(stencil.s, pshape) * un
        n = _expand(stencil.n, pshape) * un
        c = np.where(un, c, 1.0)
        # couplings into non-unknown neighbors contribute nothing
        w[1:, :] *= un[:-1, :]
        w[0, :] = 0.0
        e[:-1, :] *= un[1:, :]
        e[-1, :] = 0.0
        s[:, 1:] *= un[:, :-1]
        s[:, 0] = 0.0
        n[:, :-1] *= un[:, 1:]
        n[:, -1] = 0.0
        self._w, self._e, self._s, self._n = w, e, s, n

        # modified diagonal via wavefront recurrence
        px, py = pshape
        d = c.copy()
        for k in range(1, px + py - 1):  # anti-diagonal i + j = k
            i0 = max(0, k - py + 1)
            i1 = min(k, px - 1)
            ii = np.arange(i0, i1 + 1)
            jj = k - ii
            upd = np.zeros(ii.size)
            has_w = ii >= 1
            upd[has_w] += (w[ii[has_w], jj[has_w]]
                           * e[ii[has_w] - 1, jj[has_w]]
                           / d[ii[has_w] - 1, jj[has_w]])
            has_s = jj >= 1
            upd[has_s] += (s[ii[has_s], jj[has_s]]
                           * n[ii[has_s], jj[has_s] - 1]
                           / d[ii[has_s], jj[has_s] - 1])
            d[ii, jj] -= upd
        self._d = d
        self._px, self._py = px, py

    def apply(self, r):
        """z = U^{-1} L^{-1} r ((nx, ny) in and out; zero off unknowns)."""
        r_np = np.where(self._un, np.asarray(_host(r), dtype=np.float64), 0.0)
        px, py = self._px, self._py
        w, e, s, n, d = self._w, self._e, self._s, self._n, self._d
        # forward: (unit lower) y = r + (w/d_W) y_W + (s/d_S) y_S
        y = r_np.copy()
        for k in range(1, px + py - 1):
            i0 = max(0, k - py + 1)
            i1 = min(k, px - 1)
            ii = np.arange(i0, i1 + 1)
            jj = k - ii
            acc = np.zeros(ii.size)
            has_w = ii >= 1
            acc[has_w] += (w[ii[has_w], jj[has_w]]
                           / d[ii[has_w] - 1, jj[has_w]]
                           * y[ii[has_w] - 1, jj[has_w]])
            has_s = jj >= 1
            acc[has_s] += (s[ii[has_s], jj[has_s]]
                           / d[ii[has_s], jj[has_s] - 1]
                           * y[ii[has_s], jj[has_s] - 1])
            y[ii, jj] += acc
        # backward: z = (y + e z_E + n z_N) / d
        z = np.zeros_like(y)
        for k in range(px + py - 2, -1, -1):
            i0 = max(0, k - py + 1)
            i1 = min(k, px - 1)
            ii = np.arange(i0, i1 + 1)
            jj = k - ii
            acc = y[ii, jj].copy()
            has_e = ii <= px - 2
            acc[has_e] += (e[ii[has_e], jj[has_e]]
                           * z[ii[has_e] + 1, jj[has_e]])
            has_n = jj <= py - 2
            acc[has_n] += (n[ii[has_n], jj[has_n]]
                           * z[ii[has_n], jj[has_n] + 1])
            z[ii, jj] = acc / d[ii, jj]
        z = np.where(self._un, z, 0.0)
        return z.astype(_host(r).dtype)

    __call__ = apply

    def memory_usage(self) -> Dict[str, Any]:
        """Factor storage: ILU(0) keeps the original sparsity, 5 arrays of
        the grid's shape."""
        nnz = int(self._un.sum()) * 5
        return {
            "matrix_nnz": nnz,
            "factor_nnz": nnz,
            "fill_ratio": 1.0,
            "bytes": 5 * self._d.nbytes,
        }


# ---------------------------------------------------------------------------
# ILU(k) with level-of-fill + drop tolerance (general sparse, host path)
# ---------------------------------------------------------------------------

class ILUKPreconditioner:
    """ILU(k) of the masked 5-point matrix with symbolic level-of-fill,
    optional drop tolerance, and optional MILU diagonal compensation.

    The symbolic algorithm: levels lev(a_ij) = 0 on the original pattern;
    a fill entry created when eliminating column t of row i gets
    lev_it + lev_tj + 1 and is kept iff it is <= fill_level.

    Numeric factorization is the IKJ variant on the fixed symbolic pattern;
    with ``drop_tolerance`` > 0, entries with |v| < tol * ||row||_inf are
    dropped (diagonal always kept); with ``milu=True`` the dropped mass is
    subtracted from the diagonal (row-sum preservation).

    Triangular solves are sequential by nature: a host NumPy path, like
    ILU(0) above.
    """

    def __init__(self, grid: Grid, stencil: Stencil, unknown, *,
                 fill_level: int = 1, drop_tolerance: float = 0.0,
                 milu: bool = False, diagonal_shift: float = 0.0):
        _require_5pt(stencil)
        self.grid = grid
        self.fill_level = int(fill_level)
        self.drop_tolerance = float(drop_tolerance)
        self.milu = bool(milu)
        pshape = grid.shape
        un = _host(unknown)
        self._un = un
        px, py = pshape

        # unknown nodes in lexicographic (i, j) order -> vector indices
        idx = -np.ones(pshape, dtype=np.int64)
        nodes = np.argwhere(un)
        idx[nodes[:, 0], nodes[:, 1]] = np.arange(nodes.shape[0])
        self._idx, self._nodes = idx, nodes
        nn = nodes.shape[0]

        c = _expand(stencil.c, pshape)
        w = _expand(stencil.w, pshape)
        e = _expand(stencil.e, pshape)
        s = _expand(stencil.s, pshape)
        n = _expand(stencil.n, pshape)

        # rows as {col: (level, value)} dicts; neighbors only if unknown
        rows = []
        orig_nnz = 0
        for r, (i, j) in enumerate(nodes):
            row = {r: c[i, j]}
            for di, dj, coef in ((-1, 0, -w[i, j]), (1, 0, -e[i, j]),
                                 (0, -1, -s[i, j]), (0, 1, -n[i, j])):
                ii, jj = i + di, j + dj
                if 0 <= ii < px and 0 <= jj < py and idx[ii, jj] >= 0:
                    row[idx[ii, jj]] = coef
            orig_nnz += len(row)
            rows.append(row)
        self._orig_nnz = orig_nnz

        # combined symbolic+numeric IKJ factorization with level tracking.
        # After processing, row i holds L (cols < i, multipliers) and U
        # (cols >= i) entries.
        lev_rows = [{cc: 0 for cc in row} for row in rows]
        vals = [dict(row) for row in rows]
        K = self.fill_level
        tol = self.drop_tolerance
        for i in range(nn):
            vi, li = vals[i], lev_rows[i]
            row_norm = max(abs(v) for v in vi.values())
            # eliminate in increasing column order (cols < i); the worklist
            # re-scans because updates can INTRODUCE new L-part columns
            # (level-<=K fill with t < col < i) that must themselves be
            # eliminated — a precomputed list silently skips them and the
            # factorization diverges
            processed = set()
            while True:
                t = min((cc for cc in vi
                         if cc < i and cc not in processed), default=None)
                if t is None:
                    break
                processed.add(t)
                piv = vals[t].get(t, 0.0)
                if piv == 0.0:
                    continue
                m = vi[t] / piv
                vi[t] = m
                lev_it = li[t]
                dropped = 0.0
                for cj, vtj in vals[t].items():
                    if cj <= t:
                        continue
                    lev_new = lev_it + lev_rows[t][cj] + 1
                    if cj in vi:
                        vi[cj] -= m * vtj
                        if lev_new < li[cj]:
                            li[cj] = lev_new
                    elif lev_new <= K:
                        upd = -m * vtj
                        if tol > 0.0 and abs(upd) < tol * row_norm and cj != i:
                            dropped += upd
                        else:
                            vi[cj] = upd
                            li[cj] = lev_new
                if self.milu and dropped != 0.0:
                    vi[i] = vi.get(i, 0.0) - dropped
            if diagonal_shift:
                vi[i] = vi.get(i, 0.0) + diagonal_shift * abs(vi.get(i, 1.0))

        # pack L (unit lower) and U (upper incl. diagonal) in CSR
        import scipy.sparse as sp

        li_, lj_, lv_ = [], [], []
        ui_, uj_, uv_ = [], [], []
        for i in range(nn):
            for cj, v in vals[i].items():
                if cj < i:
                    li_.append(i); lj_.append(cj); lv_.append(v)
                else:
                    ui_.append(i); uj_.append(cj); uv_.append(v)
            li_.append(i); lj_.append(i); lv_.append(1.0)
        self._L = sp.csr_matrix((lv_, (li_, lj_)), shape=(nn, nn))
        self._U = sp.csr_matrix((uv_, (ui_, uj_)), shape=(nn, nn))
        self._nn = nn

    def apply(self, r):
        import scipy.sparse.linalg as spla

        r_np = np.asarray(_host(r), dtype=np.float64)
        vec = r_np[self._nodes[:, 0], self._nodes[:, 1]]
        y = spla.spsolve_triangular(self._L, vec, lower=True,
                                    unit_diagonal=True)
        z = spla.spsolve_triangular(self._U, y, lower=False)
        out = np.zeros(self.grid.shape, dtype=np.float64)
        out[self._nodes[:, 0], self._nodes[:, 1]] = z
        return out.astype(_host(r).dtype)

    __call__ = apply

    def apply_transpose(self, r):
        """z = L^{-T} U^{-T} r, the adjoint of ``apply``."""
        import scipy.sparse.linalg as spla

        r_np = np.asarray(_host(r), dtype=np.float64)
        vec = r_np[self._nodes[:, 0], self._nodes[:, 1]]
        y = spla.spsolve_triangular(self._U.T.tocsr(), vec, lower=True)
        z = spla.spsolve_triangular(self._L.T.tocsr(), y, lower=False,
                                    unit_diagonal=True)
        out = np.zeros(self.grid.shape, dtype=np.float64)
        out[self._nodes[:, 0], self._nodes[:, 1]] = z
        return out.astype(_host(r).dtype)

    def memory_usage(self) -> Dict[str, Any]:
        l_nnz = int(self._L.nnz) - self._nn  # exclude stored unit diagonal
        u_nnz = int(self._U.nnz)
        return {
            "matrix_nnz": self._orig_nnz,
            "factor_nnz": l_nnz + u_nnz,
            "fill_ratio": (l_nnz + u_nnz) / max(self._orig_nnz, 1),
            "bytes": int(self._L.data.nbytes + self._L.indices.nbytes
                         + self._L.indptr.nbytes + self._U.data.nbytes
                         + self._U.indices.nbytes + self._U.indptr.nbytes),
        }
