"""Sparse direct LU factorization (host side).

Native capability replacing the reference's external direct-solver wrappers
(UMFPACK /root/reference/src/solver-umfpack.cxx:107-153, KLU
solver-klu.cxx:8-41, SuperLU solver-superlu.cxx:28-85, MUMPS
solver-mumps.cxx:162-210, PARDISO solver-pardiso.cxx:10-116): a
left-looking Gilbert–Peierls LU with threshold partial pivoting, RCM
fill-reducing pre-ordering, factored once on the host; the triangular
solves then run on the device as level-scheduled sweeps
(lssp_tpu/ops/trisolve.py), so repeated solves with new right-hand sides
are pure device programs — the device analog of the reference's cached
``factored`` flag (solver-umfpack.cxx:43-44).

The C++ kernel in lssp_tpu/native/src/splu.cpp is the fast path; the Python
implementation below is the oracle/fallback (identical algorithm).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from lssp_tpu.config import Defaults
from lssp_tpu.sparse.types import CSR
from lssp_tpu.sparse.utils import transpose


@dataclasses.dataclass(frozen=True)
class SpLU:
    """Host-side factorization result: A[perm][:,perm] row-pivoted to L·U.

    Solve protocol:  x = (U⁻¹ L⁻¹ b[perm_in])[perm_out]
    where ``perm_in`` composes the fill-reducing symmetric ordering with the
    pivot row permutation and ``perm_out`` undoes the column ordering.
    """

    L: CSR              # strict lower, unit diagonal implied
    U: CSR              # upper, diagonal stored
    perm_in: np.ndarray
    perm_out: np.ndarray
    nclamped: int       # number of near-zero pivots clamped (0 = exact)

    def fill_ratio(self, A: CSR) -> float:
        """(nnz(L)+nnz(U))/nnz(A), the reference's ILU quality print
        (/root/reference/src/pc-iluk.cxx:548-551)."""
        return (self.L.nnz + self.U.nnz) / max(1, A.nnz)


def _splu_python(Ap, Ai, Ax, n, pivot_tol, ztol, zval):
    """Pure-Python Gilbert–Peierls (oracle for the C++ kernel)."""
    Lp = [0]; Li = []; Lx = []
    Up = [0]; Ui = []; Ux = []
    pinv = np.full(n, -1, dtype=np.int64)
    x = np.zeros(n)
    mark = np.zeros(n, dtype=bool)
    nclamped = 0
    for j in range(n):
        # reach via iterative DFS through existing L columns
        topstack = []
        for p in range(Ap[j], Ap[j + 1]):
            root = Ai[p]
            if mark[root]:
                continue
            stack = [(root, 0)]
            mark[root] = True
            while stack:
                i, q = stack[-1]
                jf = pinv[i]
                advanced = False
                if jf >= 0:
                    for qq in range(Lp[jf] + q, Lp[jf + 1]):
                        ii = Li[qq]
                        if not mark[ii]:
                            stack[-1] = (i, qq - Lp[jf] + 1)
                            stack.append((ii, 0))
                            mark[ii] = True
                            advanced = True
                            break
                if not advanced:
                    stack.pop()
                    topstack.append(i)
        pattern = topstack[::-1]                     # topological order
        for i in pattern:
            x[i] = 0.0
        for p in range(Ap[j], Ap[j + 1]):
            x[Ai[p]] = Ax[p]
        for i in pattern:
            jf = pinv[i]
            if jf < 0 or x[i] == 0.0:
                continue
            xv = x[i]
            for q in range(Lp[jf], Lp[jf + 1]):
                x[Li[q]] -= Lx[q] * xv
        ipiv, amax = -1, 0.0
        for i in pattern:
            if pinv[i] < 0 and abs(x[i]) > amax:
                amax, ipiv = abs(x[i]), i
        if ipiv < 0:
            ipiv = int(np.flatnonzero(pinv < 0)[0])
            pivot = 0.0
        else:
            if mark[j] and pinv[j] < 0 and abs(x[j]) >= pivot_tol * amax \
                    and abs(x[j]) > 0.0:
                ipiv = j
            pivot = x[ipiv]
        if abs(pivot) <= ztol:
            pivot = zval if pivot >= 0 else -zval
            nclamped += 1
        pinv[ipiv] = j
        for i in pattern:
            mark[i] = False
            if pinv[i] >= 0 and i != ipiv and x[i] != 0.0:
                Ui.append(pinv[i]); Ux.append(x[i])
        Ui.append(j); Ux.append(pivot)
        Up.append(len(Ui))
        for i in pattern:
            if pinv[i] < 0 and x[i] != 0.0:
                Li.append(i); Lx.append(x[i] / pivot)
        Lp.append(len(Li))
    Li = pinv[np.asarray(Li, dtype=np.int64)] if Li else np.zeros(0, np.int64)
    return (np.asarray(Lp, np.int64), np.asarray(Li, np.int64),
            np.asarray(Lx, np.float64), np.asarray(Up, np.int64),
            np.asarray(Ui, np.int64), np.asarray(Ux, np.float64),
            pinv, nclamped)


def splu_factor(A: CSR, order: str = "amd", pivot_tol: float = 0.1,
                ztol: float = None, zval: float = None,
                method: str = "auto") -> SpLU:
    """Factor the square CSR matrix A.

    ``method``: "auto" (default) routes to the supernodal multifrontal
    engine (pc/multifrontal.py — BLAS-3 fronts, the reference's
    UMFPACK/MUMPS performance class; measured ~10× this scalar path on
    the vendored coupled3d matrix) when the native toolchain is available
    and the matrix is big enough to amortize it; "supernodal"/"mf" forces
    it; "gp" forces the scalar Gilbert–Peierls below.  The multifrontal
    engine always uses AMD+postorder ordering and block-restricted
    partial pivoting (MUMPS-style), so ``order``/``pivot_tol`` apply to
    the scalar path only.

    ``order``: "amd" (default) applies the minimum-degree fill-reducing
    ordering (sparse/reorder.py: amd_permutation) — for LU, fill is the
    only objective, and minimum degree wins even on banded patterns
    (measured on the vendored matrices: convdiff fill 10.05 amd vs
    34.75 rcm vs 15.0 scipy-COLAMD; coupled3d 70.6 vs 499.3 vs 131.3).
    "rcm" applies the bandwidth-reducing permutation; None factors as
    given.
    ``pivot_tol``: diagonal entries within this factor of the column max are
    kept as pivots (1.0 = strict partial pivoting, 0 = no pivoting beyond
    structure); near-zero pivots are clamped like the reference's ILU guard
    (/root/reference/src/pc-iluk.cxx:367-374).
    """
    n = A.shape[0]
    assert A.shape[0] == A.shape[1], "direct solver needs a square matrix"
    if method in ("supernodal", "mf") or (
            method == "auto" and n >= 512 and order in ("amd", "auto")):
        from lssp_tpu import native
        if method != "auto" or native.available():
            from lssp_tpu.pc.multifrontal import mf_factor
            return mf_factor(A, pivot_tol=pivot_tol, ztol=ztol, zval=zval)
    ztol = Defaults.ZERO_DIAG_TOL if ztol is None else ztol
    zval = Defaults.ZERO_DIAG_VALUE if zval is None else zval
    p = np.arange(n, dtype=np.int64)
    B = A
    if order == "auto":
        order = "amd"
    if order == "rcm" and n > 1:
        from lssp_tpu.sparse.reorder import rcm_permutation, permute_symmetric
        p = np.asarray(rcm_permutation(A), dtype=np.int64)
        B = permute_symmetric(A, p)
    elif order == "amd" and n > 1:
        from lssp_tpu.sparse.reorder import amd_permutation, permute_symmetric
        p = np.asarray(amd_permutation(A), dtype=np.int64)
        B = permute_symmetric(A, p)
    # native kernel wants CSC = CSR of Bᵀ
    Bt = transpose(B)
    Ap = np.asarray(Bt.indptr, np.int64)
    Ai = np.asarray(Bt.indices, np.int64)
    Ax = np.asarray(Bt.data, np.float64)
    from lssp_tpu import native
    if native.available():
        Lp, Li, Lx, Up, Ui, Ux, pinv, ncl = native.splu(
            Ap, Ai, Ax, n, pivot_tol, ztol, zval)
    else:
        Lp, Li, Lx, Up, Ui, Ux, pinv, ncl = _splu_python(
            Ap, Ai, Ax, n, pivot_tol, ztol, zval)
    # CSC arrays are the CSR of the transposed factor
    L_csr = transpose(CSR(Lp, Li, Lx, (n, n)))
    U_csr = transpose(CSR(Up, Ui, Ux, (n, n)))
    rowperm = np.argsort(pinv)                  # pivot position -> orig row
    perm_in = p[rowperm]                        # b -> P·(b[p])
    perm_out = np.argsort(p)                    # y -> x (undo column perm)
    return SpLU(L=L_csr, U=U_csr,
                perm_in=perm_in.astype(np.int32),
                perm_out=perm_out.astype(np.int32), nclamped=int(ncl))
