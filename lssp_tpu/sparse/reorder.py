"""Bandwidth-reducing reordering (RCM) for the streaming execution formats.

A reverse-Cuthill–McKee symmetric permutation crushes the bandwidth of an
unstructured matrix so it can stream as DIA/HYB instead of gathering as
ELL.  Whether that wins on the GPU depends on the zero-fill; it is not
measured, so the facade applies it only on request (``reorder="rcm"``):
the system P·A·Pᵀ (P·x) = P·b is solved and x is permuted back.  ILU
quality typically improves under RCM.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from lssp_tpu.sparse.types import CSR


def rcm_permutation(A: CSR) -> np.ndarray:
    """Reverse-Cuthill–McKee ordering (symmetrized graph)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    S = A.to_scipy()
    perm = reverse_cuthill_mckee(((S + S.T) != 0).tocsr(), symmetric_mode=True)
    return np.asarray(perm, dtype=np.int64)


def permute_symmetric(A: CSR, perm: np.ndarray) -> CSR:
    """B = P A Pᵀ with B[i, j] = A[perm[i], perm[j]]."""
    n = A.shape[0]
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    S = A.to_scipy().tocoo()
    import scipy.sparse as sp
    B = sp.coo_matrix((S.data, (inv[S.row], inv[S.col])), shape=A.shape)
    return CSR.from_scipy(B.tocsr())


def bandwidth(A: CSR) -> int:
    ip = np.asarray(A.indptr).astype(np.int64)
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), ip[1:] - ip[:-1])
    if len(rows) == 0:
        return 0
    return int(np.abs(np.asarray(A.indices).astype(np.int64) - rows).max())


def num_diagonals(A: CSR) -> int:
    from lssp_tpu.sparse.convert import csr_entry_offsets
    return len(csr_entry_offsets(A.indptr, A.indices, A.shape[0])[2])


def band_coverage(A: CSR, max_diags: int = 256,
                  min_occ: float = 0.02) -> float:
    """Fraction of nnz a HYB split would stream — delegates to the single
    shared band-selection rule (sparse/convert.py: _select_band) so the
    RCM acceptance criterion and the actual csr_to_hyb split cannot
    diverge."""
    from lssp_tpu.sparse.convert import band_occupancy
    return band_occupancy(A, max_diags=max_diags, min_occ=min_occ)


def grid_transpose_perm(A: CSR, factor: float = 3.0,
                        _doffs=None) -> Optional[np.ndarray]:
    """Detect a row-major 5-point grid operator whose STRONG coupling runs
    along the stride-N (y) direction and return the grid-transpose
    permutation that makes the strong direction contiguous — or None.

    Why: the structured-SA multigrid aggregates CONTIGUOUS index ranges,
    i.e. it semicoarsens the x direction.  For a strong-y anisotropic
    operator that is the wrong direction and iteration counts blow up
    (measured 137 vs 34 CG+saamg iterations at 256², ε=100); transposing
    the grid ordering once at setup fixes it with zero runtime cost (the
    facade solves the permuted system like any other reorder)."""
    n = A.shape[0]
    if _doffs is not None:
        d, offs = _doffs
    else:
        ip = np.asarray(A.indptr).astype(np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
        d = np.asarray(A.indices).astype(np.int64) - rows
        offs = np.unique(d)
    pos = offs[offs > 1]
    if len(pos) != 1:
        return None
    N = int(pos[0])
    if N < 2 or n % N or not set(offs.tolist()) <= {-N, -1, 0, 1, N}:
        return None
    dat = np.abs(np.asarray(A.data))
    m1 = dat[np.abs(d) == 1].mean() if (np.abs(d) == 1).any() else 0.0
    mN = dat[np.abs(d) == N].mean() if (np.abs(d) == N).any() else 0.0
    if m1 == 0.0 or mN < factor * m1:
        return None
    Ny = n // N
    return np.arange(n, dtype=np.int64).reshape(Ny, N).T.ravel()


def maybe_rcm(A: CSR, max_diags: int = 256,
              dia_fill: float = 50.0) -> Tuple[CSR, Optional[np.ndarray]]:
    """Return (possibly reordered A, perm or None).

    Reorders when A is not already DIA-friendly but becomes so under RCM
    (diagonal count within ``max_diags`` and zero-fill within ``dia_fill``×
    nnz — generous because streaming zeros beats gathering), or — the HYB
    criterion — when RCM materially concentrates the nnz onto a streamable
    band (coverage ≥ 0.5 and clearly better than the original ordering).
    Grid operators with dominant stride-N coupling get the grid-transpose
    normalization instead (see grid_transpose_perm).
    """
    n = A.shape[0]
    # one offset scan shared by the grid-transpose check and the
    # diagonal-count gate (counting pass, not an O(nnz log nnz) sort)
    from lssp_tpu.sparse.convert import csr_entry_offsets
    _, dvec, offs = csr_entry_offsets(A.indptr, A.indices, n)
    dvec = dvec.astype(np.int64, copy=False)
    offs = offs.astype(np.int64, copy=False)
    gt = grid_transpose_perm(A, _doffs=(dvec, offs))
    if gt is not None:
        return permute_symmetric(A, gt), gt
    nd = len(offs)
    if nd <= max_diags and nd * n <= dia_fill * max(A.nnz, 1):
        return A, None
    perm = rcm_permutation(A)
    B = permute_symmetric(A, perm)
    ndb = num_diagonals(B)
    if ndb < nd and ndb <= max_diags and ndb * n <= dia_fill * max(A.nnz, 1):
        return B, perm
    cov_a = band_coverage(A, max_diags=max_diags)
    cov_b = band_coverage(B, max_diags=max_diags)
    if cov_b >= 0.5 and cov_b > cov_a + 0.05:
        return B, perm
    return A, None


def amd_permutation(A: CSR) -> np.ndarray:
    """Fill-reducing minimum-degree ordering on the pattern of A+Aᵀ.

    Quotient-graph minimum degree with APPROXIMATE external degrees
    (the Amestoy–Davis–Duff bound) and aggressive element absorption —
    the Gilbert–Peierls/multifrontal direct path's analog of the COLAMD /
    AMD orderings the reference reaches through SuperLU
    /root/reference/src/solver-superlu.cxx:60-64 and MUMPS ICNTL(7),
    solver-mumps.cxx:108-137.  On general unstructured patterns RCM is a
    weak fill ordering; minimum degree tracks the elimination process
    itself.  Deterministic: ties broken by smallest node index, so the
    C++ fast path (native/src/amd.cpp) returns the identical permutation.

    Returns ``perm`` with ``perm[k]`` = the node eliminated at step k
    (i.e. B = A[perm][:, perm] factors with low fill).
    """
    import heapq

    n = A.shape[0]
    ip = np.asarray(A.indptr, dtype=np.int64)
    ix = np.asarray(A.indices, dtype=np.int64)
    if n <= 1:
        return np.arange(n, dtype=np.int64)

    from lssp_tpu import native
    if native.available():
        return native.amd_order(ip, ix, n)

    # symmetrized adjacency, diagonal dropped
    T_ip, T_ix = _transpose_pattern(ip, ix, n)
    adj_var = []
    for i in range(n):
        s = np.unique(np.concatenate([ix[ip[i]:ip[i + 1]],
                                      T_ix[T_ip[i]:T_ip[i + 1]]]))
        adj_var.append(set(int(c) for c in s if c != i))

    adj_el = [set() for _ in range(n)]    # elements adjacent to variable i
    elem_vars = {}                        # element id -> set of live vars
    alive = np.ones(n, dtype=bool)
    degree = np.array([len(a) for a in adj_var], dtype=np.int64)
    heap = [(int(degree[i]), i) for i in range(n)]
    heapq.heapify(heap)
    perm = np.empty(n, dtype=np.int64)

    for k in range(n):
        while True:
            d, p = heapq.heappop(heap)
            if alive[p] and d == degree[p]:
                break
        alive[p] = False
        perm[k] = p

        # Lp = vars reachable from p (directly or through p's elements)
        Lp = set(adj_var[p])
        for e in adj_el[p]:
            if e in elem_vars:
                Lp |= elem_vars[e]
                del elem_vars[e]          # absorbed into the new element
        Lp.discard(p)
        elem_vars[p] = Lp
        absorbed = adj_el[p]

        # AMD approximate degrees (Amestoy–Davis–Duff): one pass computes
        # w[e] = |L_e \ Lp| for every element touching Lp — the exact
        # union walk per variable was O(fill²) and measured 6 s on the
        # 15.6k-row coupled3d matrix alone
        w = {}
        for i in Lp:
            for e in adj_el[i]:
                if e in elem_vars:
                    w[e] = w.get(e, len(elem_vars[e])) - 1
        for e, we in list(w.items()):
            if we == 0:                   # L_e ⊆ Lp: aggressive absorption
                del elem_vars[e]

        for i in Lp:
            adj_var[i] -= Lp
            adj_var[i].discard(p)
            newels = {e for e in adj_el[i]
                      if e not in absorbed and e in elem_vars}
            newels.add(p)
            adj_el[i] = newels
            nd = (len(adj_var[i]) + (len(Lp) - 1)
                  + sum(w[e] for e in newels if e != p))
            nd = min(nd, n - k - 1)
            if nd != degree[i]:
                degree[i] = nd
                heapq.heappush(heap, (nd, i))
        adj_var[p] = set()
        adj_el[p] = set()
    return perm


def _transpose_pattern(ip, ix, n):
    """CSR pattern of the transpose (counting sort by column)."""
    counts = np.bincount(ix, minlength=n)
    T_ip = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=T_ip[1:])
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
    # stable sort by column = counting sort; each column list stays sorted
    # by row because entries arrive in row order
    T_ix = rows[np.argsort(ix, kind="stable")]
    return T_ip, T_ix
