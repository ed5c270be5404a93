"""Test-matrix generators (host-side, numpy → CSR).

``laplacian_2d`` reproduces the reference's canonical workload generator
bit-for-bit (/root/reference/example/exam.cxx:4-59: 5-point stencil, diag 4,
off-diagonals -1, row-major grid ordering, nnz = 5N²-4N).  The others cover
the BASELINE.md acceptance configs: 3-D 7-point Poisson, nonsymmetric
convection–diffusion, 2-D elasticity (block structure), anisotropic Poisson.
"""
from __future__ import annotations

import numpy as np

from lssp_tpu.sparse.types import COO, CSR
from lssp_tpu.sparse.convert import coo_to_csr


def laplacian_2d(N: int, dtype=np.float64) -> CSR:
    """2-D 5-point Laplacian on an N×N grid (exam.cxx:4-59 semantics)."""
    idx = np.arange(N * N, dtype=np.int64)
    i, j = idx // N, idx % N
    rows, cols, vals = [], [], []
    def add(mask, nbr, v):
        rows.append(idx[mask]); cols.append(nbr[mask])
        vals.append(np.full(mask.sum(), v, dtype=dtype))
    add(i > 0, idx - N, -1.0)
    add(j > 0, idx - 1, -1.0)
    add(np.ones_like(idx, dtype=bool), idx, 4.0)
    add(j < N - 1, idx + 1, -1.0)
    add(i < N - 1, idx + N, -1.0)
    coo = COO(np.concatenate(rows).astype(np.int32),
              np.concatenate(cols).astype(np.int32),
              np.concatenate(vals), (N * N, N * N))
    return coo_to_csr(coo, sum_duplicates=False)


def laplacian_3d(N: int, dtype=np.float64) -> CSR:
    """3-D 7-point Poisson on an N³ grid (diag 6, neighbors -1)."""
    n = N * N * N
    idx = np.arange(n, dtype=np.int64)
    i, rem = idx // (N * N), idx % (N * N)
    j, k = rem // N, rem % N
    rows, cols, vals = [], [], []
    def add(mask, nbr, v):
        rows.append(idx[mask]); cols.append(nbr[mask])
        vals.append(np.full(int(mask.sum()), v, dtype=dtype))
    add(i > 0, idx - N * N, -1.0)
    add(j > 0, idx - N, -1.0)
    add(k > 0, idx - 1, -1.0)
    add(np.ones_like(idx, dtype=bool), idx, 6.0)
    add(k < N - 1, idx + 1, -1.0)
    add(j < N - 1, idx + N, -1.0)
    add(i < N - 1, idx + N * N, -1.0)
    coo = COO(np.concatenate(rows).astype(np.int32),
              np.concatenate(cols).astype(np.int32),
              np.concatenate(vals), (n, n))
    return coo_to_csr(coo, sum_duplicates=False)


def anisotropic_poisson_2d(N: int, epsilon: float = 0.001, dtype=np.float64) -> CSR:
    """2-D anisotropic Poisson -(u_xx + eps*u_yy): the classic AMG stress
    test (BASELINE config #5)."""
    idx = np.arange(N * N, dtype=np.int64)
    i, j = idx // N, idx % N
    rows, cols, vals = [], [], []
    def add(mask, nbr, v):
        rows.append(idx[mask]); cols.append(nbr[mask])
        vals.append(np.full(int(mask.sum()), v, dtype=dtype))
    add(i > 0, idx - N, -epsilon)
    add(j > 0, idx - 1, -1.0)
    add(np.ones_like(idx, dtype=bool), idx, 2.0 + 2.0 * epsilon)
    add(j < N - 1, idx + 1, -1.0)
    add(i < N - 1, idx + N, -epsilon)
    coo = COO(np.concatenate(rows).astype(np.int32),
              np.concatenate(cols).astype(np.int32),
              np.concatenate(vals), (N * N, N * N))
    return coo_to_csr(coo, sum_duplicates=False)


def convection_diffusion_2d(N: int, beta: float = 20.0, dtype=np.float64) -> CSR:
    """Nonsymmetric convection–diffusion: 5-point diffusion + upwind
    convection with velocity (beta, beta/2).  Used for the GMRES+ILUT
    acceptance config (#3) when no SuiteSparse file is available."""
    h = 1.0 / (N + 1)
    bx, by = beta, beta / 2.0
    idx = np.arange(N * N, dtype=np.int64)
    i, j = idx // N, idx % N
    # upwind: convection adds bx*h to diag, -bx*h to west/south neighbor
    diag = 4.0 + (bx + by) * h
    west, east = -1.0 - bx * h, -1.0
    south, north = -1.0 - by * h, -1.0
    rows, cols, vals = [], [], []
    def add(mask, nbr, v):
        rows.append(idx[mask]); cols.append(nbr[mask])
        vals.append(np.full(int(mask.sum()), v, dtype=dtype))
    add(i > 0, idx - N, south)
    add(j > 0, idx - 1, west)
    add(np.ones_like(idx, dtype=bool), idx, diag)
    add(j < N - 1, idx + 1, east)
    add(i < N - 1, idx + N, north)
    coo = COO(np.concatenate(rows).astype(np.int32),
              np.concatenate(cols).astype(np.int32),
              np.concatenate(vals), (N * N, N * N))
    return coo_to_csr(coo, sum_duplicates=False)


def elasticity_2d(N: int, E: float = 1.0, nu: float = 0.3, dtype=np.float64) -> CSR:
    """2-D linear elasticity (plane strain) on an N×N node grid with Q1
    finite elements, 2 dof per node → natural 2×2 block structure (BASELINE
    config #4: BiCGSTAB(l)+block-ILUK on BSR elasticity).

    Assembled from the standard 8×8 Q1 element stiffness matrix.
    """
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    # 2x2 Gauss quadrature of the Q1 element stiffness on the unit square
    gp = np.array([-1, 1], dtype=np.float64) / np.sqrt(3.0)
    Ke = np.zeros((8, 8))
    D = np.array([[lam + 2 * mu, lam, 0],
                  [lam, lam + 2 * mu, 0],
                  [0, 0, mu]])
    for xi in gp:
        for eta in gp:
            dN = 0.25 * np.array([
                [-(1 - eta),  (1 - eta), (1 + eta), -(1 + eta)],
                [-(1 - xi), -(1 + xi), (1 + xi),  (1 - xi)],
            ])  # d/dxi, d/deta of the 4 shape fns; Jacobian = I/2 scaled out
            B = np.zeros((3, 8))
            B[0, 0::2] = dN[0]
            B[1, 1::2] = dN[1]
            B[2, 0::2] = dN[1]
            B[2, 1::2] = dN[0]
            Ke += B.T @ D @ B
    nnode = N * N
    nelem = (N - 1) * (N - 1)
    ei = np.arange(nelem, dtype=np.int64)
    ex, ey = ei // (N - 1), ei % (N - 1)
    n0 = ex * N + ey
    conn = np.stack([n0, n0 + N, n0 + N + 1, n0 + 1], axis=1)  # 4 nodes/elem
    dofs = np.empty((nelem, 8), dtype=np.int64)
    dofs[:, 0::2] = 2 * conn
    dofs[:, 1::2] = 2 * conn + 1
    rows = np.repeat(dofs, 8, axis=1).ravel()
    cols = np.tile(dofs, (1, 8)).ravel()
    vals = np.tile(Ke.ravel(), nelem).astype(dtype)
    A = coo_to_csr(COO(rows.astype(np.int32), cols.astype(np.int32), vals,
                       (2 * nnode, 2 * nnode)), sum_duplicates=True)
    # pin a few dofs (Dirichlet) to make it nonsingular: add to diagonal
    from lssp_tpu.sparse.utils import diagonal
    d = diagonal(A)
    fix = np.where(np.arange(2 * nnode) < 2 * N)[0]  # clamp first node row
    data = np.asarray(A.data).copy()
    ip = np.asarray(A.indptr)
    idxs = np.asarray(A.indices)
    for f in fix:
        sl = slice(ip[f], ip[f + 1])
        data[sl] = np.where(idxs[sl] == f, d[f] + 10.0, data[sl])
    return CSR(A.indptr, A.indices, data, A.shape)


def random_sparse(n: int, nnz_per_row: int = 8, seed: int = 0,
                  diag_dominant: bool = True, dtype=np.float64) -> CSR:
    """Random sparse matrix with a guaranteed diagonal; optionally strictly
    diagonally dominant (safe for ILU and convergence tests)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n, size=n * nnz_per_row)
    vals = rng.standard_normal(n * nnz_per_row).astype(dtype)
    rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    vals = np.concatenate([vals, np.zeros(n, dtype=dtype)])
    A = coo_to_csr(COO(rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)))
    if diag_dominant:
        ip = np.asarray(A.indptr)
        data = np.asarray(A.data).copy()
        idxs = np.asarray(A.indices)
        rowsum = np.add.reduceat(np.abs(data), ip[:-1])
        r = np.repeat(np.arange(n), ip[1:] - ip[:-1])
        on_diag = idxs == r
        data[on_diag] = rowsum + 1.0
        A = CSR(A.indptr, A.indices, data, A.shape)
    return A
