"""Sparse container + conversion + structural-utility tests vs scipy oracles
(SURVEY §4 test pyramid, tier 1)."""
import numpy as np
import pytest
import scipy.sparse as sp

from lssp_tpu import sparse
from lssp_tpu.sparse import (
    COO, CSR, coo_to_csr, csr_to_coo, csr_to_bsr, bsr_to_csr, csr_to_ell,
    csr_to_dia, to_device_format, sort_columns, is_sorted, transpose,
    adjust_zero_diag, block_diag_extract, diagonal, split_lu, split_ldu,
    laplacian_2d, laplacian_3d, random_sparse,
)


def random_scipy(n, m, density, seed):
    rs = np.random.RandomState(seed)
    return sp.random(n, m, density=density, random_state=rs, format="csr")


class TestConversions:
    def test_coo_to_csr_sums_duplicates(self):
        coo = COO(np.array([0, 0, 1], np.int32), np.array([1, 1, 0], np.int32),
                  np.array([2.0, 3.0, 4.0]), (2, 2))
        A = coo_to_csr(coo)
        assert np.allclose(A.todense(), [[0, 5], [4, 0]])

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_csr_coo_roundtrip(self, seed):
        S = random_scipy(40, 30, 0.1, seed)
        A = CSR.from_scipy(S)
        B = coo_to_csr(csr_to_coo(A))
        assert np.allclose(B.todense(), S.toarray())

    def test_bsr_roundtrip(self):
        S = random_scipy(32, 32, 0.2, 3)
        A = CSR.from_scipy(S)
        B = csr_to_bsr(A, 4)
        assert np.allclose(B.todense(), S.toarray())
        C = bsr_to_csr(B)
        assert np.allclose(C.todense(), S.toarray())
        assert B.to_scipy().blocksize == (4, 4)

    def test_ell(self):
        S = random_scipy(50, 50, 0.08, 4)
        A = CSR.from_scipy(S)
        E = csr_to_ell(A)
        assert np.allclose(E.todense(), S.toarray())
        assert E.k % 4 == 0

    def test_dia(self):
        A = laplacian_2d(10)
        D = csr_to_dia(A)
        assert np.allclose(D.todense(), A.todense())
        assert D.offsets == (-10, -1, 0, 1, 10)

    def test_device_format_picks_dia_for_stencil(self):
        from lssp_tpu.sparse.types import DIA, ELL
        assert isinstance(to_device_format(laplacian_2d(12)), DIA)
        R = CSR.from_scipy(random_scipy(64, 64, 0.2, 0))
        assert isinstance(to_device_format(R), ELL)


class TestUtils:
    def test_sort_columns(self):
        A = CSR(np.array([0, 3], np.int32), np.array([2, 0, 1], np.int32),
                np.array([1.0, 2.0, 3.0]), (1, 3))
        assert not is_sorted(A)
        B = sort_columns(A)
        assert is_sorted(B)
        assert np.allclose(B.todense(), A.todense())

    def test_transpose(self):
        S = random_scipy(20, 35, 0.15, 5)
        A = CSR.from_scipy(S)
        assert np.allclose(transpose(A).todense(), S.toarray().T)

    def test_adjust_zero_diag_inserts_tol(self):
        # row 1 lacks a diagonal → entry inserted with value = tol
        # (reference matrix-utils.cxx:564 stores `1 * tol`)
        A = CSR(np.array([0, 1, 2], np.int32), np.array([0, 0], np.int32),
                np.array([5.0, 3.0]), (2, 2))
        B = adjust_zero_diag(A, 1e-10)
        d = B.todense()
        assert d[1, 1] == 1e-10
        assert is_sorted(B)
        # no-op when all diagonals exist
        L = laplacian_2d(4)
        assert adjust_zero_diag(L, 1e-10) is L

    def test_block_diag_extract(self):
        A = laplacian_2d(4)  # n=16
        B = block_diag_extract(A, 4)
        d = B.todense()
        full = A.todense()
        for blk in range(4):
            sl = slice(blk * 4, (blk + 1) * 4)
            assert np.allclose(d[sl, sl], full[sl, sl])
        # off-block entries are gone
        assert np.count_nonzero(d) <= np.count_nonzero(full)
        mask = np.zeros((16, 16), bool)
        for blk in range(4):
            sl = slice(blk * 4, (blk + 1) * 4)
            mask[sl, sl] = True
        assert np.all(d[~mask] == 0)

    def test_diagonal_and_splits(self):
        S = random_scipy(30, 30, 0.2, 6) + sp.eye(30)
        A = CSR.from_scipy(S.tocsr())
        assert np.allclose(diagonal(A), S.toarray().diagonal())
        Ls, d, Us = split_ldu(A)
        dense = S.toarray()
        assert np.allclose(Ls.todense(), np.tril(dense, -1))
        assert np.allclose(Us.todense(), np.triu(dense, 1))
        L, U = split_lu(A)
        assert np.allclose(L.todense(), np.tril(dense, -1))
        assert np.allclose(U.todense(), np.triu(dense))


class TestGenerators:
    def test_laplacian_2d_matches_reference_workload(self):
        # exam.cxx:4-59: n = N², nnz = 5N²-4N, diag 4, neighbors -1
        N = 100
        A = laplacian_2d(N)
        assert A.shape == (N * N, N * N)
        assert A.nnz == 5 * N * N - 4 * N
        d = laplacian_2d(5).todense()
        ref = (sp.kron(sp.eye(5), sp.diags([np.full(4, -1), np.full(5, 4.0),
                                            np.full(4, -1)], [-1, 0, 1]))
               + sp.kron(sp.diags([np.full(4, -1.0), np.full(4, -1.0)],
                                  [-1, 1]), sp.eye(5))).toarray()
        assert np.allclose(d, ref)

    def test_laplacian_3d(self):
        A = laplacian_3d(4)
        assert A.shape == (64, 64)
        dense = A.todense()
        assert np.allclose(dense, dense.T)
        assert (np.linalg.eigvalsh(dense) > 0).all()

    def test_random_sparse_diag_dominant(self):
        A = random_sparse(50, 6, seed=1)
        dense = A.todense()
        off = np.abs(dense).sum(1) - np.abs(np.diag(dense))
        assert (np.abs(np.diag(dense)) > off - 1e-12).all()


class TestIO:
    def test_matrix_market_roundtrip(self, tmp_path):
        S = random_scipy(25, 25, 0.15, 7)
        A = CSR.from_scipy(S)
        p = str(tmp_path / "m.mtx")
        sparse.write_matrix_market(p, A)
        B = sparse.read_matrix_market(p)
        assert np.allclose(B.todense(), S.toarray())


class TestReorder:
    def test_rcm_reduces_bandwidth(self):
        from lssp_tpu.sparse.reorder import (rcm_permutation,
                                             permute_symmetric, bandwidth)
        rng = np.random.default_rng(0)
        # random sparse symmetric matrix with scattered structure
        n = 200
        S = sp.random(n, n, density=0.03, random_state=np.random.RandomState(1))
        S = (S + S.T + sp.eye(n)).tocsr()
        A = CSR.from_scipy(S)
        perm = rcm_permutation(A)
        B = permute_symmetric(A, perm)
        assert bandwidth(B) < bandwidth(A)
        # permutation preserves the spectrum-defining structure
        d = B.todense()
        assert np.allclose(d, S.toarray()[perm][:, perm])

    def test_solve_with_rcm_reorder(self):
        import jax.numpy as jnp
        from lssp_tpu import solve
        # shuffled Poisson: unstructured-looking until reordered
        rng = np.random.default_rng(3)
        A = laplacian_2d(16)
        p = rng.permutation(256)
        from lssp_tpu.sparse.reorder import permute_symmetric
        Ashuf = permute_symmetric(A, p)
        b = jnp.ones(256, dtype=jnp.float64)
        x, info = solve(Ashuf, b, method="cg", reorder="rcm")
        assert bool(info.converged)
        res = np.linalg.norm(b - Ashuf.to_scipy() @ np.asarray(x))
        assert res <= 1.1e-7 * 16


import jax
import jax.numpy as jnp


class TestHYB:
    """Hybrid band+remainder execution format (VERDICT r1 item #2): nearly
    banded matrices stream their dominant band as DIA with only the few
    off-band entries taking the gather path."""

    @staticmethod
    def _nearly_banded(n_side=24, n_extra=60, seed=3):
        """5-pt Laplacian plus a sprinkle of random off-band entries."""
        import scipy.sparse as sp
        rng = np.random.default_rng(seed)
        S = laplacian_2d(n_side).to_scipy().tolil()
        n = S.shape[0]
        r = rng.integers(0, n, n_extra)
        c = rng.integers(0, n, n_extra)
        for i, j in zip(r, c):
            S[i, j] = S[i, j] + 0.01
        return CSR.from_scipy(S.tocsr())

    def test_hyb_exact(self, rng):
        from lssp_tpu.sparse.convert import csr_to_hyb
        from lssp_tpu.ops.spmv import spmv, spmv_t
        A = self._nearly_banded()
        H = csr_to_hyb(A)
        assert np.allclose(H.todense(), A.todense())
        x = rng.standard_normal(A.shape[0])
        np.testing.assert_allclose(np.asarray(spmv(H, jnp.asarray(x))),
                                   A.to_scipy() @ x, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(spmv_t(H, jnp.asarray(x))),
                                   A.to_scipy().T @ x, rtol=1e-12)

    def test_hyb_remainder_is_small(self):
        from lssp_tpu.sparse.convert import csr_to_hyb
        A = self._nearly_banded()
        H = csr_to_hyb(A)
        # the 5 stencil diagonals hold all but the sprinkled entries
        assert len(H.dia.offsets) == 5
        assert 0 < H.nnz_rem <= 60

    def test_device_format_picks_hyb(self):
        from lssp_tpu.sparse.types import HYB
        from lssp_tpu.sparse.convert import to_device_format
        A = self._nearly_banded()
        assert isinstance(to_device_format(A, max_diags=32, dia_fill=2.0),
                          HYB)

    def test_full_random_still_ell(self):
        from lssp_tpu.sparse.types import ELL
        from lssp_tpu.sparse.convert import to_device_format
        R = CSR.from_scipy(random_scipy(64, 64, 0.2, 0))
        assert isinstance(to_device_format(R), ELL)

    def test_solve_on_hyb(self):
        from lssp_tpu.sparse.convert import csr_to_hyb
        from lssp_tpu.solvers.facade import solve
        A = self._nearly_banded()
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = solve(csr_to_hyb(A), b, method="gmres")
        assert bool(info.converged)
        res = np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x))
        assert res < 1e-5


class TestGridTranspose:
    """Grid-transpose normalization for strong-y anisotropy (the
    structured-SA aggregates are contiguous = x-direction; the strong
    direction must be made contiguous at reorder time)."""

    def test_detects_strong_y(self):
        import lssp_tpu as lt
        from lssp_tpu.sparse.reorder import grid_transpose_perm, maybe_rcm
        A = lt.sparse.anisotropic_poisson_2d(32, epsilon=100.0)
        p = grid_transpose_perm(A)
        assert p is not None
        # transpose of a 32x32 row-major grid
        np.testing.assert_array_equal(
            p, np.arange(1024).reshape(32, 32).T.ravel())
        B, perm = maybe_rcm(A)
        assert perm is not None
        # the permuted operator is strong along ±1 now
        p2 = grid_transpose_perm(B)
        assert p2 is None

    def test_leaves_strong_x_and_isotropic_alone(self):
        import lssp_tpu as lt
        from lssp_tpu.sparse.reorder import grid_transpose_perm
        assert grid_transpose_perm(
            lt.sparse.anisotropic_poisson_2d(32, epsilon=0.01)) is None
        assert grid_transpose_perm(lt.sparse.laplacian_2d(32)) is None

    def test_saamg_handles_both_orientations(self):
        """Pre-r3 the grid transpose was REQUIRED for strong-y operators
        (range aggregation only semicoarsened x; 137 vs 34 its).  The
        direction-aware coarsening now picks y-semicoarsening from the
        measured strengths, so both orientations converge equally well —
        with and without the transpose normalization."""
        import lssp_tpu as lt
        from lssp_tpu.sparse.reorder import maybe_rcm
        A = lt.sparse.anisotropic_poisson_2d(64, epsilon=100.0)
        n = A.shape[0]
        b = jnp.ones(n, dtype=jnp.float64)
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
        _, i_raw = lt.solve_ir(A, b, method="cg", pc="saamg", options=o,
                               reorder=None)
        At, perm = maybe_rcm(A)
        assert perm is not None
        bt = jnp.asarray(np.asarray(b)[perm])
        x, i_t = lt.solve_ir(At, bt, method="cg", pc="saamg", options=o,
                             reorder=None)
        assert bool(i_raw.converged) and bool(i_t.converged)
        assert int(i_raw.nits) <= 40 and int(i_t.nits) <= 40
        assert abs(int(i_t.nits) - int(i_raw.nits)) <= 5
        res = float(np.linalg.norm(np.asarray(bt)
                                   - At.to_scipy() @ np.asarray(x)))
        assert res <= 1.1e-8 * np.sqrt(n) + 1e-10
