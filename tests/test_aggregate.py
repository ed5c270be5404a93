"""Hierarchical strength-aggregation ordering (amg/aggregate.py) — the
gather-free AMG path for matrices with no detectable grid.

Capability match: AMG on any CSR (/root/reference/src/pc-amg.cxx:21-134);
the realization (aggregate-then-renumber so reshape aggregates are true
strength aggregates) has no reference analog.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp

import lssp_tpu as lt
from lssp_tpu.config import SolverOptions, PCOptions
from lssp_tpu.sparse.types import CSR
from lssp_tpu.amg.aggregate import (hierarchy_perm, greedy_aggregate_exact,
                                    _sym_strength)
from lssp_tpu.sparse.reorder import permute_symmetric


def poisson3d(N):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N), format="csr")
    I = sp.eye(N, format="csr")
    A = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
         + sp.kron(sp.kron(I, I), T))
    return CSR.from_scipy(A.tocsr().astype(np.float64))


def coupled(N=12, n_couple=60, seed=3):
    """3-D Poisson + random long-range couplings (no detectable grid)."""
    S = poisson3d(N).to_scipy().tolil()
    n = N ** 3
    rng = np.random.default_rng(seed)
    for i, j, v in zip(rng.integers(0, n, n_couple),
                       rng.integers(0, n, n_couple),
                       rng.uniform(0.05, 0.3, n_couple)):
        if i == j:
            continue
        S[i, j] -= v
        S[j, i] -= v
        S[i, i] += v
        S[j, j] += v
    return CSR.from_scipy(S.tocsr())


class TestGreedyAggregateExact:
    def test_exact_sizes_and_partition(self):
        A = poisson3d(8).to_scipy()
        S = _sym_strength(A, 0.08)
        ids = greedy_aggregate_exact(S, 4)
        assert ids.min() == 0 and len(np.unique(ids)) == ids.max() + 1
        assert (np.bincount(ids) == 4).all()

    def test_virtuals_chunked_last(self):
        """Virtual vertices must occupy the TRAILING aggregate ids (at most
        one mixed boundary group) — the alignment invariant with
        sa_setup's end-of-vector identity padding."""
        A = poisson3d(8).to_scipy()
        n = A.shape[0]
        pad = 12
        Ap = sp.bmat([[A, None], [None, sp.eye(pad, format="csr")]],
                     format="csr")
        virt = np.zeros(n + pad, dtype=bool)
        virt[n:] = True
        ids = greedy_aggregate_exact(_sym_strength(Ap, 0.08), 4, virt)
        assert (np.bincount(ids) == 4).all()
        # every group with a virtual member has an id >= every all-real group
        vids = np.unique(ids[virt])
        rids = np.unique(ids[~virt])
        pure_real = np.setdiff1d(rids, vids)
        assert pure_real.max() < vids.min()


class TestNativeParity:
    def test_native_bfs_matches_python(self):
        """native/src/aggregate.cpp must reproduce the Python BFS ids
        EXACTLY (it defines an ordering — any divergence scrambles the
        hierarchy)."""
        from lssp_tpu import native
        from lssp_tpu.amg.aggregate import _bfs_ids
        if not native.available():
            pytest.skip("no native library")
        A = poisson3d(12).to_scipy().tolil()
        n = A.shape[0]
        rng = np.random.default_rng(5)
        for i, j, v in zip(rng.integers(0, n, 80), rng.integers(0, n, 80),
                           rng.uniform(0.05, 2.0, 80)):
            if i != j:          # nonsymmetric values, symmetric pattern
                A[i, j] -= v
                A[j, i] -= 0.5 * v
                A[i, i] += v
                A[j, j] += 0.5 * v
        A = A.tocsr()
        virt = np.zeros(n, bool)
        virt[-13:] = True
        py = _bfs_ids(_sym_strength(A, 0.08), 4, virt)
        nat = native.greedy_aggregate(A, A.T.tocsr(), 4, 0.08, virt)
        assert np.array_equal(py, nat)


class TestHierarchyPerm:
    def test_valid_permutation(self):
        A = coupled(10, 40)
        p = hierarchy_perm(A, g=4, coarse_size=64, max_levels=12)
        assert np.array_equal(np.sort(p), np.arange(A.shape[0]))

    def test_valid_with_padding(self):
        # n = 11^3 = 1331: not divisible by 4 — exercises the virtual-
        # padding alignment machinery
        A = poisson3d(11)
        p = hierarchy_perm(A, g=4, coarse_size=64, max_levels=12)
        assert np.array_equal(np.sort(p), np.arange(A.shape[0]))

    def test_level0_blind_ranges_are_strength_aggregates(self):
        """The ORIGINAL level-0 greedy strength aggregates must land on
        aligned contiguous g-chunks under the ordering (that is the whole
        point: the blind //g reshape then aggregates by true strength)."""
        A = poisson3d(8)        # 512 divisible by 4^L: no padding wrinkles
        S = _sym_strength(A.to_scipy(), 0.08)
        ids = greedy_aggregate_exact(S, 4)
        p = hierarchy_perm(A, g=4, coarse_size=64, max_levels=12)
        # aggregate id of the row placed at position k — constant per chunk
        chunked = ids[p].reshape(-1, 4)
        assert (chunked == chunked[:, :1]).all()

    def test_solve_quality_unstructured(self):
        """End-to-end through the facade: reorder='auto' + pc='saamg' must
        pick the hierarchy ordering on a no-grid matrix and converge at
        multigrid-grade counts (ILU-grade would be 2-3x more)."""
        A = coupled(12, 60)
        rng = np.random.default_rng(0)
        b = rng.standard_normal(A.shape[0])
        o = SolverOptions(rtol=1e-8, maxit=100)
        x, i = lt.solve(A, jnp.asarray(b), method="bicgstab", pc="saamg",
                        options=o)
        assert bool(i.converged)
        assert int(i.nits) <= 12
        r = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert r <= 1e-6 * np.linalg.norm(b)

    def test_identity_on_grid(self):
        """Grid-detectable operators must NOT be hierarchy-reordered (the
        direction-aware grid path is strictly better)."""
        from lssp_tpu.solvers.facade import _prepare_matrix
        A = lt.sparse.laplacian_2d(16)
        _, _, perm = _prepare_matrix(A, reorder="hier:4:64:12")
        assert perm is None


class TestDetectGridDegenerateGuard:
    def test_small_stride_not_a_grid(self):
        """Stride-5 candidates are degenerate at halfwidth 2 (every integer
        offset is within 2 of a multiple of 5) — must not detect."""
        from lssp_tpu.amg.sa import detect_grid
        rng = np.random.default_rng(0)
        n = 125                      # divisible by 5
        rows = rng.integers(0, n, 300)
        cols = (rows + rng.choice([-7, -5, -3, 3, 5, 7], 300)) % n
        S = sp.coo_matrix((np.ones(300), (rows, cols)), shape=(n, n))
        S = ((S + S.T) + 10 * sp.eye(n)).tocsr()
        assert detect_grid(CSR.from_scipy(S)) is None

    def test_true_grid_still_detected(self):
        from lssp_tpu.amg.sa import detect_grid
        assert detect_grid(lt.sparse.laplacian_2d(32)) == (32, 32)

    def test_nine_point_corner_offsets_resolve_to_true_stride(self):
        """9-point stencil on a (20, 9) grid: the corner offsets ±8/±10
        also pass the tolerance test when n divides them (180 % 10 == 0),
        so largest-first selection returned (18, 10); the minimal-Σ|dx|
        rule must pick the true gx = 9."""
        from lssp_tpu.amg.sa import detect_grid
        gy, gx = 20, 9
        n = gy * gx
        offs = [0, -1, 1, -gx - 1, -gx, -gx + 1, gx - 1, gx, gx + 1]
        rows, cols, vals = [], [], []
        for o in offs:
            i = np.arange(n)
            j = i + o
            m = (j >= 0) & (j < n)
            rows.append(i[m]); cols.append(j[m])
            vals.append(np.full(m.sum(), 8.0 if o == 0 else -1.0))
        S = sp.coo_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=(n, n)).tocsr()
        assert detect_grid(CSR.from_scipy(S)) == (gy, gx)


def test_hierarchy_perm_padding_alignment():
    """n not divisible by the planned g^L: the virtual padding slots must
    be exactly the trailing positions of the hierarchy order (internal
    assert), and every level-0 reshape chunk of the permuted-then-padded
    sequence must contain real rows of ONE strength aggregate.  Broken
    before round-3 consolidation: coarse greedy passes grouped virtual
    vertices with a second real chain, splitting a real aggregate across
    a chunk boundary (33/333 chunks on 11^3 Poisson)."""
    from lssp_tpu.amg.aggregate import (hierarchy_perm,
                                        greedy_aggregate_exact,
                                        _sym_strength)
    from lssp_tpu.parallel.dist_sa import planned_padded_size
    A = lt.sparse.laplacian_3d(11)
    n, g = A.shape[0], 4
    perm = hierarchy_perm(A, g=g, coarse_size=256)
    assert sorted(perm) == list(range(n))
    n_pad = planned_padded_size(n, 1, g, 256, 12)
    Alp = sp.bmat([[A.to_scipy().astype(np.float64), None],
                   [None, sp.eye(n_pad - n, format="csr")]],
                  format="csr")
    virt = np.zeros(n_pad, bool); virt[n:] = True
    ids0 = greedy_aggregate_exact(_sym_strength(Alp.tocsr(), 0.08), g, virt)
    seq = np.concatenate([perm, np.arange(n, n_pad)])
    for c in seq.reshape(-1, g):
        real = c[c < n]
        assert len(set(ids0[real])) <= 1, (c, ids0[c])


def test_saamg_grid_numpy_array_dims():
    """saamg_grid as a numpy array must not crash the reorder predicate
    (tuple membership against arrays raises) and must pin the ordering."""
    from lssp_tpu.solvers.facade import saamg_keeps_ordering, resolve_reorder
    from lssp_tpu import PCOptions
    po = PCOptions(saamg_grid=np.array([32, 32]))
    assert saamg_keeps_ordering("saamg", po)
    assert resolve_reorder("saamg", po, "auto") is None
    b = jnp.ones(1024, dtype=jnp.float64)
    x, info = lt.solve(lt.sparse.laplacian_2d(32), b, method="cg",
                       pc="saamg", pc_options=po)
    assert bool(info.converged)
