"""Device-kernel unit tests vs scipy oracles (SURVEY §4 tier 1): SpMV in all
execution formats, BLAS-1, level-scheduled triangular solves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from lssp_tpu.ops import (
    spmv, mv_amxpby, mv_amxpbyz, mv_amxy, mv_mxy,
    dot, norm2, axpby,
    level_schedule, trisolve_lower_unit, trisolve_upper, make_ilu_apply,
)
from lssp_tpu.sparse import (
    CSR, csr_to_ell, csr_to_dia, csr_to_bsr, laplacian_2d, random_sparse,
    split_lu,
)


def random_scipy(n, m, density, seed):
    rs = np.random.RandomState(seed)
    return sp.random(n, m, density=density, random_state=rs, format="csr")


class TestSpMV:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_csr(self, seed, rng):
        S = random_scipy(60, 60, 0.1, seed)
        A = CSR.from_scipy(S)
        x = rng.standard_normal(60)
        np.testing.assert_allclose(spmv(A, jnp.asarray(x)), S @ x, rtol=1e-12)

    def test_ell(self, rng):
        S = random_scipy(50, 50, 0.12, 2)
        E = csr_to_ell(CSR.from_scipy(S))
        x = rng.standard_normal(50)
        np.testing.assert_allclose(spmv(E, jnp.asarray(x)), S @ x, rtol=1e-12)

    def test_dia(self, rng):
        A = laplacian_2d(9)
        D = csr_to_dia(A)
        x = rng.standard_normal(81)
        np.testing.assert_allclose(spmv(D, jnp.asarray(x)),
                                   A.to_scipy() @ x, rtol=1e-12)

    def test_bsr(self, rng):
        S = random_scipy(48, 48, 0.15, 3)
        A = CSR.from_scipy(S)
        B = csr_to_bsr(A, 4)
        x = rng.standard_normal(48)
        np.testing.assert_allclose(spmv(B, jnp.asarray(x)), S @ x, rtol=1e-12)

    def test_jit_and_mvops_variants(self, rng):
        A = csr_to_dia(laplacian_2d(8))
        x = jnp.asarray(rng.standard_normal(64))
        y = jnp.asarray(rng.standard_normal(64))
        Ax = spmv(A, x)
        np.testing.assert_allclose(mv_amxpby(2.0, A, x, 3.0, y), 3 * y + 2 * Ax)
        np.testing.assert_allclose(mv_amxpbyz(-1.0, A, x, 1.0, y), y - Ax)
        np.testing.assert_allclose(mv_amxy(2.5, A, x), 2.5 * Ax)
        np.testing.assert_allclose(mv_mxy(A, x), Ax)
        jit_spmv = jax.jit(lambda M, v: spmv(M, v))
        np.testing.assert_allclose(jit_spmv(A, x), Ax)


class TestBlas1:
    def test_basic(self, rng):
        x = jnp.asarray(rng.standard_normal(33))
        y = jnp.asarray(rng.standard_normal(33))
        np.testing.assert_allclose(dot(x, y), np.dot(x, y))
        np.testing.assert_allclose(norm2(x), np.linalg.norm(x))
        np.testing.assert_allclose(axpby(2.0, x, -1.0, y), 2 * x - y)


class TestTriSolve:
    def _lower(self, n, seed):
        rs = np.random.RandomState(seed)
        S = sp.random(n, n, density=0.1, random_state=rs, format="csr")
        L = sp.tril(S, k=-1).tocsr()
        return CSR.from_scipy(L)

    @pytest.mark.parametrize("n,seed", [(40, 0), (150, 1)])
    def test_lower_unit(self, n, seed, rng):
        Lc = self._lower(n, seed)
        b = rng.standard_normal(n)
        sched = level_schedule(Lc, lower=True)
        x = trisolve_lower_unit(sched, jnp.asarray(b))
        Lfull = Lc.to_scipy() + sp.eye(n)
        ref = sp.linalg.spsolve_triangular(Lfull.tocsr(), b, lower=True,
                                           unit_diagonal=True)
        np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-12)

    @pytest.mark.parametrize("n,seed", [(40, 2), (150, 3)])
    def test_upper_with_diag(self, n, seed, rng):
        rs = np.random.RandomState(seed)
        S = sp.random(n, n, density=0.1, random_state=rs, format="csr")
        U = (sp.triu(S, k=1) + sp.diags(2.0 + rs.rand(n))).tocsr()
        Uc = CSR.from_scipy(U)
        b = rng.standard_normal(n)
        sched = level_schedule(Uc, lower=False)
        x = trisolve_upper(sched, jnp.asarray(b))
        ref = sp.linalg.spsolve_triangular(U, b, lower=False)
        np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-12)

    def test_ilu_apply_against_dense(self, rng):
        n = 64
        A = random_sparse(n, 5, seed=4)
        from lssp_tpu.pc.ilu_host import iluk_factor
        L, U = iluk_factor(A, level=0)
        apply_fn = make_ilu_apply(L, U)
        r = rng.standard_normal(n)
        z = apply_fn(jnp.asarray(r))
        Ld = L.todense() + np.eye(n)
        Ud = U.todense()
        ref = np.linalg.solve(Ud, np.linalg.solve(Ld, r))
        np.testing.assert_allclose(z, ref, rtol=1e-9, atol=1e-11)

    def test_jit_sweep(self, rng):
        Lc = self._lower(80, 5)
        sched = level_schedule(Lc, lower=True)
        b = jnp.asarray(rng.standard_normal(80))
        f = jax.jit(trisolve_lower_unit)
        np.testing.assert_allclose(f(sched, b), trisolve_lower_unit(sched, b))


class TestTriSweepCarryMiscompile:
    """Regression for an XLA:CPU miscompile (jax 0.9.0): the
    concurrency-optimized scheduler races two *independent* level-sweep
    scans of one jit program over shared scratch buffers, so any program
    applying an exact ILU/BILU twice to different vectors (every
    product-type solver) returned O(1)-wrong results — bicrsafe+biluk
    diverged to 1e61, tfqmr+biluk stalled.  Chained applies and single
    applies were unaffected, which is how it escaped every per-op oracle
    test.  lssp_tpu/__init__.py (and conftest) now disable that scheduler;
    these tests pin the two exact failing patterns, jit vs eager."""

    def test_block_parallel_applies_jit_matches_eager(self, rng):
        from lssp_tpu.sparse import laplacian_2d, csr_to_bsr
        from lssp_tpu.pc.biluk import biluk_factor_bsr
        from lssp_tpu.ops.block_trisolve import (block_trisweep,
                                                 block_diag_apply)
        from lssp_tpu.solvers.base import operator
        A = laplacian_2d(32)
        op = operator(A)
        B = csr_to_bsr(A, 4)
        sched_l, inv, sched_u = biluk_factor_bsr(B, level=1)
        dinv = jnp.asarray(inv)

        def apply_(v):
            return block_trisweep(
                sched_u, block_diag_apply(dinv, block_trisweep(sched_l, v)))

        def two(v):     # two *parallel* applies — the miscompiled shape
            return apply_(v) + apply_(2.0 * v)

        def two_op(v):  # the second observed shape: apply + A·apply
            return apply_(v) + op(apply_(2.0 * v))

        v = jnp.asarray(rng.standard_normal(1024))
        for f in (two, two_op):
            np.testing.assert_allclose(np.asarray(jax.jit(f)(v)),
                                       np.asarray(f(v)), rtol=0, atol=1e-12)

    def test_scalar_parallel_applies_jit_matches_eager(self, rng):
        from lssp_tpu.pc.ilu_host import iluk_factor
        from lssp_tpu.ops.trisolve import make_ilu_apply
        from lssp_tpu.solvers.base import operator
        A = laplacian_2d(32)
        op = operator(A)
        L, U = iluk_factor(A, level=1)
        fn = make_ilu_apply(L, U)

        def two(v):
            return fn(v) + fn(2.0 * v)

        def two_op(v):
            return fn(v) + op(fn(2.0 * v))

        v = jnp.asarray(rng.standard_normal(1024))
        for f in (two, two_op):
            np.testing.assert_allclose(np.asarray(jax.jit(f)(v)),
                                       np.asarray(f(v)), rtol=0, atol=1e-12)


class TestNeumannTriSolve:
    def test_neumann_converges_to_exact(self, rng):
        from lssp_tpu.pc.ilu_host import iluk_factor
        from lssp_tpu.ops.trisolve import (make_neumann_tri,
                                           neumann_ilu_apply, make_ilu_apply)
        A = laplacian_2d(16)
        L, U = iluk_factor(A, level=0)
        exact = make_ilu_apply(L, U)
        r = jnp.asarray(rng.standard_normal(256))
        z_exact = np.asarray(exact(r))
        errs = []
        for k in (2, 4, 8, 40):
            st = make_neumann_tri(L, U, sweeps=k)
            z = np.asarray(neumann_ilu_apply(st, r))
            errs.append(np.linalg.norm(z - z_exact))
        assert errs == sorted(errs, reverse=True)      # monotone convergence
        assert errs[-1] < 1e-10                        # exact at high k
        assert errs[2] < 0.1 * np.linalg.norm(z_exact)  # useful at k=8

    def test_cg_with_neumann_ilu(self):
        from lssp_tpu import solve, PCOptions
        A = laplacian_2d(32)
        b = jnp.ones(1024, dtype=jnp.float64)
        x, info = solve(A, b, method="cg", pc="ilu0",
                        pc_options=PCOptions(ilu_sweeps=6))
        assert bool(info.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1.1e-7 * 32


class TestBDIA:
    """Block-diagonal execution format (ops/spmv.py: _spmv_bdia) — the
    gather-free BSR path for block-banded matrices."""

    def test_spmv_matches_scipy(self, rng):
        import lssp_tpu
        from lssp_tpu.sparse.convert import csr_to_bsr, bsr_to_bdia
        from lssp_tpu.ops.spmv import spmv, spmv_t
        A = lssp_tpu.sparse.elasticity_2d(12)
        B = csr_to_bsr(A, 2)
        D = bsr_to_bdia(B, max_diags=64, fill=4.0)
        x = rng.standard_normal(A.shape[0])
        np.testing.assert_allclose(np.asarray(spmv(D, jnp.asarray(x))),
                                   A.to_scipy() @ x, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(spmv_t(D, jnp.asarray(x))),
                                   A.to_scipy().T @ x, rtol=1e-12)
        assert D.todense().shape == A.shape
        np.testing.assert_allclose(D.todense(), A.todense(), rtol=1e-14)

    def test_unbanded_raises(self):
        import scipy.sparse as sp
        from lssp_tpu.sparse.types import BSR
        from lssp_tpu.sparse.convert import bsr_to_bdia
        m = sp.random(64, 64, density=0.15, random_state=1,
                      format="csr").tobsr(blocksize=(4, 4))
        with pytest.raises(ValueError):
            bsr_to_bdia(BSR.from_scipy(m), max_diags=4, fill=1.1)

    def test_facade_prefers_scalar_dia(self):
        import lssp_tpu
        from lssp_tpu.sparse.convert import csr_to_bsr
        from lssp_tpu.sparse.types import DIA
        from lssp_tpu.solvers.facade import _prepare_matrix
        A = lssp_tpu.sparse.elasticity_2d(16)
        B = csr_to_bsr(A, 2)
        csr, dev, perm = _prepare_matrix(B)
        assert isinstance(dev, DIA)      # scalar DIA first for banded BSR


class TestTridiagPCR:
    """Parallel cyclic reduction tridiagonal solver (ops/tridiag.py) — the
    data-parallel line-smoother core."""

    def test_matches_scipy_banded(self, rng):
        import jax.numpy as jnp
        from scipy.linalg import solve_banded
        from lssp_tpu.ops.tridiag import pcr_solve
        for n in (16, 100, 257):
            d = 4.0 + rng.random(n)
            dl = np.concatenate([[0], -rng.random(n - 1)])
            du = np.concatenate([-rng.random(n - 1), [0]])
            b = rng.standard_normal(n)
            ab = np.zeros((3, n))
            ab[0, 1:] = du[:-1]; ab[1] = d; ab[2, :-1] = dl[1:]
            x = np.asarray(pcr_solve(jnp.asarray(dl), jnp.asarray(d),
                                     jnp.asarray(du), jnp.asarray(b)))
            np.testing.assert_allclose(x, solve_banded((1, 1), ab, b),
                                       rtol=1e-12, atol=1e-13)

    def test_zero_couplings_decouple_lines(self, rng):
        """Zero off-diagonals at line boundaries make the (n,) system the
        batched per-line solve — no bookkeeping needed."""
        import jax.numpy as jnp
        from scipy.linalg import solve_banded
        from lssp_tpu.ops.tridiag import pcr_solve
        B, L = 6, 32
        n = B * L
        d = 4.0 + rng.random(n)
        dl = -rng.random(n); du = -rng.random(n)
        dl[::L] = 0.0; du[L - 1::L] = 0.0
        b = rng.standard_normal(n)
        x = np.asarray(pcr_solve(jnp.asarray(dl), jnp.asarray(d),
                                 jnp.asarray(du), jnp.asarray(b)))
        for k in range(B):
            sl = slice(k * L, (k + 1) * L)
            ab = np.zeros((3, L))
            ab[0, 1:] = du[sl][:-1]; ab[1] = d[sl]; ab[2, :-1] = dl[sl][1:]
            np.testing.assert_allclose(x[sl],
                                       solve_banded((1, 1), ab, b[sl]),
                                       rtol=1e-12, atol=1e-13)


# ---- the plain-XLA DIA / HYB / block products (the GPU execution path) ----

def _dia_from_offsets(n, offsets, dtype, seed):
    """Random DIA-structured CSR with exactly ``offsets`` diagonals."""
    rng = np.random.default_rng(seed)
    S = sp.diags([rng.standard_normal(n - abs(o)) for o in offsets],
                 list(offsets), shape=(n, n), format="csr")
    return CSR.from_scipy(S.astype(dtype))


DIA_OFFSETS = {
    "stencil5": (-19, -1, 0, 1, 19),
    "asym": (-3, 0, 2, 7),
    "diag": (0,),
    "far": (-36, 0, 36),
}
DTYPE_TOL = {np.float32: 2e-6, np.float64: 1e-13}


class TestDiaSpmvXLA:
    """The static-slice DIA product (ops/spmv.py: dia_spmv_padded) against
    scipy, over offset sets, unaligned n, and both precisions."""

    @pytest.mark.parametrize("dtype", [np.float32, np.float64],
                             ids=["f32", "f64"])
    @pytest.mark.parametrize("n", [37, 1001])
    @pytest.mark.parametrize("offs", sorted(DIA_OFFSETS))
    def test_forward(self, offs, n, dtype):
        A = _dia_from_offsets(n, DIA_OFFSETS[offs], dtype, seed=n)
        D = csr_to_dia(A)
        assert D.offsets == DIA_OFFSETS[offs]
        x = np.random.default_rng(1).standard_normal(n).astype(dtype)
        y = jax.jit(spmv)(D, jnp.asarray(x))
        assert y.dtype == dtype
        ref = A.to_scipy().astype(np.float64) @ x.astype(np.float64)
        np.testing.assert_allclose(np.asarray(y, np.float64), ref,
                                   rtol=DTYPE_TOL[dtype],
                                   atol=DTYPE_TOL[dtype] * np.abs(ref).max())

    @pytest.mark.parametrize("dtype", [np.float32, np.float64],
                             ids=["f32", "f64"])
    @pytest.mark.parametrize("offs", sorted(DIA_OFFSETS))
    def test_transpose(self, offs, dtype):
        from lssp_tpu.ops.spmv import spmv_t
        n = 203
        A = _dia_from_offsets(n, DIA_OFFSETS[offs], dtype, seed=7)
        x = np.random.default_rng(2).standard_normal(n).astype(dtype)
        y = jax.jit(spmv_t)(csr_to_dia(A), jnp.asarray(x))
        ref = A.to_scipy().astype(np.float64).T @ x.astype(np.float64)
        np.testing.assert_allclose(np.asarray(y, np.float64), ref,
                                   rtol=DTYPE_TOL[dtype],
                                   atol=DTYPE_TOL[dtype] * np.abs(ref).max())

    @pytest.mark.parametrize("alpha", [0.5, np.float32(-2.0), "traced"])
    def test_mv_amxy_scaling(self, alpha):
        A = laplacian_2d(13)
        D = csr_to_dia(A)
        x = np.random.default_rng(4).standard_normal(169)
        if alpha == "traced":
            y = jax.jit(lambda a, v: mv_amxy(a, D, v))(1.5, jnp.asarray(x))
            a = 1.5
        else:
            y = mv_amxy(alpha, D, jnp.asarray(x))
            a = float(alpha)
        np.testing.assert_allclose(np.asarray(y), a * (A.to_scipy() @ x),
                                   rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("fmt", ["dia", "hyb", "ell"])
    def test_vmap_over_rhs(self, fmt):
        from lssp_tpu.sparse.convert import csr_to_hyb
        A = laplacian_2d(20)
        if fmt == "hyb":
            S = A.to_scipy().tolil()
            S[0, 300] = 0.5                 # one off-band entry
            A = CSR.from_scipy(S.tocsr())
        M = {"dia": csr_to_dia, "hyb": csr_to_hyb, "ell": csr_to_ell}[fmt](A)
        X = np.random.default_rng(6).standard_normal((3, 400))
        Y = np.asarray(jax.vmap(lambda v: spmv(M, v))(jnp.asarray(X)))
        for k in range(3):
            np.testing.assert_allclose(Y[k], A.to_scipy() @ X[k],
                                       rtol=1e-12, atol=1e-12)

    def test_dia_is_static_slices(self):
        """No dynamic_slice or gather in the DIA program: every shifted
        window of x is a static slice XLA can fuse."""
        D = csr_to_dia(laplacian_2d(16))
        jaxpr = str(jax.make_jaxpr(spmv)(D, jnp.ones(256)))
        assert "dynamic_slice" not in jaxpr and "gather" not in jaxpr


class TestHybPlainGather:
    """HYB remainder applied as x[rem_cols] + sorted scatter-add."""

    def _hyb(self, seed=3):
        from lssp_tpu.sparse.convert import csr_to_hyb
        S = laplacian_2d(24).to_scipy().tolil()
        rng = np.random.default_rng(seed)
        for i, j in zip(rng.integers(0, 576, 30), rng.integers(0, 576, 30)):
            S[i, j] += 0.1
        A = CSR.from_scipy(S.tocsr())
        H = csr_to_hyb(A)
        assert 0 < H.nnz_rem and np.all(np.diff(H.rem_rows) >= 0)
        return A, H

    @pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "t"])
    def test_matches_scipy(self, transpose):
        from lssp_tpu.ops.spmv import spmv_t
        A, H = self._hyb()
        x = np.random.default_rng(8).standard_normal(576)
        op = spmv_t if transpose else spmv
        y = jax.jit(op)(jax.device_put(H), jnp.asarray(x))
        S = A.to_scipy()
        np.testing.assert_allclose(np.asarray(y),
                                   (S.T if transpose else S) @ x,
                                   rtol=1e-12, atol=1e-12)


class TestBlockProductsPinnedPrecision:
    """BSR/BDIA einsums pin precision=HIGHEST (an fp32 contraction may run
    in TF32 on the GPU otherwise) and match numpy."""

    def _elasticity(self, dtype):
        from lssp_tpu.sparse import elasticity_2d
        A = elasticity_2d(6)
        return CSR.from_scipy(A.to_scipy().astype(dtype).tocsr())

    @pytest.mark.parametrize("fmt", ["bsr", "bdia"])
    @pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "t"])
    def test_matches_numpy(self, fmt, transpose):
        from lssp_tpu.ops.spmv import spmv_t
        from lssp_tpu.sparse.convert import bsr_to_bdia
        A = self._elasticity(np.float32)
        M = csr_to_bsr(A, 2)
        if fmt == "bdia":
            M = bsr_to_bdia(M)
        x = np.random.default_rng(9).standard_normal(A.shape[0])
        x = x.astype(np.float32)
        op = spmv_t if transpose else spmv
        fn = (lambda v: op(M, v)) if fmt == "bsr" else jax.jit(
            lambda v: op(M, v))
        y = np.asarray(fn(jnp.asarray(x)), np.float64)
        Dn = A.todense().astype(np.float64)
        ref = (Dn.T if transpose else Dn) @ x.astype(np.float64)
        np.testing.assert_allclose(y, ref, rtol=2e-6,
                                   atol=2e-6 * np.abs(ref).max())
        jaxpr = str(jax.make_jaxpr(fn)(jnp.asarray(x)))
        assert "dot_general" in jaxpr
        assert "DEFAULT" not in jaxpr and "HIGHEST" in jaxpr

    def test_block_trisolve_pins_precision(self):
        from lssp_tpu import pc as pc_mod, PCOptions
        A = self._elasticity(np.float32)
        M = pc_mod.setup(A, "biluk", PCOptions(block_size=2))
        jaxpr = str(jax.make_jaxpr(M)(jnp.ones(A.shape[0],
                                                     jnp.float32)))
        assert "dot_general" in jaxpr
        assert "DEFAULT" not in jaxpr and "HIGHEST" in jaxpr
