"""Block-ILUT and variable-block ILU tests (the reference's ITSOL adapter
capabilities: BILUT pc-bilut.cxx:12-112, VBILUK pc-vbiluk.cxx:8-65, VBILUT
pc-vbilut.cxx:7-76 — reimplemented natively; variable blocks are embedded
into uniform bs_max blocks for static batched shapes)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from lssp_tpu import solve, SolverOptions, PCOptions
from lssp_tpu.sparse.generators import elasticity_2d, laplacian_2d


def _var_sizes(n, cycle=(2, 3, 4)):
    szs, rem = [], n
    for s in itertools.cycle(cycle):
        if rem <= max(cycle):
            szs.append(rem)
            break
        szs.append(s)
        rem -= s
    return szs


class TestBlockPCs:
    A = elasticity_2d(10)
    b = jnp.ones(A.shape[0], dtype=jnp.float64)

    def _run(self, pc, po):
        x, info = solve(self.A, self.b, method="gmres", pc=pc, pc_options=po,
                        options=SolverOptions(maxit=2000, restart=60))
        res = float(np.linalg.norm(
            np.asarray(self.b) - self.A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged), f"{pc} did not converge"
        assert res < 1e-5
        return int(info.nits)

    def test_bilut(self):
        n_bilut = self._run("bilut", PCOptions(block_size=2, ilut_tol=1e-3))
        n_none = 693  # unpreconditioned GMRES baseline is far worse
        assert n_bilut < 100

    def test_bilut_tighter_tol_fewer_iterations(self):
        loose = self._run("bilut", PCOptions(block_size=2, ilut_tol=5e-2))
        tight = self._run("bilut", PCOptions(block_size=2, ilut_tol=1e-4))
        assert tight <= loose

    def test_vbiluk_uniform_matches_biluk(self):
        """Uniform variable blocks must reproduce the uniform-BSR path
        exactly (the padding embedding is the identity there)."""
        n = self.A.shape[0]
        n1 = self._run("vbiluk", PCOptions(block_sizes=[2] * (n // 2),
                                           iluk_level=1))
        n2 = self._run("biluk", PCOptions(block_size=2, iluk_level=1))
        assert n1 == n2

    def test_vbiluk_variable(self):
        n = self.A.shape[0]
        self._run("vbiluk", PCOptions(block_sizes=_var_sizes(n),
                                      iluk_level=1))

    def test_vbilut_variable(self):
        n = self.A.shape[0]
        self._run("vbilut", PCOptions(block_sizes=_var_sizes(n),
                                      ilut_tol=1e-3))

    def test_vbilu_bad_sizes(self):
        with pytest.raises(AssertionError, match="sum"):
            solve(self.A, self.b, method="gmres", pc="vbiluk",
                  pc_options=PCOptions(block_sizes=[2, 3]))

    def test_vbilu_requires_sizes(self):
        with pytest.raises(ValueError, match="block_sizes"):
            solve(self.A, self.b, method="gmres", pc="vbiluk",
                  pc_options=PCOptions())


class TestRelaxPCs:
    """SSOR/SOR/GS (LASPACK solver-laspack.cxx:29-34 / LIS
    solver-lis.cxx:8-41 PC-table capabilities)."""

    A = laplacian_2d(16)
    b = jnp.ones(A.shape[0], dtype=jnp.float64)

    @pytest.mark.parametrize("pc,omega", [("ssor", 1.0), ("ssor", 1.5),
                                          ("gs", 1.0), ("sor", 1.3)])
    def test_exact_apply(self, pc, omega):
        from lssp_tpu import pc as pc_mod
        A = laplacian_2d(12)
        n = A.shape[0]
        Ad = A.todense()
        D = np.diag(np.diag(Ad))
        L = np.tril(Ad, -1)
        U = np.triu(Ad, 1)
        M = pc_mod.setup(A, pc, PCOptions(omega=omega, ilu_sweeps=0))
        if pc == "ssor":
            Md = (D + omega * L) @ np.linalg.inv(D) @ (D + omega * U) \
                / (omega * (2 - omega))
        else:
            w = 1.0 if pc == "gs" else omega
            Md = D / w + L
        r = np.linspace(1.0, 2.0, n)
        np.testing.assert_allclose(np.asarray(M(jnp.asarray(r))),
                                   np.linalg.solve(Md, r),
                                   rtol=1e-10, atol=1e-12)

    def test_ssor_accelerates_cg(self):
        x, info = solve(self.A, self.b, method="cg", pc="ssor")
        x0, info0 = solve(self.A, self.b, method="cg", pc="none")
        assert bool(info.converged)
        assert int(info.nits) < int(info0.nits)

    def test_ssor_nonconstant_diagonal(self):
        """Regression: the SSOR unit-L factor is omega*Ls*D^-1 (column
        scaling); row scaling only coincides for constant diagonals."""
        import scipy.sparse as sp
        from lssp_tpu.sparse.types import CSR
        from lssp_tpu import pc as pc_mod
        n = 30
        d = np.linspace(1.0, 10.0, n)
        As = sp.diags([np.full(n - 1, -0.3), d, np.full(n - 1, -0.3)],
                      [-1, 0, 1]).tocsr()
        A = CSR.from_scipy(As)
        M = pc_mod.setup(A, "ssor", PCOptions(omega=1.2, ilu_sweeps=0))
        Ad = As.toarray()
        D = np.diag(np.diag(Ad))
        L = np.tril(Ad, -1)
        U = np.triu(Ad, 1)
        Md = (D + 1.2 * L) @ np.linalg.inv(D) @ (D + 1.2 * U) / (1.2 * 0.8)
        r = np.linspace(1.0, 2.0, n)
        np.testing.assert_allclose(np.asarray(M(jnp.asarray(r))),
                                   np.linalg.solve(Md, r), rtol=1e-12)
        # M must be symmetric for symmetric A (CG requirement)
        Minv = np.column_stack([np.asarray(M(jnp.eye(n)[i]))
                                for i in range(n)])
        assert np.abs(Minv - Minv.T).max() < 1e-12

    def test_ssor_transpose_symmetric(self):
        """For symmetric A, M_SSOR is symmetric: M.t == M apply."""
        from lssp_tpu import pc as pc_mod
        A = laplacian_2d(10)
        M = pc_mod.setup(A, "ssor", PCOptions(omega=1.2, ilu_sweeps=0,
                                              transpose=True))
        r = jnp.asarray(np.linspace(1.0, 2.0, A.shape[0]))
        np.testing.assert_allclose(np.asarray(M.t(r)), np.asarray(M(r)),
                                   rtol=1e-10)


class TestARMS:
    """ARMS multilevel recursive Schur (reference ITSOL ARMS adapter,
    pc-arms.cxx:83-153 — native independent-set/Schur reimplementation)."""

    @pytest.mark.parametrize("gen", [
        lambda: laplacian_2d(32),
        lambda: __import__("lssp_tpu").sparse.convection_diffusion_2d(24, beta=20.0),
        lambda: __import__("lssp_tpu").sparse.anisotropic_poisson_2d(24, 0.01),
    ])
    def test_converges_fast(self, gen):
        A = gen()
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = solve(A, b, method="gmres", pc="arms",
                        options=SolverOptions(maxit=200, restart=60))
        res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged) and res < 1e-5
        assert int(info.nits) <= 10            # multilevel quality

    def test_small_matrix_degenerates_to_direct(self):
        """Below coarse_size the hierarchy is empty — pure direct LU."""
        A = laplacian_2d(8)                    # n=64 < coarse_size=200
        b = jnp.ones(64, dtype=jnp.float64)
        x, info = solve(A, b, method="gmres", pc="arms")
        assert int(info.nits) <= 2

    def test_fine_block_is_diagonal(self):
        """The independent set must induce a diagonal B (no F-F edges in
        the symmetrized pattern), including for nonsymmetric matrices."""
        from lssp_tpu.pc.arms import _greedy_dd_mis
        import lssp_tpu
        A = lssp_tpu.sparse.convection_diffusion_2d(16, beta=30.0)
        f_idx, c_idx = _greedy_dd_mis(A)
        sub = A.to_scipy()[f_idx][:, f_idx]
        off = sub - __import__("scipy.sparse", fromlist=["diags"]).diags(
            sub.diagonal())
        assert abs(off).sum() == 0.0
        assert len(f_idx) + len(c_idx) == A.shape[0]


class TestRAS:
    """Restricted additive Schwarz (the reference's FASP krylov_Schwarz
    capability, solver-fasp.cxx:161-193 — native contiguous-subdomain
    implementation with batched local ILU solves)."""

    def test_single_block_equals_ilu(self):
        """RAS with one subdomain and no overlap IS plain ILU(k)."""
        A = laplacian_2d(24)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        _, ir = solve(A, b, method="gmres", pc="ras",
                      pc_options=PCOptions(num_blocks=1, schwarz_overlap=0))
        _, ii = solve(A, b, method="gmres", pc="iluk",
                      pc_options=PCOptions(ilu_sweeps=0))
        assert int(ir.nits) == int(ii.nits)

    @pytest.mark.parametrize("nb,ov", [(4, 0), (8, 8), (8, 24)])
    def test_converges(self, nb, ov):
        import lssp_tpu
        A = lssp_tpu.sparse.convection_diffusion_2d(32, beta=20.0)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = solve(A, b, method="gmres", pc="ras",
                        pc_options=PCOptions(num_blocks=nb,
                                             schwarz_overlap=ov),
                        options=SolverOptions(maxit=500, restart=60))
        res = float(np.linalg.norm(
            np.asarray(b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged) and res < 1e-4

    def test_uneven_division(self):
        """n not divisible by num_blocks: last subdomain is padded."""
        A = laplacian_2d(31)                       # 961 rows, 7 blocks
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = solve(A, b, method="gmres", pc="ras",
                        pc_options=PCOptions(num_blocks=7, schwarz_overlap=4))
        assert bool(info.converged)


class TestPolyPC:
    """Chebyshev polynomial preconditioner (pure-SpMV apply)."""

    def test_accelerates_cg(self):
        A = laplacian_2d(64)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = solve(A, b, method="cg", pc="poly",
                        pc_options=PCOptions(poly_degree=8))
        x0, i0 = solve(A, b, method="cg", pc="none")
        res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged) and res < 1e-4
        assert int(info.nits) < 0.3 * int(i0.nits)

    def test_degree_monotone(self):
        A = laplacian_2d(48)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        nits = []
        for d in (4, 16):
            _, info = solve(A, b, method="cg", pc="poly",
                            pc_options=PCOptions(poly_degree=d))
            nits.append(int(info.nits))
        assert nits[1] < nits[0]

    def test_symmetric_transpose(self):
        from lssp_tpu import pc as pc_mod
        A = laplacian_2d(16)
        M = pc_mod.setup(A, "poly", PCOptions(poly_degree=6))
        r = jnp.asarray(np.linspace(1.0, 2.0, 256))
        np.testing.assert_allclose(np.asarray(M.t(r)), np.asarray(M(r)),
                                   rtol=1e-12)


def test_vbilu_honors_ilu_sweeps():
    """vbiluk/vbilut route through _pack_bilu_pc so PCOptions.ilu_sweeps and
    the Neumann-sweep option apply uniformly (round-1 advisor finding)."""
    import numpy as np
    import jax.numpy as jnp
    from lssp_tpu import sparse, solve, PCOptions
    from lssp_tpu.pc import setup

    A = sparse.laplacian_2d(8)        # n=64, banded → BDIA-able factors
    n = A.shape[0]
    sizes = [2] * (n // 2)
    M_ex = setup(A, "vbiluk", PCOptions(block_sizes=sizes, ilu_sweeps=0))
    # strict block factors are nilpotent: sweeps >= nrowb makes the
    # truncated Neumann series EXACT, so the two paths must agree tightly
    M_nm = setup(A, "vbiluk", PCOptions(block_sizes=sizes, ilu_sweeps=32))
    assert not M_ex.name.endswith("-n32")
    assert M_nm.name.endswith("-n32")
    r = jnp.asarray(np.random.default_rng(0).standard_normal(n))
    np.testing.assert_allclose(np.asarray(M_nm(r)), np.asarray(M_ex(r)),
                               rtol=1e-10, atol=1e-12)


def test_vbilu_exact_complete_neumann():
    """ilu_sweeps=-1 on the block paths: complete Neumann series equals the
    exact block-scheduled solve (round-2 review pass-2 finding: -1 fell
    through to the scan on block PCs)."""
    import numpy as np
    import jax.numpy as jnp
    from lssp_tpu import sparse, PCOptions
    from lssp_tpu.pc import setup

    A = sparse.laplacian_2d(8)
    n = A.shape[0]
    M_ex = setup(A, "biluk", PCOptions(num_blocks=n // 2, ilu_sweeps=0))
    M_nm = setup(A, "biluk", PCOptions(num_blocks=n // 2, ilu_sweeps=-1))
    assert "-n" in M_nm.name            # Neumann path taken
    r = jnp.asarray(np.random.default_rng(2).standard_normal(n))
    np.testing.assert_allclose(np.asarray(M_nm(r)), np.asarray(M_ex(r)),
                               rtol=1e-11, atol=1e-12)
