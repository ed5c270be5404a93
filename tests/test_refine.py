"""Mixed-precision iterative refinement: fp64-quality answers from fp32
inner solves (the precision strategy)."""
import jax.numpy as jnp
import numpy as np

from lssp_tpu import solve, solve_ir, SolverOptions
from lssp_tpu.sparse import laplacian_2d


class TestIR:
    def test_ir_reaches_fp64_accuracy(self):
        A = laplacian_2d(32)
        b = jnp.ones(1024, dtype=jnp.float64)
        opts = SolverOptions(rtol=1e-10, atol=1e-10)
        x, info = solve_ir(A, b, method="gmres", options=opts)
        assert bool(info.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        # far below anything fp32 alone can reach (~1e-4 relative)
        assert res <= 1e-10 * 32 * 1.1

    def test_ir_beats_pure_fp32(self):
        A = laplacian_2d(32)
        b32 = jnp.ones(1024, dtype=jnp.float32)
        x32, _ = solve(A.astype(np.float32), b32, method="gmres",
                       options=SolverOptions(rtol=1e-12, atol=1e-12, maxit=500))
        res32 = np.linalg.norm(np.ones(1024) - A.to_scipy() @ np.asarray(x32, np.float64))
        b = jnp.ones(1024, dtype=jnp.float64)
        xir, info = solve_ir(A, b, method="gmres",
                             options=SolverOptions(rtol=1e-12, atol=1e-12))
        resir = np.linalg.norm(np.ones(1024) - A.to_scipy() @ np.asarray(xir))
        assert resir < res32 * 1e-2

    def test_ir_with_pc(self):
        A = laplacian_2d(32)
        b = jnp.ones(1024, dtype=jnp.float64)
        x, info = solve_ir(A, b, method="gmres", pc="iluk",
                           options=SolverOptions(rtol=1e-10, atol=1e-10))
        assert bool(info.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1e-10 * 32 * 1.1


def test_bf16_inner_refinement_reaches_fp64_target():
    """Mixed-precision IR with a bfloat16 inner solver: half the HBM bytes
    per inner iteration (bandwidth-bound; GPU speed not measured) while the
    fp64 outer loop still lands the 1e-8 relative target.  Inner tolerance
    must be loose (~3e-2): bf16 has 8 mantissa bits."""
    import numpy as np
    import jax.numpy as jnp
    import lssp_tpu as lt

    A = lt.sparse.laplacian_3d(16)
    n = A.shape[0]
    b = jnp.ones(n, dtype=jnp.float64)
    o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0)
    x, info = lt.solve_ir(A, b, method="cg", pc="ilu0", options=o,
                          inner_dtype=jnp.bfloat16, inner_rtol=3e-2,
                          max_outer=60)
    assert bool(info.converged)
    res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
    assert res <= 1.1e-8 * np.sqrt(n)


def test_ir_gmres_uses_right_preconditioned_inner():
    """The fp32 inner GMRES must be right-preconditioned: the left-PC
    Givens estimate stalls on an fp32 floor with strong PCs (measured 854
    vs 60 inner its with saamg at 512^2 anisotropic) — this test pins the
    iteration count at the right-PC level."""
    import numpy as np
    import jax.numpy as jnp
    import lssp_tpu as lt

    A = lt.sparse.anisotropic_poisson_2d(128, epsilon=0.001)
    n = A.shape[0]
    b = jnp.ones(n, dtype=jnp.float64)
    o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, restart=30,
                         maxit=4000)
    x, info = lt.solve_ir(A, b, method="gmres", pc="saamg", options=o)
    assert bool(info.converged)
    assert int(info.nits) <= 120        # left-PC inner burned ~850
    res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
    assert res <= 1.1e-8 * np.sqrt(n) + 1e-10


def test_ir_fgmres_maps_to_rgmres_inner():
    """solve_ir's PC is always a fixed operator, for which FGMRES and
    right-GMRES are identical in exact arithmetic — and fp32 FGMRES has a
    measurably higher attainable-accuracy floor (512^2 aniso + saamg:
    restart cycles stalled just above the inner tolerance, 256 vs 28
    total inner iterations).  Pin the mapped iteration count."""
    import numpy as np
    import jax.numpy as jnp
    import lssp_tpu as lt

    A = lt.sparse.anisotropic_poisson_2d(128, epsilon=0.001)
    n = A.shape[0]
    b = jnp.ones(n, dtype=jnp.float64)
    o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, restart=30,
                         maxit=4000)
    x, info = lt.solve_ir(A, b, method="fgmres", pc="saamg", options=o)
    assert bool(info.converged)
    assert int(info.nits) <= 120
    res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
    assert res <= 1.1e-8 * np.sqrt(n) + 1e-10


class TestIRMulti:
    """solve_ir_multi: fp64-quality multi-rhs via fp32 block (or vmapped)
    inner solves — per-column true residuals, honest per-column flags."""

    def _setup(self, k=4, spd=False):
        import numpy as np
        import jax.numpy as jnp
        import lssp_tpu as lt
        A = (lt.sparse.laplacian_2d(48) if spd
             else lt.sparse.convection_diffusion_2d(48))
        rng = np.random.default_rng(2)
        B = jnp.asarray(rng.standard_normal((A.shape[0], k)))
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, maxit=2000, restart=30)
        return lt, A, B, o

    def _rel(self, A, B, X):
        import numpy as np
        res = np.linalg.norm(np.asarray(B) - A.to_scipy() @ np.asarray(X),
                             axis=0)
        return res / np.linalg.norm(np.asarray(B), axis=0)

    def test_block_gmres_inner_reaches_fp64(self):
        import numpy as np
        lt, A, B, o = self._setup()
        X, info = lt.solve_ir_multi(A, B, method="blockgmres", pc="ilut",
                                    options=o)
        assert np.asarray(info.converged).all()
        assert (self._rel(A, B, X) <= 1.1e-8).all()
        assert X.dtype == np.float64

    def test_block_cg_inner_spd(self):
        import numpy as np
        lt, A, B, o = self._setup(spd=True)
        X, info = lt.solve_ir_multi(A, B, method="blockcg", pc="iluk",
                                    options=o)
        assert np.asarray(info.converged).all()
        assert (self._rel(A, B, X) <= 1.1e-8).all()

    def test_vmapped_inner_matches_per_rhs_solve_ir(self):
        """An ordinary method name runs the vmapped per-column inner;
        each column must match its own solve_ir run to the refinement
        target (converged columns are FROZEN while the slowest finishes,
        so the trajectories are the same up to batched-vs-single XLA
        rounding — bitwise parity between a vmapped and an unbatched
        program is not a JAX contract) with the same inner-policy cost
        (±2 inner iterations)."""
        import numpy as np
        lt, A, B, o = self._setup(k=3)
        X, info = lt.solve_ir_multi(A, B, method="gmres", pc="ilut",
                                    options=o)
        assert np.asarray(info.converged).all()
        for j in range(3):
            xj, ij = lt.solve_ir(A, B[:, j], method="gmres", pc="ilut",
                                 options=o)
            np.testing.assert_allclose(np.asarray(X[:, j]), np.asarray(xj),
                                       rtol=1e-8, atol=1e-10)
            assert abs(int(info.nits[j]) - int(ij.nits)) <= 2, \
                (j, info.nits, ij.nits)

    def test_solve_ir_rejects_block_methods(self):
        import pytest
        lt, A, B, o = self._setup()
        with pytest.raises(ValueError, match="solve_ir_multi"):
            lt.solve_ir(A, B[:, 0], method="blockgmres")

    def test_rejects_1d_rhs(self):
        import pytest
        lt, A, B, o = self._setup()
        with pytest.raises(ValueError, match=r"\(n, k\)"):
            lt.solve_ir_multi(A, B[:, 0], method="blockgmres")
