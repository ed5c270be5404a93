"""Structured smoothed-aggregation AMG tests (the gather-free multigrid,
lssp_tpu/amg/sa.py; LIS saamg capability, solver-lis.cxx:8-41)."""
import jax.numpy as jnp
import numpy as np
import pytest

import lssp_tpu as lt
from lssp_tpu import solve, SolverOptions, PCOptions
from lssp_tpu.amg.sa import sa_setup, sa_vcycle
from lssp_tpu.sparse.generators import (
    laplacian_2d, laplacian_3d, anisotropic_poisson_2d)
from lssp_tpu.sparse.types import DIA


class TestSAAMG:
    @pytest.mark.parametrize("gen", [
        lambda: laplacian_2d(64),
        lambda: laplacian_2d(128),
        lambda: anisotropic_poisson_2d(64, 0.001),
        lambda: laplacian_3d(16),
    ])
    def test_cg_saamg_converges(self, gen):
        A = gen()
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = solve(A, b, method="cg", pc="saamg",
                        options=SolverOptions(maxit=200))
        res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged)
        assert res < 1e-4
        assert int(info.nits) < 60

    def test_everything_is_dia(self):
        """The whole point: no gather formats anywhere in the hierarchy."""
        A = anisotropic_poisson_2d(64, 0.001)
        h = sa_setup(A)
        for lev in h.levels:
            assert isinstance(lev.A, DIA)
            if lev.B is not None:
                assert isinstance(lev.B, DIA)
                assert isinstance(lev.C, DIA)

    def test_stencils_bounded(self):
        """Lumped RAP filtering must keep anisotropic coarse stencils small
        (unfiltered they grow 5 → 17 → 53 → 164...)."""
        A = anisotropic_poisson_2d(64, 0.001)
        h = sa_setup(A, filter_tol=1e-3)
        for lev in h.levels:
            assert len(lev.A.offsets) <= 16

    def test_vcycle_reduces_error(self):
        A = laplacian_2d(48)
        n = A.shape[0]
        h = sa_setup(A)
        rng = np.random.default_rng(7)
        xstar = rng.standard_normal(n)
        b = jnp.asarray(A.to_scipy() @ xstar)
        x = jnp.zeros(n)
        e0 = np.linalg.norm(xstar)
        for _ in range(6):
            x = sa_vcycle(h, b, x)
        e = np.linalg.norm(np.asarray(x) - xstar)
        assert e < 0.15 * e0                  # ≥ ~0.7 reduction per cycle

    def test_nonsquare_padding(self):
        """Sizes not divisible by the aggregate size are identity-padded."""
        A = laplacian_2d(31)                   # 961 = not divisible by 4
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = solve(A, b, method="cg", pc="saamg")
        res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged) and res < 1e-4


class TestBoxAggregation:
    """2-D grid-aware box aggregation (saamg_grid): geometric-style
    coarsening via reshapes — near grid-size-robust on isotropic problems."""

    def test_grid_robust(self):
        nits = []
        for N in (64, 128):
            A = laplacian_2d(N)
            b = jnp.ones(A.shape[0], dtype=jnp.float64)
            x, info = solve(A, b, method="cg", pc="saamg",
                            pc_options=PCOptions(saamg_grid=(N, N)),
                            options=SolverOptions(maxit=100))
            assert bool(info.converged)
            res = float(np.linalg.norm(
                np.asarray(b) - A.to_scipy() @ np.asarray(x)))
            assert res < 1e-4
            nits.append(int(info.nits))
        assert nits[1] <= nits[0] + 4          # near grid-independence
        assert nits[1] <= 15

    def test_grid_beats_flat_isotropic(self):
        """Grid-aware aggregation (auto-detected — the default) beats
        forced-flat contiguous ranges, and explicit dims match detection."""
        N = 128
        A = laplacian_2d(N)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        _, i_box = solve(A, b, method="cg", pc="saamg",
                         pc_options=PCOptions(saamg_grid=(N, N)))
        _, i_auto = solve(A, b, method="cg", pc="saamg")
        _, i_flat = solve(A, b, method="cg", pc="saamg",
                          pc_options=PCOptions(saamg_grid=False))
        assert int(i_auto.nits) == int(i_box.nits)   # detection == explicit
        assert int(i_box.nits) < int(i_flat.nits)

    def test_wrong_grid_dims_fall_back(self):
        """grid dims not matching n: box mode silently disabled, still
        converges via range aggregation."""
        A = laplacian_2d(32)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = solve(A, b, method="cg", pc="saamg",
                        pc_options=PCOptions(saamg_grid=(100, 7)))
        assert bool(info.converged)


def test_line_smoother_converges():
    """amg_smoother='line': damped line Jacobi via PCR tridiagonal solves
    (the anisotropic smoother option)."""
    import jax.numpy as jnp
    import numpy as np
    import lssp_tpu as lt
    A = lt.sparse.anisotropic_poisson_2d(64, epsilon=0.01)
    b = jnp.ones(A.shape[0], dtype=jnp.float64)
    o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=500)
    x, info = lt.solve_ir(A, b, method="cg", pc="saamg", options=o,
                          pc_options=lt.PCOptions(amg_smoother="line"))
    assert bool(info.converged)
    res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
    assert res <= 1.1e-8 * 64 + 1e-10
