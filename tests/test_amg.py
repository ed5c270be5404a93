"""Native AMG tests: hierarchy structure, V-cycle convergence factor,
multigrid grid-size robustness, and AMG-preconditioned Krylov (BASELINE
config #5 shape: GMRES+AMG on anisotropic Poisson)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lssp_tpu import solve, SolverOptions, PCOptions
from lssp_tpu.amg import amg_setup, amg_solve, build_device_amg, vcycle
from lssp_tpu.amg.setup import strength_graph, pmis_coarsen, direct_interpolation
from lssp_tpu.ops.spmv import spmv
from lssp_tpu.sparse import laplacian_2d, laplacian_3d, anisotropic_poisson_2d


class TestSetup:
    def test_strength_poisson(self):
        A = laplacian_2d(8).to_scipy()
        S = strength_graph(A, 0.25)
        # all 4 neighbors are equally strong for the 5-pt stencil
        assert S.nnz == A.nnz - A.shape[0]

    def test_pmis_partitions(self):
        A = laplacian_2d(16).to_scipy()
        S = strength_graph(A, 0.25)
        state = pmis_coarsen(S)
        assert set(np.unique(state)) <= {-1, 1}
        nc = (state == 1).sum()
        assert 0 < nc < 256
        # every F point has a strong C neighbour
        Sc = S.tocsr()
        for i in np.nonzero(state == -1)[0]:
            cols = Sc.indices[Sc.indptr[i]:Sc.indptr[i + 1]]
            assert (state[cols] == 1).any()

    def test_interp_preserves_constants(self):
        A = laplacian_2d(16)
        hier = amg_setup(A)
        for lev in hier.levels[:-1]:
            # rows of P sum to ~1 for interior F points (constant vectors
            # interpolate exactly up to boundary effects)
            rs = np.asarray(lev.P.sum(axis=1)).ravel()
            assert np.isfinite(rs).all()

    def test_hierarchy_shrinks(self):
        hier = amg_setup(laplacian_2d(32))
        sizes = [l.A.shape[0] for l in hier.levels]
        assert sizes == sorted(sizes, reverse=True)
        assert sizes[-1] <= 64
        assert hier.complexity() < 4.0


class TestVCycle:
    def _cf(self, A, n_iter=12):
        hier = amg_setup(A)
        h = build_device_amg(hier)
        n = A.shape[0]
        b = jnp.ones(n, dtype=jnp.float64)
        x = jnp.zeros_like(b)
        Ad = h.levels[0].A
        norms = []
        for _ in range(n_iter):
            r = b - spmv(Ad, x)
            x = x + vcycle(h, r)
            norms.append(float(jnp.linalg.norm(b - spmv(Ad, x))))
        return (norms[-1] / norms[3]) ** (1.0 / (n_iter - 4))

    def test_cf_poisson2d(self):
        assert self._cf(laplacian_2d(64)) < 0.45

    def test_cf_grid_robust(self):
        cf32 = self._cf(laplacian_2d(32))
        cf64 = self._cf(laplacian_2d(64))
        assert cf64 < max(2.0 * cf32, 0.45)     # near grid-independent

    def test_cf_anisotropic(self):
        assert self._cf(anisotropic_poisson_2d(64, 0.001)) < 0.45

    def test_cf_poisson3d(self):
        assert self._cf(laplacian_3d(12)) < 0.5

    def test_standalone_solver(self):
        A = laplacian_2d(32)
        b = np.ones(1024)
        x, info = amg_solve(A, b)
        assert info["nits"] < 25
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1.01 * max(1e-7 * 32, 1e-7)


class TestAMGPreconditioner:
    def test_cg_amg_poisson(self):
        A = laplacian_2d(64)
        b = jnp.ones(4096, dtype=jnp.float64)
        x, info = solve(A, b, method="cg", pc="amg")
        assert bool(info.converged)
        assert int(info.nits) <= 15
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1.1e-7 * 64

    def test_gmres_amg_anisotropic(self):
        """BASELINE config #5 shape (scaled down for CI)."""
        A = anisotropic_poisson_2d(128, 0.001)
        b = jnp.ones(128 * 128, dtype=jnp.float64)
        x, info = solve(A, b, method="gmres", pc="amg",
                        options=SolverOptions(restart=30))
        assert bool(info.converged)
        assert int(info.nits) <= 20

    def test_iteration_count_grid_independence(self):
        """The multigrid hallmark: Krylov+AMG iterations stay ~constant as
        the grid refines (vs sqrt(n) growth unpreconditioned)."""
        counts = []
        for N in (32, 64, 96):
            A = laplacian_2d(N)
            b = jnp.ones(N * N, dtype=jnp.float64)
            x, info = solve(A, b, method="cg", pc="amg")
            counts.append(int(info.nits))
        assert counts[-1] <= counts[0] + 4


def test_fmg_initial_guess():
    """Full-multigrid start (the reference's FASP FMG solver type,
    solver-amg.cxx:99): the nested-iteration guess must not lose to the
    zero guess, on both cycle realizations."""
    import numpy as np
    from lssp_tpu.amg.cycle import amg_solve
    A = laplacian_2d(48)
    b = np.ones(A.shape[0])
    x1, i1 = amg_solve(A, b)
    x2, i2 = amg_solve(A, b, fmg=True)
    assert i2["nits"] <= i1["nits"]
    res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x2))
    assert res <= 1.05 * max(1e-7 * np.sqrt(A.shape[0]), 1e-7)


@pytest.mark.parametrize("pc", ["amg", "rsamg", "saamg"])
def test_w_cycle(pc):
    """W-cycle (FASP AMG_param cycle_type capability) on all three cycle
    realizations: converges, and never needs more iterations than V."""
    from lssp_tpu import solve, PCOptions
    A = anisotropic_poisson_2d(64, 0.01)
    b = jnp.ones(A.shape[0], dtype=jnp.float64)
    o = SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=100)
    xv, iv = solve(A, b, method="cg", pc=pc, options=o)
    xw, iw = solve(A, b, method="cg", pc=pc, options=o,
                   pc_options=PCOptions(amg_cycle_type="W"))
    resw = np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(xw))
    assert bool(iw.converged) and resw < 1e-5
    assert int(iw.nits) <= int(iv.nits) + 1, (int(iw.nits), int(iv.nits))


@pytest.mark.parametrize("pc,expect", [
    ("amg", "DeviceAMG"), ("rsamg", "RSAMG"), ("saamg", "SAHierarchy")])
def test_amg_pc_builds_expected_hierarchy(pc, expect):
    """pc='amg' is the classical ELL hierarchy on every backend; rsamg and
    saamg are asked for by name."""
    from lssp_tpu import pc as pc_mod
    M = pc_mod.setup(laplacian_2d(32), pc)
    assert type(M.state).__name__ == expect
    assert M.name.startswith(pc)


def test_coarse_solve_pins_precision():
    """The dense coarse solve of the V-cycle runs at HIGHEST precision (an
    fp32 product may otherwise run in TF32 on the GPU)."""
    h = build_device_amg(amg_setup(laplacian_2d(16)), dtype=np.float32)
    jaxpr = str(jax.make_jaxpr(lambda r: vcycle(h, r))(
        jnp.ones(256, jnp.float32)))
    assert "dot_general" in jaxpr
    assert "DEFAULT" not in jaxpr and "HIGHEST" in jaxpr
