"""Distributed-path tests on the 8-virtual-device CPU mesh (SURVEY §4:
mesh-sharded SpMV/dots must match the single-device path exactly)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lssp_tpu import solve, SolverOptions, PCOptions  # noqa
from lssp_tpu.parallel.partition import partition_csr
from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh
from lssp_tpu.parallel.dist_ops import make_dist_spmv
from lssp_tpu.sparse import laplacian_2d, laplacian_3d, random_sparse, CSR


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return make_mesh(8)


class TestPartition:
    def test_halo_mode_for_stencil(self):
        A = laplacian_2d(16)          # n=256, band 16 → halo 16 ≤ R=32
        M = partition_csr(A, 8)
        assert M.mode == "halo"
        assert M.halo == 16

    def test_allgather_for_random(self):
        A = random_sparse(64, 6, seed=0)
        M = partition_csr(A, 8)
        assert M.mode == "allgather"

    @pytest.mark.parametrize("gen,mode", [
        (lambda: laplacian_2d(16), "halo"),
        (lambda: random_sparse(64, 6, seed=1), "allgather"),
    ])
    def test_dist_spmv_matches_scipy(self, gen, mode, mesh8, rng):
        from jax.sharding import PartitionSpec as P
        A = gen()
        n = A.shape[0]
        M = partition_csr(A, 8)
        assert M.mode == mode
        x = rng.standard_normal(n)
        R = n // 8
        spmv_impl = make_dist_spmv(M, "shards")

        def body(cols, data, xs):
            return spmv_impl(cols[0], data[0], xs[0])[None]

        mapped = jax.shard_map(
            body, mesh=mesh8,
            in_specs=(P("shards"), P("shards"), P("shards")),
            out_specs=P("shards"))
        y = np.asarray(mapped(M.cols, M.data,
                              jnp.asarray(x.reshape(8, R)))).reshape(n)
        np.testing.assert_allclose(y, A.to_scipy() @ x, rtol=1e-12)


class TestDistSolve:
    def test_cg_matches_single_device(self, mesh8):
        A = laplacian_2d(16)
        b = jnp.ones(256, dtype=jnp.float64)
        xd, infod = dist_solve(A, b, method="cg", mesh=mesh8)
        xs, infos = solve(A, b, method="cg")
        assert bool(infod.converged)
        # identical stopping rule; counts may differ by reduction order only
        assert abs(int(infod.nits) - int(infos.nits)) <= 2
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(xd))
        assert res <= 1.1e-7 * 16

    @pytest.mark.parametrize("method", ["cg", "gmres", "bicgstab"])
    def test_methods_with_jacobi(self, method, mesh8):
        A = laplacian_2d(16)
        b = jnp.ones(256, dtype=jnp.float64)
        x, info = dist_solve(A, b, method=method, pc="jacobi", mesh=mesh8)
        assert bool(info.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1.1e-7 * 16 * 2

    def test_block_jacobi_ilu(self, mesh8):
        A = laplacian_2d(32)           # n=1024, R=128 per shard
        b = jnp.ones(1024, dtype=jnp.float64)
        x, info = dist_solve(A, b, method="cg", pc="bjilu", mesh=mesh8,
                             pc_options=PCOptions(iluk_level=1))
        assert bool(info.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1.1e-7 * 32 * 2
        # block-Jacobi ILU(1) must beat unpreconditioned CG
        x2, info2 = dist_solve(A, b, method="cg", mesh=mesh8)
        assert int(info.nits) < int(info2.nits)

    def test_allgather_path_gmres(self, mesh8):
        A = random_sparse(64, 6, seed=3)
        b = jnp.ones(64, dtype=jnp.float64)
        x, info = dist_solve(A, b, method="gmres", mesh=mesh8)
        assert bool(info.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1e-6


class TestDistAMG:
    """Distributed AMG V-cycle PC over the 8-virtual-device mesh (BASELINE
    config #5 shape: GMRES+AMG, multi-host partition)."""

    def test_gmres_dist_amg(self, mesh8):
        from lssp_tpu.sparse import anisotropic_poisson_2d
        A = anisotropic_poisson_2d(64, 0.001)
        n = 64 * 64
        b = jnp.ones(n, dtype=jnp.float64)
        x, info = dist_solve(A, b, method="gmres", pc="amg", mesh=mesh8,
                             options=SolverOptions(restart=30))
        assert bool(info.converged)
        assert int(info.nits) <= 20
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1.1e-7 * 64

    def test_dist_amg_matches_single_device_iterations(self, mesh8):
        from lssp_tpu import solve
        A = laplacian_2d(32)
        b = jnp.ones(1024, dtype=jnp.float64)
        xd, infod = dist_solve(A, b, method="cg", pc="amg", mesh=mesh8)
        xs, infos = solve(A, b, method="cg", pc="amg")
        assert bool(infod.converged)
        assert abs(int(infod.nits) - int(infos.nits)) <= 3


class TestDistSAAMG:
    """Distributed structured-SA multigrid (parallel/dist_sa.py): shard-local
    reshape prolongation + halo-exchange SpMVs, no gathers except the coarse
    solve's all_gather."""

    def test_matches_single_device(self):
        import lssp_tpu as lt
        from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh
        A = lt.sparse.laplacian_2d(32)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = dist_solve(A, b, method="cg", pc="saamg",
                             mesh=make_mesh(8),
                             options=lt.SolverOptions(maxit=100))
        res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged) and res < 1e-4
        xs, i1 = lt.solve(A, b, method="cg", pc="saamg",
                          options=lt.SolverOptions(maxit=100))
        assert abs(int(info.nits) - int(i1.nits)) <= 4

    def test_padding_path(self):
        """n not divisible by P·g^L: the system is identity-padded."""
        import lssp_tpu as lt
        from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh
        A = lt.sparse.laplacian_2d(30)             # 900 rows
        b = jnp.ones(900, dtype=jnp.float64)
        x, info = dist_solve(A, b, method="cg", pc="saamg",
                             mesh=make_mesh(8),
                             options=lt.SolverOptions(maxit=100))
        assert x.shape == (900,)
        res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged) and res < 1e-4


class TestDistMethodMatrix:
    """Every transpose-free Krylov method runs unchanged under shard_map
    (the dist layer injects op + psum dot; regression for the IDR shadow
    products, which must route through the distributed dot)."""

    @pytest.mark.parametrize("method", [
        "cg", "gmres", "rgmres", "fgmres", "bicgstab", "bicgstabl",
        "bicgsafe", "cgs", "gpbicg", "cr", "crs", "bicrstab", "bicrsafe",
        "gpbicr", "qmrcgstab", "tfqmr", "orthomin", "idrs", "lgmres",
        "minres", "pipecg", "cagmres", "cargmres"])
    def test_method_distributed(self, method):
        import lssp_tpu as lt
        from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh
        sym = method in ("minres", "cg", "cr", "pipecg")
        A = (lt.sparse.laplacian_2d(32) if sym
             else lt.sparse.convection_diffusion_2d(32, beta=10.0))
        b = jnp.ones(1024, dtype=jnp.float64)
        x, info = dist_solve(A, b, method=method, pc="bjilu",
                             mesh=make_mesh(8),
                             options=lt.SolverOptions(maxit=2000, restart=30))
        res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged) and res < 1e-4, (method, res)


class TestCommAvoiding:
    """Communication-avoiding Krylov variants: pipecg's per-iteration sync
    cost is ONE psum (cg pays 3 — rho, <q,p>, and the norm — at two
    dependent points per iteration, SURVEY §3.3)."""

    def test_pipecg_matches_cg(self):
        import lssp_tpu as lt
        o = SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
        for gen, pc in [(lambda: laplacian_2d(64), "jacobi"),
                        (lambda: laplacian_3d(16), "ilu0")]:
            A = gen()
            b = jnp.ones(A.shape[0], dtype=jnp.float64)
            x1, i1 = lt.solve(A, b, method="cg", pc=pc, options=o)
            x2, i2 = lt.solve(A, b, method="pipecg", pc=pc, options=o)
            assert bool(i2.converged)
            res = float(np.linalg.norm(
                np.asarray(b) - A.to_scipy() @ np.asarray(x2)))
            assert res <= 1.1e-8 * float(i2.r0norm) + 1e-10
            # the pipelined norm is known one reduction late => +1 body
            assert abs(int(i2.nits) - int(i1.nits)) <= 2, (pc, int(i1.nits),
                                                           int(i2.nits))

    @staticmethod
    def _psums_in_while(method):
        """Count psum equations inside while_loop bodies of the
        shard_map'd iteration (trace inspection — the latency census)."""
        import lssp_tpu as lt
        from lssp_tpu.parallel.dist_solve import make_mesh, AXIS
        from lssp_tpu.parallel.dist_ops import make_psum_dot
        from lssp_tpu.solvers.registry import get_solver
        from jax.sharding import PartitionSpec as P

        fn = get_solver(method)

        def prog(b):
            op = lambda v: v * 2.0 - jnp.roll(v, 1) * 0.5
            x, info = fn(op, b, jnp.zeros_like(b), None,
                         opts=SolverOptions(maxit=10).resolved(),
                         dot=make_psum_dot(AXIS))
            return x, info.residual

        jaxpr = jax.make_jaxpr(jax.shard_map(
            prog, mesh=make_mesh(8), in_specs=P(AXIS), out_specs=(P(AXIS),
                                                                  P()),
            check_vma=False))(jnp.ones(1024))

        def count(jx, inside):
            tot = 0
            for eq in jx.eqns:
                if eq.primitive.name == "psum" and inside:
                    tot += 1
                for v in eq.params.values():
                    # params hold raw Jaxprs (shard_map) or ClosedJaxprs
                    # (while/cond/pjit) — unwrap both
                    sub = v if hasattr(v, "eqns") else getattr(v, "jaxpr",
                                                              None)
                    if sub is not None:
                        tot += count(sub, inside
                                     or eq.primitive.name == "while")
            return tot
        return count(jaxpr.jaxpr, False)

    def test_pipecg_single_reduction(self):
        n_cg = self._psums_in_while("cg")
        n_pipe = self._psums_in_while("pipecg")
        assert n_pipe == 1, f"pipecg body must psum ONCE, traced {n_pipe}"
        assert n_cg >= 3, f"census harness broken (cg traced {n_cg})"

    def test_cagmres_matches_gmres(self):
        import lssp_tpu as lt
        o = SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000,
                          restart=30)
        A = lt.sparse.convection_diffusion_2d(48)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        for base, ca in (("gmres", "cagmres"), ("rgmres", "cargmres")):
            _, i1 = lt.solve(A, b, method=base, pc="ilut", options=o)
            x2, i2 = lt.solve(A, b, method=ca, pc="ilut", options=o)
            assert bool(i2.converged)
            res = float(np.linalg.norm(
                np.asarray(b) - A.to_scipy() @ np.asarray(x2)))
            assert res <= 1.1e-8 * float(i2.r0norm) + 1e-10
            assert abs(int(i2.nits) - int(i1.nits)) <= 2

    @staticmethod
    def _psum_depths(method):
        """Map while-nesting depth → psum count (the MGS loop's dependent
        per-column dot shows up as a psum at depth ≥ 3)."""
        import lssp_tpu as lt
        from lssp_tpu.parallel.dist_solve import make_mesh, AXIS
        from lssp_tpu.parallel.dist_ops import make_psum_dot
        from lssp_tpu.solvers.registry import get_solver
        from jax.sharding import PartitionSpec as P

        fn = get_solver(method)

        def prog(b):
            op = lambda v: v * 2.0 - jnp.roll(v, 1) * 0.5
            x, info = fn(op, b, jnp.zeros_like(b), None,
                         opts=SolverOptions(maxit=10, restart=5).resolved(),
                         dot=make_psum_dot(AXIS))
            return x, info.residual

        jaxpr = jax.make_jaxpr(jax.shard_map(
            prog, mesh=make_mesh(8), in_specs=P(AXIS),
            out_specs=(P(AXIS), P()), check_vma=False))(jnp.ones(1024))
        depths = {}

        def walk(jx, d):
            for eq in jx.eqns:
                if eq.primitive.name == "psum":
                    depths[d] = depths.get(d, 0) + 1
                for v in eq.params.values():
                    sub = v if hasattr(v, "eqns") else getattr(v, "jaxpr",
                                                              None)
                    if sub is not None:
                        walk(sub, d + (eq.primitive.name == "while"))
            return depths
        return walk(jaxpr.jaxpr, 0)

    def test_cagmres_constant_reductions(self):
        """gmres's MGS pays a psum inside the per-column j-loop (while
        depth ≥ 3: outer restart → Arnoldi → MGS); cagmres's batched CGS2
        reductions all sit in the Arnoldi body (depth ≤ 2)."""
        d_mgs = self._psum_depths("gmres")
        d_ca = self._psum_depths("cagmres")
        assert any(k >= 3 and v > 0 for k, v in d_mgs.items()), d_mgs
        assert not any(k >= 3 and v > 0 for k, v in d_ca.items()), d_ca


class TestDistTranspose:
    """Distributed transpose SpMV (reverse halo exchange / psum_scatter) and
    the transpose-based Krylov methods under shard_map."""

    @pytest.mark.parametrize("gen,mode", [
        (lambda: __import__("lssp_tpu").sparse.convection_diffusion_2d(
            32, beta=10.0), "halo"),
        (lambda: __import__("lssp_tpu").sparse.generators.random_sparse(
            1024, nnz_per_row=6, seed=2), "allgather"),
    ])
    def test_spmv_t_exact(self, gen, mode, rng):
        import jax
        from jax.sharding import PartitionSpec as P
        from lssp_tpu.parallel.partition import partition_csr
        from lssp_tpu.parallel.dist_ops import make_dist_spmv_t
        from lssp_tpu.parallel.dist_solve import make_mesh
        A = gen()
        M = partition_csr(A, 8)
        assert M.mode == mode
        opt = make_dist_spmv_t(M, "shards")
        x = rng.standard_normal(1024)
        f = jax.shard_map(
            lambda c, d, v: opt(c[0], d[0], v[0])[None], mesh=make_mesh(8),
            in_specs=(P("shards"), P("shards"), P("shards")),
            out_specs=P("shards"), check_vma=False)
        y = np.asarray(f(M.cols, M.data,
                         jnp.asarray(x.reshape(8, -1)))).reshape(-1)
        np.testing.assert_allclose(y, A.to_scipy().T @ x, rtol=1e-12)

    @pytest.mark.parametrize("method", ["bicg", "qmr", "cgnr", "lsqr"])
    @pytest.mark.parametrize("pc", ["jacobi", "bjilu"])
    def test_transpose_methods_distributed(self, method, pc):
        import lssp_tpu as lt
        from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh
        A = lt.sparse.convection_diffusion_2d(32, beta=10.0)
        b = jnp.ones(1024, dtype=jnp.float64)
        x, info = dist_solve(A, b, method=method, pc=pc,
                             mesh=make_mesh(8),
                             options=lt.SolverOptions(maxit=3000))
        res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged) and res < 1e-4

    def test_unsupported_pc_raises(self):
        import lssp_tpu as lt
        from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh
        A = lt.sparse.laplacian_2d(32)
        b = jnp.ones(1024, dtype=jnp.float64)
        with pytest.raises(ValueError, match="transpose"):
            dist_solve(A, b, method="bicg", pc="saamg", mesh=make_mesh(8))


class TestDistPCOptions:
    """Distributed PCs honor the same PCOptions knobs as single-device."""

    def test_dist_amg_cycles(self):
        import lssp_tpu as lt
        from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh
        A = lt.sparse.laplacian_2d(32)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        _, i1 = dist_solve(A, b, method="cg", pc="amg", mesh=make_mesh(8),
                           options=lt.SolverOptions(maxit=100),
                           pc_options=lt.PCOptions(amg_cycles=1))
        _, i2 = dist_solve(A, b, method="cg", pc="amg", mesh=make_mesh(8),
                           options=lt.SolverOptions(maxit=100),
                           pc_options=lt.PCOptions(amg_cycles=2))
        assert bool(i1.converged) and bool(i2.converged)
        assert int(i2.nits) < int(i1.nits)

    def test_dist_host_trace_fallback(self, capsys, monkeypatch):
        import importlib
        import lssp_tpu as lt
        from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh
        ulog = importlib.import_module("lssp_tpu.utils.log")
        monkeypatch.setattr(ulog, "_device_print_ok", False)
        A = lt.sparse.laplacian_2d(16)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        x, info = dist_solve(A, b, method="cg", pc="jacobi",
                             mesh=make_mesh(8),
                             options=lt.SolverOptions(maxit=30, verbosity=1))
        lines = [l for l in capsys.readouterr().out.splitlines()
                 if l.startswith("itr:")]
        assert len(lines) == int(info.nits)
        assert info.history is None      # forced buffer stripped


class TestDistDIA:
    """Gather-free distributed DIA path (VERDICT r1 item #1): per-shard
    shifted-stream SpMV with neighbour ppermute halo exchange must match the
    single-device product and solves exactly."""

    def test_partition_matrix_picks_dia_for_banded(self):
        from lssp_tpu.parallel.partition import partition_matrix, DistDIA
        A = laplacian_2d(16)
        M = partition_matrix(A, 8)
        assert isinstance(M, DistDIA)
        assert M.offsets == (-16, -1, 0, 1, 16)
        assert M.lo == 16 and M.hi == 16

    def test_partition_matrix_falls_back_for_random(self):
        from lssp_tpu.parallel.partition import partition_matrix, DistELL
        A = random_sparse(64, 6, seed=0)
        M = partition_matrix(A, 8)
        assert isinstance(M, DistELL)

    def test_dia_reach_beyond_neighbour_raises(self):
        from lssp_tpu.parallel.partition import partition_csr_dia
        import scipy.sparse as sp
        n = 256
        S = sp.diags([np.ones(n - 40), 2 * np.ones(n), np.ones(n - 40)],
                     [-40, 0, 40], format="csr")
        with pytest.raises(ValueError, match="reach"):
            partition_csr_dia(CSR.from_scipy(S), 8)   # R=32 < 40

    @pytest.mark.parametrize("gen", [
        lambda: laplacian_2d(16),
        lambda: __import__("lssp_tpu").sparse.convection_diffusion_2d(
            32, beta=10.0),
    ])
    def test_dist_dia_spmv_exact(self, gen, mesh8, rng):
        from jax.sharding import PartitionSpec as P
        from lssp_tpu.parallel.partition import partition_csr_dia
        A = gen()
        n = A.shape[0]
        M = partition_csr_dia(A, 8)
        x = rng.standard_normal(n)
        op = make_dist_spmv(M, "shards")
        f = jax.shard_map(lambda d, v: op(d[0], v[0])[None], mesh=mesh8,
                          in_specs=(P("shards"), P("shards")),
                          out_specs=P("shards"), check_vma=False)
        y = np.asarray(f(jnp.asarray(M.data),
                         jnp.asarray(x.reshape(8, -1)))).reshape(-1)
        np.testing.assert_allclose(y, A.to_scipy() @ x, rtol=1e-13)

    def test_dist_dia_spmv_t_exact(self, mesh8, rng):
        from jax.sharding import PartitionSpec as P
        from lssp_tpu.parallel.partition import partition_csr_dia
        from lssp_tpu.parallel.dist_ops import make_dist_spmv_t
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(32, beta=10.0)
        n = A.shape[0]
        M = partition_csr_dia(A, 8)
        x = rng.standard_normal(n)
        op = make_dist_spmv_t(M, "shards")
        f = jax.shard_map(lambda d, v: op(d[0], v[0])[None], mesh=mesh8,
                          in_specs=(P("shards"), P("shards")),
                          out_specs=P("shards"), check_vma=False)
        y = np.asarray(f(jnp.asarray(M.data),
                         jnp.asarray(x.reshape(8, -1)))).reshape(-1)
        np.testing.assert_allclose(y, A.to_scipy().T @ x, rtol=1e-13)

    @pytest.mark.parametrize("method,pc", [
        ("cg", "none"), ("gmres", "jacobi"), ("bicgstab", "bjilu"),
        ("qmr", "bjilu"),
    ])
    def test_dia_solve_matches_single_device(self, method, pc, mesh8):
        A = laplacian_2d(16)
        b = jnp.ones(256, dtype=jnp.float64)
        xd, infod = dist_solve(A, b, method=method, pc=pc, mesh=mesh8,
                               fmt="dia")
        xs, infos = solve(A, b, method=method,
                          pc={"bjilu": None}.get(pc, pc))
        assert bool(infod.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(xd))
        assert res <= 1.2e-7 * 16


class TestGeneralN:
    """n % nshards != 0 is padded with identity equations (VERDICT r1 #8)."""

    @pytest.mark.parametrize("method,pc", [
        ("cg", "bjilu"), ("gmres", "jacobi"),
    ])
    def test_prime_n(self, method, pc, mesh8):
        A = laplacian_2d(15)            # n=225, 225 % 8 = 1
        n = A.shape[0]
        b = jnp.ones(n, dtype=jnp.float64)
        x, info = dist_solve(A, b, method=method, pc=pc, mesh=mesh8)
        assert bool(info.converged)
        assert x.shape == (n,)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1.2e-7 * 15

    def test_padded_matches_unpadded_counts(self, mesh8):
        A = laplacian_2d(15)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        _, infod = dist_solve(A, b, method="cg", mesh=mesh8)
        _, infos = solve(A, b, method="cg")
        assert abs(int(infod.nits) - int(infos.nits)) <= 2


class TestDistHYB:
    """Distributed band+remainder hybrid: nearly-banded matrices keep the
    gather-free DIA streaming multi-chip, with the COO remainder applied
    against the all-gathered x."""

    @staticmethod
    def _nearly_banded(n_side=16, n_extra=40, seed=4):
        import scipy.sparse as sp
        rng = np.random.default_rng(seed)
        S = laplacian_2d(n_side).to_scipy().tolil()
        n = S.shape[0]
        for i, j in zip(rng.integers(0, n, n_extra),
                        rng.integers(0, n, n_extra)):
            S[i, j] += 0.02
        return CSR.from_scipy(S.tocsr())

    def test_partition_matrix_picks_hyb(self):
        from lssp_tpu.parallel.partition import partition_matrix, DistHYB
        M = partition_matrix(self._nearly_banded(), 8)
        assert isinstance(M, DistHYB)
        assert M.band.offsets == (-16, -1, 0, 1, 16)

    def test_dist_hyb_spmv_exact(self, mesh8, rng):
        from jax.sharding import PartitionSpec as P
        from lssp_tpu.parallel.partition import partition_csr_hyb
        A = self._nearly_banded()
        n = A.shape[0]
        M = partition_csr_hyb(A, 8)
        x = rng.standard_normal(n)
        op = make_dist_spmv(M, "shards")
        leaves, _ = jax.tree_util.tree_flatten(M)
        f = jax.shard_map(
            lambda *a: op(*[q[0] for q in a[:-1]], a[-1][0])[None],
            mesh=mesh8, in_specs=tuple(P("shards") for _ in range(5)),
            out_specs=P("shards"), check_vma=False)
        y = np.asarray(f(*[jnp.asarray(l) for l in leaves],
                         jnp.asarray(x.reshape(8, -1)))).reshape(-1)
        np.testing.assert_allclose(y, A.to_scipy() @ x, rtol=1e-12)

    def test_dist_hyb_spmv_t_exact(self, mesh8, rng):
        from jax.sharding import PartitionSpec as P
        from lssp_tpu.parallel.partition import partition_csr_hyb
        from lssp_tpu.parallel.dist_ops import make_dist_spmv_t
        A = self._nearly_banded()
        n = A.shape[0]
        M = partition_csr_hyb(A, 8)
        x = rng.standard_normal(n)
        op = make_dist_spmv_t(M, "shards")
        leaves, _ = jax.tree_util.tree_flatten(M)
        f = jax.shard_map(
            lambda *a: op(*[q[0] for q in a[:-1]], a[-1][0])[None],
            mesh=mesh8, in_specs=tuple(P("shards") for _ in range(5)),
            out_specs=P("shards"), check_vma=False)
        y = np.asarray(f(*[jnp.asarray(l) for l in leaves],
                         jnp.asarray(x.reshape(8, -1)))).reshape(-1)
        np.testing.assert_allclose(y, A.to_scipy().T @ x, rtol=1e-12)

    @pytest.mark.parametrize("method,pc", [
        ("gmres", "jacobi"), ("bicgstab", "bjilu"), ("qmr", "jacobi"),
    ])
    def test_dist_hyb_solve(self, method, pc, mesh8):
        A = self._nearly_banded()
        n = A.shape[0]
        b = jnp.ones(n, dtype=jnp.float64)
        xd, infod = dist_solve(A, b, method=method, pc=pc, mesh=mesh8,
                               fmt="hyb",
                               options=SolverOptions(maxit=3000))
        assert bool(infod.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(xd))
        assert res <= 2e-6


class TestDistNeumannILU:
    """Distributed Chow-sweep bjilu (r2): every sweep is a shard-local DIA
    stream; the complete series (-1) must equal the
    exact-scheduled apply."""

    def test_exact_neumann_matches_schedules(self, mesh8):
        A = laplacian_2d(16)
        b = jnp.ones(256, dtype=jnp.float64)
        x_ex, i_ex = dist_solve(A, b, method="cg", pc="bjilu", mesh=mesh8,
                                pc_options=PCOptions(ilu_sweeps=0))
        x_nm, i_nm = dist_solve(A, b, method="cg", pc="bjilu", mesh=mesh8,
                                pc_options=PCOptions(ilu_sweeps=-1))
        assert bool(i_nm.converged)
        assert int(i_nm.nits) == int(i_ex.nits)
        np.testing.assert_allclose(np.asarray(x_nm), np.asarray(x_ex),
                                   rtol=1e-10, atol=1e-12)

    def test_truncated_sweeps_converge(self, mesh8):
        A = laplacian_2d(16)
        b = jnp.ones(256, dtype=jnp.float64)
        x, info = dist_solve(A, b, method="cg", pc="bjilu", mesh=mesh8,
                             pc_options=PCOptions(ilu_sweeps=6))
        assert bool(info.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1.2e-7 * 16

    def test_transpose_method_with_neumann(self, mesh8):
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(32, beta=10.0)
        b = jnp.ones(1024, dtype=jnp.float64)
        x, info = dist_solve(A, b, method="qmr", pc="bjilu", mesh=mesh8,
                             pc_options=PCOptions(ilu_sweeps=-1),
                             options=SolverOptions(maxit=3000))
        assert bool(info.converged)
        res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
        assert res <= 1e-4


def _union_buster(n=1024, Pn=8):
    """Block-diagonal matrix whose shard blocks are each narrow-banded but
    at DIFFERENT offsets: the cross-shard offset union exceeds the static
    streaming cap (96) while each shard stays well under it."""
    import scipy.sparse as sp
    R = n // Pn
    blocks = []
    rng = np.random.default_rng(3)
    for p in range(Pn):
        offs = [0] + [-(1 + 14 * p + j) for j in range(14)] \
            + [1 + 14 * p + j for j in range(14)]
        diags, keep = [], []
        for o in offs:
            if abs(o) >= R:
                continue
            m = R - abs(o)
            diags.append(40.0 * np.ones(R) if o == 0
                         else -rng.uniform(0.1, 0.5, m))
            keep.append(o)
        blocks.append(sp.diags(diags, keep, shape=(R, R)))
    return CSR.from_scipy(sp.block_diag(blocks, format="csr"))


def test_dist_ilu_dynamic_offsets(mesh8):
    """Per-shard offset sets (ilu_nmd) keep the streaming Chow-sweep path
    when the union diagonal count exceeds the static cap.  The dynamic
    roll-streams (forward AND transpose) are verified directly against a
    dense numpy replay of the sweep recurrence, then through full
    solves."""
    from lssp_tpu.parallel.dist_solve import (_build_dist_pc,
                                              _shard_pc_apply,
                                              _DistNeumannILUDyn)
    A = _union_buster()
    n = A.shape[0]
    R = n // 8
    kind, st = _build_dist_pc(A, "bjilu",
                              PCOptions(ilu_sweeps=3).resolved(), 8, R)
    assert kind == "ilu_nmd" and isinstance(st, _DistNeumannILUDyn)

    def dense(data, offs):
        D = np.zeros((R, R))
        for k, o in enumerate(np.asarray(offs)):
            for i in range(R):
                if 0 <= i + o < R:
                    D[i, i + o] += np.asarray(data)[k, i]
        return D

    for p in (0, 3, 7):
        loc = jax.tree_util.tree_map(lambda a: a[p], st)
        fn = _shard_pc_apply(kind, loc, R)
        L = dense(loc.Ldata, loc.Loff)
        U = dense(loc.Udata, loc.Uoff)
        inv = np.asarray(loc.invdiag)
        rng = np.random.default_rng(p)
        r = rng.standard_normal(R)
        y = r.copy()
        for _ in range(3):
            y = r - L @ y
        zr = inv * y
        z = zr.copy()
        for _ in range(3):
            z = zr - U @ z
        np.testing.assert_allclose(np.asarray(fn(jnp.asarray(r))), z,
                                   rtol=1e-12, atol=1e-12)
        w = r.copy()
        for _ in range(3):
            w = r - U.T @ w
        zr = inv * w
        z = zr.copy()
        for _ in range(3):
            z = zr - L.T @ z
        np.testing.assert_allclose(np.asarray(fn.t(jnp.asarray(r))), z,
                                   rtol=1e-12, atol=1e-12)

    b = jnp.ones(n, dtype=jnp.float64)
    x, info = dist_solve(A, b, method="bicgstab", pc="bjilu", mesh=mesh8,
                         pc_options=PCOptions(ilu_sweeps=3),
                         options=SolverOptions(rtol=1e-10, maxit=200))
    assert bool(info.converged)
    assert np.linalg.norm(b - A.to_scipy() @ np.asarray(x)) <= 1e-5
    # transpose apply (qmr exercises M^-T)
    xq, iq = dist_solve(A, b, method="qmr", pc="bjilu", mesh=mesh8,
                        pc_options=PCOptions(ilu_sweeps=3),
                        options=SolverOptions(rtol=1e-10, maxit=200))
    assert bool(iq.converged)
    assert np.linalg.norm(b - A.to_scipy() @ np.asarray(xq)) <= 1e-5


def test_dist_pcr_solve_exact(mesh8):
    """Spike substructured tridiagonal solve: machine-exact vs scipy for
    couplings that cross every shard cut, and equal to the decoupled
    per-shard solve when they don't."""
    import scipy.sparse as sp
    from jax.sharding import PartitionSpec as P
    from lssp_tpu.ops.tridiag import dist_pcr_solve

    n, Pn = 256, 8
    rng = np.random.default_rng(0)
    d = 4.0 + rng.uniform(0, 1, n)
    dl = np.zeros(n); dl[1:] = -rng.uniform(0.5, 1.0, n - 1)
    du = np.zeros(n); du[:-1] = -rng.uniform(0.5, 1.0, n - 1)
    b = rng.standard_normal(n)
    f = jax.shard_map(
        lambda a, c, e, r: dist_pcr_solve(a, c, e, r, "shards", Pn),
        mesh=mesh8, in_specs=(P("shards"),) * 4, out_specs=P("shards"))
    for zero_cuts in (False, True):
        dl2, du2 = dl.copy(), du.copy()
        if zero_cuts:
            cuts = np.arange(1, Pn) * (n // Pn)
            dl2[cuts] = 0.0
            du2[cuts - 1] = 0.0
        T = sp.diags([dl2[1:], d, du2[:-1]], [-1, 0, 1]).tocsr()
        x = np.asarray(f(jnp.asarray(dl2), jnp.asarray(d),
                         jnp.asarray(du2), jnp.asarray(b)))
        assert np.abs(x - sp.linalg.spsolve(T, b)).max() < 1e-12


def test_dist_sa_grid_stall_falls_back_to_flat(mesh8, capsys):
    """When shard alignment stops grid coarsening far above coarse_size
    (here: x-direction exhausted, (gy/P) % g != 0 blocks y), build_dist_sa
    must fall back to the flat planned-padding hierarchy instead of
    dense-inverting the stalled operator — and still converge."""
    import scipy.sparse as sp
    from lssp_tpu.parallel.dist_sa import build_dist_sa
    gy, gx, eps = 48, 64, 1e-3
    Ty = sp.diags([-np.ones(gy - 1), 2 * np.ones(gy), -np.ones(gy - 1)],
                  [-1, 0, 1])
    Tx = sp.diags([-np.ones(gx - 1), 2 * np.ones(gx), -np.ones(gx - 1)],
                  [-1, 0, 1])
    A = CSR.from_scipy((sp.kron(Ty, sp.eye(gx)) * eps
                        + sp.kron(sp.eye(gy), Tx)).tocsr())
    h = build_dist_sa(A, 8, coarse_size=8, grid=(gy, gx))
    captured = capsys.readouterr()
    assert "falling back to the flat hierarchy" in (captured.err
                                                    + captured.out)
    assert h.coarse_inv.shape[2] <= 32     # flat hierarchy coarsened fully
    x, info = dist_solve(A, jnp.ones(A.shape[0], jnp.float64),
                         method="cg", pc="saamg", mesh=mesh8,
                         pc_options=PCOptions(saamg_grid=(gy, gx),
                                              amg_coarse_size=8),
                         options=SolverOptions(maxit=400))
    assert bool(info.converged)


def test_dist_spike_solve_matches_unprepared(mesh8):
    """The prepared-interface Spike solve (spikes + interface inverse
    precomputed at setup, ops/tridiag.spike_interface_host) returns the
    same solution as the all-in-the-loop dist_pcr_solve."""
    import scipy.sparse as sp
    from jax.sharding import PartitionSpec as P
    from lssp_tpu.ops.tridiag import (dist_pcr_solve, dist_spike_solve,
                                      spike_interface_host)

    n, Pn = 256, 8
    R = n // Pn
    rng = np.random.default_rng(1)
    d = 4.0 + rng.uniform(0, 1, n)
    dl = np.zeros(n); dl[1:] = -rng.uniform(0.5, 1.0, n - 1)
    du = np.zeros(n); du[:-1] = -rng.uniform(0.5, 1.0, n - 1)
    b = rng.standard_normal(n)
    v, w, Minv = spike_interface_host(dl.reshape(Pn, R),
                                      d.reshape(Pn, R),
                                      du.reshape(Pn, R))
    vj, wj = jnp.asarray(v), jnp.asarray(w)
    mij = jnp.asarray(np.tile(Minv[None], (Pn, 1, 1)))
    f0 = jax.shard_map(
        lambda a, c, e, r: dist_pcr_solve(a, c, e, r, "shards", Pn),
        mesh=mesh8, in_specs=(P("shards"),) * 4, out_specs=P("shards"))
    f1 = jax.shard_map(
        lambda a, c, e, vs, ws, mi, r: dist_spike_solve(
            a[0], c[0], e[0], vs[0], ws[0], mi[0], r[0], "shards", Pn)[None],
        mesh=mesh8, in_specs=(P("shards"),) * 7, out_specs=P("shards"))
    x0 = np.asarray(f0(jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du),
                       jnp.asarray(b)))
    x1 = np.asarray(f1(jnp.asarray(dl.reshape(Pn, R)),
                       jnp.asarray(d.reshape(Pn, R)),
                       jnp.asarray(du.reshape(Pn, R)), vj, wj, mij,
                       jnp.asarray(b.reshape(Pn, R)))).reshape(-1)
    T = sp.diags([dl[1:], d, du[:-1]], [-1, 0, 1]).tocsr()
    ref = sp.linalg.spsolve(T, b)
    assert np.abs(x1 - ref).max() < 1e-10
    np.testing.assert_allclose(x1, x0, rtol=1e-10, atol=1e-12)


def test_dist_saamg_line_smoother(mesh8):
    """Distributed line smoother: shard-local PCR tridiagonal sweeps
    (valid because grid partitions keep whole lines in one shard)."""
    import lssp_tpu as lt
    A = lt.sparse.anisotropic_poisson_2d(32, epsilon=0.01)
    b = jnp.ones(A.shape[0], dtype=jnp.float64)
    x, info = dist_solve(A, b, method="cg", pc="saamg", mesh=mesh8,
                         options=SolverOptions(maxit=300),
                         pc_options=PCOptions(amg_smoother="line"))
    assert bool(info.converged)
    res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
    assert res <= 2e-6
    # iteration count close to the single-device line-smoothed solve
    _, i1 = lt.solve(A, b, method="cg",
                     M=__import__("lssp_tpu").pc.setup(
                         A, "saamg", PCOptions(amg_smoother="line")),
                     options=lt.SolverOptions(maxit=300), reorder=None)
    assert abs(int(info.nits) - int(i1.nits)) <= 4


def test_dist_line_smoother_crossing_lines(mesh8, capsys):
    """A 1-D chain partitioned across shards has ±1 couplings at every
    shard cut — round 2 fell back to Chebyshev with a warning there; the
    Spike tridiagonal solve (ops/tridiag.dist_pcr_solve) now handles
    crossing lines exactly: no warning, iteration parity with the
    single-device line smoother."""
    import scipy.sparse as sp
    import lssp_tpu as lt
    n = 512
    S = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    A = CSR.from_scipy(S)
    b = jnp.ones(n, dtype=jnp.float64)
    x, info = dist_solve(A, b, method="cg", pc="saamg", mesh=mesh8,
                         options=SolverOptions(maxit=1000),
                         pc_options=PCOptions(amg_smoother="line"))
    assert bool(info.converged)
    err = capsys.readouterr().err
    assert "line smoother unavailable" not in err
    res = np.linalg.norm(b - S @ np.asarray(x))
    assert res <= 5e-5
    _, i1 = lt.solve(A, b, method="cg",
                     M=lt.pc.setup(A, "saamg",
                                   PCOptions(amg_smoother="line")),
                     options=lt.SolverOptions(maxit=1000), reorder=None)
    assert abs(int(info.nits) - int(i1.nits)) <= 4


def test_dist_line_smoother_misaligned_grid(mesh8, capsys):
    """A 2-D strong-x anisotropic grid whose rows do NOT align with the
    shard cuts (gy % P != 0 forces flat mode; R % gx != 0 cuts lines
    mid-row).  The Spike solve keeps whole-line smoothing across the
    cuts: converges at line-smoother counts, no fallback warning."""
    import lssp_tpu as lt
    A = lt.sparse.anisotropic_poisson_2d(36, epsilon=0.01)   # strong x
    n = A.shape[0]                                           # 1296, R=162
    b = jnp.ones(n, dtype=jnp.float64)
    x, info = dist_solve(A, b, method="cg", pc="saamg", mesh=mesh8,
                         options=SolverOptions(maxit=300),
                         pc_options=PCOptions(amg_smoother="line",
                                              saamg_grid=False))
    assert bool(info.converged)
    assert "line smoother unavailable" not in capsys.readouterr().err
    res = np.linalg.norm(b - A.to_scipy() @ np.asarray(x))
    assert res <= 2e-6
    # the whole point of line smoothing: beat the point smoother on the
    # same flat hierarchy
    _, ic = dist_solve(A, b, method="cg", pc="saamg", mesh=mesh8,
                       options=SolverOptions(maxit=300),
                       pc_options=PCOptions(saamg_grid=False))
    assert int(info.nits) <= int(ic.nits)


class TestDistSolveMulti:
    """Distributed multiple right-hand sides: one shard_map program whose
    body vmaps the iteration over rhs columns (matrix streamed once per
    iteration for all rhs, batched psum dots)."""

    def test_matches_per_rhs_dist_solves(self, mesh8, rng):
        from lssp_tpu.parallel.dist_solve import dist_solve_multi
        A = laplacian_2d(16)
        n = A.shape[0]
        B = jnp.asarray(rng.standard_normal((n, 3)))
        X, info = dist_solve_multi(A, B, method="cg", pc="bjilu", mesh=mesh8)
        assert X.shape == (n, 3)
        assert info.nits.shape == (3,)
        S = A.to_scipy()
        for k in range(3):
            assert bool(info.converged[k])
            xk, ik = dist_solve(A, B[:, k], method="cg", pc="bjilu",
                                mesh=mesh8)
            assert int(info.nits[k]) == int(ik.nits)
            np.testing.assert_allclose(np.asarray(X[:, k]), np.asarray(xk),
                                       rtol=1e-10, atol=1e-12)

    def test_blockcg_multi(self, mesh8, rng):
        """Distributed block CG: one shared search block across rhs, all
        reductions as single stacked psums.  True residuals checked
        independently; fewer iterations than per-rhs dist CG."""
        from lssp_tpu.parallel.dist_solve import dist_solve_multi
        import lssp_tpu as lt
        A = laplacian_2d(32)
        n = A.shape[0]
        B = jnp.asarray(rng.standard_normal((n, 4)))
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=1000)
        X, info = dist_solve_multi(A, B, method="blockcg", pc="bjilu",
                                   mesh=mesh8, options=o)
        S = A.to_scipy()
        res = np.linalg.norm(np.asarray(B) - S @ np.asarray(X), axis=0)
        tol = 1e-8 * np.linalg.norm(np.asarray(B), axis=0)
        assert np.asarray(info.converged).all()
        assert (res <= tol).all(), res / tol
        _, ic = dist_solve_multi(A, B, method="cg", pc="bjilu",
                                 mesh=mesh8, options=o)
        assert int(np.max(np.asarray(info.nits))) < \
            int(np.min(np.asarray(ic.nits)))

    def test_blockgmres_multi(self, mesh8, rng):
        """Distributed block GMRES (nonsymmetric): one shared basis,
        every orthogonalization reduction a single stacked psum, and the
        per-cycle least squares replicated per shard.  Must match the
        single-device block result (same tol, true residuals checked)."""
        from lssp_tpu.parallel.dist_solve import dist_solve_multi
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(24)
        n = A.shape[0]
        B = jnp.asarray(rng.standard_normal((n, 3)))
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=600,
                             restart=25)
        X, info = dist_solve_multi(A, B, method="blockgmres", pc="jacobi",
                                   mesh=mesh8, options=o)
        S = A.to_scipy()
        res = np.linalg.norm(np.asarray(B) - S @ np.asarray(X), axis=0)
        tol = 1e-8 * np.linalg.norm(np.asarray(B), axis=0)
        assert np.asarray(info.converged).all()
        assert (res <= tol).all(), res / tol
        # iteration parity with the single-device block solve: jacobi is
        # the same math in both paths, but the shard program sums each
        # Gram as 8 psum'd partials vs one full-length jnp.sum — last-ulp
        # residual differences can land a column one restart cycle apart,
        # so parity is asserted to ±1 cycle, not bitwise
        _, i1 = lt.solve_multi(A, B, method="blockgmres", pc="jacobi",
                               options=o)
        assert (np.abs(np.asarray(info.nits, np.int64)
                       - np.asarray(i1.nits, np.int64)) <= o.restart).all(), \
            (info.nits, i1.nits)

    def test_general_n_and_amg(self, mesh8):
        from lssp_tpu.parallel.dist_solve import dist_solve_multi
        A = laplacian_2d(15)           # 225 % 8 != 0 -> identity padding
        n = A.shape[0]
        B = jnp.stack([jnp.ones(n), jnp.arange(float(n))], axis=1)
        X, info = dist_solve_multi(A, B, method="cg", pc="amg", mesh=mesh8)
        S = A.to_scipy()
        for k in range(2):
            assert bool(info.converged[k])
            r = np.linalg.norm(np.asarray(B[:, k]) - S @ np.asarray(X[:, k]))
            assert r <= 1e-4 * max(1.0, float(jnp.linalg.norm(B[:, k])))

    def test_saamg_multi(self, mesh8):
        """Multi-rhs with the saamg hierarchy (was unsupported pre-r3):
        per-rhs convergence + column-0 parity with the single-rhs solve."""
        from lssp_tpu.parallel.dist_solve import dist_solve, dist_solve_multi
        import lssp_tpu as lt
        A = laplacian_2d(32)
        n = A.shape[0]
        B = jnp.stack([jnp.ones(n), jnp.arange(float(n)) % 5 + 1], axis=1)
        o = lt.SolverOptions(maxit=100)
        X, info = dist_solve_multi(A, B, method="cg", pc="saamg", mesh=mesh8,
                                   options=o)
        S = A.to_scipy()
        for k in range(2):
            assert bool(info.converged[k])
            r = np.linalg.norm(np.asarray(B[:, k]) - S @ np.asarray(X[:, k]))
            assert r <= 1e-4 * max(1.0, float(jnp.linalg.norm(B[:, k])))
        _, i1 = dist_solve(A, B[:, 0], method="cg", pc="saamg", mesh=mesh8,
                           options=o)
        assert abs(int(info.nits[0]) - int(i1.nits)) <= 1

    def test_transpose_method_multi(self, mesh8):
        """Transpose methods (qmr + shard-local bjilu M⁻ᵀ) in the
        multi-rhs launcher (was unsupported pre-r3)."""
        from lssp_tpu.parallel.dist_solve import dist_solve_multi
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(24)
        n = A.shape[0]
        B = jnp.stack([jnp.ones(n),
                       jnp.cos(jnp.arange(float(n)) * 0.1)], axis=1)
        X, info = dist_solve_multi(
            A, B, method="qmr", pc="bjilu", mesh=mesh8,
            options=lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0,
                                     maxit=500))
        S = A.to_scipy()
        for k in range(2):
            assert bool(info.converged[k])
            r = np.linalg.norm(np.asarray(B[:, k]) - S @ np.asarray(X[:, k]))
            assert r <= 1.1e-8 * float(info.r0norm[k]) + 1e-10


class TestDistIR:
    """Distributed mixed-precision refinement (dist_solve_ir[_multi]):
    fp64 outer residuals through the fp64-partitioned operator, fp32
    inner shard solves — one shard_map program end to end."""

    def test_single_rhs_reaches_fp64(self, mesh8):
        from lssp_tpu.parallel.dist_solve import dist_solve_ir
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(32)
        n = A.shape[0]
        b = jnp.ones(n, dtype=jnp.float64)
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, maxit=2000, restart=30)
        x, info = dist_solve_ir(A, b, method="gmres", pc="bjilu",
                                mesh=mesh8, options=o)
        assert np.asarray(x).dtype == np.float64
        assert bool(info.converged)
        res = float(np.linalg.norm(np.asarray(b)
                                   - A.to_scipy() @ np.asarray(x)))
        assert res <= 1.1e-8 * np.sqrt(n) + 1e-10

    def test_multi_block_inner(self, mesh8, rng):
        from lssp_tpu.parallel.dist_solve import dist_solve_ir_multi
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(24)
        n = A.shape[0]
        B = jnp.asarray(rng.standard_normal((n, 4)))
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, maxit=2000, restart=30)
        X, info = dist_solve_ir_multi(A, B, pc="bjilu", mesh=mesh8,
                                      options=o)   # default blockgmres
        assert np.asarray(info.converged).all()
        res = np.linalg.norm(np.asarray(B) - A.to_scipy() @ np.asarray(X),
                             axis=0)
        assert (res <= 1.1e-8 * np.linalg.norm(np.asarray(B), axis=0)
                + 1e-10).all()

    def test_multi_blockcg_saamg(self, mesh8, rng):
        """SPD block inner under the distributed saamg hierarchy — the
        strongest-PC composition of the fp32 shard program."""
        from lssp_tpu.parallel.dist_solve import dist_solve_ir_multi
        import lssp_tpu as lt
        A = laplacian_2d(32)
        B = jnp.asarray(rng.standard_normal((A.shape[0], 3)))
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, maxit=2000)
        X, info = dist_solve_ir_multi(A, B, method="blockcg", pc="saamg",
                                      mesh=mesh8, options=o)
        assert np.asarray(info.converged).all()
        res = np.linalg.norm(np.asarray(B) - A.to_scipy() @ np.asarray(X),
                             axis=0)
        assert (res <= 1.1e-8 * np.linalg.norm(np.asarray(B), axis=0)
                + 1e-10).all()
        assert int(np.asarray(info.nits).max()) <= 20

    def test_pipecg_and_cagmres_inner(self, mesh8):
        """Communication-avoiding inners inside the distributed
        refinement: pipecg (ONE psum per inner iteration) and cagmres
        (mapped to cargmres by _inner_plan) compose with the fp32 shard
        program — the two multi-chip latency stories end to end."""
        from lssp_tpu.parallel.dist_solve import dist_solve_ir
        import lssp_tpu as lt
        for method, A in (("pipecg", laplacian_2d(32)),
                          ("cagmres", lt.sparse.convection_diffusion_2d(24))):
            n = A.shape[0]
            b = jnp.ones(n, dtype=jnp.float64)
            o = lt.SolverOptions(rtol=1e-8, atol=0.0, maxit=2000, restart=25)
            x, info = dist_solve_ir(A, b, method=method, pc="bjilu",
                                    mesh=mesh8, options=o)
            assert bool(info.converged), method
            res = float(np.linalg.norm(np.asarray(b)
                                       - A.to_scipy() @ np.asarray(x)))
            assert res <= 1.1e-8 * np.sqrt(n) + 1e-10, (method, res)

    def test_general_n_padding(self, mesh8):
        from lssp_tpu.parallel.dist_solve import dist_solve_ir
        import lssp_tpu as lt
        A = laplacian_2d(15)                 # 225 % 8 != 0
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, maxit=2000)
        x, info = dist_solve_ir(A, b, method="cg", pc="jacobi",
                                mesh=mesh8, options=o)
        assert bool(info.converged)
        res = float(np.linalg.norm(np.asarray(b)
                                   - A.to_scipy() @ np.asarray(x)))
        assert res <= 1.1e-8 * np.sqrt(A.shape[0]) + 1e-10

    def test_single_rejects_block_method(self, mesh8):
        from lssp_tpu.parallel.dist_solve import dist_solve_ir
        import lssp_tpu as lt
        A = laplacian_2d(8)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        with pytest.raises(ValueError, match="dist_solve_ir_multi"):
            dist_solve_ir(A, b, method="blockgmres", mesh=mesh8)


class TestDistPrepareMemo:
    """The rhs-independent half of a distributed solve (padding, PC build,
    partitioning, compiled shard program) is memoized per container with a
    content fingerprint — production re-solves with a new rhs must not
    repartition, refactor, or retrace."""

    def test_resolve_hits_memo_and_mutation_invalidates(self, mesh8):
        import lssp_tpu as lt
        from lssp_tpu.parallel import dist_solve as ds
        calls = {"n": 0}
        orig = ds._build_dist_program

        def counting(*a, **k):
            calls["n"] += 1
            return orig(*a, **k)

        ds._build_dist_program = counting
        try:
            A = lt.sparse.laplacian_2d(24)
            b = jnp.ones(A.shape[0], dtype=jnp.float64)
            x1, _ = ds.dist_solve(A, b, method="cg", pc="bjilu", mesh=mesh8)
            x2, i2 = ds.dist_solve(A, 2.0 * b, method="cg", pc="bjilu",
                                   mesh=mesh8)
            assert calls["n"] == 1, "re-solve rebuilt the dist program"
            r = np.linalg.norm(2 * np.asarray(b)
                               - A.to_scipy() @ np.asarray(x2))
            assert bool(i2.converged) and r <= 1e-5
            np.testing.assert_allclose(np.asarray(x2), 2 * np.asarray(x1),
                                       rtol=1e-6)
            # different options -> different key -> rebuild
            ds.dist_solve(A, b, method="cg", pc="bjilu", mesh=mesh8,
                          options=SolverOptions(rtol=1e-10))
            assert calls["n"] == 2
            # content mutation -> fingerprint invalidates
            A.data[0] = A.data[0] + 0.125
            ds.dist_solve(A, b, method="cg", pc="bjilu", mesh=mesh8)
            assert calls["n"] == 3
        finally:
            ds._build_dist_program = orig

    def test_short_rhs_raises(self, mesh8):
        # a short rhs must raise — the launcher's identity padding is for
        # its OWN growth only; zero-filling user equations would silently
        # return a wrong answer (568 % 8 == 0, so only the length check
        # can catch it)
        import lssp_tpu as lt
        from lssp_tpu.parallel import dist_solve as ds
        A = lt.sparse.laplacian_2d(24)           # n = 576
        with pytest.raises(ValueError, match="576"):
            ds.dist_solve(A, jnp.ones(568, dtype=jnp.float64), mesh=mesh8)
        with pytest.raises(ValueError, match="576"):
            ds.dist_solve_multi(A, jnp.ones((568, 2), dtype=jnp.float64),
                                mesh=mesh8)

    def test_program_cache_lru_and_sizing_survival(self, mesh8):
        """The program cache is LRU-bounded at 8; a hot entry must survive
        churn from 8+ other keys IF re-touched (LRU, not FIFO), and the
        saamg sizing plan lives in its own unbounded cache so eviction
        never re-runs the detect_grid host scan."""
        import lssp_tpu as lt
        from lssp_tpu.parallel import dist_solve as ds
        from lssp_tpu.amg import sa as sa_mod
        A = lt.sparse.laplacian_2d(24)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        ds.dist_solve(A, b, method="cg", pc="saamg", mesh=mesh8)
        scans = {"n": 0}
        orig_dg = sa_mod.detect_grid

        def counting_dg(*a, **k):
            scans["n"] += 1
            return orig_dg(*a, **k)

        sa_mod.detect_grid = counting_dg
        try:
            # churn 8 distinct program keys; re-touch saamg between them
            for i, rt in enumerate([1e-6, 1e-7, 1e-9, 1e-10]):
                for m in ("cg", "bicgstab"):
                    ds.dist_solve(A, b, method=m, pc="jacobi", mesh=mesh8,
                                  options=SolverOptions(rtol=rt))
                ds.dist_solve(A, b, method="cg", pc="saamg", mesh=mesh8)
            assert scans["n"] == 0, "sizing plan was evicted/re-scanned"
            assert len(A._dist_cache) <= 8
            # the re-touched saamg program survived the churn (LRU)
            key_pcs = [k[4] for k in A._dist_cache]
            assert "saamg" in key_pcs
        finally:
            sa_mod.detect_grid = orig_dg


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("batched", [False, True], ids=["vec", "vmap"])
def test_dist_dia_op_four_devices(dtype, batched):
    """The per-shard DIA op (the shared static-slice product on
    [halo_lo ‖ x ‖ halo_hi]) on a 4-device mesh against scipy, alone and
    vmapped over right-hand sides (the dist_solve_multi body)."""
    from jax.sharding import PartitionSpec as P
    from lssp_tpu.parallel.partition import partition_csr_dia
    import lssp_tpu as lt
    A = lt.sparse.convection_diffusion_2d(24, beta=10.0)
    A = CSR.from_scipy(A.to_scipy().astype(dtype).tocsr())
    n = A.shape[0]
    M = partition_csr_dia(A, 4)
    op = make_dist_spmv(M, "shards")
    per = (jax.vmap(op, in_axes=(None, 0)) if batched else op)
    f = jax.shard_map(lambda d, v: per(d[0], v[0])[None], mesh=make_mesh(4),
                      in_specs=(P("shards"), P("shards")),
                      out_specs=P("shards"), check_vma=False)
    rng = np.random.default_rng(11)
    k = 3 if batched else 1
    X = rng.standard_normal((k, n)).astype(dtype)
    xs = X.reshape(k, 4, -1).transpose(1, 0, 2)          # (shard, k, R)
    if not batched:
        xs = xs[:, 0]
    y = np.asarray(f(jnp.asarray(M.data), jnp.asarray(xs)), np.float64)
    Y = (y.transpose(1, 0, 2).reshape(k, n) if batched
         else y.reshape(1, n))
    S = A.to_scipy().astype(np.float64)
    tol = 2e-6 if dtype == np.float32 else 1e-13
    for j in range(k):
        ref = S @ X[j].astype(np.float64)
        np.testing.assert_allclose(Y[j], ref, rtol=tol,
                                   atol=tol * np.abs(ref).max())
