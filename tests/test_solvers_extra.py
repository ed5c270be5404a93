"""Tests for the capability-parity Krylov methods drawn from the reference's
external-package solver tables (SURVEY §2.5: LASPACK solver-laspack.cxx:29-34
exposes QMR/CGN/BiCG; PETSc solver-petsc.cxx:23-32 exposes MINRES/LSQR/
FGMRES/BiCG), plus the transpose machinery (spmv_t, ILU M⁻ᵀ apply) they
rely on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lssp_tpu import solve, SolverOptions, PCOptions
from lssp_tpu.sparse import laplacian_2d, convection_diffusion_2d
from lssp_tpu.sparse.types import CSR
from lssp_tpu.ops.spmv import spmv, spmv_t


def _solve_and_check(A, b, method, pc, maxit=3000, restart=60,
                     pc_options=None):
    opts = SolverOptions(maxit=maxit, restart=restart)
    x, info = solve(A, b, method=method, pc=pc, options=opts,
                    pc_options=pc_options)
    true_res = float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x)))
    tol = max(1e-7 * float(jnp.linalg.norm(b)), 1e-7)
    assert bool(info.converged), f"{method}+{pc} did not converge"
    assert true_res <= 4 * tol, f"{method}+{pc}: true residual {true_res}"
    return int(info.nits)


# ---- SPD problem: the symmetric methods ------------------------------------

class TestSymmetric:
    A = laplacian_2d(32)
    b = jnp.ones(A.shape[0], dtype=jnp.float64)

    @pytest.mark.parametrize("pc", ["none", "jacobi", "iluk"])
    def test_minres(self, pc):
        _solve_and_check(self.A, self.b, "minres", pc)

    def test_minres_matches_cg_iterations(self):
        """On an SPD system MINRES and CG converge in a comparable number of
        iterations (same Krylov space)."""
        n_minres = _solve_and_check(self.A, self.b, "minres", "none")
        n_cg = _solve_and_check(self.A, self.b, "cg", "none")
        assert abs(n_minres - n_cg) <= max(5, int(0.2 * n_cg))

    def test_minres_indefinite(self):
        """MINRES handles symmetric *indefinite* systems (CG cannot)."""
        A = self.A.to_scipy() - 3.0 * __import__("scipy.sparse", fromlist=["eye"]).eye(
            self.A.shape[0], format="csr")
        A = CSR.from_scipy(A.tocsr())
        x, info = solve(A, self.b, method="minres", pc="none",
                        options=SolverOptions(maxit=5000))
        res = float(np.linalg.norm(np.asarray(self.b) - A.to_scipy() @ np.asarray(x)))
        assert bool(info.converged) and res < 1e-5

    @pytest.mark.parametrize("method", ["cgnr", "lsqr"])
    def test_normal_equation_methods(self, method):
        _solve_and_check(self.A, self.b, method, "none")

    @pytest.mark.parametrize("method", ["cgnr", "lsqr"])
    def test_normal_equation_right_pc(self, method):
        # right-preconditioned via M⁻ᵀ; ILU makes the normal equations
        # dramatically better conditioned
        n_pc = _solve_and_check(self.A, self.b, method, "iluk")
        n_raw = _solve_and_check(self.A, self.b, method, "none")
        assert n_pc < n_raw


# ---- nonsymmetric problem: the two-sided methods ----------------------------

class TestNonsymmetric:
    A = convection_diffusion_2d(24, beta=10.0)
    b = jnp.ones(A.shape[0], dtype=jnp.float64)

    @pytest.mark.parametrize("method", ["bicg", "qmr"])
    @pytest.mark.parametrize("pc", ["none", "iluk", "ilut"])
    def test_two_sided(self, method, pc):
        _solve_and_check(self.A, self.b, method, pc)

    @pytest.mark.parametrize("pc", ["iluk", "jacobi"])
    def test_fgmres(self, pc):
        _solve_and_check(self.A, self.b, "fgmres", pc, restart=30)

    def test_fgmres_matches_rgmres(self):
        """With a *fixed* PC, FGMRES and right-GMRES build the same Krylov
        space — iteration counts should agree closely."""
        nf = _solve_and_check(self.A, self.b, "fgmres", "iluk", restart=30)
        nr = _solve_and_check(self.A, self.b, "rgmres", "iluk", restart=30)
        assert abs(nf - nr) <= 3

    def test_lu_pc_transpose_methods(self):
        """Regression: transpose methods with pc="lu" must use the real
        M^-T (an exact right PC converges LSQR/CGNR in ~1 iteration)."""
        for m in ("lsqr", "cgnr", "bicg", "qmr"):
            x, info = solve(self.A, self.b, method=m, pc="lu")
            assert int(info.nits) <= 3, m
            res = float(np.linalg.norm(
                np.asarray(self.b) - self.A.to_scipy() @ np.asarray(x)))
            assert res < 1e-6, m

    def test_lifecycle_transpose_injection(self):
        """Regression: the Solver lifecycle must auto-build M^-T for
        transpose methods like solve() does."""
        from lssp_tpu.solvers.facade import Solver
        s = Solver(method="bicg", pc="iluk",
                   pc_options=PCOptions(ilu_sweeps=0)).assemble(self.A, self.b)
        s.solve()
        assert bool(s.info.converged)

    def test_unsupported_transpose_pc_raises(self):
        with pytest.raises(ValueError, match="no transpose apply"):
            solve(self.A, self.b, method="bicg", pc="amg")

    def test_warm_start(self):
        opts = SolverOptions(maxit=3000)
        x1, _ = solve(self.A, self.b, method="bicg", pc="iluk", options=opts)
        x2, info = solve(self.A, self.b, x0=x1, method="bicg", pc="iluk",
                         options=opts)
        assert int(info.nits) <= 2


# ---- transpose machinery -----------------------------------------------------

class TestTranspose:
    def test_spmv_t_all_formats(self, rng):
        from lssp_tpu.sparse.convert import csr_to_ell, csr_to_dia
        from lssp_tpu.sparse.generators import random_sparse
        A = random_sparse(96, nnz_per_row=6, seed=3)
        x = rng.standard_normal(96)
        want = A.to_scipy().T @ x
        np.testing.assert_allclose(np.asarray(spmv_t(A, x)), want, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(spmv_t(csr_to_ell(A), x)), want,
                                   rtol=1e-12)
        dia = csr_to_dia(laplacian_2d(10))
        xs = rng.standard_normal(100)
        np.testing.assert_allclose(np.asarray(spmv_t(dia, xs)),
                                   laplacian_2d(10).to_scipy().T @ xs,
                                   rtol=1e-12)

    def test_spmv_t_bsr(self, rng):
        import scipy.sparse as sp
        from lssp_tpu.sparse.types import BSR
        m = sp.random(24, 24, density=0.2, random_state=7,
                      format="csr").tobsr(blocksize=(4, 4))
        A = BSR.from_scipy(m)
        x = rng.standard_normal(24)
        np.testing.assert_allclose(np.asarray(spmv_t(A, x)), m.T @ x,
                                   rtol=1e-12)

    def test_ilu_transpose_apply_exact(self):
        """M.t(r) must equal the dense solve of (LU)ᵀ z = r."""
        from lssp_tpu import pc as pc_mod
        from lssp_tpu.pc.ilu_host import iluk_factor
        A = convection_diffusion_2d(12, beta=8.0)
        L, U = iluk_factor(A, level=1)
        M = pc_mod.setup(A, "iluk", PCOptions(iluk_level=1, transpose=True))
        r = np.linspace(1.0, 2.0, A.shape[0])
        z = np.asarray(M.t(jnp.asarray(r)))
        LU = (L.todense() + np.eye(A.shape[0])) @ U.todense()
        want = np.linalg.solve(LU.T, r)
        np.testing.assert_allclose(z, want, rtol=1e-10, atol=1e-12)

    def test_neumann_transpose_apply(self):
        """The sweep-based M⁻ᵀ converges to the exact transpose solve."""
        from lssp_tpu.pc.ilu import make_ilu_pc
        from lssp_tpu.pc.ilu_host import iluk_factor
        A = laplacian_2d(12)
        L, U = iluk_factor(A, level=0)
        M = make_ilu_pc(L, U, "ilu0", sweeps=40)
        r = np.linspace(1.0, 2.0, A.shape[0])
        z = np.asarray(M.t(jnp.asarray(r)))
        LU = (L.todense() + np.eye(A.shape[0])) @ U.todense()
        want = np.linalg.solve(LU.T, r)
        np.testing.assert_allclose(z, want, rtol=1e-6, atol=1e-8)

    def test_transpose_requires_flag_for_exact_ilu(self):
        from lssp_tpu import pc as pc_mod
        A = laplacian_2d(8)
        M = pc_mod.setup(A, "iluk", PCOptions(iluk_level=1))
        with pytest.raises(ValueError, match="transpose"):
            M.t(jnp.ones(64))


class TestHostTraceFallback:
    """Backends without host callbacks (some PJRT plugins) cannot run
    jax.debug.print; verbosity>=1 must fall back to a host-printed trace
    instead of crashing."""

    def test_verbose_solve_prints_host_trace(self, capsys, monkeypatch):
        import importlib
        ulog = importlib.import_module("lssp_tpu.utils.log")
        monkeypatch.setattr(ulog, "_device_print_ok", False)
        A = laplacian_2d(12)
        b = np.ones(A.shape[0])
        x, info = solve(A, b, method="cg", pc="jacobi",
                        options=SolverOptions(verbosity=1, maxit=40))
        out = capsys.readouterr().out
        lines = [l for l in out.splitlines() if l.startswith("itr:")]
        assert len(lines) == int(info.nits)
        # reference line format: abs res / rel res / res-over-||b||
        assert "abs res:" in lines[0] and "rbn:" in lines[0]
        last = float(lines[-1].split("abs res:")[1].split(",")[0])
        assert last == pytest.approx(float(info.residual), rel=1e-5)

    def test_verbose_lifecycle_solver(self, capsys, monkeypatch):
        import importlib
        ulog = importlib.import_module("lssp_tpu.utils.log")
        from lssp_tpu.solvers.facade import Solver
        monkeypatch.setattr(ulog, "_device_print_ok", False)
        A = laplacian_2d(12)
        b = np.ones(A.shape[0])
        s = Solver("bicgstab", pc="ilu0",
                   options=SolverOptions(verbosity=1, maxit=40))
        s.assemble(A)
        s.solve(b)
        lines = [l for l in capsys.readouterr().out.splitlines()
                 if l.startswith("itr:")]
        assert len(lines) >= 1

    def test_probe_memoized(self, monkeypatch):
        import importlib
        ulog = importlib.import_module("lssp_tpu.utils.log")
        monkeypatch.setattr(ulog, "_device_print_ok", None)
        first = ulog.device_print_supported()
        assert first is True          # CPU backend supports callbacks
        assert ulog._device_print_ok is True

    def test_probe_under_trace(self, monkeypatch):
        # first touch of device_print_supported() often happens while
        # TRACING a solver; the probe must evaluate eagerly there (not
        # stage its own callback into the caller's program) and cache the
        # correct verdict
        import importlib
        ulog = importlib.import_module("lssp_tpu.utils.log")
        monkeypatch.setattr(ulog, "_device_print_ok", None)

        @jax.jit
        def traced(x):
            assert ulog.device_print_supported() is True
            return x + 1.0

        assert float(traced(jnp.float32(1.0))) == 2.0
        assert ulog._device_print_ok is True


class TestReviewRegressions:
    """Fixes from the 347809d..HEAD review pass."""

    def test_minres_breakdown_terminates(self):
        # indefinite matrix + jacobi (negative diagonal entries) makes the
        # preconditioned Lanczos norm vanish at entry; the restart loop
        # must exit instead of spinning forever
        import scipy.sparse as sp
        A0 = laplacian_2d(8)
        S = (sp.csr_matrix((np.asarray(A0.data), np.asarray(A0.indices),
                            np.asarray(A0.indptr)), shape=A0.shape)
             - 5.0 * sp.eye(A0.shape[0])).tocsr()
        A = CSR(data=S.data, indices=S.indices, indptr=S.indptr,
                shape=S.shape)
        b = np.ones(A.shape[0])
        x, info = solve(A, b, method="minres", pc="jacobi",
                        options=SolverOptions(maxit=50))
        assert not bool(info.converged)

    def test_minres_unpreconditioned_unaffected(self):
        A = laplacian_2d(16)
        b = np.ones(A.shape[0])
        x, info = solve(A, b, method="minres")
        assert bool(info.converged)

    def test_callable_preconditioner(self):
        A = laplacian_2d(16)
        b = np.ones(A.shape[0])
        dj = jnp.full(A.shape[0], 0.25)
        x, info = solve(A, b, method="cg", M=lambda r: dj * r)
        assert bool(info.converged)
        from lssp_tpu.sparse.convert import to_device_format
        from lssp_tpu.ops.spmv import spmv
        Adev = to_device_format(A)
        x2, info2 = solve(lambda v: spmv(Adev, v), b, method="cg",
                          M=lambda r: dj * r)
        assert bool(info2.converged)
        np.testing.assert_allclose(np.asarray(x), np.asarray(x2), atol=1e-10)

    def test_bsr_inplace_mutation_invalidates_cache(self):
        from lssp_tpu.sparse.convert import csr_to_bsr
        import scipy.sparse as sp
        A = laplacian_2d(16)
        B = csr_to_bsr(A, 2)
        b = np.ones(A.shape[0])
        solve(B, b, method="cg")
        np.asarray(B.blocks).__imul__(2.0)
        x2, _ = solve(B, b, method="cg")
        S2 = sp.csr_matrix((np.asarray(A.data) * 2.0, np.asarray(A.indices),
                            np.asarray(A.indptr)), shape=A.shape)
        assert np.linalg.norm(b - S2 @ np.asarray(x2)) < 1e-4

    def test_saamg_postsmooth_only(self):
        # amg_presmooth=0, amg_postsmooth=2 must still smooth (degree was
        # taken from presmooth alone, giving an unsmoothed V-cycle)
        A = laplacian_2d(32)
        b = np.ones(A.shape[0])
        x, info = solve(A, b, method="cg", pc="saamg",
                        options=SolverOptions(maxit=100),
                        pc_options=PCOptions(amg_presmooth=0,
                                             amg_postsmooth=2))
        assert bool(info.converged)
        assert int(info.nits) < 40

    def test_minres_scaled_spd_recovers(self):
        # beta1 below the inner tolerance at entry is NOT breakdown: the
        # restart loop must tighten inner_tol and converge (the first
        # stall guard conflated the two and gave up instantly)
        import scipy.sparse as sp
        S = sp.diags(np.full(64, 1e18)).tocsr()
        A = CSR(data=S.data, indices=S.indices, indptr=S.indptr,
                shape=S.shape)
        b = np.ones(64)
        x, info = solve(A, b, method="minres", pc="jacobi", reorder=None)
        assert bool(info.converged)
        assert np.linalg.norm(b - S @ np.asarray(x)) < 1e-6

    def test_smoother_degree_mapping(self):
        from lssp_tpu.config import smoother_degree
        assert smoother_degree(0, 0) == 0      # explicit off stays off
        assert smoother_degree(1, 1) == 1      # defaults unchanged
        assert smoother_degree(0, 2) == 1      # total work preserved
        assert smoother_degree(1, 3) == 2
        assert smoother_degree(2, 2) == 2

    def test_callable_m_with_solver_lifecycle(self):
        from lssp_tpu.solvers.facade import Solver
        A = laplacian_2d(16)
        b = np.ones(A.shape[0])
        dj = jnp.full(A.shape[0], 0.25)
        s = Solver("cg")
        s.assemble(A)
        s.M = lambda r: dj * r
        x = s.solve(b)
        assert s.residual < 1e-5


class TestBareCallablePCTranspose:
    """A bare-callable M without a transpose apply must be rejected by the
    transpose-based methods (round-1 advisor: silently reusing the forward
    apply corrupts the two-sided recurrences for nonsymmetric M)."""

    def test_bicg_bare_callable_raises(self):
        import pytest
        import jax.numpy as jnp
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(8, beta=5.0)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        with pytest.raises(TypeError, match="transpose"):
            lt.solve(A, b, method="bicg", M=lambda r: r)

    def test_bicg_callable_with_t_works(self):
        import numpy as np
        import jax.numpy as jnp
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(8, beta=5.0)
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        M = lambda r: 0.5 * r
        M.t = M                      # declare symmetric
        x, info = lt.solve(A, b, method="bicg", M=M)
        assert bool(info.converged)
        res = np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x))
        assert res < 1e-5


def test_solver_set_log(tmp_path):
    """Reference lssp_solver_set_log parity: solver output tees to a file."""
    import io
    import jax.numpy as jnp
    import lssp_tpu as lt
    from lssp_tpu.utils.log import set_log

    buf = io.StringIO()
    A = lt.sparse.laplacian_2d(8)
    b = jnp.ones(A.shape[0], dtype=jnp.float64)
    s = lt.Solver(method="cg", pc="jacobi",
                  options=lt.SolverOptions(verbosity=2))
    s.set_log(buf)
    try:
        s.assemble(A, b)
        s.solve()
    finally:
        set_log(None)
    out = buf.getvalue()
    assert "assemble" in out       # the phase timers reached the log file


class TestSolveMulti:
    """Multiple right-hand sides as one vmapped device program (production
    serving: the batched SpMV reads the matrix once per iteration for all
    rhs)."""

    def test_matches_per_rhs_solves(self):
        import numpy as np
        import jax.numpy as jnp
        import lssp_tpu as lt
        A = lt.sparse.laplacian_2d(24)
        n = A.shape[0]
        rng = np.random.default_rng(0)
        B = jnp.asarray(rng.standard_normal((n, 4)))
        X, info = lt.solve_multi(A, B, method="cg", pc="iluk")
        assert X.shape == (n, 4)
        assert info.nits.shape == (4,)
        S = A.to_scipy()
        for k in range(4):
            assert bool(info.converged[k])
            r = np.linalg.norm(np.asarray(B[:, k]) - S @ np.asarray(X[:, k]))
            assert r <= 2e-5
            xk, ik = lt.solve(A, B[:, k], method="cg", pc="iluk")
            assert int(info.nits[k]) == int(ik.nits)
            np.testing.assert_allclose(np.asarray(X[:, k]), np.asarray(xk),
                                       rtol=1e-10, atol=1e-12)

    def test_nonsymmetric_gmres_multi(self):
        import numpy as np
        import jax.numpy as jnp
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(16, beta=10.0)
        n = A.shape[0]
        B = jnp.stack([jnp.ones(n), jnp.arange(float(n))], axis=1)
        X, info = lt.solve_multi(A, B, method="gmres", pc="ilut")
        S = A.to_scipy()
        for k in range(2):
            assert bool(info.converged[k])
            r = np.linalg.norm(np.asarray(B[:, k]) - S @ np.asarray(X[:, k]))
            assert r <= 1e-4 * max(1.0, float(jnp.linalg.norm(B[:, k])))

    def test_bad_shape_raises(self):
        import pytest
        import jax.numpy as jnp
        import lssp_tpu as lt
        A = lt.sparse.laplacian_2d(8)
        with pytest.raises(ValueError, match="n, k"):
            lt.solve_multi(A, jnp.ones(64))


class TestBlockCG:
    """Block Conjugate Gradient (solvers/block_cg.py): one shared Krylov
    search block for all rhs — fewer iterations than k independent CGs
    (information mixes across rhs), one k×k Gram reduction per step, and
    an exit criterion pinned to the RECOMPUTED residual."""

    def _setup(self, k=5, n_side=48):
        import numpy as np
        import jax.numpy as jnp
        import lssp_tpu as lt
        A = lt.sparse.laplacian_2d(n_side)
        rng = np.random.default_rng(1)
        B = jnp.asarray(rng.standard_normal((A.shape[0], k)))
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
        return lt, A, B, o

    def test_true_residual_meets_tolerance(self):
        import numpy as np
        lt, A, B, o = self._setup()
        X, info = lt.solve_multi(A, B, method="blockcg", pc="iluk",
                                 options=o)
        S = A.to_scipy()
        res = np.linalg.norm(np.asarray(B) - S @ np.asarray(X), axis=0)
        tol = 1e-8 * np.linalg.norm(np.asarray(B), axis=0)
        assert np.asarray(info.converged).all()
        # the exit criterion recomputes the residual, so the INDEPENDENT
        # residual must meet the tolerance (not just the recursive one)
        assert (res <= tol).all(), res / tol

    def test_fewer_iterations_than_independent_cg(self):
        import numpy as np
        lt, A, B, o = self._setup()
        _, ib = lt.solve_multi(A, B, method="blockcg", pc="iluk", options=o)
        _, ic = lt.solve_multi(A, B, method="cg", pc="iluk", options=o)
        assert int(np.max(np.asarray(ib.nits))) < \
            int(np.min(np.asarray(ic.nits))), (ib.nits, ic.nits)

    def test_duplicate_rhs_converge_in_lockstep(self):
        """Identical columns make the residual block exactly rank-
        deficient from step 0 — the Gram ridge must keep the solve
        well-defined (duplicates converge together, not break down)."""
        import numpy as np
        import jax.numpy as jnp
        lt, A, B, o = self._setup()
        B2 = jnp.tile(B[:, :1], (1, 3))
        X, info = lt.solve_multi(A, B2, method="blockcg", pc="iluk",
                                 options=o)
        assert np.asarray(info.converged).all()
        S = A.to_scipy()
        res = np.linalg.norm(np.asarray(B2) - S @ np.asarray(X), axis=0)
        assert (res <= 1e-8 * np.linalg.norm(np.asarray(B2), axis=0)).all()
        np.testing.assert_allclose(np.asarray(X[:, 0]), np.asarray(X[:, 2]),
                                   rtol=1e-10, atol=1e-12)

    def test_saamg_preconditioned(self):
        import numpy as np
        lt, A, B, o = self._setup()
        X, info = lt.solve_multi(A, B, method="blockcg", pc="saamg",
                                 options=o)
        assert np.asarray(info.converged).all()
        assert int(np.max(np.asarray(info.nits))) <= 15


class TestBlockGMRES:
    """Restarted block GMRES (solvers/block_gmres.py): the nonsymmetric
    block-Krylov path — one shared basis for all rhs, CholQR²+CGS2
    orthogonalization (stacked mul+sum Grams), per-cycle block least
    squares, exit on the RECOMPUTED per-column residual."""

    def _setup(self, k=4, n_side=48, restart=30):
        import numpy as np
        import jax.numpy as jnp
        import lssp_tpu as lt
        A = lt.sparse.convection_diffusion_2d(n_side)   # nonsymmetric
        rng = np.random.default_rng(0)
        B = jnp.asarray(rng.standard_normal((A.shape[0], k)))
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000,
                             restart=restart)
        return lt, A, B, o

    def test_true_residual_meets_tolerance(self):
        import numpy as np
        lt, A, B, o = self._setup()
        X, info = lt.solve_multi(A, B, method="blockgmres", pc="iluk",
                                 options=o)
        S = A.to_scipy()
        res = np.linalg.norm(np.asarray(B) - S @ np.asarray(X), axis=0)
        tol = 1e-8 * np.linalg.norm(np.asarray(B), axis=0)
        assert np.asarray(info.converged).all()
        assert (res <= tol).all(), res / tol

    def test_no_worse_than_slowest_independent_gmres(self):
        """The shared block subspace contains every column's own Krylov
        directions, so (at restart granularity) the block converges no
        later than the slowest independent GMRES run."""
        import numpy as np
        lt, A, B, o = self._setup()
        _, ib = lt.solve_multi(A, B, method="blockgmres", pc="none",
                               options=o)
        _, ig = lt.solve_multi(A, B, method="gmres", pc="none", options=o)
        assert np.asarray(ib.converged).all()
        m = o.restart
        worst_indep = int(np.max(np.asarray(ig.nits)))
        # round the per-rhs count up to cycle granularity for a fair bound
        worst_cycles = -(-worst_indep // m) * m
        assert int(np.max(np.asarray(ib.nits))) <= worst_cycles, \
            (ib.nits, ig.nits)

    def test_duplicate_rhs_converge_in_lockstep(self):
        """Duplicate columns make the block rank-deficient from step 0 —
        the CholQR ridge must keep the recurrence well-defined."""
        import numpy as np
        import jax.numpy as jnp
        lt, A, B, o = self._setup()
        B2 = jnp.stack([B[:, 0], B[:, 0], B[:, 1]], axis=1)
        X, info = lt.solve_multi(A, B2, method="blockgmres", pc="iluk",
                                 options=o)
        assert np.asarray(info.converged).all()
        S = A.to_scipy()
        res = np.linalg.norm(np.asarray(B2) - S @ np.asarray(X), axis=0)
        assert (res <= 1e-8 * np.linalg.norm(np.asarray(B2), axis=0)).all()

    def test_restart_cap_and_honest_unconverged(self):
        """maxit below one restart shrinks the cycle; an impossible
        tolerance exits honestly with converged=False."""
        import numpy as np
        import dataclasses
        lt, A, B, o = self._setup()
        o2 = dataclasses.replace(o, maxit=8, rtol=1e-14)
        X, info = lt.solve_multi(A, B, method="blockgmres", pc="none",
                                 options=o2)
        assert not np.asarray(info.converged).any()
        assert np.asarray(info.nits).max() <= 8
        assert np.isfinite(np.asarray(X)).all()

    def test_spd_matches_blockcg_quality(self):
        """On an SPD system both block methods must reach the tolerance
        (blockgmres is the general-matrix fallback of blockcg)."""
        import numpy as np
        import jax.numpy as jnp
        import lssp_tpu as lt
        A = lt.sparse.laplacian_2d(32)
        rng = np.random.default_rng(3)
        B = jnp.asarray(rng.standard_normal((A.shape[0], 3)))
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000,
                             restart=30)
        X, info = lt.solve_multi(A, B, method="blockgmres", pc="saamg",
                                 options=o)
        assert np.asarray(info.converged).all()
        S = A.to_scipy()
        res = np.linalg.norm(np.asarray(B) - S @ np.asarray(X), axis=0)
        assert (res <= 1e-8 * np.linalg.norm(np.asarray(B), axis=0)).all()

    def test_history_and_jit_cache(self):
        """Round-3 review fixes: (a) record_history on the block path
        returns a per-column (k, maxit+1) trace ending at the reported
        residual; (b) repeated solve_multi block calls reuse ONE compiled
        executable (the inline jax.jit retrace bug)."""
        import numpy as np
        import dataclasses
        from lssp_tpu.solvers.facade import _jitted
        import jax.numpy as jnp
        lt, A, B, o = self._setup(k=3)
        o2 = dataclasses.replace(o, record_history=True)
        for method, Ah in (("blockgmres", A),
                           ("blockcg", lt.sparse.laplacian_2d(32))):
            rng = np.random.default_rng(1)
            Bh = jnp.asarray(rng.standard_normal((Ah.shape[0], 3)))
            X, info = lt.solve_multi(Ah, Bh, method=method, pc="iluk",
                                     options=o2)
            h = np.asarray(info.history)
            assert h.shape == (3, o.maxit + 1)
            assert np.allclose(h[:, 0], np.asarray(info.r0norm))
            for c in range(3):
                col = h[c][np.isfinite(h[c])]
                assert col[-1] <= 1e-8 * float(info.bnorm[c]) * 1.01 \
                    or np.isclose(col[-1], float(info.residual[c]),
                                  rtol=1e-3)
        # the block path dispatches through the same cached jit as the
        # scalar path (_dispatch_solve → _jitted keyed on the solver fn):
        # repeated serving calls must not retrace the block while_loop
        before = _jitted.cache_info().misses
        lt.solve_multi(A, B, method="blockgmres", pc="iluk", options=o)
        lt.solve_multi(A, B, method="blockgmres", pc="iluk", options=o)
        after = _jitted.cache_info()
        assert after.misses - before <= 1 and after.hits >= 1

    def test_step_granular_nits(self):
        """nits resolve at block-Arnoldi STEP granularity via the full-QR
        prefix residual estimates: in a single-cycle solve the block count
        per column is no worse than that column's own GMRES count (the
        block prefix space contains each column's Krylov space) and not
        just a multiple of the restart length."""
        import numpy as np
        lt, A, B, o = self._setup(k=3, restart=300)   # converge in 1 cycle
        # pc="none": the subspace-containment claim needs the SAME Krylov
        # operator on both sides (registry gmres is left-preconditioned,
        # blockgmres right — containment does not hold across PC sides)
        _, ib = lt.solve_multi(A, B, method="blockgmres", pc="none",
                               options=o)
        _, ig = lt.solve_multi(A, B, method="gmres", pc="none", options=o)
        nb, ng = np.asarray(ib.nits), np.asarray(ig.nits)
        assert np.asarray(ib.converged).all()
        assert (nb <= ng).all(), (nb, ng)
        assert (nb < 300).all() and (nb >= 1).all(), nb


class TestSolverLifecycleMulti:
    """Solver.solve_multi: multi-rhs solves on the ASSEMBLED lifecycle
    state (matrix conversion + PC factorization reused across calls)."""

    def test_matches_module_level(self):
        import numpy as np
        import jax.numpy as jnp
        import lssp_tpu as lt
        from lssp_tpu.solvers.facade import Solver
        A = lt.sparse.laplacian_2d(32)
        rng = np.random.default_rng(2)
        B = jnp.asarray(rng.standard_normal((A.shape[0], 3)))
        o = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
        s = Solver(method="cg", pc="iluk", options=o).assemble(
            A, jnp.ones(A.shape[0]))
        X = s.solve_multi(B)
        Xm, im = lt.solve_multi(A, B, method="cg", pc="iluk", options=o)
        np.testing.assert_allclose(np.asarray(X), np.asarray(Xm),
                                   rtol=1e-12)
        assert np.array_equal(np.asarray(s.nits), np.asarray(im.nits))
        assert s.residual.shape == (3,)
        # block method through the same lifecycle
        s2 = Solver(method="blockcg", pc="iluk", options=o).assemble(
            A, jnp.ones(A.shape[0]))
        Xb = s2.solve_multi(B)
        res = np.linalg.norm(np.asarray(B) - A.to_scipy() @ np.asarray(Xb),
                             axis=0)
        assert (res <= 1e-8 * np.linalg.norm(np.asarray(B), axis=0)).all()
        # scalar solve AFTER a multi solve on the same instance: the
        # (n, k) solution left in self.x must not pollute the scalar
        # warm start (regression: rank mismatch inside the solver)
        b1 = jnp.ones(A.shape[0])
        x1 = s.solve(b1)
        r1 = np.linalg.norm(np.asarray(b1)
                            - A.to_scipy() @ np.asarray(x1))
        assert bool(s.info.converged) and r1 <= 1e-5
        assert isinstance(s.nits, int) and isinstance(s.residual, float)
