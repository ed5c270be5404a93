"""Tests that need the GPU: the XLA:GPU programs of the SpMV formats and of
the block and multigrid solves, against host references.

Every test here is marked ``gpu`` and skips without a card (the fixture
decides, at run time).  On the card they run as phase (e) of
``python chip_smoke.py``, or alone with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.

Tolerances: fp32 products against scipy in fp64 to 1e-5 max-norm relative
(an fp32 contraction that fell back to TF32 misses this by two orders);
solves to a host-recomputed relative residual of 1e-8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import lssp_tpu as lt
from lssp_tpu.ops.spmv import spmv, spmv_t
from lssp_tpu.sparse import CSR
from lssp_tpu.sparse.convert import (bsr_to_bdia, csr_to_bsr, csr_to_dia,
                                     csr_to_ell, csr_to_hyb)

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


def _laplacian32(N):
    return lt.sparse.laplacian_2d(N, dtype=np.float32)


def _nearly_banded32(N, seed=0):
    S = _laplacian32(N).to_scipy()
    n = S.shape[0]
    rng = np.random.default_rng(seed)
    k = max(n // 200, 8)
    E = sp.coo_matrix((np.full(k, 0.01, np.float32),
                       (rng.integers(0, n, k), rng.integers(0, n, k))),
                      shape=S.shape)
    return CSR.from_scipy((S + E).tocsr())


def _elasticity32():
    A = lt.sparse.elasticity_2d(24)
    return CSR.from_scipy(A.to_scipy().astype(np.float32).tocsr())


FORMATS = {
    "dia": lambda: (_laplacian32(256), csr_to_dia),
    "hyb": lambda: (_nearly_banded32(256), csr_to_hyb),
    "ell": lambda: (lt.sparse.random_sparse(1 << 16, 8, seed=1,
                                            dtype=np.float32), csr_to_ell),
    "bsr": lambda: (_elasticity32(), lambda A: csr_to_bsr(A, 2)),
    "bdia": lambda: (_elasticity32(),
                     lambda A: bsr_to_bdia(csr_to_bsr(A, 2))),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "t"])
def test_spmv_fp32_matches_scipy(gpu, fmt, transpose):
    A, convert = FORMATS[fmt]()
    M = convert(A)
    S = A.to_scipy().astype(np.float64)
    x = np.random.default_rng(3).uniform(-1, 1, A.shape[0]).astype(np.float32)
    op = spmv_t if transpose else spmv
    if fmt == "bsr":
        # raw BSR expands its block rows on the host: close over it
        y = jax.jit(lambda v: op(M, v))(jnp.asarray(x))
    else:
        y = jax.jit(op)(jax.device_put(M), jnp.asarray(x))
    y = np.asarray(y, np.float64)
    ref = (S.T if transpose else S) @ x.astype(np.float64)
    err = np.max(np.abs(y - ref)) / np.max(np.abs(ref))
    assert err <= 1e-5, f"{fmt}: max-norm relative error {err:.2e}"


@pytest.mark.parametrize("method,pc,pc_opts", [
    ("bicgstabl", "biluk", lt.PCOptions(block_size=2)),
    ("gmres", "amg", None),
    ("cg", "saamg", None),
])
def test_solve_ir_reaches_1e8(gpu, method, pc, pc_opts):
    """fp32 inner solves whose block triangular sweeps and dense coarse
    solves must not drop to TF32."""
    A = (lt.sparse.elasticity_2d(24) if pc == "biluk"
         else lt.sparse.anisotropic_poisson_2d(128))
    b = jnp.ones(A.shape[0], dtype=jnp.float64)
    x, info = lt.solve_ir(A, b, method=method, pc=pc, pc_options=pc_opts,
                          options=lt.SolverOptions(rtol=1e-8, atol=0.0,
                                                   rbtol=0.0, maxit=3000))
    r = np.ones(A.shape[0]) - A.to_scipy() @ np.asarray(x, np.float64)
    rel = np.linalg.norm(r) / np.sqrt(A.shape[0])
    assert bool(info.converged) and rel <= 1.1e-8, (int(info.nits), rel)


def test_dia_spmv_batched_matches_columns(gpu):
    """vmap over right-hand sides (the solve_multi path) on the card."""
    A = _laplacian32(128)
    D = jax.device_put(csr_to_dia(A))
    X = jnp.asarray(np.random.default_rng(5).uniform(
        -1, 1, (4, A.shape[0])).astype(np.float32))
    Y = np.asarray(jax.jit(jax.vmap(lambda v: spmv(D, v)))(X), np.float64)
    S = A.to_scipy().astype(np.float64)
    for k in range(4):
        ref = S @ np.asarray(X[k], np.float64)
        assert np.max(np.abs(Y[k] - ref)) / np.max(np.abs(ref)) <= 1e-5


def test_dia_spmv_is_one_kernel(gpu):
    """XLA:GPU fuses the static-slice DIA product (pad, shifted windows,
    multiply-adds) into a single kernel."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import dia_fusion_count
    D = jax.device_put(csr_to_dia(_laplacian32(256)))
    assert dia_fusion_count(D, jnp.ones(256 * 256, jnp.float32)) == 1


def test_dia_fp32_keeps_device_dtype(gpu):
    D = csr_to_dia(_laplacian32(64))
    y = jax.jit(spmv)(jax.device_put(D), jnp.ones(64 * 64, jnp.float32))
    assert y.dtype == jnp.float32
    assert y.devices() == {gpu}
    D64 = dataclasses.replace(D, data=np.asarray(D.data, np.float64))
    y64 = jax.jit(spmv)(jax.device_put(D64), jnp.ones(64 * 64))
    assert y64.dtype == jnp.float64
