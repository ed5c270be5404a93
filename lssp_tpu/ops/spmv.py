"""Sparse matrix–vector products, dispatched on execution format.

Replaces the reference's scalar row-loop SpMV family
(/root/reference/src/mvops.cxx:5-150).  The four reference entry points
(y=βy+αAx, z=βy+αAx, y=αAx, y=Ax; include/mvops.h:9-19) are provided as thin
compositions — under jit XLA fuses the scale/add into the SpMV epilogue, so
there is no performance reason to hand-write each variant.

Format strategy:
- ``DIA``: each diagonal is a shifted elementwise multiply-add on static
  slices of one padded x — XLA fuses the whole sum into one streaming loop
  fusion, the bandwidth-bound choice for stencil matrices.
- ``HYB``: the DIA band plus a COO remainder applied as a plain gather of
  x and a sorted scatter-add.
- ``ELL``: one gather of x at (n, k) indices + row-sum; with k small this is
  bandwidth-bound on the data/cols arrays.
- ``BSR``/``BDIA``: batched (bs×bs)@(bs,) block products via einsum, plus a
  segment-sum over block rows (BSR) or shifted block columns (BDIA).
- ``CSR``: segment-sum reference path (correctness oracle / fallback).

Every fp32 einsum pins ``precision=HIGHEST``: the GPU may otherwise run an
fp32 contraction in TF32 (~3 decimal digits), which breaks solves held to a
1e-8 residual.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lssp_tpu.sparse.types import CSR, BSR, ELL, DIA, BDIA, HYB

HIGHEST = jax.lax.Precision.HIGHEST


def csr_row_ids(A: CSR) -> np.ndarray:
    """Expanded row index per nonzero (host-precomputed for the CSR path)."""
    ip = np.asarray(A.indptr)
    return np.repeat(np.arange(A.shape[0], dtype=np.int32), ip[1:] - ip[:-1])


def _spmv_csr(A: CSR, x, rows=None):
    if rows is None:
        rows = csr_row_ids(A)
    prod = A.data * x[A.indices]
    return jax.ops.segment_sum(prod, rows, num_segments=A.shape[0])


def _spmv_ell(A: ELL, x):
    return jnp.sum(A.data * x[A.cols], axis=1)


def _band_pad(offs):
    """(lo, hi) zero padding that keeps every shifted window in range."""
    lo = max(0, -min(offs)) if offs else 0
    hi = max(0, max(offs)) if offs else 0
    return lo, hi


def dia_spmv_padded(data, offs, xp, lo):
    """y[i] = Σ_d data[d, i] · xp[lo + i + offs[d]] for a pre-padded x.

    Shared by the single-device DIA product (``xp`` = zero-padded x) and
    the distributed per-shard op (``xp`` = [halo_lo ‖ x_local ‖ halo_hi]).
    Every window is a static ``lax.slice``, so XLA fuses the whole sum into
    one elementwise loop fusion that streams the diagonals once."""
    n = data.shape[1]
    y = None
    for d, off in enumerate(offs):
        term = data[d] * jax.lax.slice(xp, (lo + off,), (lo + off + n,))
        y = term if y is None else y + term
    if y is None:
        return jnp.zeros(n, jnp.result_type(data.dtype, xp.dtype))
    return y


def _spmv_dia(A: DIA, x):
    lo, hi = _band_pad(A.offsets)
    return dia_spmv_padded(A.data, A.offsets, jnp.pad(x, (lo, hi)), lo)


def _spmv_bsr(A: BSR, x, block_rows=None):
    bs = A.blocksize
    if block_rows is None:
        ip = np.asarray(A.indptr)
        block_rows = np.repeat(np.arange(A.nrowb, dtype=np.int32), ip[1:] - ip[:-1])
    xb = x.reshape(A.shape[1] // bs, bs)
    gathered = xb[A.indices]                                   # (nnzb, bs)
    prod = jnp.einsum("nij,nj->ni", A.blocks, gathered, precision=HIGHEST)
    yb = jax.ops.segment_sum(prod, block_rows, num_segments=A.nrowb)
    return yb.reshape(A.shape[0])


def _spmv_bdia(A: BDIA, x):
    """Block-diagonal SpMV: per block diagonal, one batched (bs×bs)@(bs,)
    einsum on shifted block columns — no gathers."""
    nb = A.nrowb
    bs = A.blocksize
    offs = A.offsets
    lo, hi = _band_pad(offs)
    xb = x.reshape(nb, bs)
    xp = jnp.pad(xb, ((lo, hi), (0, 0)))
    dtype = jnp.result_type(A.blocks.dtype, x.dtype)
    y = jnp.zeros((nb, bs), dtype=dtype)
    for d, off in enumerate(offs):
        xs = jax.lax.slice(xp, (lo + off, 0), (lo + off + nb, bs))
        y = y + jnp.einsum("nij,nj->ni", A.blocks[d], xs, precision=HIGHEST)
    return y.reshape(A.shape[0])


def _spmv_bdia_t(A: BDIA, x):
    nb = A.nrowb
    bs = A.blocksize
    offs = A.offsets
    lo, hi = _band_pad(offs)
    xb = x.reshape(nb, bs)
    dtype = jnp.result_type(A.blocks.dtype, x.dtype)
    y = jnp.zeros((nb, bs), dtype=dtype)
    for d, off in enumerate(offs):
        z = jnp.einsum("nij,ni->nj", A.blocks[d], xb,     # blockᵀ·x per row
                       precision=HIGHEST)
        zp = jnp.pad(z, ((hi, lo), (0, 0)))
        y = y + jax.lax.slice(zp, (hi - off, 0), (hi - off + nb, bs))
    return y.reshape(A.shape[1])


def _spmv_hyb(A: HYB, x):
    """Band part streams as DIA; the small COO remainder applies as one
    gather of x plus a scatter-add whose cost scales with the remainder
    count, not the matrix.  ``rem_rows`` is row-sorted by construction
    (CSR order, padding at row n-1 with value 0), which the sorted hint
    lets the scatter exploit."""
    y = _spmv_dia(A.dia, x)
    return y.at[A.rem_rows].add(A.rem_vals * x[A.rem_cols],
                                indices_are_sorted=True)


def spmv(A, x):
    """y = A @ x for any container format."""
    if isinstance(A, DIA):
        return _spmv_dia(A, x)
    if isinstance(A, HYB):
        return _spmv_hyb(A, x)
    if isinstance(A, ELL):
        return _spmv_ell(A, x)
    if isinstance(A, BDIA):
        return _spmv_bdia(A, x)
    if isinstance(A, BSR):
        return _spmv_bsr(A, x)
    if isinstance(A, CSR):
        return _spmv_csr(A, x)
    if callable(A):
        return A(x)
    raise TypeError(f"unsupported matrix type {type(A)}")


# ---- transpose products (yᵀ = Aᵀx) -----------------------------------------
# The reference never needs Aᵀ·x (its 17 solvers are transpose-free); the
# extra capability-parity methods drawn from its external-package tables
# (BiCG/QMR from LASPACK solver-laspack.cxx:29-34, CGNR/LSQR/BiCG from PETSc
# solver-petsc.cxx:23-32) do.  Each format gets a native transpose apply so
# no explicit Aᵀ container has to be materialized.

def _spmv_csr_t(A: CSR, x, rows=None):
    if rows is None:
        rows = csr_row_ids(A)
    prod = A.data * x[rows]
    return jax.ops.segment_sum(prod, A.indices, num_segments=A.shape[1])


def _spmv_ell_t(A: ELL, x):
    prod = (A.data * x[:, None]).ravel()
    return jax.ops.segment_sum(prod, A.cols.ravel(), num_segments=A.shape[1])


def _spmv_dia_t(A: DIA, x):
    # y[j] = Σ_d data[d, j−off_d]·x[j−off_d]: same shifted-stream structure as
    # the forward product with the shift sign negated (out-of-range slots are
    # stored as 0, so no masking is needed).
    n = A.shape[0]
    dtype = jnp.result_type(A.data.dtype, x.dtype)
    lo, hi = _band_pad(A.offsets)
    y = jnp.zeros(n, dtype=dtype)
    for d, off in enumerate(A.offsets):
        zp = jnp.pad(A.data[d] * x, (hi, lo))
        y = y + jax.lax.slice(zp, (hi - off,), (hi - off + n,))
    return y


def _spmv_bsr_t(A: BSR, x, block_rows=None):
    bs = A.blocksize
    if block_rows is None:
        ip = np.asarray(A.indptr)
        block_rows = np.repeat(np.arange(A.nrowb, dtype=np.int32), ip[1:] - ip[:-1])
    xb = x.reshape(A.shape[0] // bs, bs)
    gathered = xb[block_rows]                                   # (nnzb, bs)
    prod = jnp.einsum("nij,ni->nj", A.blocks, gathered,         # blockᵀ·x
                      precision=HIGHEST)
    yb = jax.ops.segment_sum(prod, A.indices,
                             num_segments=A.shape[1] // bs)
    return yb.reshape(A.shape[1])


def spmv_t(A, x):
    """y = Aᵀ @ x for any container format."""
    if isinstance(A, DIA):
        return _spmv_dia_t(A, x)
    if isinstance(A, HYB):
        y = _spmv_dia_t(A.dia, x)
        return y.at[A.rem_cols].add(A.rem_vals * x[A.rem_rows])
    if isinstance(A, ELL):
        return _spmv_ell_t(A, x)
    if isinstance(A, BDIA):
        return _spmv_bdia_t(A, x)
    if isinstance(A, BSR):
        return _spmv_bsr_t(A, x)
    if isinstance(A, CSR):
        return _spmv_csr_t(A, x)
    raise TypeError(
        f"transpose SpMV needs a matrix container, got {type(A)}; "
        "pass an explicit At operator for callable inputs")


# ---- reference mvops parity wrappers (include/mvops.h:9-19) ----

def mv_amxpby(alpha, A, x, beta, y):
    """y = beta*y + alpha*A@x   (mvops.cxx:5-39)."""
    return beta * y + alpha * spmv(A, x)


def mv_amxpbyz(alpha, A, x, beta, y):
    """z = beta*y + alpha*A@x   (mvops.cxx:42-78)."""
    return beta * y + alpha * spmv(A, x)


def mv_amxy(alpha, A, x):
    """y = alpha*A@x            (mvops.cxx:81-115).  Under jit XLA fuses the
    scale into the SpMV's loop fusion."""
    return alpha * spmv(A, x)


def mv_mxy(A, x):
    """y = A@x                  (mvops.cxx:118-150)."""
    return spmv(A, x)
