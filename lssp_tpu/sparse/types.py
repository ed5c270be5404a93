"""Immutable pytree sparse-matrix containers.

The reference's containers are malloc'd struct-of-arrays
(/root/reference/include/type-defs.h:15-62).  Here each format is a frozen
dataclass registered as a JAX pytree: the index/data arrays are leaves (live in
device memory when jitted), the shape/blocksize metadata is static aux data, so matrices
can flow through ``jit``/``shard_map``/``scan`` like any other array bundle.

Arrays may be numpy (host, during assembly/factorization) or ``jax.Array``
(device, during iteration).  All methods are no-copy where possible.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np


def _fields(obj):
    return [getattr(obj, f.name) for f in dataclasses.fields(obj) if f.metadata.get("leaf", True)]


def _register(cls, leaf_names, static_names):
    def flatten(obj):
        return tuple(getattr(obj, n) for n in leaf_names), tuple(getattr(obj, n) for n in static_names)

    def unflatten(aux, leaves):
        kwargs = dict(zip(leaf_names, leaves))
        kwargs.update(dict(zip(static_names, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@dataclasses.dataclass(frozen=True)
class COO:
    """Triplet format (reference lssp_mat_coo, type-defs.h:26-35).

    Duplicate (row, col) entries are *summed* on conversion to CSR, the
    standard assembly semantic.
    """

    row: Any            # (nnz,) int32
    col: Any            # (nnz,) int32
    data: Any           # (nnz,) float
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.dtype)
        np.add.at(out, (np.asarray(self.row), np.asarray(self.col)), np.asarray(self.data))
        return out

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.coo_matrix((np.asarray(self.data), (np.asarray(self.row), np.asarray(self.col))), shape=self.shape)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row (reference lssp_mat_csr, type-defs.h:15-24).

    ``indptr``: (nrows+1,) int32, ``indices``: (nnz,) int32, ``data``: (nnz,).
    Column indices within each row are kept sorted (the reference sorts on
    assemble, /root/reference/src/lssp.cxx:173).
    """

    indptr: Any
    indices: Any
    data: Any
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row_nnz(self) -> np.ndarray:
        ip = np.asarray(self.indptr)
        return ip[1:] - ip[:-1]

    def todense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix(
            (np.asarray(self.data), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    @staticmethod
    def from_scipy(m) -> "CSR":
        m = m.tocsr()
        return CSR(
            indptr=m.indptr.astype(np.int32),
            indices=m.indices.astype(np.int32),
            data=m.data,
            shape=tuple(m.shape),
        )

    def astype(self, dtype) -> "CSR":
        return dataclasses.replace(self, data=self.data.astype(dtype))

    def device_put(self) -> "CSR":
        return jax.tree_util.tree_map(jax.device_put, self)


@dataclasses.dataclass(frozen=True)
class BSR:
    """Uniform block CSR (reference lssp_mat_bcsr, type-defs.h:45-55).

    ``blocks``: (nnzb, bs, bs) row-major dense blocks — directly consumable by
    batched einsum/GEMM (the reference stores blocks column-major for
    Fortran BLAS, doc/mv.tex:54; we deliberately diverge).
    ``shape`` is the *scalar* shape (nrows, ncols) = (nrowb*bs, ncolb*bs).
    """

    indptr: Any         # (nrowb+1,) int32
    indices: Any        # (nnzb,) int32 — block-column indices
    blocks: Any         # (nnzb, bs, bs)
    shape: Tuple[int, int]
    blocksize: int

    @property
    def nnzb(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def nnz(self) -> int:
        return self.nnzb * self.blocksize * self.blocksize

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def nrowb(self) -> int:
        return self.shape[0] // self.blocksize

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.bsr_matrix(
            (np.asarray(self.blocks), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    @staticmethod
    def from_scipy(m) -> "BSR":
        bs = m.blocksize
        assert bs[0] == bs[1], "only square blocks supported"
        return BSR(
            indptr=m.indptr.astype(np.int32),
            indices=m.indices.astype(np.int32),
            blocks=np.asarray(m.data),
            shape=tuple(m.shape),
            blocksize=int(bs[0]),
        )

    def todense(self) -> np.ndarray:
        return self.to_scipy().toarray()


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded ELLPACK — the gather-SpMV execution format.

    ``cols``: (nrows, k) int32 column indices, padded entries point at column
    0; ``data``: (nrows, k) with padded entries 0 — so a plain gather +
    row-sum computes A@x with no masking.  ``k`` is the max row nnz, rounded
    up to a lane-friendly multiple when built by ``csr_to_ell``.
    """

    cols: Any
    data: Any
    shape: Tuple[int, int]

    @property
    def k(self) -> int:
        return int(self.data.shape[1])

    @property
    def dtype(self):
        return self.data.dtype

    def todense(self) -> np.ndarray:
        n, k = np.asarray(self.data).shape
        out = np.zeros(self.shape, dtype=self.dtype)
        rows = np.repeat(np.arange(n), k)
        np.add.at(out, (rows, np.asarray(self.cols).ravel()), np.asarray(self.data).ravel())
        return out


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal storage — the stencil-matrix execution format.

    ``offsets``: static tuple of diagonal offsets; ``data``: (ndiag, nrows)
    where ``data[d, i] = A[i, i + offsets[d]]`` (row-aligned convention, so
    SpMV is ``y[i] += data[d, i] * x[i + off]`` — a shifted elementwise
    multiply that XLA fuses into one streaming loop).
    Out-of-range entries are stored as 0.
    """

    offsets: Tuple[int, ...]    # static aux
    data: Any                   # (ndiag, nrows)
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    def todense(self) -> np.ndarray:
        n, m = self.shape
        out = np.zeros(self.shape, dtype=self.dtype)
        dat = np.asarray(self.data)
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(n, m - off))
            out[i, i + off] = dat[d, i]
        return out


@dataclasses.dataclass(frozen=True)
class BDIA:
    """Block-diagonal storage — the execution format for block-banded
    matrices (e.g. elasticity BSR after RCM).

    ``blocks[d, i] = A_block[i, i + offsets[d]]`` (row-aligned, like DIA but
    at block granularity): the SpMV is one batched (bs×bs)@(bs,) einsum per
    block diagonal on shifted block columns with zero gathers, unlike the
    BSR path's block-row gather.  Out-of-range blocks are 0.
    """

    offsets: Tuple[int, ...]    # static; in BLOCK units
    blocks: Any                 # (ndiag, nrowb, bs, bs)
    shape: Tuple[int, int]      # scalar shape
    blocksize: int

    @property
    def nrowb(self) -> int:
        return self.shape[0] // self.blocksize

    @property
    def dtype(self):
        return self.blocks.dtype

    def todense(self) -> np.ndarray:
        nb = self.nrowb
        bs = self.blocksize
        out = np.zeros(self.shape, dtype=self.dtype)
        blk = np.asarray(self.blocks)
        for d, off in enumerate(self.offsets):
            for i in range(max(0, -off), min(nb, nb - off)):
                out[i*bs:(i+1)*bs, (i+off)*bs:(i+off+1)*bs] = blk[d, i]
        return out


@dataclasses.dataclass(frozen=True)
class HYB:
    """Hybrid band + remainder — the execution format for *nearly* banded
    matrices (general SuiteSparse patterns after RCM).

    The densely-occupied diagonals stream as a ``DIA`` part; the few
    off-band entries live in row-sorted COO triplet arrays
    (``rem_rows``/``rem_cols``/``rem_vals``, padded with zero entries at
    (n-1, 0) to a multiple of 8).  The remainder applies as one gather +
    scatter-add whose cost is proportional to the REMAINDER COUNT, where a
    padded-ELL remainder would touch all n·k slots however few are real.
    SpMV = DIA product + ``y.at[rem_rows].add(rem_vals · x[rem_cols])``.
    Built by ``convert.csr_to_hyb`` which bounds both the diagonal padding
    waste and the remainder fraction.
    """

    dia: "DIA"
    rem_rows: Any         # (nnz_rem_padded,) int32
    rem_cols: Any         # (nnz_rem_padded,) int32
    rem_vals: Any         # (nnz_rem_padded,)
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.dia.dtype

    @property
    def nnz_rem(self) -> int:
        return int(np.count_nonzero(np.asarray(self.rem_vals)))

    def todense(self) -> np.ndarray:
        out = self.dia.todense()
        np.add.at(out, (np.asarray(self.rem_rows), np.asarray(self.rem_cols)),
                  np.asarray(self.rem_vals))
        return out


_register(COO, ("row", "col", "data"), ("shape",))
_register(CSR, ("indptr", "indices", "data"), ("shape",))
_register(BSR, ("indptr", "indices", "blocks"), ("shape", "blocksize"))
_register(ELL, ("cols", "data"), ("shape",))
_register(DIA, ("data",), ("offsets", "shape"))
_register(BDIA, ("blocks",), ("offsets", "shape", "blocksize"))
_register(HYB, ("dia", "rem_rows", "rem_cols", "rem_vals"), ("shape",))
