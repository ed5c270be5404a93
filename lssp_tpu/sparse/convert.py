"""Host-side format conversions (numpy), run once at assembly time.

Semantics follow /root/reference/src/matrix-utils.cxx: COO→CSR is a counting
sort that sums duplicates (:324-380), CSR↔BSR requires an exact uniform block
partition (:62-215).  ELL/DIA/HYB are device execution formats with no
reference analog.
"""
from __future__ import annotations

import numpy as np

from lssp_tpu.sparse.types import COO, CSR, BSR, ELL, DIA, HYB


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def csr_entry_offsets(indptr, indices, n):
    """Per-entry diagonal offsets (col − row) and their sorted unique set,
    via a counting pass instead of an O(nnz log nnz) sort — the dominant
    host cost at 16.8M rows was ``np.unique`` over 84M int64 offsets
    (several seconds per call ×25 hierarchy conversions).  Returns
    ``(rows, d, offs)`` with ``rows``/``d`` int32 when the dimension
    permits (n < 2³¹) so downstream fancy indexing moves half the bytes.

    SQUARE-ONLY contract: offsets are assumed to live in [-(n-1), n-1]
    (the counting array is sized 2n-1 and the int32 eligibility shifts by
    n-1) — a rectangular CSR with column count m > n would both overflow
    the shift near int32 and under-size the bincount (advisor r3)."""
    ip = np.asarray(indptr)
    # int32 only when the shifted offset d+(n-1) ∈ [0, 2n-2] also fits
    it = np.int32 if 2 * n < 2**31 else np.int64
    rows = np.repeat(np.arange(n, dtype=it), np.diff(ip))
    d = np.asarray(indices).astype(it, copy=False) - rows
    if len(d) and int(d.max()) > n - 1:
        raise ValueError(f"csr_entry_offsets: square-only (max offset "
                         f"{int(d.max())} > n-1={n - 1})")
    if len(d) == 0:
        return rows, d, np.zeros(0, dtype=it)
    # offsets live in [-(n-1), n-1]: one counting array of length 2n-1
    # (bincount casts to intp internally in C — no explicit astype copy)
    occ = np.bincount(d + it(n - 1), minlength=2 * n - 1)
    offs = (np.flatnonzero(occ) - (n - 1)).astype(it)
    return rows, d, offs


def coo_to_csr(A: COO, sum_duplicates: bool = True) -> CSR:
    """Counting-sort COO→CSR, summing duplicate entries
    (reference lssp_mat_coo_to_csr, matrix-utils.cxx:324-380)."""
    n, m = A.shape
    row = np.asarray(A.row, dtype=np.int64)
    col = np.asarray(A.col, dtype=np.int64)
    dat = np.asarray(A.data)
    order = np.lexsort((col, row))
    row, col, dat = row[order], col[order], dat[order]
    if sum_duplicates and len(row):
        keys = row * m + col
        uniq_mask = np.empty(len(keys), dtype=bool)
        uniq_mask[0] = True
        np.not_equal(keys[1:], keys[:-1], out=uniq_mask[1:])
        seg_ids = np.cumsum(uniq_mask) - 1
        dat = np.bincount(seg_ids, weights=dat, minlength=seg_ids[-1] + 1).astype(dat.dtype)
        row, col = row[uniq_mask], col[uniq_mask]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr.astype(np.int32), col.astype(np.int32), dat, (n, m))


def csr_to_coo(A: CSR) -> COO:
    ip = np.asarray(A.indptr)
    row = np.repeat(np.arange(A.shape[0], dtype=np.int32), ip[1:] - ip[:-1])
    return COO(row, np.asarray(A.indices).copy(), np.asarray(A.data).copy(), A.shape)


def csr_to_bsr(A: CSR, blocksize: int) -> BSR:
    """CSR→uniform-block BSR (reference csr→bcsr, matrix-utils.cxx:62-162).

    Every scalar nnz lands inside some bs×bs block; blocks are materialized
    dense (explicit zeros), row-major for batched GEMM.
    """
    n, m = A.shape
    bs = int(blocksize)
    if n % bs or m % bs:
        raise ValueError(f"matrix shape {A.shape} not divisible by blocksize {bs}")
    ip = np.asarray(A.indptr).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    brow, bcol = rows // bs, cols // bs
    lrow, lcol = rows % bs, cols % bs
    nrowb = n // bs
    keys = brow * (m // bs) + bcol
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    uniq_mask = np.empty(len(keys_s), dtype=bool)
    if len(keys_s):
        uniq_mask[0] = True
        np.not_equal(keys_s[1:], keys_s[:-1], out=uniq_mask[1:])
    blk_ids_sorted = np.cumsum(uniq_mask) - 1 if len(keys_s) else np.array([], np.int64)
    nnzb = int(blk_ids_sorted[-1] + 1) if len(keys_s) else 0
    blocks = np.zeros((nnzb, bs, bs), dtype=dat.dtype)
    blocks[blk_ids_sorted, lrow[order], lcol[order]] = dat[order]
    ukeys = keys_s[uniq_mask]
    ubrow, ubcol = ukeys // (m // bs), ukeys % (m // bs)
    indptr = np.zeros(nrowb + 1, dtype=np.int64)
    np.add.at(indptr, ubrow + 1, 1)
    indptr = np.cumsum(indptr)
    return BSR(indptr.astype(np.int32), ubcol.astype(np.int32), blocks, (n, m), bs)


def bsr_to_csr(A: BSR, prune: bool = True) -> CSR:
    """BSR→CSR; explicit zeros inside blocks are dropped when ``prune``."""
    bs, nrowb = A.blocksize, A.nrowb
    ip = np.asarray(A.indptr).astype(np.int64)
    bcols = np.asarray(A.indices).astype(np.int64)
    blocks = np.asarray(A.blocks)
    brows = np.repeat(np.arange(nrowb, dtype=np.int64), ip[1:] - ip[:-1])
    # expand: nnzb × bs × bs scalar entries
    nnzb = blocks.shape[0]
    r = np.broadcast_to(brows[:, None, None] * bs
                        + np.arange(bs)[None, :, None], (nnzb, bs, bs)).ravel()
    c = np.broadcast_to(bcols[:, None, None] * bs
                        + np.arange(bs)[None, None, :], (nnzb, bs, bs)).ravel()
    v = blocks.ravel()
    if prune:
        keep = v != 0
        r, c, v = r[keep], c[keep], v[keep]
    return coo_to_csr(COO(r.astype(np.int32), c.astype(np.int32), v, A.shape), sum_duplicates=False)


def csr_to_ell(A: CSR, pad_to: int = 4) -> ELL:
    """CSR→padded ELLPACK; padded slots get (col=0, val=0) so the device
    gather needs no mask.  ``k`` is rounded up to a multiple of ``pad_to``."""
    n, m = A.shape
    ip = np.asarray(A.indptr).astype(np.int64)
    rn = ip[1:] - ip[:-1]
    k = max(1, _round_up(int(rn.max()) if n else 1, pad_to))
    cols = np.zeros((n, k), dtype=np.int32)
    data = np.zeros((n, k), dtype=A.data.dtype)
    pos = np.arange(k)[None, :] < rn[:, None]          # (n, k) valid mask
    flat_idx = (ip[:-1][:, None] + np.arange(k)[None, :])[pos]
    cols[pos] = np.asarray(A.indices)[flat_idx]
    data[pos] = np.asarray(A.data)[flat_idx]
    return ELL(cols, data, A.shape)


def csr_to_dia(A: CSR, max_diags: int = 64, dtype=None) -> DIA:
    """CSR→diagonal storage (row-aligned: data[d,i] = A[i, i+off]).

    Raises ``ValueError`` if the matrix has more than ``max_diags`` distinct
    diagonals — callers fall back to ELL.  ``dtype`` casts during the
    scatter so hierarchy builders never materialize an intermediate
    full-precision copy of the CSR just to change dtype."""
    n, m = A.shape
    out_dtype = np.dtype(dtype or np.asarray(A.data).dtype)
    ip = np.asarray(A.indptr)
    ix = np.asarray(A.indices)
    dat = np.asarray(A.data)
    from lssp_tpu import native
    if (n == m and native.available() and dat.dtype == np.float64
            and out_dtype in (np.float32, np.float64)
            and ip.dtype in (np.int32, np.int64) and n > 1):
        # fused C++ pass (native/src/amgfilter.cpp): the numpy path makes
        # ~5 separate nnz-length passes (repeat/subtract/bincount/
        # searchsorted/fancy-scatter) — ~0.6 s/call ×27 hierarchy
        # conversions at the 16.8M acceptance scale
        res = native.dia_convert(ip, ix, dat, n, max_diags, out_dtype)
        if res is None:
            raise ValueError(f"more than max_diags={max_diags} diagonals")
        offs, data = res
        return DIA(tuple(int(o) for o in offs), data, A.shape)
    rows, d, offs = csr_entry_offsets(A.indptr, A.indices, n)
    if len(offs) > max_diags:
        raise ValueError(f"{len(offs)} diagonals > max_diags={max_diags}")
    data = np.zeros((len(offs), n), dtype=out_dtype)
    d_idx = np.searchsorted(offs, d)
    data[d_idx, rows] = dat
    return DIA(tuple(int(o) for o in offs), data, A.shape)


def bsr_to_bdia(A: "BSR", max_diags: int = 32, fill: float = 2.0):
    """BSR→block-diagonal storage (block-banded matrices).  Raises
    ``ValueError`` when the block-diagonal count or padding waste is too
    large — callers keep the gather-based BSR path then."""
    from lssp_tpu.sparse.types import BDIA
    nb = A.nrowb
    bs = A.blocksize
    ip = np.asarray(A.indptr).astype(np.int64)
    rows = np.repeat(np.arange(nb, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(A.indices).astype(np.int64)
    offs = np.unique(cols - rows)
    if len(offs) > max_diags:
        raise ValueError(f"{len(offs)} block diagonals > {max_diags}")
    if len(offs) * nb > fill * max(A.nnzb, 1):
        raise ValueError("block-diagonal padding waste too large")
    blocks = np.zeros((len(offs), nb, bs, bs), dtype=A.blocks.dtype)
    d_idx = np.searchsorted(offs, cols - rows)
    blocks[d_idx, rows] = np.asarray(A.blocks)
    return BDIA(tuple(int(o) for o in offs), blocks, A.shape, bs)


def _select_band(counts: np.ndarray, n: int, max_diags: int,
                 min_occ: float) -> np.ndarray:
    """THE band-selection rule, shared by csr_to_hyb and the RCM acceptance
    criterion (reorder.band_coverage) so the two can never diverge: the
    up-to-``max_diags`` most-occupied diagonals, each holding at least
    max(min_occ·n, 16) entries (the absolute floor keeps tiny-n noise
    diagonals from classifying small random matrices as banded).  Returns
    indices into ``counts``."""
    order = np.argsort(-counts, kind="stable")
    take = order[:max_diags]
    return take[counts[take] >= max(min_occ * n, 16.0)]


def band_occupancy(A: CSR, max_diags: int = 256,
                   min_occ: float = 0.02) -> float:
    """Fraction of nnz a HYB split would stream as DIA diagonals."""
    n = A.shape[0]
    _, d, offs = csr_entry_offsets(A.indptr, A.indices, n)
    if len(d) == 0:
        return 0.0
    counts = np.bincount(np.searchsorted(offs, d), minlength=len(offs))
    take = _select_band(counts, n, max_diags, min_occ)
    return float(counts[take].sum()) / max(A.nnz, 1)


def csr_to_hyb(A: CSR, max_diags: int = 256, min_occ: float = 0.02,
               min_cover: float = 0.5, pad_to: int = 8) -> HYB:
    """CSR→hybrid band + remainder: the up-to-``max_diags`` most-occupied
    diagonals (each holding ≥ ``min_occ``·n entries) stream as DIA; the
    leftover entries become a COO triplet remainder (gather + scatter-add,
    cost proportional to the remainder count, where a padded-ELL remainder
    would touch every n·k slot).

    Raises ``ValueError`` when the band would cover less than ``min_cover``
    of the nnz — then plain ELL is no worse and far simpler.
    """
    n, m = A.shape
    rows, d_all, offs = csr_entry_offsets(A.indptr, A.indices, n)
    cols = np.asarray(A.indices)
    dat = np.asarray(A.data)
    all_idx = np.searchsorted(offs, d_all)
    counts = np.bincount(all_idx, minlength=len(offs))
    take = _select_band(counts, n, max_diags, min_occ)
    if len(take) == 0 or counts[take].sum() < min_cover * max(A.nnz, 1):
        raise ValueError(
            f"band coverage {counts[take].sum() / max(A.nnz, 1):.2f} below "
            f"min_cover={min_cover}; use ELL")
    keep_mask = np.zeros(len(offs), dtype=bool)
    keep_mask[take] = True
    in_band = keep_mask[all_idx]
    kept = offs[keep_mask].astype(np.int64)

    data_dia = np.zeros((len(kept), n), dtype=dat.dtype)
    d_idx = np.searchsorted(kept, d_all[in_band])
    data_dia[d_idx, rows[in_band]] = dat[in_band]
    dia = DIA(tuple(int(o) for o in kept), data_dia, A.shape)

    # remainder triplets; padding targets (n-1, 0) with value 0, so
    # rem_rows stays SORTED (CSR order) for the indices_are_sorted scatter
    r_rem, c_rem, v_rem = rows[~in_band], cols[~in_band], dat[~in_band]
    npad = _round_up(max(len(v_rem), 1), pad_to) - len(v_rem)
    r_rem = np.concatenate([r_rem, np.full(npad, n - 1, np.int64)])
    c_rem = np.concatenate([c_rem, np.zeros(npad, np.int64)])
    v_rem = np.concatenate([v_rem, np.zeros(npad, dat.dtype)])
    return HYB(dia=dia, rem_rows=r_rem.astype(np.int32),
               rem_cols=c_rem.astype(np.int32), rem_vals=v_rem,
               shape=A.shape)


def to_device_format(A: CSR, max_diags: int = 32, dia_fill: float = 2.0,
                     hyb_diags: int = 256):
    """Pick the device execution format for a CSR matrix.

    DIA when the diagonal count is small and storage waste bounded (stencil
    matrices — one streaming pass); HYB when a dominant band exists
    with a small unstructured remainder; padded ELL (gather SpMV) last.
    """
    n = A.shape[0]
    try:
        _, _, offs = csr_entry_offsets(A.indptr, A.indices, n)
        if len(offs) <= max_diags and len(offs) * n <= dia_fill * max(A.nnz, 1):
            return csr_to_dia(A, max_diags=max_diags)
    except Exception:
        pass
    try:
        return csr_to_hyb(A, max_diags=hyb_diags)
    except ValueError:
        pass
    return csr_to_ell(A)
