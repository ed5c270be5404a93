"""Host-side row partitioning for the distributed path (SURVEY §2.7 — the
communication layer the serial reference does not have).

A CSR matrix is split into P equal row blocks.  Each shard's rows are stored
as padded ELL with *remapped* column indices into that shard's extended
vector ``x_ext = [halo_left | x_local | halo_right]`` (banded/halo mode) or
into the full gathered vector (all-gather mode, general matrices).  The
result is a ``DistELL`` pytree whose leaves are stacked (P, ...) arrays —
exactly the layout ``shard_map`` shards along a mesh axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np

from lssp_tpu.sparse.types import CSR


@dataclasses.dataclass(frozen=True)
class DistELL:
    """Row-partitioned ELL, leaves stacked along the shard axis.

    mode "halo": cols index into [halo_left(h) | local(R) | halo_right(h)].
    mode "allgather": cols are global; SpMV all-gathers x first.
    """

    cols: Any                  # (P, R, k) int32
    data: Any                  # (P, R, k)
    n: int                     # global rows (static)
    nshards: int               # P (static)
    halo: int                  # h; 0 in allgather mode (static)
    mode: str                  # "halo" | "allgather" (static)

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.nshards


jax.tree_util.register_pytree_node(
    DistELL,
    lambda m: ((m.cols, m.data), (m.n, m.nshards, m.halo, m.mode)),
    lambda aux, l: DistELL(*l, n=aux[0], nshards=aux[1], halo=aux[2],
                           mode=aux[3]))


@dataclasses.dataclass(frozen=True)
class DistDIA:
    """Row-partitioned DIA — the gather-free distributed execution format.

    ``data[p, d, r] = A[p·R + r, p·R + r + offsets[d]]`` (row-aligned, same
    convention as sparse.types.DIA).  Each shard's product is pure shifted
    streaming over ``x_ext = [halo_lo(lo) | x_local(R) | halo_hi(hi)]``; the
    halos arrive via two neighbour ``ppermute`` shifts.  Out-of-range
    diagonal slots store 0, so no edge masking is needed anywhere — ring
    wrap-around garbage in the halos is always multiplied by a stored zero.

    Replaces the ELL-gather distributed path with the static-slice DIA
    product per shard (ops/spmv.py: dia_spmv_padded) — the distributed
    contract of /root/reference/src/mvops.cxx:5-39 as one streaming pass.
    """

    data: Any                  # (P, ndiag, R)
    offsets: Tuple[int, ...]   # static, sorted
    n: int                     # global rows (static)
    nshards: int               # P (static)

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.nshards

    @property
    def lo(self) -> int:
        return max(0, -min(self.offsets)) if self.offsets else 0

    @property
    def hi(self) -> int:
        return max(0, max(self.offsets)) if self.offsets else 0


jax.tree_util.register_pytree_node(
    DistDIA,
    lambda m: ((m.data,), (m.offsets, m.n, m.nshards)),
    lambda aux, l: DistDIA(l[0], offsets=aux[0], n=aux[1], nshards=aux[2]))


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def partition_csr_dia(A: CSR, nshards: int, max_diags: int = 256,
                      dia_fill: float = 50.0) -> DistDIA:
    """Partition a banded matrix into per-shard DIA blocks.

    Raises ``ValueError`` when the matrix is not diagonal-structured enough
    (too many distinct diagonals, excessive padding waste, or a band reach
    beyond one neighbouring shard) — callers fall back to the ELL partition.
    """
    n, m = A.shape
    if n != m:
        raise ValueError("only square matrices supported")
    if n % nshards:
        raise ValueError(f"n={n} not divisible by nshards={nshards}")
    R = n // nshards
    from lssp_tpu.sparse.convert import csr_entry_offsets
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    rows, _, offs = csr_entry_offsets(A.indptr, A.indices, n)
    rows = rows.astype(np.int64, copy=False)
    offs = offs.astype(np.int64, copy=False)
    if len(offs) > max_diags:
        raise ValueError(f"{len(offs)} diagonals > max_diags={max_diags}")
    if len(offs) * n > dia_fill * max(A.nnz, 1):
        raise ValueError("DIA padding waste too large")
    lo = max(0, -int(offs.min(initial=0)))
    hi = max(0, int(offs.max(initial=0)))
    if lo > R or hi > R:
        raise ValueError(
            f"band reach ({lo},{hi}) exceeds shard size R={R}: halo would "
            "span more than one neighbour")
    data = np.zeros((len(offs), n), dtype=np.asarray(A.data).dtype)
    d_idx = np.searchsorted(offs, idx - rows)
    data[d_idx, rows] = np.asarray(A.data)
    # (ndiag, n) → (P, ndiag, R): shard p takes columns [p·R, (p+1)·R)
    data = np.swapaxes(data.reshape(len(offs), nshards, R), 0, 1)
    return DistDIA(data=np.ascontiguousarray(data),
                   offsets=tuple(int(o) for o in offs), n=n, nshards=nshards)


@dataclasses.dataclass(frozen=True)
class DistHYB:
    """Row-partitioned hybrid: per-shard DIA band (halo ppermute exchange,
    gather-free streaming) + a per-shard COO remainder applied against the
    all-gathered x.  The all-gather moves n values — for a remainder of
    any size that is the minimal correct exchange, and the band part
    still streams.  Remainder triplets are stored
    with LOCAL row indices and GLOBAL column indices, zero-padded to a
    common per-shard length.
    """

    band: DistDIA
    rem_rows: Any              # (P, nrem) int32, local row ids
    rem_cols: Any              # (P, nrem) int32, global col ids
    rem_vals: Any              # (P, nrem)

    @property
    def n(self) -> int:
        return self.band.n

    @property
    def nshards(self) -> int:
        return self.band.nshards

    @property
    def rows_per_shard(self) -> int:
        return self.band.rows_per_shard


jax.tree_util.register_pytree_node(
    DistHYB,
    lambda m: ((m.band, m.rem_rows, m.rem_cols, m.rem_vals), ()),
    lambda aux, l: DistHYB(*l))


def partition_csr_hyb(A: CSR, nshards: int, max_diags: int = 256,
                      min_occ: float = 0.02, min_cover: float = 0.5,
                      pad_to: int = 8) -> DistHYB:
    """Partition a nearly-banded matrix: dominant diagonals as DistDIA,
    leftovers as per-shard COO remainder.  Raises ``ValueError`` when no
    dominant band exists (fall back to ELL) or the band reach exceeds one
    neighbouring shard."""
    from lssp_tpu.sparse.convert import csr_to_hyb
    n, m = A.shape
    if n != m:
        raise ValueError("only square matrices supported")
    if n % nshards:
        raise ValueError(f"n={n} not divisible by nshards={nshards}")
    R = n // nshards
    H = csr_to_hyb(A, max_diags=max_diags, min_occ=min_occ,
                   min_cover=min_cover, pad_to=pad_to)
    offs = H.dia.offsets
    lo = max(0, -min(offs)) if offs else 0
    hi = max(0, max(offs)) if offs else 0
    if lo > R or hi > R:
        raise ValueError(
            f"band reach ({lo},{hi}) exceeds shard size R={R}")
    data = np.asarray(H.dia.data)
    band = DistDIA(
        data=np.ascontiguousarray(
            np.swapaxes(data.reshape(len(offs), nshards, R), 0, 1)),
        offsets=offs, n=n, nshards=nshards)
    # remainder triplets by owning shard, padded to a common length with
    # zero entries at (local row 0, global col 0)
    rr = np.asarray(H.rem_rows).astype(np.int64)
    rc = np.asarray(H.rem_cols).astype(np.int64)
    rv = np.asarray(H.rem_vals)
    real = rv != 0
    rr, rc, rv = rr[real], rc[real], rv[real]
    shard = rr // R
    counts = np.bincount(shard, minlength=nshards)
    nrem = _round_up(max(int(counts.max()), 1), pad_to)
    rows_p = np.zeros((nshards, nrem), dtype=np.int32)
    cols_p = np.zeros((nshards, nrem), dtype=np.int32)
    vals_p = np.zeros((nshards, nrem), dtype=rv.dtype)
    order = np.argsort(shard, kind="stable")
    slot = np.arange(len(rr), dtype=np.int64) - \
        np.concatenate([[0], np.cumsum(counts)])[shard[order]]
    rows_p[shard[order], slot] = (rr[order] - shard[order] * R)
    cols_p[shard[order], slot] = rc[order]
    vals_p[shard[order], slot] = rv[order]
    return DistHYB(band=band, rem_rows=rows_p, rem_cols=cols_p,
                   rem_vals=vals_p)


def partition_matrix(A: CSR, nshards: int, fmt: str = "auto"):
    """Pick the distributed execution format: DIA streaming when the matrix
    is banded, band+remainder hybrid when nearly
    banded, padded-ELL halo/all-gather otherwise."""
    if fmt in ("auto", "dia"):
        try:
            return partition_csr_dia(A, nshards)
        except ValueError:
            if fmt == "dia":
                raise
    if fmt in ("auto", "hyb"):
        try:
            return partition_csr_hyb(A, nshards)
        except ValueError:
            if fmt == "hyb":
                raise
    if fmt in ("auto", "ell", "halo", "allgather"):
        mode = fmt if fmt in ("halo", "allgather") else "auto"
        return partition_csr(A, nshards, mode=mode)
    raise ValueError(f"unknown distributed format {fmt!r}")


def partition_csr(A: CSR, nshards: int, mode: str = "auto",
                  pad_to: int = 4) -> DistELL:
    """Partition rows into ``nshards`` equal blocks.

    mode "auto": halo layout when every off-shard column lies within one
    neighbouring shard (banded stencil matrices — neighbor-only ppermute
    exchange), else all-gather.
    """
    n, m = A.shape
    if n != m:
        raise ValueError("only square matrices supported")
    if n % nshards:
        raise ValueError(f"n={n} not divisible by nshards={nshards}")
    R = n // nshards
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    shard_of_row = rows // R
    shard_of_col = idx // R

    # halo feasibility: every entry's column shard within ±1 of its row
    # shard, and the reach into the neighbour bounded by h ≤ R
    if mode in ("auto", "halo"):
        d = shard_of_col - shard_of_row
        if np.abs(d).max(initial=0) <= 1:
            # reach: how far cols extend past the local range
            lo_reach = np.where(d == -1, (shard_of_row * R) - idx, 0).max(initial=0)
            hi_reach = np.where(d == 1, idx - ((shard_of_row + 1) * R - 1),
                                0).max(initial=0)
            h = int(max(lo_reach, hi_reach))
            if h <= R:
                return _build(A, nshards, R, h, "halo", pad_to)
        if mode == "halo":
            raise ValueError("matrix is not banded enough for halo mode")
    return _build(A, nshards, R, 0, "allgather", pad_to)


def _build(A: CSR, P: int, R: int, h: int, mode: str, pad_to: int) -> DistELL:
    # fully vectorized (the former P×R Python double loop cost minutes of
    # interpreter time at 1M rows — SURVEY §7 config-#5 critical path)
    n = A.shape[0]
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    rn = ip[1:] - ip[:-1]
    k = max(1, _round_up(int(rn.max()), pad_to))

    pos = np.arange(k)[None, :] < rn[:, None]            # (n, k) valid mask
    flat = (ip[:-1][:, None] + np.arange(k)[None, :])[pos]
    cols = np.zeros((n, k), dtype=np.int64)
    data = np.zeros((n, k), dtype=dat.dtype)
    cols[pos] = idx[flat]
    data[pos] = dat[flat]
    if mode == "halo":
        # remap into this row's extended frame [0, R + 2h); padded slots
        # must stay at 0 (in-bounds, value 0)
        shard_of_row = np.arange(n, dtype=np.int64) // R
        cols[pos] = (cols - (shard_of_row * R)[:, None] + h)[pos]
    return DistELL(cols=cols.reshape(P, R, k).astype(np.int32),
                   data=data.reshape(P, R, k),
                   n=n, nshards=P, halo=h, mode=mode)


def shard_vector(x, nshards: int):
    """(n,) → (P, R) host-side reshape (the shard_map layout)."""
    x = np.asarray(x)
    return x.reshape(nshards, -1)


def unshard_vector(xs):
    return np.asarray(xs).reshape(-1)
