"""Level-scheduled *block* triangular solve for the block-ILU path.

Same design as ops/trisolve.py but at block granularity: rows are bs-sized
block rows, off-diagonal entries are dense bs×bs blocks, and each level step
is a batched (w, k, bs, bs) × (w, k, bs) block GEMV — one einsum.  This
replaces the reference's scalar expansion of the block factors
(/root/reference/src/pc-biluk.cxx:104-196 flattens blocks into scalar CSR
and runs the scalar sweep; we keep blocks intact for batched products).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from lssp_tpu.sparse.types import BSR


@dataclasses.dataclass(frozen=True)
class BlockTriSchedule:
    rows: Any       # (nlev, w) int32 block-row ids, padded with nrowb
    cols: Any       # (nlev, w, k) int32 block-col ids, padded with nrowb
    vals: Any       # (nlev, w, k, bs, bs) blocks, padded 0
    nrowb: int
    bs: int

    @property
    def nlevels(self):
        return int(self.rows.shape[0])


jax.tree_util.register_pytree_node(
    BlockTriSchedule,
    lambda s: ((s.rows, s.cols, s.vals), (s.nrowb, s.bs)),
    lambda aux, l: BlockTriSchedule(*l, nrowb=aux[0], bs=aux[1]))


def block_level_schedule(indptr, indices, blocks, nrowb: int, bs: int,
                         lower: bool) -> BlockTriSchedule:
    """Build the schedule from a *strict* block-triangular BSR structure."""
    ip = np.asarray(indptr).astype(np.int64)
    idx = np.asarray(indices).astype(np.int64)
    blk = np.asarray(blocks)

    lev = np.zeros(nrowb, dtype=np.int64)
    rng = range(nrowb) if lower else range(nrowb - 1, -1, -1)
    for i in rng:
        s, e = ip[i], ip[i + 1]
        if e > s:
            lev[i] = lev[idx[s:e]].max() + 1
    nlev = int(lev.max()) + 1 if nrowb else 1
    order = np.argsort(lev, kind="stable")
    counts = np.bincount(lev, minlength=nlev)
    w = max(1, int(counts.max()))
    k = max(1, int((ip[1:] - ip[:-1]).max()) if nrowb else 1)

    rows = np.full((nlev, w), nrowb, dtype=np.int32)
    cols = np.full((nlev, w, k), nrowb, dtype=np.int32)
    vals = np.zeros((nlev, w, k, bs, bs), dtype=blk.dtype)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for l in range(nlev):
        rs = order[starts[l]:starts[l + 1]]
        rows[l, :len(rs)] = rs
        for slot, r in enumerate(rs):
            s, e = ip[r], ip[r + 1]
            cols[l, slot, : e - s] = idx[s:e]
            vals[l, slot, : e - s] = blk[s:e]
    return BlockTriSchedule(rows=rows, cols=cols, vals=vals, nrowb=nrowb, bs=bs)


def block_trisweep(sched: BlockTriSchedule, b):
    """Solve (I + T) y = b where T is the strict block-triangular part held
    by the schedule (unit block diagonal)."""
    nrowb, bs = sched.nrowb, sched.bs
    bb = b.reshape(nrowb, bs)
    be = jnp.concatenate([bb, jnp.zeros((1, bs), dtype=b.dtype)])

    def step(ye, level):
        rows, cols, vals = level
        yv = ye[cols]                                    # (w, k, bs)
        s = be[rows] - jnp.einsum("wkij,wkj->wi", vals, yv,
                                   precision=jax.lax.Precision.HIGHEST)
        return ye.at[rows].set(s), None

    # NB: two independent copies of this scan in one jit program were
    # miscompiled by XLA CPU's concurrency-optimized scheduler (shared
    # scratch raced; bicrsafe+biluk diverged to 1e61).  The scheduler is
    # disabled in lssp_tpu/__init__.py; the failing pattern is pinned by
    # tests/test_ops.py::TestTriSweepCarryMiscompile.
    y0 = jnp.zeros((nrowb + 1, bs), dtype=b.dtype)
    ye, _ = jax.lax.scan(step, y0, (sched.rows, sched.cols, sched.vals))
    return ye[:nrowb].reshape(nrowb * bs)


def block_diag_apply(dinv, y):
    """z_i = Dinv_i · y_i — batched bs×bs GEMV."""
    nrowb, bs = dinv.shape[0], dinv.shape[1]
    yb = y.reshape(nrowb, bs)
    return jnp.einsum("nij,nj->ni", dinv, yb,
                      precision=jax.lax.Precision.HIGHEST).reshape(nrowb * bs)
