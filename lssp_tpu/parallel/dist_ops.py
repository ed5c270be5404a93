"""Inside-shard_map device ops: halo-exchange SpMV and psum reductions.

These run *per shard* under ``shard_map`` over a 1-D mesh axis.  The halo
exchange is two ``lax.ppermute`` shifts between neighbouring devices (left
and right), which XLA overlaps with the local gather; dots/norms are a local
dot + ``lax.psum`` — the only cross-device synchronisation points in a
Krylov iteration (SURVEY §3.3).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from lssp_tpu.ops.spmv import dia_spmv_padded
from lssp_tpu.parallel.partition import DistELL, DistDIA, DistHYB


def _make_dia_spmv(M: DistDIA, axis: str):
    P = M.nshards
    lo, hi = M.lo, M.hi
    offsets = M.offsets

    def op(data, x):
        # Halo exchange: my last lo values go right (arrive as the
        # neighbour's left halo), my first hi values go left.  No edge
        # masking anywhere — ring wrap-around garbage is only ever
        # multiplied by stored zeros (see DistDIA docstring).
        parts = []
        if lo > 0:
            right = [(i, (i + 1) % P) for i in range(P)]
            parts.append(lax.ppermute(x[-lo:], axis, right))
        parts.append(x)
        if hi > 0:
            left = [(i, (i - 1) % P) for i in range(P)]
            parts.append(lax.ppermute(x[:hi], axis, left))
        x_ext = jnp.concatenate(parts) if len(parts) > 1 else x
        return dia_spmv_padded(data, offsets, x_ext, lo)

    return op


def _make_dia_spmv_t(M: DistDIA, axis: str):
    """Transpose: accumulate shifted streams into the extended vector, keep
    the local part, ship the halo accumulations to the owning neighbours."""
    P = M.nshards
    lo, hi = M.lo, M.hi
    offsets = M.offsets
    R = M.rows_per_shard

    def op_t(data, x):
        dtype = jnp.result_type(data.dtype, x.dtype)
        z_ext = jnp.zeros(lo + R + hi, dtype=dtype)
        for d, off in enumerate(offsets):
            # rows r contribute data[d,r]·x[r] to column r+off, i.e. the
            # contiguous z_ext slice [lo+off, lo+off+R) — a static slice add
            z_ext = z_ext.at[lo + off:lo + off + R].add(data[d] * x)
        y = z_ext[lo:lo + R]
        if lo > 0:
            # z_ext[:lo] belongs to the LEFT neighbour's last lo rows
            left = [(i, (i - 1) % P) for i in range(P)]
            y = y.at[-lo:].add(lax.ppermute(z_ext[:lo], axis, left))
        if hi > 0:
            right = [(i, (i + 1) % P) for i in range(P)]
            y = y.at[:hi].add(lax.ppermute(z_ext[-hi:], axis, right))
        # no masking: shard 0's left-halo / shard P-1's right-halo
        # accumulations are sums of stored zeros, so the ring wrap adds 0
        return y

    return op_t


def _make_hyb_spmv(M: DistHYB, axis: str):
    """Band streams via the DIA halo exchange; the COO remainder gathers
    from the all-gathered x (n values — the minimal correct exchange for
    arbitrary off-band columns) and scatter-adds locally."""
    band_op = _make_dia_spmv(M.band, axis)

    def op(band_data, rr, rc, rv, x):
        y = band_op(band_data, x)
        x_full = lax.all_gather(x, axis, tiled=True)
        return y.at[rr].add(rv * x_full[rc])

    return op


def _make_hyb_spmv_t(M: DistHYB, axis: str):
    band_op_t = _make_dia_spmv_t(M.band, axis)
    n = M.n

    def op_t(band_data, rr, rc, rv, x):
        y = band_op_t(band_data, x)
        # remainder entries (local row r, global col c): v·x[r] lands on
        # global row c; psum_scatter reduces the per-shard full-length
        # accumulations and hands each shard its slice
        z_full = jnp.zeros(n, dtype=y.dtype).at[rc].add(
            rv * x[rr])
        return y + lax.psum_scatter(z_full, axis, scatter_dimension=0,
                                    tiled=True)

    return op_t


def make_dist_spmv(M, axis: str):
    """Return op(*mat_leaves_local, x_local) -> y_local for a
    row-partitioned matrix (DistDIA: op(data, x); DistHYB: op(band_data,
    rem_rows, rem_cols, rem_vals, x); DistELL: op(cols, data, x)).  The
    returned closure must be called inside shard_map over ``axis`` with
    this shard's slice of each array leaf.
    """
    if isinstance(M, DistHYB):
        return _make_hyb_spmv(M, axis)
    if isinstance(M, DistDIA):
        return _make_dia_spmv(M, axis)
    P = M.nshards
    h = M.halo

    if M.mode == "halo":
        def op(cols, data, x):
            if h > 0:
                right = [(i, (i + 1) % P) for i in range(P)]
                left = [(i, (i - 1) % P) for i in range(P)]
                # my last h values go right; neighbour's arrive as my left halo
                from_left = lax.ppermute(x[-h:], axis, right)
                from_right = lax.ppermute(x[:h], axis, left)
                # ring wrap-around delivers garbage at the ends; rows never
                # reference those slots (halo feasibility guaranteed at
                # partition time for interior reaches only)
                pidx = lax.axis_index(axis)
                from_left = jnp.where(pidx == 0, jnp.zeros_like(from_left),
                                      from_left)
                from_right = jnp.where(pidx == P - 1,
                                       jnp.zeros_like(from_right), from_right)
                x_ext = jnp.concatenate([from_left, x, from_right])
            else:
                x_ext = x
            return jnp.sum(data * x_ext[cols], axis=1)
    else:
        def op(cols, data, x):
            x_full = lax.all_gather(x, axis, tiled=True)
            return jnp.sum(data * x_full[cols], axis=1)

    return op


def make_dist_spmv_t(M, axis: str):
    """Return op_t(*mat_leaves_local, x_local) -> (Aᵀx)_local — the reverse of the halo
    exchange: each shard accumulates its rows' contributions into the
    extended vector [halo_l | local | halo_r] with a segment sum, keeps the
    local part, and ships the halo accumulations to the owning neighbours
    (the mirror image of the forward ppermute shifts).  All-gather mode
    reduces the per-shard full-length accumulations with a psum_scatter.
    """
    import numpy as np

    if isinstance(M, DistHYB):
        return _make_hyb_spmv_t(M, axis)
    if isinstance(M, DistDIA):
        return _make_dia_spmv_t(M, axis)
    P = M.nshards
    h = M.halo
    R = M.rows_per_shard

    if M.mode == "halo":
        def op_t(cols, data, x):
            prod = (data * x[:, None]).ravel()
            z_ext = jax.ops.segment_sum(prod, cols.ravel(),
                                        num_segments=R + 2 * h)
            y = z_ext[h:h + R]
            if h > 0:
                left = [(i, (i - 1) % P) for i in range(P)]
                right = [(i, (i + 1) % P) for i in range(P)]
                # my left-halo accumulation belongs to my LEFT neighbour's
                # last h rows; my right-halo to my RIGHT neighbour's first h
                from_right = lax.ppermute(z_ext[:h], axis, left)
                from_left = lax.ppermute(z_ext[-h:], axis, right)
                pidx = lax.axis_index(axis)
                from_right = jnp.where(pidx == P - 1,
                                       jnp.zeros_like(from_right), from_right)
                from_left = jnp.where(pidx == 0,
                                      jnp.zeros_like(from_left), from_left)
                y = y.at[-h:].add(from_right).at[:h].add(from_left)
            return y
    else:
        def op_t(cols, data, x):
            prod = (data * x[:, None]).ravel()
            z_full = jax.ops.segment_sum(prod, cols.ravel(),
                                         num_segments=M.n)
            return lax.psum_scatter(z_full, axis, scatter_dimension=0,
                                    tiled=True)

    return op_t


class OpWithTranspose:
    """A matrix-free operator carrying its transpose — recognised by
    lssp_tpu.solvers.base.operator_t, so transpose-based Krylov methods
    (BiCG/QMR/CGNR/LSQR) work on callables that provide one."""

    def __init__(self, op, op_t):
        self._op = op
        self.t_op = op_t

    def __call__(self, x):
        return self._op(x)


def apply_dist_spmv(M_local, axis: str, x):
    """Apply a row-partitioned matrix whose array leaves are ALREADY this
    shard's slice (the shard_map-sliced pytree, e.g. a distributed-AMG
    level matrix).  Static metadata (offsets/halo/nshards) survives the
    slicing as aux data, so the right op builds from the container alone."""
    op = make_dist_spmv(M_local, axis)
    leaves, _ = jax.tree_util.tree_flatten(M_local)
    return op(*leaves, x)


def make_psum_dot(axis: str):
    """Distributed ⟨x,y⟩: local dot + psum over the mesh axis.

    Local part is multiply+sum, not jnp.dot, so no backend can route it
    through a reduced-precision matrix unit (see
    lssp_tpu.solvers.base.vdot)."""
    def dot(x, y):
        return lax.psum(jnp.sum(x * y), axis)

    def many(pairs):
        # the communication-avoiding contract (solvers/base.py dot_many):
        # all simultaneous inner products share ONE psum of the stacked
        # local partials — k products cost one latency, not k
        loc = jnp.stack([jnp.sum(a * b) for a, b in pairs])
        glob = lax.psum(loc, axis)
        return tuple(glob[i] for i in range(len(pairs)))

    dot.many = many

    def rows(V, w):
        # all ⟨V[j], w⟩ in one psum of the coefficient vector (the
        # cagmres classical-Gram-Schmidt reduction)
        return lax.psum(jnp.sum(V * w, axis=1), axis)

    dot.rows = rows
    return dot
