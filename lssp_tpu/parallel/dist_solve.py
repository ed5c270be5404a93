"""Distributed solve facade: partition on host, iterate fully sharded.

The entire Krylov iteration — including its ``lax.while_loop`` — runs inside
one ``shard_map`` over a 1-D device mesh: vectors live row-sharded, SpMV
does a neighbour halo exchange (or all-gather), and every dot/norm
lowers to a local dot + ``lax.psum``.  The same solver functions from
lssp_tpu.solvers are reused unchanged — they take the distributed operator
and psum-dot as parameters.

Distributed preconditioning is block-Jacobi ILU: each shard factors its
local diagonal block (the reference's own block machinery legitimizes this,
pc-iluk.cxx:411-552) and applies it with zero communication.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from lssp_tpu.config import SolverOptions, PCOptions, smoother_degree
from lssp_tpu.ops.trisolve import TriSchedule, level_schedule, ilu_apply
from lssp_tpu.parallel.partition import (DistELL, DistDIA, partition_csr,
                                         partition_matrix)
from lssp_tpu.parallel.dist_ops import (make_dist_spmv, make_dist_spmv_t,
                                        make_psum_dot)
from lssp_tpu.pc.ilu_host import iluk_factor, ilut_factor
from lssp_tpu.sparse.types import CSR
from lssp_tpu.sparse.utils import diagonal
from lssp_tpu.solvers.registry import get_solver, get_block_solver
from lssp_tpu.solvers.base import SolveInfo
from lssp_tpu.utils.memo import (fingerprint as _fingerprint,
                                 memo_get as _memo_get,
                                 memo_put as _memo_put)

AXIS = "shards"


def make_mesh(ndevices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if ndevices is not None:
            devices = devices[:ndevices]
    return Mesh(np.array(devices), (AXIS,))


def _extract_diag_block(A: CSR, lo: int, hi: int) -> CSR:
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    R = hi - lo
    rows = np.repeat(np.arange(lo, hi, dtype=np.int64), ip[lo + 1:hi + 1] - ip[lo:hi])
    sl = slice(ip[lo], ip[hi])
    keep = (idx[sl] >= lo) & (idx[sl] < hi)
    r = rows[keep] - lo
    c = idx[sl][keep] - lo
    v = dat[sl][keep]
    p = np.zeros(R + 1, dtype=np.int64)
    np.add.at(p, r + 1, 1)
    p = np.cumsum(p)
    return CSR(p.astype(np.int32), c.astype(np.int32), v, (R, R))


def _stack_schedules(scheds, R):
    """Pad per-shard TriSchedules to a common shape and stack (leading shard
    axis) so shard_map can slice them."""
    NL = max(s.rows.shape[0] for s in scheds)
    W = max(s.rows.shape[1] for s in scheds)
    K = max(s.cols.shape[2] for s in scheds)
    P_ = len(scheds)
    dtype = scheds[0].vals.dtype
    rows = np.full((P_, NL, W), R, dtype=np.int32)
    cols = np.full((P_, NL, W, K), R, dtype=np.int32)
    vals = np.zeros((P_, NL, W, K), dtype=dtype)
    has_diag = any(s.invdiag is not None for s in scheds)
    invd = np.ones((P_, R), dtype=dtype) if has_diag else None
    for p, s in enumerate(scheds):
        nl, w = s.rows.shape
        k = s.cols.shape[2]
        rows[p, :nl, :w] = s.rows
        cols[p, :nl, :w, :k] = s.cols
        vals[p, :nl, :w, :k] = s.vals
        if s.invdiag is not None:
            invd[p] = s.invdiag
    return rows, cols, vals, invd


@dataclasses.dataclass(frozen=True)
class _DistNeumannILU:
    """Stacked shard-local strict factors in DIA layout for Chow-sweep ILU
    application: every sweep is one shard-local diagonal stream (the
    distributed analog of ops/trisolve.NeumannTri)."""

    Ldata: Any            # (P, ndl, R) strict lower, union offsets
    Udata: Any            # (P, ndu, R) strict upper scaled by 1/diag
    invdiag: Any          # (P, R)
    offL: tuple           # static
    offU: tuple           # static
    sweeps: int           # static


jax.tree_util.register_pytree_node(
    _DistNeumannILU,
    lambda s: ((s.Ldata, s.Udata, s.invdiag), (s.offL, s.offU, s.sweeps)),
    lambda aux, c: _DistNeumannILU(*c, offL=aux[0], offU=aux[1],
                                   sweeps=aux[2]))


@dataclasses.dataclass(frozen=True)
class _DistNeumannILUDyn:
    """Per-SHARD offset sets as int32 data leaves (padded to the max
    per-shard diagonal count, zero-offset slots carry zero data): keeps
    the streaming Chow-sweep path when the cross-shard offset UNION blows
    past the static cap but each shard's own factor stays narrow — the
    unstructured-shard-blocks case that previously fell back to the slow
    exact level schedules.  Streams use dynamic rolls + iota masks
    (vectorised over the diagonal slots) instead of static shifts."""

    Ldata: Any            # (P, ndl, R) strict lower
    Loff: Any             # (P, ndl) int32
    Udata: Any            # (P, ndu, R) strict upper scaled by 1/diag
    Uoff: Any             # (P, ndu) int32
    invdiag: Any          # (P, R)
    sweeps: int           # static


jax.tree_util.register_pytree_node(
    _DistNeumannILUDyn,
    lambda s: ((s.Ldata, s.Loff, s.Udata, s.Uoff, s.invdiag), (s.sweeps,)),
    lambda aux, c: _DistNeumannILUDyn(*c, sweeps=aux[0]))


def _csr_to_dia_rows(S: CSR, offsets, R: int) -> np.ndarray:
    """Shard-local CSR → row-aligned DIA data on a FIXED offset set."""
    ip = np.asarray(S.indptr).astype(np.int64)
    rows = np.repeat(np.arange(R, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(S.indices).astype(np.int64)
    data = np.zeros((len(offsets), R), dtype=np.asarray(S.data).dtype)
    d_idx = np.searchsorted(np.asarray(offsets), cols - rows)
    data[d_idx, rows] = np.asarray(S.data)
    return data


def _build_dist_ilu_neumann(factors, Pn: int, R: int, sweeps: int,
                            max_union: int = 96):
    """Stack per-shard (L, U) factors into _DistNeumannILU, or None when
    the union diagonal count is too large for streaming (exact schedules
    then)."""
    from lssp_tpu.sparse.utils import split_ldu

    Ls_list, Us_list, inv_list = [], [], []
    offL, offU = set(), set()
    for (L, U) in factors:
        _, d, Us = split_ldu(U)
        d = np.where(np.asarray(d) == 0, 1.0, np.asarray(d))
        # cast BEFORE scaling: numpy<2 promotion would otherwise widen a
        # float32 factor to float64 and break the fp32 while_loop carry
        # (mirrors make_neumann_tri, ops/trisolve.py)
        inv = (1.0 / d).astype(np.asarray(U.data).dtype)
        ip = np.asarray(Us.indptr)
        rr = np.repeat(np.arange(R), ip[1:] - ip[:-1])
        Us_s = CSR(Us.indptr, Us.indices,
                   np.asarray(Us.data) * inv[rr], Us.shape)
        Ls, _, _ = split_ldu(L)
        Ls_list.append(Ls)
        Us_list.append(Us_s)
        inv_list.append(inv)
        for S, acc in ((Ls, offL), (Us_s, offU)):
            ipS = np.asarray(S.indptr).astype(np.int64)
            rows = np.repeat(np.arange(R, dtype=np.int64),
                             ipS[1:] - ipS[:-1])
            acc.update(np.unique(
                np.asarray(S.indices).astype(np.int64) - rows).tolist())
    offL = tuple(sorted(offL)) or (0,)
    offU = tuple(sorted(offU)) or (0,)

    def resolve_sweeps():
        if sweeps != -1:
            return int(sweeps)
        # exact via the complete Neumann series: max dependency depth
        from lssp_tpu.ops.trisolve import neumann_exact_depth
        return int(neumann_exact_depth(
            [(S.indptr, S.indices, R, lower)
             for S_list, lower in ((Ls_list, True), (Us_list, False))
             for S in S_list]))

    if len(offL) > max_union or len(offU) > max_union:
        # the union blew the static cap — per-shard offset sets keep the
        # streaming path as long as EACH shard's factor stays narrow
        def shard_offs(S):
            ipS = np.asarray(S.indptr).astype(np.int64)
            rows = np.repeat(np.arange(R, dtype=np.int64),
                             ipS[1:] - ipS[:-1])
            return np.unique(np.asarray(S.indices).astype(np.int64) - rows)
        offsL = [shard_offs(S) for S in Ls_list]
        offsU = [shard_offs(S) for S in Us_list]
        ndl = max(max((len(o) for o in offsL), default=0), 1)
        ndu = max(max((len(o) for o in offsU), default=0), 1)
        if ndl > max_union or ndu > max_union:
            return None       # a single shard is too wide even alone
        def pad(o, nd):
            # pad with offset 0 (never a STRICT-factor offset, so the
            # padding slots always carry zero data) and re-sort —
            # _csr_to_dia_rows scatters via searchsorted, which needs
            # sorted offsets and lands duplicates on the first slot
            return np.sort(np.concatenate(
                [o, np.zeros(nd - len(o), np.int64)]))
        Ldata = np.stack([_csr_to_dia_rows(S, pad(o, ndl), R)
                          for S, o in zip(Ls_list, offsL)])
        Udata = np.stack([_csr_to_dia_rows(S, pad(o, ndu), R)
                          for S, o in zip(Us_list, offsU)])
        return _DistNeumannILUDyn(
            Ldata=Ldata,
            Loff=np.stack([pad(o, ndl) for o in offsL]).astype(np.int32),
            Udata=Udata,
            Uoff=np.stack([pad(o, ndu) for o in offsU]).astype(np.int32),
            invdiag=np.stack(inv_list).astype(Ldata.dtype),
            sweeps=resolve_sweeps())
    Ldata = np.stack([_csr_to_dia_rows(S, offL, R) for S in Ls_list])
    Udata = np.stack([_csr_to_dia_rows(S, offU, R) for S in Us_list])
    return _DistNeumannILU(Ldata=Ldata, Udata=Udata,
                           invdiag=np.stack(inv_list).astype(Ldata.dtype),
                           offL=offL, offU=offU, sweeps=resolve_sweeps())


def _dia_block_apply_t(data, x, offsets):
    """Shard-local transpose DIA product (zero boundary, no exchange) —
    delegates to the one shifted-stream transpose implementation."""
    from lssp_tpu.ops.spmv import _spmv_dia_t
    from lssp_tpu.sparse.types import DIA
    R = x.shape[0]
    return _spmv_dia_t(DIA(offsets, data, (R, R)), x)


def _build_dist_pc(A: CSR, pc_type, pc_opts: PCOptions, Pn: int, R: int,
                   transpose: bool = False, sa_grid=False):
    """Returns (kind, state_pytree) where state leaves have leading shard
    axis; kind selects the inside-shard_map apply.  ``transpose`` also
    builds the shard-local M⁻ᵀ schedules (bicg/qmr/cgnr/lsqr).
    ``sa_grid``: the launcher's resolved saamg grid dims (False = flat) —
    the launcher owns the decision because the system-padding it applies
    must agree with the hierarchy's alignment plan."""
    if pc_type in (None, "none"):
        return "none", ()
    if pc_type == "jacobi":
        from lssp_tpu.config import Defaults
        d = diagonal(A).copy()
        small = np.abs(d) < Defaults.ZERO_DIAG_TOL
        d[small] = np.where(d[small] > 0, Defaults.ZERO_DIAG_VALUE,
                            -Defaults.ZERO_DIAG_VALUE)
        return "jacobi", (pc_opts.omega / d).reshape(Pn, R)
    if pc_type == "amg":
        from lssp_tpu.amg.setup import amg_setup
        from lssp_tpu.parallel.dist_amg import build_dist_amg
        hier = amg_setup(A, theta=pc_opts.amg_theta,
                         max_levels=pc_opts.amg_max_levels,
                         coarse_size=pc_opts.amg_coarse_size,
                         smooth_interp=pc_opts.amg_smooth_interp,
                         trunc=pc_opts.amg_trunc)
        h = build_dist_amg(hier, Pn, dtype=np.asarray(A.data).dtype,
                           degree=smoother_degree(
                               pc_opts.amg_presmooth,
                               pc_opts.amg_postsmooth))
        return "amg", h
    if pc_type == "rsamg":
        # distributed classical AMG: the rs hierarchy expressed as a
        # DistSA (B := P-hat, C := P-hat^T, pair-reshape agg) — executed
        # by the SAME dist_sa_vcycle; falls back to the flat saamg plan
        # when the matrix is not a shard-alignable lattice
        from lssp_tpu.parallel.dist_rs import build_dist_rs
        h = build_dist_rs(A, Pn, theta=pc_opts.amg_theta,
                          max_levels=pc_opts.amg_max_levels,
                          coarse_size=max(pc_opts.amg_coarse_size, 4 * Pn),
                          smoother=pc_opts.amg_smoother
                          if pc_opts.amg_smoother not in ("l1jacobi",
                                                          "line")
                          else "chebyshev",
                          degree=smoother_degree(pc_opts.amg_presmooth,
                                                 pc_opts.amg_postsmooth),
                          dtype=np.asarray(A.data).dtype,
                          max_pdiags=pc_opts.amg_max_pdiags)
        if h is not None:
            return "saamg", h
        from lssp_tpu.utils.log import warning
        warning("dist pc='rsamg': matrix is not a shard-alignable "
                "lattice; using the distributed structured-SA hierarchy "
                "instead")
        pc_type = "saamg"
        sa_grid = False
    if pc_type == "saamg":
        from lssp_tpu.parallel.dist_sa import build_dist_sa
        sm = pc_opts.amg_smoother
        if sm == "l1jacobi":
            sm = "jacobi"
        # "line" passes through: lines that cross shard boundaries are
        # solved exactly by the Spike substructured tridiagonal solve
        # (ops/tridiag.py: dist_pcr_solve) — no alignment restriction
        h = build_dist_sa(A, Pn, g=pc_opts.saamg_aggregate,
                          max_levels=pc_opts.amg_max_levels,
                          coarse_size=pc_opts.amg_coarse_size,
                          smoother=sm,
                          grid=sa_grid,
                          degree=smoother_degree(
                              pc_opts.amg_presmooth,
                              pc_opts.amg_postsmooth),
                          dtype=np.asarray(A.data).dtype)
        return "saamg", h
    if pc_type in ("bjilu", "iluk", "ilu0", "ilut"):
        # block-Jacobi ILU: factor each shard's diagonal block independently;
        # transposed schedules (shard-local M^-T, BiCG/QMR) only when asked
        from lssp_tpu.ops.trisolve import ilu_transpose_schedules
        factors = []
        for p in range(Pn):
            blk = _extract_diag_block(A, p * R, (p + 1) * R)
            if pc_type == "ilut":
                L, U = ilut_factor(blk, tol=pc_opts.ilut_tol, p=pc_opts.ilut_p)
            else:
                lev = 0 if pc_type == "ilu0" else pc_opts.iluk_level
                L, U = iluk_factor(blk, level=lev)
            factors.append((L, U))
        # triangular-solve strategy mirrors the single-device PC
        # (pc/ilu.py: make_ilu_pc): exact level scan by default, k > 0
        # Chow Neumann sweeps (each a shard-local DIA stream), -1 = exact
        # via the complete series
        from lssp_tpu.ops.trisolve import default_ilu_sweeps
        sweeps = pc_opts.ilu_sweeps
        if sweeps is None:
            sweeps = default_ilu_sweeps()
        if sweeps:
            st = _build_dist_ilu_neumann(factors, Pn, R, sweeps)
            if st is not None:
                return ("ilu_nmd" if isinstance(st, _DistNeumannILUDyn)
                        else "ilu_nm"), st
            from lssp_tpu.utils.log import warning
            warning("distributed ILU: a single shard's factor exceeds the "
                    "streaming diagonal cap — falling back to exact level "
                    "schedules (slow scan path); consider RCM ordering or "
                    "more shards")
        sls, sus, slts, suts = [], [], [], []
        for (L, U) in factors:
            sls.append(level_schedule(L, lower=True))
            sus.append(level_schedule(U, lower=False))
            if transpose:
                sut, slt = ilu_transpose_schedules(L, U)
                suts.append(sut)
                slts.append(slt)
        state = (_stack_schedules(sls, R), _stack_schedules(sus, R))
        if transpose:
            state = state + (_stack_schedules(suts, R),
                             _stack_schedules(slts, R))
        return "ilu", state
    raise ValueError(f"unsupported distributed pc {pc_type!r}")


def _sweep_repeat(step, k: int, x0):
    """k applications of ``step`` — unrolled for the common small counts,
    a single XLA while for large ones (exact Neumann depths can reach the
    hundreds; unrolling those made compile time explode)."""
    if k <= 8:
        x = x0
        for _ in range(k):
            x = step(x)
        return x
    return jax.lax.fori_loop(0, k, lambda _, x: step(x), x0)


def _shard_pc_apply(kind, state, R, op=None, cycles=1):
    if kind == "none":
        fn = lambda r: r
        fn.t = fn                     # identity is symmetric
        return fn
    if kind == "jacobi":
        inv = state
        fn = lambda r: inv * r
        fn.t = fn                     # diagonal scaling is symmetric
        return fn
    if kind == "ilu_nm":
        from lssp_tpu.ops.spmv import spmv
        from lssp_tpu.sparse.types import DIA
        st = state

        def _stream(data, offs, v):
            return spmv(DIA(offs, data, (R, R)), v)

        def fn(r):
            y = _sweep_repeat(lambda y: r - _stream(st.Ldata, st.offL, y),
                              st.sweeps, r)
            zr = st.invdiag * y
            return _sweep_repeat(
                lambda z: zr - _stream(st.Udata, st.offU, z), st.sweeps, zr)

        def fnt(r):
            w = _sweep_repeat(
                lambda w: r - _dia_block_apply_t(st.Udata, w, st.offU),
                st.sweeps, r)
            zr = st.invdiag * w
            return _sweep_repeat(
                lambda z: zr - _dia_block_apply_t(st.Ldata, z, st.offL),
                st.sweeps, zr)

        fn.t = fnt        # Neumann transpose needs no extra state
        return fn
    if kind == "ilu_nmd":
        st = state
        idx = jnp.arange(R)

        def _stream_dyn(data, offs, v):
            # y[i] = sum_k data[k, i] * v[i + off_k]: dynamic roll + iota
            # mask per diagonal slot, vectorised over the (per-shard)
            # offset axis — offsets are DATA here, not static shifts.
            # Lowering note vs the never-gather law: a dynamic roll is
            # concatenate + CONTIGUOUS dynamic-slice (vmapped: one whole-
            # row slice per diagonal, nd ≤ 96 of them), not the per-
            # element random gather the law bans (the 340×-slower class
            # was n·k random element gathers).  Still second-best to the
            # static-shift stream — used only when shard offset sets
            # genuinely differ.
            sh = jax.vmap(lambda o: jnp.roll(v, -o))(offs)     # (nd, R)
            valid = (idx[None, :] + offs[:, None] >= 0) \
                & (idx[None, :] + offs[:, None] < R)
            return jnp.sum(data * jnp.where(valid, sh, 0.0), axis=0)

        def _stream_dyn_t(data, offs, v):
            # y[j] = sum_k data[k, j - off_k] * v[j - off_k]
            w = data * v[None, :]
            sh = jax.vmap(jnp.roll)(w, offs)                   # (nd, R)
            valid = (idx[None, :] - offs[:, None] >= 0) \
                & (idx[None, :] - offs[:, None] < R)
            return jnp.sum(jnp.where(valid, sh, 0.0), axis=0)

        def fn(r):
            y = _sweep_repeat(
                lambda y: r - _stream_dyn(st.Ldata, st.Loff, y),
                st.sweeps, r)
            zr = st.invdiag * y
            return _sweep_repeat(
                lambda z: zr - _stream_dyn(st.Udata, st.Uoff, z),
                st.sweeps, zr)

        def fnt(r):
            w = _sweep_repeat(
                lambda w: r - _stream_dyn_t(st.Udata, st.Uoff, w),
                st.sweeps, r)
            zr = st.invdiag * w
            return _sweep_repeat(
                lambda z: zr - _stream_dyn_t(st.Ldata, st.Loff, z),
                st.sweeps, zr)

        fn.t = fnt
        return fn
    if kind == "ilu":
        (lr, lc, lv, lid), (ur, uc, uv, uid) = state[:2]
        sl = TriSchedule(rows=lr, cols=lc, vals=lv, invdiag=lid, n=R)
        su = TriSchedule(rows=ur, cols=uc, vals=uv, invdiag=uid, n=R)
        fn = lambda r: ilu_apply(sl, su, r)
        if len(state) == 4:
            ut, lt_ = state[2], state[3]
            sut = TriSchedule(rows=ut[0], cols=ut[1], vals=ut[2],
                              invdiag=ut[3], n=R)
            slt = TriSchedule(rows=lt_[0], cols=lt_[1], vals=lt_[2],
                              invdiag=lt_[3], n=R)
            # attach M^-T (pc_transpose picks up the .t attribute)
            from lssp_tpu.ops.trisolve import ilu_apply_t
            fn.t = lambda r: ilu_apply_t(sut, slt, r)
        return fn
    if kind in ("amg", "saamg"):
        if kind == "amg":
            from lssp_tpu.parallel.dist_amg import dist_vcycle as vcycle
        else:
            from lssp_tpu.parallel.dist_sa import dist_sa_vcycle as vcycle
        if cycles <= 1:
            return lambda r: vcycle(state, r, AXIS)

        def apply_mg(r):
            # further cycles refine on the residual via the distributed
            # operator (same net effect as the single-device warm-started
            # V-cycle in _saamg_apply / pc/amg.py)
            z = vcycle(state, r, AXIS)
            for _ in range(cycles - 1):
                z = z + vcycle(state, r - op(z), AXIS)
            return z
        return apply_mg
    raise ValueError(kind)


def _shard_ir(op32, op64, pc_apply, fn, block_fn, b, x0, opts, inner_opts,
              max_outer, inner_dtype, pdot, multi):
    """Mixed-precision refinement loop INSIDE the shard body: fp64 outer
    residuals via the fp64-partitioned distributed operator, fp32 inner
    Krylov shard program, fp64 accumulation.  Mirrors
    solvers/refine.py:_fused_ir(_multi) with psum reductions; converged
    columns are frozen (zero inner rhs) exactly as in solve_ir_multi."""
    x = jnp.zeros_like(b) if x0 is None else x0

    if multi:
        def norms(V):                     # per-column, ONE stacked psum
            return jnp.sqrt(jax.lax.psum(jnp.sum(V * V, axis=0), AXIS))
        op64_b = jax.vmap(op64, in_axes=1, out_axes=1)
        k = b.shape[1]
        tot0 = jnp.zeros(k, jnp.int32)
    else:
        def norms(v):
            return jnp.sqrt(pdot(v, v))
        op64_b = op64
        tot0 = jnp.int32(0)

    bnorm = norms(b)
    r0 = norms(b - op64_b(x))
    tol = jnp.maximum(opts.rtol * bnorm, opts.atol)

    def cond(c):
        x, res, outer, tot = c
        return jnp.any(res > tol) & (outer < max_outer)

    def body(c):
        x, res, outer, tot = c
        r = b - op64_b(x)
        scale = norms(r)
        safe = jnp.where(scale == 0, 1.0, scale)
        if multi:
            active = scale > tol
            r32 = jnp.where(active[None, :],
                            r / safe[None, :], 0.0).astype(inner_dtype)
            if block_fn is not None:
                d32, info = block_fn(op32, r32, jnp.zeros_like(r32),
                                     M=pc_apply, opts=inner_opts,
                                     reduce=lambda v: jax.lax.psum(v, AXIS))
            else:
                def one(rc):
                    return fn(op32, rc, jnp.zeros_like(rc), pc_apply,
                              opts=inner_opts, dot=pdot)
                d32, info = jax.vmap(one, in_axes=1, out_axes=(1, 0))(r32)
            x = x + d32.astype(jnp.float64) * safe[None, :]
        else:
            r32 = (r / safe).astype(inner_dtype)
            d32, info = fn(op32, r32, jnp.zeros_like(r32), pc_apply,
                           opts=inner_opts, dot=pdot)
            x = x + d32.astype(jnp.float64) * safe
        res = norms(b - op64_b(x))
        return (x, res, outer + 1, tot + info.nits)

    x, res, _, tot = jax.lax.while_loop(cond, body, (x, r0, jnp.int32(0),
                                                     tot0))
    return x, SolveInfo(nits=tot, residual=res, converged=res <= tol,
                        r0norm=r0, bnorm=bnorm, history=None)


def _grow_identity(A: CSR, extra: int) -> CSR:
    """Identity-row padding of the MATRIX (unit diagonal); the launcher
    pads the rhs/x0 with zero rows to match — padded components start at
    0 and stay 0 through every Krylov recurrence."""
    from lssp_tpu.amg.sa import _pad_identity
    return CSR.from_scipy(_pad_identity(A.to_scipy().tocsr(), extra))


def _dist_sizing(A: CSR, n_orig: int, Pn: int, pc, pc_opts, fp):
    """Resolve (sa_grid, npad).  saamg: a shard-aligned grid hierarchy
    (gy % P == 0) needs no padding at all — every level's reshape groups
    are whole by construction; otherwise pad to the flat plan's P·g^L
    multiple; other PCs pad to the device-count multiple.  detect_grid is
    an O(nnz) host scan, so the result is memoized per container (same
    fingerprint discipline as _prepare_dist — re-solves must be
    rhs-work only).  Sizing plans are a few scalars, so they live in
    their own UNBOUNDED cache attr — the bounded program cache's LRU
    eviction must never cost a detect_grid re-scan."""
    if pc != "saamg":
        return False, (-n_orig) % Pn if n_orig % Pn else 0

    from lssp_tpu.solvers.refine import _pc_options_key

    key = (Pn, _pc_options_key(pc_opts))
    hit = _memo_get(A, "_dist_sizing_cache", key, fp)
    if hit is not None:
        return hit

    from lssp_tpu.amg.sa import detect_grid
    sa_grid, npad = False, 0
    g0 = pc_opts.saamg_grid
    if g0 is None:
        g0 = detect_grid(A)
    elif g0 is False or (g0 is not None and g0[0] * g0[1] != n_orig):
        g0 = None
    if (g0 is not None and n_orig % Pn == 0 and g0[0] % Pn == 0):
        sa_grid = tuple(g0)
    else:
        from lssp_tpu.parallel.dist_sa import planned_padded_size
        n0 = planned_padded_size(n_orig, Pn, g=pc_opts.saamg_aggregate,
                                 coarse_size=pc_opts.amg_coarse_size,
                                 max_levels=pc_opts.amg_max_levels)
        npad = n0 - n_orig
    _memo_put(A, "_dist_sizing_cache", key, fp, (sa_grid, npad))
    return sa_grid, npad


def _prepare_dist(A: CSR, mesh, Pn, fmt, method, pc, pc_opts, opts,
                  multi, ir, inner_rtol, max_outer, inner_dtype,
                  transpose_method, sa_grid, npad, fp):
    """The rhs-independent half of a distributed solve — identity
    padding, per-shard PC build, matrix partitioning (both precisions
    for ir), and the COMPILED shard_map program — memoized per container
    with a content fingerprint (same pattern as facade._prepare_matrix).
    Production re-solves with a new rhs skip repartitioning,
    refactoring, re-upload, AND retracing: each was measured to dominate
    warm time-to-solution on the single-device path (CLAUDE.md).
    Bounded (LRU, 8 entries): each entry pins device copies of the
    partitioned matrix (two for ir), the PC state, and a compiled
    executable — a serving process varying options per request must not
    exhaust HBM (same rationale as the facade's lru_cache(maxsize=64))."""
    from lssp_tpu.solvers.refine import _pc_options_key

    key = (mesh, Pn, fmt, method, pc, _pc_options_key(pc_opts), opts,
           multi, ir, float(inner_rtol), int(max_outer),
           str(np.dtype(inner_dtype)), transpose_method, sa_grid, npad,
           jax.default_backend())
    hit = _memo_get(A, "_dist_cache", key, fp)
    if hit is not None:
        return hit
    out = _build_dist_program(A, mesh, Pn, fmt, method, pc, pc_opts,
                              opts, multi, ir, inner_rtol, max_outer,
                              inner_dtype, transpose_method, sa_grid,
                              npad)
    _memo_put(A, "_dist_cache", key, fp, out, bound=8)
    return out


def _build_dist_program(A: CSR, mesh, Pn, fmt, method, pc, pc_opts, opts,
                        multi, ir, inner_rtol, max_outer, inner_dtype,
                        transpose_method, sa_grid, npad):
    if npad:
        A = _grow_identity(A, npad)
    n = A.shape[0]
    R = n // Pn
    # ir: the preconditioner (and the solve matrix below) live in the
    # inner dtype — factors, hierarchies, and the hot SpMV all run fp32
    pc_src = A.astype(np.dtype(inner_dtype)) if ir else A
    kind, pc_state = _build_dist_pc(pc_src, pc, pc_opts, Pn, R,
                                    transpose=transpose_method,
                                    sa_grid=sa_grid)
    if kind == "saamg" and pc_state.n_top != n:
        # grid coarsening stalled inside build_dist_sa and the hierarchy
        # fell back to the flat plan, padding itself — grow the system to
        # the hierarchy's size (result slicing uses n_orig either way)
        A = _grow_identity(A, pc_state.n_top - n)
        n = A.shape[0]
        R = n // Pn
    M = partition_matrix(A.astype(np.dtype(inner_dtype)) if ir else A,
                         Pn, fmt=fmt)
    M64 = partition_matrix(A, Pn, fmt=fmt) if ir else None
    if ir:
        from lssp_tpu.solvers.refine import _inner_plan
        if not multi and get_block_solver(method) is not None:
            raise ValueError(f"{method!r} is a multi-rhs block method; "
                             "use dist_solve_ir_multi")
        inner_fn, solver_opts = _inner_plan(method, opts, inner_rtol)
        block = multi and get_block_solver(method) is not None
        block_fn = inner_fn if block else None
        fn = None if block else inner_fn
    else:
        solver_opts = opts
        block_fn = get_block_solver(method) if multi else None
        block = block_fn is not None
        fn = None if block else get_solver(method)

    spmv_impl = make_dist_spmv(M, AXIS)
    pdot = make_psum_dot(AXIS)
    spmv_t_impl = (make_dist_spmv_t(M, AXIS) if transpose_method else None)
    spmv64_impl = make_dist_spmv(M64, AXIS) if ir else None
    mat_leaves, _ = jax.tree_util.tree_flatten(M)
    nleaf = len(mat_leaves)
    mat64_leaves = (jax.tree_util.tree_flatten(M64)[0] if ir else [])
    nleaf64 = len(mat64_leaves)

    def body(*args):
        # shard_map passes (1, ...)-shaped slices; drop the shard axis
        mat_l = [a[0] for a in args[:nleaf]]
        mat64_l = [a[0] for a in args[nleaf:nleaf + nleaf64]]
        b_sh, x0_sh, pc_state_sh = args[nleaf + nleaf64:]
        pc_state_l = jax.tree_util.tree_map(lambda a: a[0], pc_state_sh)
        op = lambda x: spmv_impl(*mat_l, x)
        if transpose_method:
            from lssp_tpu.parallel.dist_ops import OpWithTranspose
            op = OpWithTranspose(op,
                                 lambda x: spmv_t_impl(*mat_l, x))
        pc_apply = _shard_pc_apply(kind, pc_state_l, R, op=op,
                                   cycles=max(1, int(pc_opts.amg_cycles)))
        if ir:
            op64 = lambda x: spmv64_impl(*mat64_l, x)
            x, info = _shard_ir(op, op64, pc_apply, fn, block_fn,
                                b_sh[0], x0_sh[0], opts, solver_opts,
                                max_outer, inner_dtype, pdot, multi)
            return x[None], info
        if multi:
            if block:
                # block-Krylov shard program: the stacked Grams and
                # residual norms reduce in ONE psum each — the multi-chip
                # latency win compounds with the shared-search-block
                # convergence win (solvers/block_cg.py, block_gmres.py)
                X, info = block_fn(op, b_sh[0], x0_sh[0], M=pc_apply,
                                   opts=opts,
                                   reduce=lambda v: jax.lax.psum(v, AXIS))
                return X[None], info
            def one(bl, x0l):
                return fn(op, bl, x0l, pc_apply, opts=opts, dot=pdot)
            X, info = jax.vmap(one, in_axes=1, out_axes=(1, 0))(b_sh[0],
                                                                x0_sh[0])
            return X[None], info
        x, info = fn(op, b_sh[0], x0_sh[0], pc_apply, opts=opts, dot=pdot)
        return x[None], info

    in_specs = tuple(P(AXIS) for _ in range(nleaf + nleaf64)) + (
        P(AXIS), P(AXIS),
        jax.tree_util.tree_map(lambda _: P(AXIS), pc_state))
    out_specs = (P(AXIS), jax.tree_util.tree_map(lambda _: P(), SolveInfo(
        nits=0, residual=0.0, converged=False, r0norm=0.0, bnorm=0.0,
        history=(0.0 if opts.record_history and not ir
                 else None))))

    mapped = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
    return dict(n=n, R=R, pc_state=pc_state, mat_leaves=mat_leaves,
                mat64_leaves=mat64_leaves, run=jax.jit(mapped))


def _dist_launch(A: CSR, b, x0, method: str, pc, mesh,
                 options, pc_options, fmt: str, multi: bool,
                 ir: bool = False, inner_rtol: float = 1e-3,
                 max_outer: int = 20, inner_dtype=jnp.float32):
    """The one distributed launcher, parameterized on the rhs rank:
    ``multi=False`` solves b (n,); ``multi=True`` solves B (n, k) with the
    Krylov iteration vmapped over columns inside the same shard_map body
    (the matrix streams once per iteration for all rhs, psum dots batch).
    ``ir=True`` runs mixed-precision iterative refinement INSIDE the shard
    body: fp64 outer residuals through a second fp64-partitioned matrix,
    fp32 inner Krylov solves (the PC is factored/built in fp32), fp64
    accumulation (same policy as solvers/refine.py, one shared
    _inner_plan).
    dist_solve / dist_solve_multi / dist_solve_ir* are thin wrappers."""
    opts = (options or SolverOptions()).resolved()
    pc_opts = (pc_options or PCOptions()).resolved()
    # backends without host callbacks can't run jax.debug.print inside the
    # shard_map'd iteration: record the (shard-replicated) residual trace
    # and print it host-side after the solve, as the facade does
    from lssp_tpu.utils.log import device_print_supported
    host_trace = (opts.verbosity >= 1 and not ir
                  and not device_print_supported())   # ir: no inner trace
    user_history = opts.record_history
    if host_trace and not opts.record_history:
        opts = dataclasses.replace(opts, record_history=True)
    from lssp_tpu.solvers.facade import needs_transpose_pc
    transpose_method = needs_transpose_pc(method)
    if transpose_method and pc not in (None, "none", "jacobi", "bjilu",
                                       "iluk", "ilu0", "ilut"):
        raise ValueError(
            f"distributed {method} supports pc in (none, jacobi, bjilu/"
            "ilu*) — amg/saamg have no distributed transpose apply")
    if mesh is None:
        mesh = make_mesh()
    Pn = mesh.devices.size

    b = jnp.asarray(b, jnp.float64) if ir else jnp.asarray(b)
    if multi:
        if b.ndim != 2:
            raise ValueError(f"B must be (n, k), got {b.shape}")
        n_orig, k = b.shape
    else:
        n_orig, k = b.shape[0], None
    if n_orig != A.shape[0]:
        # must raise, not pad: the identity-padding below is ONLY for the
        # launcher's own growth (device-count multiple / saamg plan) — a
        # short user rhs silently zero-filled against real matrix rows
        # would return a wrong answer
        raise ValueError(f"rhs length {n_orig} != matrix rows {A.shape[0]}")
    if x0 is not None:
        x0 = jnp.asarray(x0, jnp.float64) if ir else jnp.asarray(x0)
        if x0.shape != b.shape:
            raise ValueError(f"x0 must match the rhs shape {b.shape}, "
                             f"got {x0.shape}")

    # system sizing.  saamg: a shard-aligned grid hierarchy (gy % P == 0)
    # needs no padding at all — every level's reshape groups are whole by
    # construction; otherwise pad to the flat plan's P·g^L multiple.  The
    # launcher resolves the grid and passes it DOWN to build_dist_sa so
    # the padding decision and the hierarchy's alignment plan cannot skew.
    fp = _fingerprint(A)     # ONE content scan shared by both memo lookups
    sa_grid, npad = _dist_sizing(A, n_orig, Pn, pc, pc_opts, fp)
    prep = _prepare_dist(A, mesh, Pn, fmt, method, pc, pc_opts, opts,
                         multi, ir, inner_rtol, max_outer, inner_dtype,
                         transpose_method, sa_grid, npad, fp)
    n, R = prep["n"], prep["R"]
    extra = n - n_orig
    if extra:
        pad_shape = (extra, k) if multi else (extra,)
        b = jnp.concatenate([b, jnp.zeros(pad_shape, dtype=b.dtype)],
                            axis=0)
        if x0 is not None:
            x0 = jnp.concatenate([x0, jnp.zeros(pad_shape,
                                                dtype=x0.dtype)], axis=0)
    shp = (Pn, R, k) if multi else (Pn, R)
    b2 = jnp.asarray(np.asarray(b).reshape(shp))
    x02 = (jnp.zeros_like(b2) if x0 is None
           else jnp.asarray(np.asarray(x0).reshape(shp)))
    x_sh, info = prep["run"](*prep["mat_leaves"], *prep["mat64_leaves"],
                             b2, x02, prep["pc_state"])
    if host_trace:
        from lssp_tpu.solvers.base import (history_print_host,
                                           history_print_host_multi)
        if multi:
            history_print_host_multi(info, k)
        else:
            history_print_host(info)
        if not user_history:
            info = dataclasses.replace(info, history=None)
    if multi:
        return jnp.reshape(x_sh, (n, k))[:n_orig, :], info
    return jnp.reshape(x_sh, (n,))[:n_orig], info


def dist_solve(A: CSR, b, x0=None, method: str = "cg",
               pc: Optional[str] = "none", mesh: Optional[Mesh] = None,
               options: Optional[SolverOptions] = None,
               pc_options: Optional[PCOptions] = None, fmt: str = "auto"):
    """Distributed Ax=b over a 1-D mesh.  Returns (x (n,), SolveInfo).

    ``fmt`` selects the distributed execution format: "auto" prefers
    gather-free DIA streaming (banded matrices), falling
    back to padded-ELL halo exchange, then all-gather; "dia"/"halo"/
    "allgather" force one.  ``n`` need not divide the device count — rows
    are padded with identity equations (zero rhs) to the next multiple.
    """
    return _dist_launch(A, b, x0, method, pc, mesh, options, pc_options,
                        fmt, multi=False)


def dist_solve_multi(A: CSR, B, X0=None, method: str = "cg",
                     pc: Optional[str] = "none",
                     mesh: Optional[Mesh] = None,
                     options: Optional[SolverOptions] = None,
                     pc_options: Optional[PCOptions] = None,
                     fmt: str = "auto"):
    """Distributed A·X = B for k right-hand sides (B: (n, k)) — the
    row-sharded analog of ``solve_multi``: ONE shard_map program whose
    body vmaps the Krylov iteration over the rhs columns, so the
    partitioned matrix streams once per iteration for all rhs and the
    psum dots batch over k.  Returns (X (n, k), SolveInfo with (k,)
    fields).  Shares the full dist_solve method × pc matrix (including
    saamg and the transpose methods with shard-local M⁻ᵀ)."""
    return _dist_launch(A, B, X0, method, pc, mesh, options, pc_options,
                        fmt, multi=True)


def dist_solve_ir(A: CSR, b, x0=None, method: str = "gmres",
                  pc: Optional[str] = "none", mesh: Optional[Mesh] = None,
                  options: Optional[SolverOptions] = None,
                  pc_options: Optional[PCOptions] = None, fmt: str = "auto",
                  inner_rtol: float = 1e-3, max_outer: int = 20,
                  inner_dtype=jnp.float32):
    """Distributed mixed-precision refinement: fp64-quality x over the
    mesh with the hot Krylov loop in fp32 (factors, hierarchy, SpMV all
    inner-dtype), moving half the bytes of an fp64 solve.  The ENTIRE
    refinement (fp64 distributed residuals, fp32 inner
    shard program, fp64 accumulation) is one shard_map program.  Same
    inner policy as ``lssp_tpu.solve_ir`` (right-preconditioned mapping,
    stall-bounded inner cap); ``nits`` counts total inner iterations."""
    return _dist_launch(A, b, x0, method, pc, mesh, options, pc_options,
                        fmt, multi=False, ir=True, inner_rtol=inner_rtol,
                        max_outer=max_outer, inner_dtype=inner_dtype)


def dist_solve_ir_multi(A: CSR, B, X0=None, method: str = "blockgmres",
                        pc: Optional[str] = "none",
                        mesh: Optional[Mesh] = None,
                        options: Optional[SolverOptions] = None,
                        pc_options: Optional[PCOptions] = None,
                        fmt: str = "auto", inner_rtol: float = 1e-3,
                        max_outer: int = 20, inner_dtype=jnp.float32):
    """Distributed multi-rhs mixed-precision refinement (B: (n, k)) — the
    row-sharded ``solve_ir_multi``: per-column fp64 residuals, ONE fp32
    inner solve per round for the whole block (default: the blockgmres
    shared-basis inner — every reduction a single stacked psum), converged
    columns frozen.  Returns (X (n, k) fp64, SolveInfo with (k,) fields
    counting total inner iterations)."""
    return _dist_launch(A, B, X0, method, pc, mesh, options, pc_options,
                        fmt, multi=True, ir=True, inner_rtol=inner_rtol,
                        max_outer=max_outer, inner_dtype=inner_dtype)
