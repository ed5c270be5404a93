"""Level-scheduled sparse triangular solve.

The reference's forward/backward substitution
(/root/reference/src/solver-tri.cxx:4-60) is a sequential row recurrence —
unrunnable as-is on a data-parallel machine.  Redesign (SURVEY §7 "hard
parts"):

1. **Host (once, at PC assemble):** compute each row's *level* — the longest
   dependency chain ending at that row.  Rows within one level are mutually
   independent.
2. **Device (every solve):** one `lax.scan` over levels; each step gathers the
   off-diagonal entries of that level's rows (pre-padded to rectangular
   shape), forms ``s = b[rows] − Σ vals·x[cols]`` as a vectorized gather +
   row-sum, scales by 1/diag, and scatters into x.  The only sequential axis
   left is the level count (≈ the dependency-graph depth, e.g. 2N−1 for a
   2-D N×N 5-point grid), each step being full-width vector work.

Padded slots use row index n / column index n pointing at a dummy slot, so
the device code needs no masking.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lssp_tpu.sparse.types import CSR
from lssp_tpu.sparse.utils import split_ldu


@dataclasses.dataclass(frozen=True)
class TriSchedule:
    """Device-ready level schedule for one triangular factor."""

    rows: Any           # (nlev, w) int32, padded with n
    cols: Any           # (nlev, w, k) int32, padded with n
    vals: Any           # (nlev, w, k), padded with 0
    invdiag: Any        # (n,) 1/diag, or None for unit-diagonal factors
    n: int              # static

    @property
    def nlevels(self) -> int:
        return int(self.rows.shape[0])


def _flatten(s):
    return (s.rows, s.cols, s.vals, s.invdiag), (s.n,)


def _unflatten(aux, leaves):
    return TriSchedule(*leaves, n=aux[0])


jax.tree_util.register_pytree_node(TriSchedule, _flatten, _unflatten)


def _compute_levels(indptr, indices, n, lower: bool) -> np.ndarray:
    """Longest-dependency-chain level per row (host, sequential; C++ fast
    path in lssp_tpu.native when available)."""
    from lssp_tpu import native
    if native.available():
        return native.levels(np.ascontiguousarray(indptr, np.int64),
                             np.ascontiguousarray(indices, np.int64),
                             n, lower)
    lev = np.zeros(n, dtype=np.int64)
    ip = indptr
    idx = indices
    if lower:
        for i in range(n):
            s, e = ip[i], ip[i + 1]
            if e > s:
                m = lev[idx[s:e]].max()
                lev[i] = m + 1
    else:
        for i in range(n - 1, -1, -1):
            s, e = ip[i], ip[i + 1]
            if e > s:
                m = lev[idx[s:e]].max()
                lev[i] = m + 1
    return lev


def default_ilu_sweeps() -> int:
    """The ilu_sweeps=None resolution, shared by every ILU family (scalar,
    block, distributed): exact level-scheduled solves."""
    return 0


def neumann_exact_depth(tris) -> int:
    """Dependency depth over strict triangular factors, given as
    (indptr, indices, n, lower) tuples — the sweep count at which the
    finite Neumann series of every factor terminates EXACTLY (the
    ilu_sweeps=-1 contract, shared by the scalar/block/distributed
    paths)."""
    depth = 1
    for ip, idx, n, lower in tris:
        lev = _compute_levels(np.asarray(ip, np.int64),
                              np.asarray(idx, np.int64), n, lower)
        depth = max(depth, int(lev.max()) + 1 if len(lev) else 1)
    return depth


def level_schedule(T: CSR, lower: bool = True,
                   diag: Optional[np.ndarray] = None) -> TriSchedule:
    """Build a TriSchedule from a triangular CSR factor.

    ``T`` may include the diagonal; it is split off automatically.  For
    unit-diagonal factors pass a factor with no stored diagonal and leave
    ``diag=None``.
    """
    n = T.shape[0]
    Ls, d, Us = split_ldu(T)
    S = Ls if lower else Us
    if diag is None and np.any(d != 0):
        diag = d
    ip = np.asarray(S.indptr).astype(np.int64)
    idx = np.asarray(S.indices).astype(np.int64)
    dat = np.asarray(S.data)

    lev = _compute_levels(ip, idx, n, lower)
    nlev = int(lev.max()) + 1 if n else 1
    order = np.argsort(lev, kind="stable")
    counts = np.bincount(lev, minlength=nlev)
    w = max(1, int(counts.max()))
    k = max(1, int((ip[1:] - ip[:-1]).max()) if n else 1)

    rows = np.full((nlev, w), n, dtype=np.int32)
    cols = np.full((nlev, w, k), n, dtype=np.int32)
    vals = np.zeros((nlev, w, k), dtype=dat.dtype)
    starts = np.concatenate([[0], np.cumsum(counts)])
    # vectorized construction: slot of each (level-ordered) row within its
    # level, then one padded-ELL expansion of S scattered by (level, slot)
    slots = np.arange(n, dtype=np.int64) - starts[lev[order]]
    rows[lev[order], slots] = order
    rn = ip[1:] - ip[:-1]
    valid = np.arange(k)[None, :] < rn[:, None]                # (n, k)
    flat = (ip[:-1][:, None] + np.arange(k)[None, :])[valid]
    ell_cols = np.full((n, k), n, dtype=np.int64)
    ell_vals = np.zeros((n, k), dtype=dat.dtype)
    ell_cols[valid] = idx[flat]
    ell_vals[valid] = dat[flat]
    cols[lev[order], slots] = ell_cols[order]
    vals[lev[order], slots] = ell_vals[order]

    invd = None
    if diag is not None:
        invd = (1.0 / np.asarray(diag)).astype(dat.dtype)
    return TriSchedule(rows=rows, cols=cols, vals=vals, invdiag=invd, n=n)


def _sweep(sched: TriSchedule, b):
    n = sched.n
    be = jnp.concatenate([b, jnp.zeros(1, dtype=b.dtype)])
    if sched.invdiag is not None:
        ide = jnp.concatenate([sched.invdiag,
                               jnp.ones(1, dtype=sched.invdiag.dtype)])
    else:
        ide = None

    def step(xe, level):
        rows, cols, vals = level
        xv = xe[cols]                                  # (w, k) gather
        s = be[rows] - jnp.sum(vals * xv, axis=1)
        if ide is not None:
            s = s * ide[rows]
        xe = xe.at[rows].set(s)
        return xe, None

    # NB: two independent copies of this scan in one jit program were
    # miscompiled by XLA CPU's concurrency-optimized scheduler (shared
    # scratch raced; O(1)-wrong product-type solves).  lssp_tpu/__init__.py
    # disables that scheduler; tests/test_ops.py::TestTriSweepCarryMiscompile
    # pins the failing pattern.
    x0 = jnp.zeros(n + 1, dtype=b.dtype)
    xe, _ = jax.lax.scan(step, x0, (sched.rows, sched.cols, sched.vals))
    return xe[:n]


def trisolve_lower_unit(sched: TriSchedule, b):
    """Solve L x = b with unit-diagonal lower L (reference forward solve,
    solver-tri.cxx:4-24)."""
    return _sweep(sched, b)


def trisolve_upper(sched: TriSchedule, b):
    """Solve U x = b with U holding its diagonal (reference backward solve,
    solver-tri.cxx:26-46)."""
    return _sweep(sched, b)


def ilu_apply(sched_l: TriSchedule, sched_u: TriSchedule, r):
    """z = U⁻¹ (L⁻¹ r) — the PC application contract
    (reference lssp_pc_ilu_solve, solver-tri.cxx:48-60)."""
    return trisolve_upper(sched_u, trisolve_lower_unit(sched_l, r))


def ilu_apply_t(sched_ut: TriSchedule, sched_lt: TriSchedule, r):
    """z = M⁻ᵀ r = L⁻ᵀ (U⁻ᵀ r) for M = LU (needed by BiCG/QMR).

    ``sched_ut`` is the level schedule of Uᵀ (lower-triangular, carries the
    diagonal), ``sched_lt`` of Lᵀ (upper-triangular, unit diagonal)."""
    return _sweep(sched_lt, _sweep(sched_ut, r))


def ilu_transpose_schedules(L: CSR, U: CSR):
    """Level schedules for the transposed factors (host, once)."""
    from lssp_tpu.sparse.utils import transpose
    sut = level_schedule(transpose(U), lower=True)
    slt = level_schedule(transpose(L), lower=False)
    return sut, slt


def make_ilu_apply(L: CSR, U: CSR):
    """Build schedules from L (strict lower, unit diag) and U (with diag) and
    return a jit-friendly ``apply(r) -> z`` closure."""
    sl = level_schedule(L, lower=True)
    su = level_schedule(U, lower=False)
    return lambda r: ilu_apply(sl, su, r)


# ---------------------------------------------------------------------------
# Iterative (Neumann / Jacobi-sweep) triangular solves — Chow-style.
#
# The level-scheduled sweep is exact but serializes on the level count
# (hundreds of tiny device steps).  For unit-lower L = I + Ls the inverse is
# the finite Neumann series Σ (−Ls)^m, so k sweeps of  y ← b − Ls·y  give a
# degree-k truncation — every sweep is ONE full-width SpMV with the strict
# factor in its DIA/ELL execution format, i.e. it runs at SpMV speed
# instead of level-by-level.  Truncation makes the PC approximate
# (slightly more Krylov iterations), the standard GPU trade
# (Chow & Patel, "Fine-grained parallel incomplete LU", SISC 2015 — see
# PAPERS.md "Parallel Triangular Solvers on GPU").
# ---------------------------------------------------------------------------

import dataclasses as _dc


@_dc.dataclass(frozen=True)
class NeumannTri:
    """State for iterative triangular ILU application."""

    Ls: Any         # strict lower factor, device format (DIA/ELL)
    Us: Any         # strict upper factor scaled by 1/diag, device format
    invdiag: Any    # (n,)
    sweeps: int     # static


jax.tree_util.register_pytree_node(
    NeumannTri,
    lambda s: ((s.Ls, s.Us, s.invdiag), (s.sweeps,)),
    lambda aux, c: NeumannTri(*c, sweeps=aux[0]))


def make_neumann_tri(L: CSR, U: CSR, sweeps: int = 6) -> NeumannTri:
    """Build iterative-solve state from L (strict lower, unit diag) and U
    (upper with diag)."""
    from lssp_tpu.sparse.convert import to_device_format
    from lssp_tpu.sparse.utils import split_ldu
    _, d, Us = split_ldu(U)
    d = np.where(d == 0, 1.0, d)
    inv = (1.0 / d).astype(np.asarray(U.data).dtype)
    # scale strict upper rows by 1/diag once: U⁻¹ = (I + D⁻¹Us)⁻¹ D⁻¹
    ip = np.asarray(Us.indptr)
    rows = np.repeat(np.arange(U.shape[0]), ip[1:] - ip[:-1])
    Us_scaled = CSR(Us.indptr, Us.indices,
                    np.asarray(Us.data) * inv[rows], Us.shape)
    return NeumannTri(Ls=to_device_format(L), Us=to_device_format(Us_scaled),
                      invdiag=inv, sweeps=sweeps)


def neumann_ilu_apply(state: NeumannTri, r):
    """z ≈ U⁻¹ L⁻¹ r via truncated Neumann sweeps (pure SpMVs)."""
    from lssp_tpu.ops.spmv import spmv
    y = r
    for _ in range(state.sweeps):
        y = r - spmv(state.Ls, y)
    zr = state.invdiag * y
    z = zr
    for _ in range(state.sweeps):
        z = zr - spmv(state.Us, z)
    return z


def neumann_ilu_apply_t(state: NeumannTri, r):
    """z ≈ M⁻ᵀ r = L⁻ᵀ U⁻ᵀ r via transposed Neumann sweeps.

    Needs no extra state: with U = D(I + D⁻¹Us) stored as ``Us`` = D⁻¹Us,
    U⁻ᵀ = D⁻¹(I + UsᵀD⁻¹)⁻¹ and UsᵀD⁻¹ is exactly ``spmv_t`` on the stored
    scaled factor; likewise L⁻ᵀ = (I + Lsᵀ)⁻¹."""
    from lssp_tpu.ops.spmv import spmv_t
    w = r
    for _ in range(state.sweeps):
        w = r - spmv_t(state.Us, w)
    zr = state.invdiag * w
    z = zr
    for _ in range(state.sweeps):
        z = zr - spmv_t(state.Ls, z)
    return z
