"""Gather-free classical (Ruge–Stüben-type) AMG.

The classical-AMG-as-PC capability (reference: FASP/MI20/SXAMG wrappers,
/root/reference/src/pc-amg.cxx:21-134, /root/reference/src/solver-amg.cxx:
64-130) with transfers that need no gather: the ELL classical cycle
(amg/cycle.py) applies P/R as gathers, this one as slices and
reshape-sums.

The construction generalizes aggregate-then-renumber to classical
interpolation:

* **One C-point per reshape group.**  Each level is partitioned into
  PAIRS along one lattice axis — the strongest-coupled direction
  (classical semicoarsening), alternating axes when couplings are
  balanced (full coarsening over d levels) — or contiguous g-ranges when
  no grid is detected.  Each group elects ONE C-point: the member with
  the most in-group strength, ties broken toward the even coordinate
  along the coarsening axis so the C lattice stays tensor-ALIGNED
  (a staggered/checkerboard lattice was measured to compound coarse
  stencils to 40-70 nnz/row and lose grid-independence).  The coarse
  index of a C-point is exactly its group index — no renumbering drift.
* **Classical direct interpolation** (Stüben direct-interp formula from
  amg/setup.py, weights from the actual matrix entries) onto those
  C-points.  On grid levels every F-point's in-line neighbours are C, so
  plain direct interpolation covers everything and the Galerkin stencil
  holds a tensor fixed point; flat (unstructured) levels add one Jacobi
  smoothing pass to fill F-points whose strong neighbours hold no C.
* **Aggregated-diagonal P (AggP).**  Every interpolation entry
  ``P[i, c]`` sits at coarse offset ``d = grp(c) − grp(i)`` — a static,
  stencil-shaped set (measured 2-7 offsets on the shipped matrix
  classes).  P is stored as one weight vector per distinct offset:
  prolongation is ``Σ_d data[d] ⊙ grp_broadcast(shift(ec, off_d))`` and
  restriction (Pᵀ) is ``Σ_d place(grp_sum(data[d] ⊙ r), off_d)`` —
  static slices, reshape-sums and multiplies only.  **Zero gathers at
  any level.**  Offsets are capped (``max_pdiags``) with a row-sum-
  preserving rescale, and the capped P feeds the Galerkin RAP, so the
  device cycle applies exactly the hierarchy the host built.

Level operators upload in the usual DIA/ELL execution formats; smoothing
is shared with the SA cycle (amg/sa.py: _smooth).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lssp_tpu.ops.spmv import spmv
from lssp_tpu.sparse.types import CSR
from lssp_tpu.amg.setup import (strength_graph, direct_interpolation,
                                truncate_P, lambda_est as _lambda_max)
from lssp_tpu.amg.sa import detect_grid, _filter_lumped, _pad_identity, \
    _to_dia

AXES = ("z", "y", "x")


# --------------------------------------------------------------------------
# grid detection (host)
# --------------------------------------------------------------------------

def detect_grid3(A) -> Optional[Tuple[int, int, int]]:
    """(nz, ny, nx) if A's sparsity matches a row-major lattice stencil;
    2-D grids return nz=1.  Builds on sa.detect_grid (which finds the
    innermost period nx) and then factors the outer dimension the same
    way: outer offsets dy = rint(off/nx) must all fall within a small
    halfwidth of multiples of some ny."""
    g2 = detect_grid(A)
    if g2 is None:
        return None
    gy, nx = g2
    from lssp_tpu.sparse.convert import csr_entry_offsets
    _, _, offs = csr_entry_offsets(A.indptr, A.indices, A.shape[0])
    offs = offs.astype(np.int64)
    dy = np.rint(offs / nx).astype(np.int64)
    hw = 1
    cands = np.unique(np.abs(dy[np.abs(dy) > hw]))
    best = None
    for N in cands:
        N = int(N)
        if N <= 2 * hw + 1 or gy % N:
            continue
        dz = dy - np.rint(dy / N).astype(np.int64) * N
        if np.all(np.abs(dz) <= hw):
            cost = int(np.sum(np.abs(dz)))
            if best is None or cost < best[0]:
                best = (cost, N)
    if best is None:
        return (1, gy, nx)
    ny = best[1]
    return (gy // ny, ny, nx)


def _axis_strengths(Al, dims) -> Tuple[float, float, float]:
    """Total |coupling| along each lattice axis (z, y, x) — one O(#diags)
    pass over the per-diagonal |a| sums."""
    from lssp_tpu.sparse.convert import csr_entry_offsets
    nz, ny, nx = dims
    Ac = Al.tocsr()
    n = Ac.shape[0]
    ip, ind, dat = Ac.indptr, Ac.indices, Ac.data
    if len(ind) > 20_000_000:
        # direction RATIOS of a near-constant-stencil operator are exact
        # on a leading row block up to boundary effects (same sampling
        # rule as sa._grid_strengths; the full 84M-entry scan was ~4 s
        # of the 16.8M classical setup)
        ns = int(np.searchsorted(ip, 8_000_000))
        ns = min(n, max(ns, min(n, 4 * ny * nx)))
        ip = ip[:ns + 1]
        ind = ind[:ip[-1]]
        dat = dat[:ip[-1]]
    _, d, offs = csr_entry_offsets(ip, ind, len(ip) - 1)
    idx = np.searchsorted(offs, d)
    sums = np.bincount(idx, weights=np.abs(dat), minlength=len(offs))
    o = offs.astype(np.int64)
    dy = np.rint(o / nx).astype(np.int64)
    dz = np.rint(dy / max(ny, 1)).astype(np.int64)
    dyy = dy - dz * max(ny, 1)
    dx = o - dy * nx
    sx = float(sums[(dz == 0) & (dyy == 0) & (dx != 0)].sum())
    sy = float(sums[(dz == 0) & (dyy != 0)].sum())
    sz = float(sums[dz != 0].sum())
    return sz, sy, sx


def choose_axis(Al, dims, theta_dir: float,
                prev_axis: Optional[int] = None) -> Optional[int]:
    """Coarsening axis: the dominant direction if one exceeds the others
    by ``theta_dir``, else rotate through the coarsenable axes starting
    after the previous level's choice (full coarsening over d levels)."""
    s = _axis_strengths(Al, dims)
    ok = [dims[a] > 1 for a in range(3)]
    if not any(ok):
        return None
    for a in range(3):
        others = max(max((s[b] for b in range(3) if b != a), default=0.0),
                     1e-300)
        if ok[a] and s[a] >= theta_dir * others:
            return a
    start = (prev_axis + 1) if prev_axis is not None else 2
    for k in range(3):
        a = (start + k) % 3
        if ok[a]:
            return a
    return None


# --------------------------------------------------------------------------
# group machinery (host)
# --------------------------------------------------------------------------

def group_index(agg, g: int, n: int) -> Tuple[np.ndarray, int]:
    """Fine row → reshape-group index, and the group count M.  ``agg`` is
    None (flat contiguous g-ranges, n % g == 0) or ("ax", axis, dims) —
    pairs along one lattice axis of the row-major dims."""
    if agg is None:
        assert n % g == 0, (n, g)
        return np.arange(n, dtype=np.int64) // g, n // g
    _, axis, dims = agg
    nz, ny, nx = dims
    idx = np.arange(n, dtype=np.int64)
    cc = [idx // (ny * nx), (idx // nx) % ny, idx % nx]
    cd = list(dims)
    cc[axis] = cc[axis] // 2
    cd[axis] = -(-dims[axis] // 2)
    return (cc[0] * cd[1] + cc[1]) * cd[2] + cc[2], cd[0] * cd[1] * cd[2]


def coarse_dims(agg) -> Tuple[int, int, int]:
    _, axis, dims = agg
    cd = list(dims)
    cd[axis] = -(-dims[axis] // 2)
    return tuple(cd)


def axis_parity(agg, n: int) -> np.ndarray:
    """Even/odd coordinate along the coarsening axis — the ALIGNED
    C-election tie-break."""
    _, axis, dims = agg
    nz, ny, nx = dims
    idx = np.arange(n, dtype=np.int64)
    cc = (idx // (ny * nx), (idx // nx) % ny, idx % nx)
    return cc[axis] % 2


def elect_cpoints(S, grp: np.ndarray, M: int,
                  parity: Optional[np.ndarray] = None) -> np.ndarray:
    """One C-point per group: the member with the largest in-group strength
    degree; ties prefer ``parity == 0`` (the aligned lattice), then lowest
    index.  Returns the C row index per group."""
    n = S.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(S.indptr))
    ingrp = grp[rows] == grp[S.indices]
    deg = np.bincount(rows[ingrp], minlength=n)
    par = parity if parity is not None else np.zeros(n, dtype=np.int64)
    # per-group argmax of (deg, even-parity, lowest index) via ONE packed
    # int64 key + np.maximum.at — the 3-key lexsort over the full level
    # was 4.3 s of the 16.8M classical setup
    key = ((np.minimum(deg, (1 << 20) - 1).astype(np.int64) << 33)
           | ((1 - par).astype(np.int64) << 32)
           | (n - 1 - np.arange(n, dtype=np.int64)))
    best = np.zeros(M, dtype=np.int64)
    np.maximum.at(best, grp, key)
    return (n - 1) - (best & ((1 << 32) - 1))


def cap_offsets(P, grp: np.ndarray, max_pdiags: int):
    """Restrict P's entries to the ``max_pdiags`` coarse offsets carrying
    the most absolute mass; dropped rows rescale to preserve row sums
    (constants stay exactly interpolated).  Returns (P_capped, offsets,
    kept_mass_fraction)."""
    import scipy.sparse as sp
    P = P.tocsr()
    n = P.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(P.indptr))
    off = P.indices.astype(np.int64) - grp[rows]
    uniq, inv = np.unique(off, return_inverse=True)
    if len(uniq) <= max_pdiags:
        return P, tuple(int(o) for o in uniq), 1.0
    mass = np.bincount(inv, weights=np.abs(P.data), minlength=len(uniq))
    keep_ids = np.sort(np.argsort(-mass)[:max_pdiags])
    kept = np.zeros(len(uniq), dtype=bool)
    kept[keep_ids] = True
    keep = kept[inv]
    frac = float(mass[keep_ids].sum() / max(mass.sum(), 1e-300))
    rowsum = np.zeros(n)
    np.add.at(rowsum, rows, P.data)
    newsum = np.zeros(n)
    np.add.at(newsum, rows[keep], P.data[keep])
    scale = np.where((newsum != 0) & (rowsum != 0),
                     rowsum / np.where(newsum == 0, 1.0, newsum), 1.0)
    P2 = sp.csr_matrix(
        (P.data[keep] * scale[rows[keep]], P.indices[keep],
         np.concatenate([[0], np.cumsum(np.bincount(rows[keep],
                                                    minlength=n))])),
        shape=P.shape)
    return P2, tuple(int(o) for o in uniq[keep_ids]), frac


# --------------------------------------------------------------------------
# AggP: interpolation in aggregated-diagonal layout
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AggP:
    """Interpolation P (n × M) with every entry at a static coarse offset:
    ``data[d, i] = P[i, grp(i) + offsets[d]]`` where grp is the reshape-
    group map described by ``agg``/``g``."""

    offsets: Tuple[int, ...]        # static
    data: Any                       # (ndiag, n)
    g: int                          # static (flat aggregate width)
    agg: Any                        # static ("ax", axis, dims) or None
    shape: Tuple[int, int]          # (n, M)

    @property
    def dtype(self):
        return self.data.dtype


jax.tree_util.register_pytree_node(
    AggP,
    lambda p: ((p.data,), (p.offsets, p.g, p.agg, p.shape)),
    lambda aux, c: AggP(offsets=aux[0], data=c[0], g=aux[1], agg=aux[2],
                        shape=aux[3]))


def to_aggp(P, grp: np.ndarray, g: int, agg, offsets,
            dtype=np.float64) -> AggP:
    """Exact conversion of a (n × M) scipy CSR interpolation whose entries
    all sit on ``offsets`` into the AggP layout."""
    P = P.tocsr()
    n, M = P.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(P.indptr))
    off = P.indices.astype(np.int64) - grp[rows]
    pos = {o: d for d, o in enumerate(offsets)}
    data = np.zeros((len(offsets), n), dtype=dtype)
    if len(off):
        d_idx = np.array([pos[o] for o in off], dtype=np.int64)
        data[d_idx, rows] = P.data
    return AggP(offsets=tuple(offsets), data=data, g=g, agg=agg,
                shape=(n, M))


def _grp_broadcast(agg, g: int, M: int, v):
    """Coarse (M,) → fine (n,): broadcast each group's value over its
    members (pairs duplicate along the axis; ragged edges slice)."""
    if agg is None:
        return jnp.broadcast_to(v[:, None], (M, g)).reshape(-1)
    _, axis, dims = agg
    cd = list(dims)
    cd[axis] = -(-dims[axis] // 2)
    T = v.reshape(cd)
    T = jnp.repeat(T, 2, axis=axis)
    if 2 * cd[axis] != dims[axis]:
        T = jax.lax.slice_in_dim(T, 0, dims[axis], axis=axis)
    return T.reshape(-1)


def _grp_sum(agg, g: int, M: int, t):
    """Fine (n,) → coarse (M,): sum each group's members (ragged edges
    pad)."""
    if agg is None:
        return t.reshape(M, g).sum(axis=1)
    _, axis, dims = agg
    cd = list(dims)
    cd[axis] = -(-dims[axis] // 2)
    T = t.reshape(dims)
    if 2 * cd[axis] != dims[axis]:
        pad = [(0, 0)] * 3
        pad[axis] = (0, 2 * cd[axis] - dims[axis])
        T = jnp.pad(T, pad)
    shape5 = list(T.shape)
    shape5[axis] = cd[axis]
    shape5.insert(axis + 1, 2)
    return T.reshape(shape5).sum(axis=axis + 1).reshape(-1)


def aggp_prolong(P: AggP, ec):
    """y = P @ ec: per offset, a static slice of the once-padded coarse
    vector broadcast over the groups, fused multiply-add."""
    n, M = P.shape
    lo = max(0, -min(P.offsets)) if P.offsets else 0
    hi = max(0, max(P.offsets)) if P.offsets else 0
    ec_p = jnp.pad(ec, (lo, hi))
    y = jnp.zeros(n, dtype=ec.dtype)
    for d, off in enumerate(P.offsets):
        seg = jax.lax.slice_in_dim(ec_p, lo + off, lo + off + M)
        y = y + P.data[d] * _grp_broadcast(P.agg, P.g, M, seg)
    return y


def aggp_restrict(P: AggP, r):
    """rc = Pᵀ @ r: per offset, a group reshape-sum of the weighted
    residual placed back at the offset (static pad + slice)."""
    n, M = P.shape
    lo = max(0, -min(P.offsets)) if P.offsets else 0
    hi = max(0, max(P.offsets)) if P.offsets else 0
    rc = jnp.zeros(M + lo + hi, dtype=r.dtype)
    for d, off in enumerate(P.offsets):
        # gs[m] contributes to coarse index m + off (buffer slot lo+off+m)
        gs = _grp_sum(P.agg, P.g, M, P.data[d] * r)
        rc = jax.lax.dynamic_update_slice_in_dim(
            rc, jax.lax.slice_in_dim(rc, lo + off, lo + off + M) + gs,
            lo + off, axis=0)
    return jax.lax.slice_in_dim(rc, lo, lo + M)


# --------------------------------------------------------------------------
# host setup
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RSLevelHost:
    A: Any                  # scipy CSR (n × n), flat levels pre-padded
    P: Any                  # scipy CSR (n × M), offset-capped
    grp: np.ndarray
    g: int
    agg: Any
    offsets: Tuple[int, ...]
    dinv: np.ndarray
    lmax: float
    kept_mass: float
    zero_rows: int          # F rows left with no interpolation


@dataclasses.dataclass
class RSHierarchyHost:
    levels: list
    A_coarse: Any           # scipy CSR
    n_top: int


def rs_host_setup(A: CSR, theta: float = 0.25, max_levels: int = 12,
                  coarse_size: int = 64, g: int = 4,
                  smooth_interp: bool = True,
                  interp_omega: float = 2.0 / 3.0, trunc: float = 0.2,
                  max_pdiags: int = 40, grid=None, theta_dir: float = 4.0,
                  filter_tol: float = 1e-3) -> RSHierarchyHost:
    """Grouped classical setup: axis-pair groups (direction-aware, aligned
    C lattice) or flat g-ranges elect one C-point each; classical direct
    interpolation (Stüben rule, amg/setup.py) onto those C-points;
    Galerkin RAP with the offset-capped P."""
    import scipy.sparse as sp
    n_top = A.shape[0]
    Al = A.to_scipy().tocsr().astype(np.float64)
    if grid is None:
        dims = detect_grid3(A)
    elif grid is False:
        dims = None
    else:
        dims = tuple(grid) if len(grid) == 3 else (1,) + tuple(grid)
    if dims is not None and dims[0] * dims[1] * dims[2] != n_top:
        dims = None
    levels = []
    prev_axis = None
    for _ in range(max_levels):
        if Al.shape[0] <= coarse_size:
            break
        axis = choose_axis(Al, dims, theta_dir, prev_axis) \
            if dims is not None else None
        if axis is None:
            agg = dims = None
            Al = _pad_identity(Al, (-Al.shape[0]) % g)
        else:
            agg = ("ax", axis, dims)
            prev_axis = axis
        n = Al.shape[0]
        lev_g = 2 if agg is not None else g
        grp, M = group_index(agg, lev_g, n)
        parity = axis_parity(agg, n) if agg is not None else None
        d = Al.diagonal().copy()
        d[d == 0] = 1.0
        dinv = 1.0 / d
        S = strength_graph(Al, theta)
        crows = elect_cpoints(S, grp, M, parity)
        state = np.full(n, -1, dtype=np.int8)
        state[crows] = 1
        P = direct_interpolation(Al, S, state)
        # direct_interpolation numbers C by fine order; recolumn to groups
        cmap_grp = grp[np.sort(crows)]
        P = sp.csr_matrix((P.data, cmap_grp[P.indices], P.indptr),
                          shape=(n, M))
        if smooth_interp and agg is None:
            # flat (unstructured) levels: one Jacobi pass fills the zero
            # rows of F-points whose strong neighbours hold no C, then
            # truncation bounds the reach.  Grid levels skip smoothing —
            # aligned in-line direct interpolation already covers every
            # F-point, and an unsmoothed P keeps the Galerkin stencil at
            # its tensor fixed point instead of compounding.
            P = ((sp.eye(n) - interp_omega * sp.diags(dinv) @ Al)
                 @ P).tocsr()
            if trunc:
                P = truncate_P(P, trunc)
        P, offsets, kept = cap_offsets(P, grp, max_pdiags)
        zero_rows = int((np.diff(P.indptr) == 0).sum())
        lmax = _lambda_max(Al, dinv)
        # Galerkin RAP through the fused C++ kernel (native/src/rap.cpp):
        # pass P as the row-expansion operand with an identity column map
        # (P.row(k) is already in coarse indices) — scipy tocsc/matmat
        # fallback kept as the oracle
        from lssp_tpu import native
        Ac = native.rap(Al, P, np.arange(M, dtype=np.int64), M) \
            if native.available() else None
        if Ac is None:
            Ac = (P.T @ Al @ P).tocsr()
        Ac.eliminate_zeros()
        # lumped strength filter (sa.py rule, row sums preserved): bounds
        # the coarse-stencil growth that compounds through repeated RAPs
        Ac = _filter_lumped(Ac, filter_tol)
        # groups whose C row ended up with a zero P column (never for the
        # elected identity rows, but guard) → keep the operator nonsingular
        zd = Ac.diagonal() == 0
        if zd.any():
            Ac = (Ac + sp.diags(zd.astype(np.float64))).tocsr()
        Ac.sort_indices()
        levels.append(RSLevelHost(A=Al, P=P, grp=grp, g=lev_g, agg=agg,
                                  offsets=offsets, dinv=dinv, lmax=lmax,
                                  kept_mass=kept, zero_rows=zero_rows))
        Al = Ac
        if dims is not None:
            dims = coarse_dims(agg)
    return RSHierarchyHost(levels=levels, A_coarse=Al, n_top=n_top)


# --------------------------------------------------------------------------
# device hierarchy + cycle
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RSLevel:
    A: Any              # DIA/ELL/HYB device operator
    P: AggP             # (n × M)
    dinv: Any           # (n,)
    lmax: float         # static
    smoother: str       # static
    degree: int         # static
    tri: Any = None     # pointwise smoothers only (sa._smooth protocol)
    g: int = 2          # static (sa._smooth protocol compat)


jax.tree_util.register_pytree_node(
    RSLevel,
    lambda l: ((l.A, l.P, l.dinv, l.tri), (l.lmax, l.smoother, l.degree,
                                           l.g)),
    lambda aux, c: RSLevel(A=c[0], P=c[1], dinv=c[2], tri=c[3], lmax=aux[0],
                           smoother=aux[1], degree=aux[2], g=aux[3]))


@dataclasses.dataclass(frozen=True)
class RSAMG:
    levels: Tuple[RSLevel, ...]
    coarse_inv: Any
    cycles: int         # static
    n_top: int          # static: unpadded fine size
    gamma: int = 1      # static: 1 = V-cycle, 2 = W-cycle


jax.tree_util.register_pytree_node(
    RSAMG,
    lambda h: ((h.levels, h.coarse_inv), (h.cycles, h.n_top, h.gamma)),
    lambda aux, c: RSAMG(levels=c[0], coarse_inv=c[1], cycles=aux[0],
                         n_top=aux[1], gamma=aux[2]))


def build_device_rs(hier: RSHierarchyHost, dtype=np.float64,
                    smoother: str = "chebyshev", degree: int = 2,
                    cycles: int = 1, max_diags: int = 96,
                    gamma: int = 1) -> RSAMG:
    levels = []
    for lev in hier.levels:
        Pagg = to_aggp(lev.P, lev.grp, lev.g, lev.agg, lev.offsets,
                       dtype=dtype)
        Pagg = AggP(offsets=Pagg.offsets, data=jnp.asarray(Pagg.data),
                    g=Pagg.g, agg=Pagg.agg, shape=Pagg.shape)
        levels.append(RSLevel(
            A=_to_dia(lev.A, dtype, max_diags), P=Pagg,
            dinv=jnp.asarray(lev.dinv.astype(dtype)), lmax=float(lev.lmax),
            smoother=smoother, degree=degree, g=lev.g))
    coarse_inv = jnp.asarray(
        np.linalg.pinv(hier.A_coarse.toarray()).astype(dtype))
    return RSAMG(levels=tuple(levels), coarse_inv=coarse_inv, cycles=cycles,
                 n_top=hier.n_top, gamma=gamma)


def _smooth(lev: RSLevel, x, b):
    from lssp_tpu.amg import sa
    return sa._smooth(lev, x, b)     # same pointwise Chebyshev/Jacobi


def rs_vcycle(h: RSAMG, b, x=None):
    """One V-cycle (h.cycles repeats); top-level flat padding transparent."""
    nl0 = h.levels[0].A.shape[0] if h.levels else h.coarse_inv.shape[0]
    bp = b if b.shape[0] == nl0 else jnp.pad(b, (0, nl0 - b.shape[0]))
    xp = jnp.zeros_like(bp) if x is None else (
        x if x.shape[0] == nl0 else jnp.pad(x, (0, nl0 - x.shape[0])))

    def cycle(l, b_l, x_l):
        if l == len(h.levels):
            return jnp.matmul(h.coarse_inv, b_l,
                              precision=jax.lax.Precision.HIGHEST)
        lev = h.levels[l]
        x_l = _smooth(lev, x_l, b_l)
        r = b_l - spmv(lev.A, x_l)
        rc = aggp_restrict(lev.P, r)
        # the level below may be flat-padded past this level's M
        n_below = (h.levels[l + 1].A.shape[0] if l + 1 < len(h.levels)
                   else h.coarse_inv.shape[0])
        if n_below != rc.shape[0]:
            rc = jnp.pad(rc, (0, n_below - rc.shape[0]))
        ec = cycle(l + 1, rc, jnp.zeros_like(rc))
        for _ in range(getattr(h, "gamma", 1) - 1):
            # W-cycle: revisit the coarse hierarchy with the current
            # correction as the starting guess (FASP cycle_type capability)
            ec = cycle(l + 1, rc, ec)
        x_l = x_l + aggp_prolong(lev.P, ec[:lev.P.shape[1]])
        return _smooth(lev, x_l, b_l)

    for _ in range(h.cycles):
        xp = cycle(0, bp, xp)
    return xp[:b.shape[0]]


def rs_fmg_initial(h: RSAMG, b):
    """Full-multigrid (nested-iteration) initial guess on the gather-free
    hierarchy: restrict b down, exact coarsest solve, one V-cycle per
    level on the way up (reference FMG capability, fasp_solver_famg,
    /root/reference/src/solver-amg.cxx:99)."""
    nl0 = h.levels[0].A.shape[0] if h.levels else h.coarse_inv.shape[0]
    bp = b if b.shape[0] == nl0 else jnp.pad(b, (0, nl0 - b.shape[0]))
    bs = [bp]
    for l in range(len(h.levels)):
        rc = aggp_restrict(h.levels[l].P, bs[-1])
        n_below = (h.levels[l + 1].A.shape[0] if l + 1 < len(h.levels)
                   else h.coarse_inv.shape[0])
        if n_below != rc.shape[0]:
            rc = jnp.pad(rc, (0, n_below - rc.shape[0]))
        bs.append(rc)
    x = jnp.matmul(h.coarse_inv, bs[-1],
                   precision=jax.lax.Precision.HIGHEST)

    def cycle(l, b_l, x_l):
        if l == len(h.levels):
            return jnp.matmul(h.coarse_inv, b_l,
                              precision=jax.lax.Precision.HIGHEST)
        lev = h.levels[l]
        x_l = _smooth(lev, x_l, b_l)
        r = b_l - spmv(lev.A, x_l)
        rc = aggp_restrict(lev.P, r)
        n_below = (h.levels[l + 1].A.shape[0] if l + 1 < len(h.levels)
                   else h.coarse_inv.shape[0])
        if n_below != rc.shape[0]:
            rc = jnp.pad(rc, (0, n_below - rc.shape[0]))
        ec = cycle(l + 1, rc, jnp.zeros_like(rc))
        x_l = x_l + aggp_prolong(lev.P, ec[:lev.P.shape[1]])
        return _smooth(lev, x_l, b_l)

    for l in range(len(h.levels) - 1, -1, -1):
        x = aggp_prolong(h.levels[l].P, x[:h.levels[l].P.shape[1]])
        x = cycle(l, bs[l], x)
    return x[:b.shape[0]]


# --------------------------------------------------------------------------
# preconditioner entry point
# --------------------------------------------------------------------------

def _rs_apply(state, r):
    return rs_vcycle(state, r)


def setup_rs_pc(A: CSR, opts, reject_below: float = 0.0):
    """Build the gather-free classical-AMG PC.  ``reject_below``: if any
    level's offset-capped interpolation kept less than this fraction of
    its absolute mass, return None instead of a PC (the matrix's
    interpolation is too non-local for the grouped layout — the caller
    routes to saamg)."""
    from lssp_tpu.pc.base import Preconditioner
    from lssp_tpu.config import smoother_degree
    from lssp_tpu.utils.profile import phase
    with phase("amg_host_levels"):
        hier = rs_host_setup(A, theta=opts.amg_theta,
                             max_levels=opts.amg_max_levels,
                             coarse_size=opts.amg_coarse_size,
                             smooth_interp=opts.amg_smooth_interp,
                             trunc=opts.amg_trunc,
                             max_pdiags=opts.amg_max_pdiags)
    if reject_below and hier.levels and \
            min(l.kept_mass for l in hier.levels) < reject_below:
        return None
    with phase("amg_pack_upload"):
        h = build_device_rs(
            hier, dtype=np.asarray(A.data).dtype,
            smoother=opts.amg_smoother
            if opts.amg_smoother != "l1jacobi" else "jacobi",
            degree=smoother_degree(opts.amg_presmooth, opts.amg_postsmooth),
            cycles=max(1, int(opts.amg_cycles)),
            gamma=2 if str(opts.amg_cycle_type).upper() == "W" else 1)
        from lssp_tpu.utils.profile import add_bytes, tree_device_bytes
        add_bytes("amg_pack_upload", tree_device_bytes(h))
    return Preconditioner(_rs_apply, state=h, name="rsamg")
