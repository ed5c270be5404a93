"""Structured smoothed-aggregation AMG — the gather-free multigrid.

Capability parity with the LIS adapter's ``saamg`` PC
(/root/reference/src/solver-lis.cxx:8-41) and the AMG-as-PC capability of
the FASP adapter (/root/reference/src/pc-amg.cxx:21-134); the design is
not a port of any aggregation code:

The classical-AMG device cycle (lssp_tpu/amg/cycle.py) applies P/R as ELL
gathers.  This module removes every gather from the cycle:

* **aggregates are reshape groups**: for a detected row-major grid
  (gy, gx) each level aggregates along x, along y, or as a 2×2 box —
  chosen per level from the measured coupling strengths of that level's
  operator (direction-aware semicoarsening, the anisotropy-robustness
  fix); without a grid, contiguous index ranges of fixed size ``g``
  (after the facade's RCM banded-ization, neighbouring rows are
  geometrically close, so ranges are legitimate aggregates);
* the tentative prolongator P₀ is then a *reshape*: ``P₀·ec`` broadcasts
  coarse values over their group and ``P₀ᵀ·r`` is a reshape-sum — pure
  elementwise (grid modes add only a 2-D pad/slice at ragged edges);
* Jacobi smoothing of the prolongator keeps everything **banded**:
  ``P = B·P₀`` with ``B = I − c·D⁻¹A_f`` stored as one extra DIA matrix
  per level (and ``C = Bᵀ`` for the restriction), where ``A_f`` is the
  **strength-filtered** operator (weak couplings dropped, mass lumped to
  the diagonal) so smoothing does not smear across weak connections;
* Galerkin coarse operators ``A_{l+1} = PᵀA P`` are built on the host
  (scipy); flat-mode levels are padded with identity rows to a multiple
  of ``g`` — every level is static-shape DIA.

A V-cycle therefore costs a handful of DIA SpMVs per level (smoothers +
B/C) — bandwidth-limited, with no gather anywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lssp_tpu.sparse.types import CSR
from lssp_tpu.ops.spmv import spmv


# --------------------------------------------------------------------------
# host setup
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SALevel:
    A: Any              # DIA, (n_l, n_l), n_l % g == 0 (except coarsest)
    B: Any              # DIA: I − c·D⁻¹A_f  (prolongator smoother), or None
    C: Any              # DIA: I − c·A_fᵀD⁻¹ (restriction smoother), or None
    dinv: Any           # (n_l,)
    lmax: float         # static: λmax(D⁻¹A) for Chebyshev
    g: int              # static: aggregate size (flat mode)
    smoother: str       # static
    degree: int         # static
    n_next: int         # static: (padded) size of the next level, 0 at bottom
    agg: Any = None     # static aggregation descriptor:
                        #   None                      flat g-ranges
                        #   ("x",  g, gy, gx, gxc)    semicoarsen x
                        #   ("y",  g, gy, gx, gyc)    semicoarsen y
                        #   ("box", gy, gx, gyc, gxc) 2×2 box
    tri: Any = None     # (dl, d, du) of the level operator — LINE smoother
                        # only (strong-direction tridiagonal part, solved
                        # per sweep by parallel cyclic reduction)


jax.tree_util.register_pytree_node(
    SALevel,
    lambda l: ((l.A, l.B, l.C, l.dinv, l.tri),
               (l.lmax, l.g, l.smoother, l.degree, l.n_next, l.agg)),
    lambda aux, c: SALevel(*c[:4], tri=c[4], lmax=aux[0], g=aux[1],
                           smoother=aux[2], degree=aux[3], n_next=aux[4],
                           agg=aux[5]))


@dataclasses.dataclass(frozen=True)
class SAHierarchy:
    levels: Tuple[SALevel, ...]
    coarse_inv: Any     # dense (n_b, n_b)
    n_top: int          # static: unpadded problem size
    gamma: int = 1      # static: 1 = V-cycle, 2 = W-cycle


jax.tree_util.register_pytree_node(
    SAHierarchy,
    lambda h: ((h.levels, h.coarse_inv), (h.n_top, h.gamma)),
    lambda aux, c: SAHierarchy(levels=c[0], coarse_inv=c[1], n_top=aux[0],
                               gamma=aux[1]))


def _pad_identity(A, m):
    """Pad a scipy CSR with ``m`` decoupled identity rows/cols."""
    import scipy.sparse as sp
    if m == 0:
        return A
    n = A.shape[0]
    return sp.bmat([[A, None], [None, sp.eye(m, format="csr")]],
                   format="csr")


import functools as _ft


@_ft.lru_cache(maxsize=None)
def _dia_transpose_fn(offsets):
    """ONE jitted program transposing a square DIA's data block: offsets
    negate, each diagonal's row shifts by its offset (data[d, i] =
    A[i, i+off] ⇒ dataT[d', i] = data[d, i−off]).  Derives the restriction
    smoother C = Bᵀ from B's ALREADY-UPLOADED data, so C is never
    converted or uploaded from the host, and one fused dispatch replaces
    a per-diagonal eager loop."""
    import jax as _jax

    order = tuple(sorted(range(len(offsets)), key=lambda k: -offsets[k]))
    new_offsets = tuple(-offsets[k] for k in order)

    @_jax.jit
    def f(data):
        rows = []
        for k in order:
            off = offsets[k]
            v = data[k]
            if off > 0:
                v = jnp.roll(v, off).at[:off].set(0)
            elif off < 0:
                v = jnp.roll(v, off).at[off:].set(0)
            rows.append(v)
        return jnp.stack(rows)

    return new_offsets, f


def _dia_transpose_dev(D):
    """C = Dᵀ with data computed on device (see _dia_transpose_fn)."""
    from lssp_tpu.sparse.types import DIA
    offs, f = _dia_transpose_fn(D.offsets)
    return DIA(offs, f(D.data), D.shape)


def _to_dia(Ah, dtype, max_diags):
    from lssp_tpu.sparse.convert import csr_to_dia, csr_to_ell
    # dtype cast happens inside the DIA scatter — no intermediate
    # full-precision CSR copy (measured ~11 s of pure astype at 4.2M rows)
    csr = CSR.from_scipy(Ah)
    try:
        return csr_to_dia(csr, max_diags=max_diags, dtype=dtype)
    except ValueError:
        return csr_to_ell(csr.astype(dtype))    # fallback; still correct


def _subset_csr_lumped(Ac, keep, rows, isdiag):
    """Shared fast tail of the two lumping filters: build the kept-entry
    CSR directly from the row-ordered masked arrays (no coo_tocsr re-sort,
    no second `+ diags` sparse binop) and add the dropped mass onto the
    structural diagonal in place.  Falls back to the allocating path when
    some row with dropped mass has no structural diagonal to lump onto
    (never the case for the I−cD⁻¹A smoothers or Galerkin RAPs this
    filters, but correctness must not depend on that)."""
    import scipy.sparse as sp
    n = Ac.shape[0]
    drop = ~keep
    lump = np.bincount(rows[drop], weights=Ac.data[drop], minlength=n)
    lumped_rows = lump != 0
    # the lumping target must itself be a KEPT diagonal: a structural
    # diagonal excluded by `keep` would pass the guard but receive the
    # in-place add on no entry (advisor r3)
    kept_diag_rows = rows[keep & isdiag]
    hasdiag = np.zeros(n, dtype=bool)
    hasdiag[kept_diag_rows] = True
    new_dat = Ac.data[keep]
    new_ind = Ac.indices[keep]
    # per-row kept counts → indptr: cumsum over n rows, not nnz entries
    # (the former cumsum over an 84M-entry mask was ~1 s/call ×25 at the
    # 16.8M acceptance scale)
    kept_rows = rows[keep]
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(kept_rows, minlength=n), out=new_indptr[1:])
    if np.any(lumped_rows & ~hasdiag):
        out = sp.csr_matrix((new_dat, new_ind, new_indptr), shape=Ac.shape)
        return (out + sp.diags(lump.astype(Ac.data.dtype))).tocsr()
    diag_kept = isdiag[keep]
    new_dat[diag_kept] += lump[kept_diag_rows]
    return sp.csr_matrix((new_dat, new_ind, new_indptr), shape=Ac.shape)


def _filter_lumped(Ac, tol):
    """Drop |a_ij| < tol·√(a_ii·a_jj), lumping dropped mass onto the
    diagonal (keeps row sums; bounds the coarse-stencil growth that
    otherwise compounds through repeated smoothed RAP, and doubles as the
    SA strength filter for prolongator smoothing)."""
    if tol <= 0:
        return Ac
    import scipy.sparse as sp
    from lssp_tpu import native
    Ac = Ac.tocsr()
    Ac.sum_duplicates()
    n = Ac.shape[0]
    if native.available() and Ac.data.dtype == np.float64 \
            and Ac.indptr.dtype in (np.int32, np.int64):
        out = native.filter_lumped(Ac.indptr, Ac.indices, Ac.data, n, tol)
        if out is not None:     # None: no kept diag to lump onto → oracle
            oip, oix, oax = out
            return sp.csr_matrix((oax, oix, oip), shape=Ac.shape)
    d = np.abs(Ac.diagonal())
    d[d == 0] = 1.0
    sq = np.sqrt(d)            # √ over n rows once, not over nnz entries
    it = np.int32 if n < 2**31 else np.int64
    rows = np.repeat(np.arange(n, dtype=it), np.diff(Ac.indptr))
    cols = Ac.indices
    thresh = tol * (sq[rows] * sq[cols])
    isdiag = cols == rows
    keep = (np.abs(Ac.data) >= thresh) | isdiag
    if keep.all():
        return Ac
    return _subset_csr_lumped(Ac, keep, rows, isdiag)


def _lump_to_pattern(Ac, gy, gx, ry, rx):
    """Structurally lump everything outside the (2ry+1)×(2rx+1) grid
    stencil onto the diagonal (keeps row sums).  Geometric-MG fact: the
    Galerkin RAP of a 9-point operator under (bi)linear transfers stays
    9-point, so for grid levels the out-of-pattern mass produced by
    repeated smoothed RAP is noise — lumping it keeps every coarse
    operator a bounded DIA stencil instead of compounding toward ELL."""
    import scipy.sparse as sp
    from lssp_tpu import native
    Ac = Ac.tocsr()
    Ac.sum_duplicates()
    n = Ac.shape[0]
    if native.available() and Ac.data.dtype == np.float64 \
            and Ac.indptr.dtype in (np.int32, np.int64):
        out = native.lump_pattern(Ac.indptr, Ac.indices, Ac.data, n,
                                  int(gx), int(ry), int(rx))
        if out is not None:
            oip, oix, oax = out
            return sp.csr_matrix((oax, oix, oip), shape=Ac.shape)
    it = np.int32 if n < 2**31 else np.int64
    rows = np.repeat(np.arange(n, dtype=it), np.diff(Ac.indptr))
    d = Ac.indices.astype(it, copy=False) - rows
    dy = np.rint(d / gx).astype(it)
    dx = d - dy * gx
    keep = (np.abs(dy) <= ry) & (np.abs(dx) <= rx)
    if keep.all():
        return Ac
    return _subset_csr_lumped(Ac, keep, rows, d == 0)


def detect_grid(A, max_halfwidth: int = 2) -> Optional[Tuple[int, int]]:
    """(gy, gx) if A's sparsity matches a row-major 2-D grid stencil:
    every column offset within ``max_halfwidth`` of 0, +gx, or −gx.
    Among the candidates that fit, the one with the TIGHTEST offset
    decomposition (minimal Σ|dx|) wins: for a 9-point stencil the corner
    offsets ±(gx−1), ±gx, ±(gx+1) can all pass the tolerance test
    whenever n happens to divide them, but only the true gx decomposes
    the stencil with total in-row distance 2·hw — largest-first selection
    returned (gy', gx+1) on such grids.  Returns None when no candidate
    fits (e.g. after RCM reordering, or genuinely unstructured
    sparsity)."""
    from lssp_tpu.sparse.convert import csr_entry_offsets
    n = A.shape[0]
    _, _, offs = csr_entry_offsets(A.indptr, A.indices, n)
    offs = offs.astype(np.int64)
    cands = np.unique(np.abs(offs[np.abs(offs) > max_halfwidth]))
    best = None
    for N in cands:
        N = int(N)
        # N <= 2*hw+1 is DEGENERATE: every integer offset is then within
        # ``max_halfwidth`` of a multiple of N (rint rounds to the nearest
        # multiple, never farther than (N-1)/2 away), so the test would
        # "detect" a grid in any sparsity with n % N == 0 — measured as a
        # spurious (3125, 5) grid on the hierarchy-ordered coupled3d_25
        if N <= 2 * max_halfwidth + 1 or n % N:
            continue
        dx = offs - np.rint(offs / N).astype(np.int64) * N
        if np.all(np.abs(dx) <= max_halfwidth):
            cost = int(np.sum(np.abs(dx)))
            if best is None or cost < best[0]:
                best = (cost, N)
    return (n // best[1], best[1]) if best else None


def _grid_strengths(Al, gy, gx):
    """Total |coupling| along x (same grid row) vs y (crossing rows).

    One O(nnz) pass: per-DIAGONAL |a| sums via bincount over the offset
    index, then the handful of offsets are classified by direction —
    avoids materializing per-entry dy/abs masks over 84M entries."""
    from lssp_tpu.sparse.convert import csr_entry_offsets
    Ac = Al.tocsr()
    n = Ac.shape[0]
    ip, ind, dat = Ac.indptr, Ac.indices, Ac.data
    if len(ind) > 20_000_000:
        # direction RATIOS of a near-constant-stencil operator are exact
        # on a leading row block (>= 4 grid rows, ~8M entries) up to
        # boundary effects - measured identical mode choices on the
        # shipped classes, and the full 84M-entry scan was ~2.9 s of the
        # 16.8M setup
        ns = int(np.searchsorted(ip, 8_000_000))
        ns = min(n, max(ns, min(n, 4 * gx)))
        ip = ip[:ns + 1]
        ind = ind[:ip[-1]]
        dat = dat[:ip[-1]]
    _, d, offs = csr_entry_offsets(ip, ind, len(ip) - 1)
    idx = np.searchsorted(offs, d)
    sums = np.bincount(idx, weights=np.abs(dat), minlength=len(offs))
    o = offs.astype(np.int64)
    dy = np.rint(o / gx).astype(np.int64)
    sx = float(sums[(dy == 0) & (o != 0)].sum())
    sy = float(sums[dy != 0].sum())
    return sx, sy


def sa_host_levels(A: CSR, g: int = 4, max_levels: int = 12,
                   coarse_size: int = 256, omega_p: float = 4.0 / 3.0,
                   filter_tol: float = 1e-3, smooth_levels: int = 2,
                   grid=None, pad_mult: int = None, theta_dir: float = 4.0,
                   strength_tol: float = 0.02,
                   pattern_radius: Optional[Tuple[int, int]] = None,
                   b_radius: Optional[Tuple[int, int]] = (1, 1),
                   shards: int = 1, host_c: bool = True):
    """Host part of the structured-SA setup, shared by the single-device
    and distributed builders.  Returns (levels, Al_coarse, n_top) where
    each level is (A_scipy, B_scipy|None, C_scipy|None, dinv, lmax, n_c,
    agg).  ``grid``: (gy, gx) row-major dims enabling direction-aware
    grid aggregation (semicoarsening); None keeps flat contiguous ranges.
    ``theta_dir``: semicoarsen when one direction's total coupling exceeds
    the other's by this factor, else 2×2 box.  ``strength_tol``: drop
    couplings below this (relative, √(a_ii·a_jj)-scaled) when smoothing
    the prolongator.  ``pad_mult``: flat mode pads every level to a
    multiple of this (defaults to ``g``; the distributed builder passes
    P·g so shard-local reshapes stay aligned).  ``shards``: restrict grid
    modes to aggregations whose reshape groups stay inside one of P
    row-shards (the distributed builder's constraint); coarsening stops
    early if no aligned mode remains.  ``host_c``: materialize the host
    restriction smoother C = (lumped B)ᵀ — the distributed builder
    partitions it; the single-device packer derives C on device from B's
    uploaded data, so it skips the host transpose entirely."""
    import scipy.sparse as sp
    from lssp_tpu.amg.setup import lambda_est as _lambda_max

    pad_mult = pad_mult or g
    n_top = A.shape[0]
    Al = A.to_scipy().tocsr().astype(np.float64)
    if grid is not None and grid[0] * grid[1] != n_top:
        grid = None
    levels = []
    for li in range(max_levels):
        n = Al.shape[0]
        if n <= coarse_size:
            break
        agg = next_grid = None
        mode = None
        if grid is not None and max(grid) > 1:
            gy, gx = grid
            idx = np.arange(n, dtype=np.int64)
            iy, ix = idx // gx, idx % gx
            sx, sy = _grid_strengths(Al, gy, gx)
            # shard-alignment feasibility: with `shards` row-shards, every
            # reshape group must stay inside one shard — x-groups always do
            # (whole grid rows per shard), y/box groups need the per-shard
            # row count exactly divisible (no ragged padding across a
            # shard boundary); shards == 1 allows ragged edges everywhere
            ok = {
                "x": gx > 1 and gy % shards == 0,
                "y": gy > 1 and (shards == 1
                                 or (gy % shards == 0
                                     and (gy // shards) % g == 0)),
                "box": gx > 1 and gy > 1
                       and (shards == 1 or (gy % shards == 0
                                            and (gy // shards) % 2 == 0)),
            }
            if sx >= theta_dir * max(sy, 1e-300):
                order = ("x", "box", "y")
            elif sy >= theta_dir * max(sx, 1e-300):
                order = ("y", "box", "x")
            else:
                order = ("box", "x", "y")
            mode = next((m for m in order if ok[m]), None)
            if mode is None:
                break    # alignment exhausted: current Al is the coarse op
            if mode == "x":
                gyc, gxc = gy, -(-gx // g)
                cols = iy * gxc + ix // g
                agg = ("x", g, gy, gx, gxc)
            elif mode == "y":
                gyc, gxc = -(-gy // g), gx
                cols = (iy // g) * gx + ix
                agg = ("y", g, gy, gx, gyc)
            else:
                gyc, gxc = -(-gy // 2), -(-gx // 2)
                cols = (iy // 2) * gxc + ix // 2
                agg = ("box", gy, gx, gyc, gxc)
            n_c = gyc * gxc
            p0_cols = cols
            next_grid = (gyc, gxc)
        else:
            grid = None
            pad = (-n) % pad_mult
            Al = _pad_identity(Al, pad)
            n = Al.shape[0]
            # P0: (n, n/g) contiguous aggregation
            n_c = n // g
            p0_cols = np.arange(n, dtype=np.int64) // g
        d = Al.diagonal().copy()
        d[d == 0] = 1.0
        dinv = 1.0 / d
        lmax = _lambda_max(Al, dinv)
        if li < smooth_levels:
            # smooth the tentative prolongator in the STRENGTH-FILTERED
            # operator: smoothing in the full operator smears coarse basis
            # functions across weak couplings, which both fattens the RAP
            # stencil and degrades anisotropic convergence
            Af = _filter_lumped(Al, strength_tol) if strength_tol > 0 else Al
            df = Af.diagonal().copy()
            df[df == 0] = 1.0
            dfinv = 1.0 / df
            lmax_f = _lambda_max(Af, dfinv) if strength_tol > 0 else lmax
            c = omega_p / lmax_f
            # B = I − c·D⁻¹Af built directly on Af's arrays (row-scale +
            # in-place diagonal add — no diags() SpGEMM, no eye() binop:
            # those were ~1.1 s/level of csr_matmat+csr_minus_csr at the
            # 16.8M acceptance scale); C = I − c·AfᵀD⁻¹ is EXACTLY Bᵀ
            Afc = Af.tocsr()
            Afc.sum_duplicates()
            it = np.int32 if n < 2**31 else np.int64
            rows_f = np.repeat(np.arange(n, dtype=it), np.diff(Afc.indptr))
            isdiag_f = Afc.indices == rows_f
            if int(isdiag_f.sum()) == n:       # every row has a diagonal
                bdat = (-c) * (dfinv[rows_f] * Afc.data)
                bdat[isdiag_f] += 1.0
                B = sp.csr_matrix((bdat, Afc.indices.copy(),
                                   Afc.indptr.copy()), shape=Afc.shape)
            else:                              # rare: missing structural diag
                B = (sp.eye(n) - c * sp.diags(dfinv) @ Afc).tocsr()
            if agg is not None and b_radius is not None:
                # bound the prolongator smoother to a fixed grid stencil:
                # with B at radius (1,1) the Galerkin RAP reach has a
                # 5×5 fixed point, so coarse stencils stop compounding
                # (measured: unbounded all-level smoothing grows 5→13→29
                # →45→ELL on 2-D Poisson; bounding B holds 25 diagonals
                # with the same iteration counts)
                B = _lump_to_pattern(B, gy, gx, b_radius[0], b_radius[1])
            # C = Bᵀ of the LUMPED B — the SAME operator the single-device
            # packer derives on device (_dia_transpose_dev); materialized
            # host-side only for the distributed builder.  (Previously the
            # host path lumped Bᵀ row-wise instead, a slightly different
            # diagonal adjustment than the device convention.)
            C = B.T.tocsr() if host_c else None
        else:
            B = C = None                                    # tentative P0
        # Galerkin RAP with the implicit P = B·P0: the fused C++ kernel
        # (native/src/rap.cpp) consumes B + the aggregation column map
        # directly — no P materialization, no scipy tocsc/matmat chain
        # (measured ~10 s of the 16.8M host hierarchy build)
        from lssp_tpu import native
        Ac = native.rap(Al, B, p0_cols, n_c) if native.available() else None
        if Ac is None:                                      # Python oracle
            if B is not None:
                # P = B @ P0 as a pure column remap + duplicate sum
                P = sp.csr_matrix((B.data.copy(),
                                   p0_cols[B.indices.astype(np.int64)],
                                   B.indptr.copy()), shape=(n, n_c))
                P.sum_duplicates()
            else:
                P = sp.csr_matrix((np.ones(n), p0_cols,
                                   np.arange(n + 1)), shape=(n, n_c))
            Ac = (P.T @ Al @ P).tocsr()
        Ac.eliminate_zeros()
        Ac = _filter_lumped(Ac, filter_tol)
        if next_grid is not None and pattern_radius is not None:
            Ac = _lump_to_pattern(Ac, next_grid[0], next_grid[1],
                                  pattern_radius[0], pattern_radius[1])
        levels.append((Al, B, C, dinv, lmax, n_c, agg))
        grid = next_grid
        Al = Ac
    return levels, Al, n_top


def sa_setup(A: CSR, g: int = 4, max_levels: int = 12,
             coarse_size: int = 256, omega_p: float = 4.0 / 3.0,
             smoother: str = "chebyshev", degree: int = 2,
             dtype=None, max_diags: int = 96, filter_tol: float = 1e-3,
             smooth_levels: Optional[int] = None, grid=None,
             theta_dir: float = 4.0, strength_tol: float = 0.02,
             pattern_radius: Optional[Tuple[int, int]] = None,
             b_radius: Optional[Tuple[int, int]] = (1, 1),
             gamma: int = 1) -> SAHierarchy:
    """Build the structured-SA hierarchy (host, scipy SpGEMM).

    ``filter_tol``: post-RAP lumped filtering threshold (stencil control).
    ``smooth_levels``: Jacobi-smooth the prolongator on this many of the
    finest levels; deeper levels use the tentative P₀ (pure reshape — no
    B/C SpMVs at all).  ``None`` = all levels in grid mode (B is pattern-
    bounded so stencils cannot compound; all-level smoothing is what makes
    convergence grid-independent — measured 10 its at 512² isotropic vs 17
    with 2 smoothed levels), 2 in flat mode (stencil-growth-safe).
    ``grid``: (gy, gx) row-major grid dims of the operator — enables
    direction-aware grid aggregation (per-level x/y semicoarsening or 2×2
    box, chosen from the measured coupling strengths: the anisotropy-
    robust coarsening).  ``None`` auto-detects the grid from the sparsity
    (detect_grid); pass ``False`` to force flat contiguous ranges.
    """
    dtype = dtype or np.asarray(A.data).dtype
    if grid is None:
        grid = detect_grid(A)
    elif grid is False:
        grid = None
    if smooth_levels is None:
        # grid mode: smooth every level (B is pattern-bounded, so stencils
        # hold at a 25-diagonal fixed point and convergence is measured
        # grid-independent); flat mode keeps the stencil-growth-safe 2
        smooth_levels = max_levels if grid is not None else 2
    from lssp_tpu.utils.profile import phase
    with phase("saamg_host_levels"):
        levels, Al, n_top = sa_host_levels(
            A, g=g, max_levels=max_levels, coarse_size=coarse_size,
            omega_p=omega_p, filter_tol=filter_tol,
            smooth_levels=smooth_levels, grid=grid, theta_dir=theta_dir,
            strength_tol=strength_tol, pattern_radius=pattern_radius,
            b_radius=b_radius, host_c=False)
    # pack device levels; n_next records the size the level below was
    # built at (for reshape bookkeeping)
    dev = []
    for i, (Ah, B, C, dinv, lmax, n_c, agg) in enumerate(levels):
      with phase("saamg_pack_upload"):
        A_dia = _to_dia(Ah, dtype, max_diags)
        tri = None
        if smoother == "line":
            from lssp_tpu.sparse.types import DIA
            if isinstance(A_dia, DIA):
                from lssp_tpu.ops.tridiag import tridiag_parts
                dl, d0, du = tridiag_parts(A_dia)
                tri = (jnp.asarray(dl), jnp.asarray(d0), jnp.asarray(du))
            else:
                # level fell back to ELL (too many diagonals): no
                # tridiagonal part to extract — _smooth uses Chebyshev
                # there (tri=None), warn once at setup
                from lssp_tpu.utils.log import warning
                warning(f"saamg level {i}: line smoother unavailable on a "
                        "non-DIA level (too many diagonals); using "
                        "Chebyshev for this level")
        from lssp_tpu.sparse.types import DIA as _DIA
        B_dia = _to_dia(B, dtype, max_diags) if B is not None else None
        if isinstance(B_dia, _DIA):
            # commit B's data once, derive C = Bᵀ on device from it (one
            # jitted dispatch, zero extra upload).  NB this transposes the
            # LUMPED B, i.e. R = P0ᵀBᵀ exactly — the symmetric coarse
            # correction; convergence-validated (acceptance nits unchanged
            # at 1M and 16.8M, golden ratchet green)
            B_dia = _DIA(B_dia.offsets, jax.device_put(B_dia.data),
                         B_dia.shape)
            C_dia = _dia_transpose_dev(B_dia)
        else:
            # ELL fallback: derive the host C = (lumped B)ᵀ on demand —
            # sa_host_levels skips it for the single-device packer
            if C is None and B is not None:
                C = B.T.tocsr()
            C_dia = _to_dia(C, dtype, max_diags) if C is not None else None
        lev_dev = SALevel(
            A=A_dia,
            B=B_dia,
            C=C_dia,
            dinv=jnp.asarray(dinv.astype(dtype)),
            lmax=float(lmax), g=g, smoother=smoother, degree=degree,
            n_next=n_c, agg=agg, tri=tri)
        from lssp_tpu.utils.profile import add_bytes, tree_device_bytes
        # C is DERIVED on device from B's committed data — it crosses the
        # link zero times; count only what actually uploads
        add_bytes("saamg_pack_upload", tree_device_bytes(
            (lev_dev.A, lev_dev.B, lev_dev.dinv, lev_dev.tri)))
        dev.append(lev_dev)
    with phase("saamg_coarse_inv"):
        coarse_inv = jnp.asarray(np.linalg.inv(Al.toarray()).astype(dtype))
        from lssp_tpu.utils.profile import add_bytes
        add_bytes("saamg_coarse_inv", int(coarse_inv.nbytes))
    return SAHierarchy(levels=tuple(dev), coarse_inv=coarse_inv,
                       n_top=n_top, gamma=gamma)


# --------------------------------------------------------------------------
# device cycle — reshape prolongation, DIA everything
# --------------------------------------------------------------------------

def _smooth(lev: SALevel, x, b):
    if lev.degree <= 0:
        return x
    if lev.smoother == "line" and lev.tri is not None:
        # damped LINE Jacobi: solve whole strong-direction tridiagonal
        # lines each sweep (parallel cyclic reduction — log-depth elementwise
        # streaming).  Point smoothers cannot damp errors smooth along the
        # strong coupling of an anisotropic operator, which is what makes
        # iteration counts grow with size; line sweeps restore robustness.
        from lssp_tpu.ops.tridiag import line_jacobi_sweeps
        return line_jacobi_sweeps(lev.tri, lambda v: spmv(lev.A, v), x, b,
                                  lev.degree)
    if lev.smoother == "jacobi":
        for _ in range(lev.degree):
            x = x + (2.0 / 3.0) * lev.dinv * (b - spmv(lev.A, x))
        return x
    # Chebyshev on [0.3, 1.1]·lmax of D⁻¹A (same interval as amg/cycle.py)
    ub = 1.1 * lev.lmax
    lb = 0.3 * lev.lmax
    theta = (ub + lb) / 2.0
    delta = (ub - lb) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    r = lev.dinv * (b - spmv(lev.A, x))
    d = r / theta
    for _ in range(lev.degree):
        x = x + d
        r = r - lev.dinv * spmv(lev.A, d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x


def agg_restrict(agg, g, n_next, t):
    """P0ᵀ·t as a pure reshape-sum (grid modes pad ragged edges).  Shared
    by the single-device cycle and the distributed one (where ``agg``
    carries shard-LOCAL dims and t is the shard's slice — reshape groups
    never cross shards by construction, see sa_host_levels ``shards``)."""
    if agg is None:
        return t.reshape(n_next, g).sum(axis=1)
    if agg[0] == "x":
        _, g, gy, gx, gxc = agg
        T = t.reshape(gy, gx)
        if gxc * g != gx:
            T = jnp.pad(T, ((0, 0), (0, gxc * g - gx)))
        return T.reshape(gy, gxc, g).sum(axis=2).reshape(-1)
    if agg[0] == "y":
        _, g, gy, gx, gyc = agg
        T = t.reshape(gy, gx)
        if gyc * g != gy:
            T = jnp.pad(T, ((0, gyc * g - gy), (0, 0)))
        return T.reshape(gyc, g, gx).sum(axis=1).reshape(-1)
    _, gy, gx, gyc, gxc = agg
    T = t.reshape(gy, gx)
    if gyc * 2 != gy or gxc * 2 != gx:
        T = jnp.pad(T, ((0, gyc * 2 - gy), (0, gxc * 2 - gx)))
    return T.reshape(gyc, 2, gxc, 2).sum(axis=(1, 3)).reshape(-1)


def agg_prolong(agg, g, n_next, ec):
    """P0·ec as a broadcast-reshape (grid modes slice ragged edges)."""
    if agg is None:
        return jnp.broadcast_to(ec[:, None], (n_next, g)).reshape(-1)
    if agg[0] == "x":
        _, g, gy, gx, gxc = agg
        t = jnp.broadcast_to(ec.reshape(gy, gxc, 1), (gy, gxc, g))
        return t.reshape(gy, gxc * g)[:, :gx].reshape(-1)
    if agg[0] == "y":
        _, g, gy, gx, gyc = agg
        t = jnp.broadcast_to(ec.reshape(gyc, 1, gx), (gyc, g, gx))
        return t.reshape(gyc * g, gx)[:gy].reshape(-1)
    _, gy, gx, gyc, gxc = agg
    t = jnp.broadcast_to(ec.reshape(gyc, 1, gxc, 1), (gyc, 2, gxc, 2))
    return t.reshape(gyc * 2, gxc * 2)[:gy, :gx].reshape(-1)


def agg_localize(agg, shards):
    """Global → shard-local aggregation descriptor (divide the y dim by
    the shard count; sa_host_levels' ``shards`` feasibility guarantees
    exact divisibility)."""
    if agg is None:
        return None
    if agg[0] == "x":
        _, g, gy, gx, gxc = agg
        return ("x", g, gy // shards, gx, gxc)
    if agg[0] == "y":
        _, g, gy, gx, gyc = agg
        return ("y", g, gy // shards, gx, gyc // shards)
    _, gy, gx, gyc, gxc = agg
    return ("box", gy // shards, gx, gyc // shards, gxc)


def _restrict(lev: SALevel, r):
    """rc = P0ᵀ·(C·r): one DIA SpMV + a reshape-sum (no SpMV when the
    level uses the tentative prolongator)."""
    t = spmv(lev.C, r) if lev.C is not None else r
    return agg_restrict(lev.agg, lev.g, lev.n_next, t)


def _prolong(lev: SALevel, ec):
    """e = B·(P0·ec): a broadcast-reshape + one DIA SpMV (reshape only for
    tentative-P levels)."""
    t = agg_prolong(lev.agg, lev.g, lev.n_next, ec)
    return spmv(lev.B, t) if lev.B is not None else t


def sa_vcycle(h: SAHierarchy, b, x=None):
    """One V-cycle; handles the top-level identity padding transparently."""
    nl0 = h.levels[0].A.shape[0] if h.levels else h.coarse_inv.shape[0]
    bp = b if b.shape[0] == nl0 else jnp.pad(b, (0, nl0 - b.shape[0]))
    if x is None:
        xp = jnp.zeros_like(bp)
    else:
        xp = x if x.shape[0] == nl0 else jnp.pad(x, (0, nl0 - x.shape[0]))

    def cycle(l, b_l, x_l):
        if l == len(h.levels):
            return jnp.matmul(h.coarse_inv, b_l,
                              precision=jax.lax.Precision.HIGHEST)
        lev = h.levels[l]
        x_l = _smooth(lev, x_l, b_l)
        r = b_l - spmv(lev.A, x_l)
        rc = _restrict(lev, r)
        # the next level may be identity-padded to a multiple of g
        n_below = (h.levels[l + 1].A.shape[0] if l + 1 < len(h.levels)
                   else h.coarse_inv.shape[0])
        if n_below != rc.shape[0]:
            rc = jnp.pad(rc, (0, n_below - rc.shape[0]))
        ec = cycle(l + 1, rc, jnp.zeros_like(rc))
        for _ in range(getattr(h, "gamma", 1) - 1):
            # W-cycle: revisit the coarse hierarchy warm-started (FASP
            # AMG_param cycle_type capability)
            ec = cycle(l + 1, rc, ec)
        x_l = x_l + _prolong(lev, ec[:lev.n_next])
        return _smooth(lev, x_l, b_l)

    xp = cycle(0, bp, xp)
    return xp[:b.shape[0]]


# --------------------------------------------------------------------------
# preconditioner registration
# --------------------------------------------------------------------------

def _saamg_apply(cycles, state, r):
    x = None
    for _ in range(cycles):
        x = sa_vcycle(state, r, x)
    return x


def setup_saamg_pc(A: CSR, opts):
    import functools
    from lssp_tpu.pc.base import Preconditioner
    from lssp_tpu.config import smoother_degree
    h = sa_setup(A, g=opts.saamg_aggregate, max_levels=opts.amg_max_levels,
                 coarse_size=opts.amg_coarse_size,
                 smoother=opts.amg_smoother
                 if opts.amg_smoother != "l1jacobi" else "jacobi",
                 degree=smoother_degree(opts.amg_presmooth,
                                        opts.amg_postsmooth),
                 grid=opts.saamg_grid,
                 gamma=2 if str(opts.amg_cycle_type).upper() == "W" else 1)
    cycles = max(1, int(opts.amg_cycles))
    return Preconditioner(functools.partial(_saamg_apply, cycles),
                          state=h, name=f"saamg(x{cycles})")
