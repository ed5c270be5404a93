"""ARMS-style multilevel recursive-Schur preconditioner.

Capability parity with the reference's ITSOL ARMS adapter
(/root/reference/src/pc-arms.cxx:83-153: ``arms2`` setup + ``armsol2``
apply) — reimplemented natively with a data-parallel structure (independent-set
elimination, ILUM-family):

setup (host, per level):
  1. pick a greedy *independent set* F among diagonally-dominant rows of
     the current matrix (no F–F edges ⇒ the fine block B = A[F,F] is
     exactly DIAGONAL — the multilevel analog of ITSOL's ddPQ ordering);
  2. split  A = [B F; E C]  and form the dropped Schur complement
     S ≈ C − E·B⁻¹·F  (B diagonal makes this one sparse product; entries
     below ``tol``·row-mean are dropped, the ILUT rule at
     pc-ilut.cxx:116-122);
  3. recurse on S; the coarsest level is factored exactly by the native
     sparse direct LU (lssp_tpu/pc/lu_host.py).

apply (device, all levels unrolled in one jitted program):
     y_f = B⁻¹ r_f                (elementwise)
     z_c = M_S⁻¹ (r_c − E y_f)    (recursive)
     z_f = B⁻¹ (r_f − F z_c)      (SpMV + elementwise)
No triangular recurrences outside the coarsest LU — every level is SpMV +
elementwise work, which streams at full bandwidth.
"""
from __future__ import annotations

import numpy as np

from lssp_tpu.config import Defaults
from lssp_tpu.pc.base import Preconditioner, register_pc
from lssp_tpu.sparse.types import CSR


def _greedy_dd_mis(A: CSR):
    """Greedy independent set, visiting rows by diagonal dominance
    (most-dominant first) so the eliminated block is well-conditioned.
    Independence is with respect to the SYMMETRIZED pattern |A|+|A|ᵀ, so
    B = A[F,F] is guaranteed diagonal for nonsymmetric matrices too."""
    n = A.shape[0]
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.abs(np.asarray(A.data, dtype=np.float64))
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    diag = np.zeros(n)
    on = rows == idx
    diag[rows[on]] = dat[on]
    rowsum = np.bincount(rows, weights=dat, minlength=n) - diag
    dominance = diag / np.maximum(rowsum, 1e-300)
    # symmetrized adjacency for the independence test
    import scipy.sparse as sp
    G0 = sp.csr_matrix((np.ones_like(dat), idx, ip), shape=A.shape)
    G = (G0 + G0.T).tocsr()
    gp, gi = G.indptr.astype(np.int64), G.indices.astype(np.int64)
    # Parallel priority rounds (Luby-style) instead of the former sequential
    # greedy visit: each round every free vertex whose priority beats all
    # its free neighbours joins F and blocks them — vectorized numpy, a few
    # rounds total vs O(n) interpreter steps (config-#5 setup path).
    # Priority = dominance with a seeded-random tie break (pure index tie
    # break degenerates to O(n) rounds on constant-dominance chains).
    tie = np.random.default_rng(0).random(n)
    rank = np.empty(n, dtype=np.int64)
    rank[np.lexsort((tie, -dominance))] = np.arange(n)
    prio = -rank                                 # higher = earlier pick
    rowsG = np.repeat(np.arange(n, dtype=np.int64), np.diff(gp))
    self_edge = rowsG == gi
    state = np.zeros(n, dtype=np.int8)          # 0 free, 1 in F, 2 blocked
    while True:
        free_edge = ((state[rowsG] == 0) & (state[gi] == 0) & ~self_edge)
        nbmax = np.full(n, np.iinfo(np.int64).min, dtype=np.int64)
        np.maximum.at(nbmax, rowsG[free_edge], prio[gi[free_edge]])
        winners = (state == 0) & (prio > nbmax)
        if not winners.any():
            break
        state[winners] = 1
        blocked = free_edge & winners[rowsG]
        state[gi[blocked]] = np.maximum(state[gi[blocked]], 2)
    f_idx = np.flatnonzero(state == 1)
    c_idx = np.flatnonzero(state != 1)
    return f_idx, c_idx


def _drop(S, tol):
    """ILUT-style drop: |s_ij| < tol · (mean |row|) removed; diagonal kept."""
    S = S.tocsr()
    S.sum_duplicates()
    ip = S.indptr
    nrow = len(ip) - 1
    rows = np.repeat(np.arange(nrow), ip[1:] - ip[:-1])
    absd = np.abs(S.data)
    cnt = np.maximum(ip[1:] - ip[:-1], 1)
    rmean = np.bincount(rows, weights=absd, minlength=nrow) / cnt
    keep = (absd >= tol * rmean[rows]) | (rows == S.indices)
    import scipy.sparse as sp
    return sp.csr_matrix((S.data[keep], (rows[keep], S.indices[keep])),
                         shape=S.shape)


def _safe_inv(d):
    small = np.abs(d) < Defaults.ZERO_DIAG_TOL
    d = np.where(small, np.where(d >= 0, Defaults.ZERO_DIAG_VALUE,
                                 -Defaults.ZERO_DIAG_VALUE), d)
    return 1.0 / d


def arms_setup(A: CSR, tol: float = 1e-3, max_levels: int = 10,
               coarse_size: int = 200):
    """Build the per-level state list + coarsest LU."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from lssp_tpu.ops.trisolve import level_schedule
    from lssp_tpu.pc.lu_host import splu_factor
    from lssp_tpu.sparse.convert import csr_to_ell

    dtype = np.asarray(A.data).dtype
    levels = []
    S = A.to_scipy().tocsr()
    for _ in range(max_levels):
        n = S.shape[0]
        if n <= coarse_size:
            break
        cur = CSR.from_scipy(S)
        f_idx, c_idx = _greedy_dd_mis(cur)
        # degenerate split — stop coarsening
        if len(f_idx) < max(8, n // 16) or len(c_idx) == 0:
            break
        B_diag = np.asarray(S[f_idx, f_idx]).ravel()
        invd = _safe_inv(B_diag).astype(dtype)
        E = S[c_idx][:, f_idx].tocsr()
        F = S[f_idx][:, c_idx].tocsr()
        C = S[c_idx][:, c_idx].tocsr()
        Snew = C - E @ sp.diags(invd) @ F
        Snew = _drop(Snew, tol)
        # ELL execution format: a rectangular gather-SpMV that is jit-safe
        # (the CSR path needs host-side row expansion)
        levels.append((
            jnp.asarray(f_idx, jnp.int32), jnp.asarray(c_idx, jnp.int32),
            jnp.asarray(invd),
            csr_to_ell(CSR.from_scipy(E.astype(dtype))),
            csr_to_ell(CSR.from_scipy(F.astype(dtype))),
        ))
        S = Snew
    # coarsest: exact sparse LU
    f = splu_factor(CSR.from_scipy(S.astype(np.float64)).astype(dtype),
                    order="rcm")
    sl = level_schedule(f.L, lower=True)
    su = level_schedule(f.U, lower=False)
    coarse = (sl, su, jnp.asarray(f.perm_in), jnp.asarray(f.perm_out))
    return levels, coarse


def _arms_apply(state, r):
    import jax.numpy as jnp
    from lssp_tpu.ops.spmv import spmv
    from lssp_tpu.ops.trisolve import ilu_apply
    levels, coarse = state

    def rec(lev, rr):
        if lev == len(levels):
            sl, su, pin, pout = coarse
            return ilu_apply(sl, su, rr[pin])[pout]
        f_idx, c_idx, invd, E, F = levels[lev]
        r_f = rr[f_idx]
        r_c = rr[c_idx]
        y_f = invd * r_f
        z_c = rec(lev + 1, r_c - spmv(E, y_f))
        z_f = invd * (r_f - spmv(F, z_c))
        return jnp.zeros_like(rr).at[f_idx].set(z_f).at[c_idx].set(z_c)

    return rec(0, r)


@register_pc("arms")
def setup_arms(A, opts):
    state = arms_setup(A, tol=opts.arms_tol, max_levels=opts.arms_max_levels,
                       coarse_size=opts.arms_coarse_size)
    return Preconditioner(_arms_apply, state=state, name="arms")
