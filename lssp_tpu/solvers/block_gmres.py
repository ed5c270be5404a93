"""Restarted block GMRES for multiple right-hand sides (Vital 1990).

The nonsymmetric companion of ``solvers/block_cg.py`` — no reference
counterpart (the serial C++ library re-solves per rhs,
lssp_solver_reset_rhs — /root/reference/src/lssp.cxx:470-489).  All k rhs
share ONE block-Krylov basis: the matrix streams once per block-Arnoldi
step for the whole block, information mixes across rhs (the union of the
k residual directions enriches every column's search space), and every
reduction is a stacked Gram — ONE psum distributed, where k independent
GMRES runs pay per-column dot chains.

Right-preconditioned, restart-cycle structure (restart m = opts.restart):

    R = B − A·X;  (V₀, S₀) = qr(R)                      (CholQR², k×k)
    for j < m:   W = A M⁻¹ V_j
                 Hᵢⱼ = VᵢᵀW (all i at once, CGS2);  W −= Σ Vᵢ Hᵢⱼ
                 (V_{j+1}, H_{j+1,j}) = qr(W)           (CholQR², ridge)
    Y = argmin ‖E₁S₀ − H̄Y‖_F   (small dense QR, per-column separable)
    X += M⁻¹(V·Y);  R = B − A·X  → exit on the TRUE residual per column

Design choices:
- **CholQR² + block CGS2** instead of column-wise MGS/Householder: every
  orthogonalization step is a stacked mul+sum Gram over the whole basis —
  4 reductions per block column regardless of the column index (the same
  low-sync contract as ``cagmres``), and zero basis columns need no mask
  (rows of V beyond j are zero within a cycle, so their Gram rows vanish).
- The basis is carried as ``(n, m+1, k)`` so the flattened (n, (m+1)k)
  view used by the stacked Grams is a free reshape, never a transpose of
  the (potentially GB-sized) basis.
- Rank deficiency (duplicate rhs, converged-together columns) is handled
  by the same relative O(eps) ridge as block CG — inside the CholQR
  Grams — so the recurrence never divides by a lost direction; the exit
  criterion is pinned to a per-cycle RECOMPUTED residual, which also
  bounds any orthogonality drift the ridge admits (the Arnoldi relation
  W = Σ VᵢHᵢⱼ holds exactly by construction regardless).
- The (m+1)k × mk block-Hessenberg least squares runs once per CYCLE
  (dense QR + triangular solve — the subdiagonal blocks are ridge-Cholesky
  factors, hence nonsingular, hence H̄ has full column rank); per-column
  iteration counts are still STEP-granular because the one full QR yields
  the LS residual of every block-column prefix for free (R triangular ⇒
  span(H̄[:, :jk]) = span(Q[:, :jk])); convergence itself is exact — the
  exit test uses the recomputed true residual.

fp64-dot hazard: every large contraction (Grams, basis combines) is a
column-broadcast mul+sum, never an (n,·)ᵀ(n,·) dot_general (whose
precision the backend may lower, see solvers/base.py: vdot); the dense QR only
ever sees the small replicated H̄.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from lssp_tpu.solvers.base import (SolveInfo, operator, identity_pc,
                                  history_init_block, history_update_block)

__all__ = ["block_gmres"]


def _gram_rect(U, V, red=None):
    """Gᵢⱼ = Σₙ U[n,i]·V[n,j] for U (n, p), V (n, k) without a dot_general:
    k column-broadcast mul+sum reductions (k small and static)."""
    k = V.shape[1]
    G = jnp.stack(
        [jnp.sum(U * V[:, j][:, None], axis=0) for j in range(k)], axis=1)
    return G if red is None else red(G)


def _mm_rect(P, S):
    """(n, p) @ (p, k) as k broadcast mul+sum combinations (no (n, p, k)
    temporary; XLA fuses the multiply into each reduction)."""
    k = S.shape[1]
    return jnp.stack(
        [jnp.sum(P * S[:, j][None, :], axis=1) for j in range(k)], axis=1)


def _cholqr2(W, red, ridge):
    """Two-pass Cholesky QR: W = V·S with V ~orthonormal, S upper k×k.
    The ridge keeps the Gram factorizable when the block lost rank —
    deficient directions come out small, not NaN."""
    def one(W):
        G = ridge(_gram_rect(W, W, red))
        L = jnp.linalg.cholesky(G)
        V = _mm_rect(W, jnp.linalg.inv(L).T)        # V = W L⁻ᵀ
        return V, L.T
    V1, S1 = one(W)
    V2, S2 = one(V1)
    return V2, _mm_rect(S2, S1)                      # W = V2 (S2 S1)


def block_gmres(A, B, X0=None, M=None, opts=None, reduce=None):
    """Solve A X = B for all columns of B (n, k) at once — restarted,
    right-preconditioned block GMRES.

    Returns (X (n, k), SolveInfo with per-column (k,) nits/residual/
    converged).  ``nits`` is step-granular: within the cycle whose
    recomputed residual confirms a column converged, the full-QR prefix
    residual estimates locate the block-Arnoldi step it crossed its
    tolerance at.  The loop runs until EVERY column meets its tolerance,
    maxit total block iterations elapse, or three consecutive cycles
    leave every active column's residual bit-stationary (a numerically
    dead block — slow-but-monotone convergence is governed by the maxit
    budget alone, never a progress heuristic).

    Basis memory is (m+1)·n·k; pick ``opts.restart`` accordingly.

    ``reduce``: cross-shard reduction applied to every length-n
    contraction (stacked Grams, CholQR Grams, residual norms²) — the
    distributed launcher passes ``lambda v: lax.psum(v, axis)``."""
    op = operator(A)
    pc = M if M is not None else identity_pc
    red = reduce if reduce is not None else (lambda v: v)
    pc_b = jax.vmap(lambda c: pc(c), in_axes=1, out_axes=1)
    op_b = jax.vmap(lambda c: op(c), in_axes=1, out_axes=1)

    n, k = B.shape
    m = max(1, min(int(opts.restart), int(opts.maxit)))
    dtype = B.dtype
    eps = jnp.finfo(dtype).eps
    # absolute floor on the relative ridge: a fully-vanished block (all
    # columns at exact zero) must factor to tiny, not NaN — the stall
    # counter then exits honestly instead of poisoning the cycle
    floor = jnp.sqrt(jnp.finfo(dtype).tiny)     # stays normal after *eps
    ridge = lambda G: G + (64.0 * eps / k) * (jnp.trace(G) + floor) \
        * jnp.eye(k, dtype=dtype)

    X = jnp.zeros_like(B) if X0 is None else X0
    R = B - op_b(X)
    bnorm = jnp.sqrt(red(jnp.sum(B * B, axis=0)))
    r0norm = jnp.sqrt(red(jnp.sum(R * R, axis=0)))
    tol = jnp.maximum(jnp.maximum(opts.rtol * r0norm, opts.atol),
                      opts.rbtol * bnorm)

    def cycle(X, R):
        V0, S0 = _cholqr2(R, red, ridge)
        V = jnp.zeros((n, m + 1, k), dtype=dtype)
        V = V.at[:, 0].set(V0)
        H = jnp.zeros((m, m + 1, k, k), dtype=dtype)

        def step(j, carry):
            V, H = carry
            Vj = jax.lax.dynamic_slice_in_dim(V, j, 1, axis=1)[:, 0]
            W = op_b(pc_b(Vj))
            Vflat = V.reshape(n, (m + 1) * k)
            # block CGS2: basis columns beyond j are zero, so their Gram
            # rows are exactly zero — no mask needed (cf. cagmres)
            h1 = _gram_rect(Vflat, W, red)
            W = W - _mm_rect(Vflat, h1)
            h2 = _gram_rect(Vflat, W, red)
            W = W - _mm_rect(Vflat, h2)
            Vn, Sj = _cholqr2(W, red, ridge)
            V = jax.lax.dynamic_update_slice_in_dim(
                V, Vn[:, None, :], j + 1, axis=1)
            hcol = (h1 + h2).reshape(m + 1, k, k)
            hcol = jax.lax.dynamic_update_slice_in_dim(
                hcol, Sj[None], j + 1, axis=0)
            return V, H.at[j].set(hcol)

        V, H = jax.lax.fori_loop(0, m, step, (V, H))
        # least squares on the replicated small system (per-column
        # separable): H̄[(i),(j)] = H[j, i]; rhs g = E₁S₀
        Hbar = jnp.moveaxis(H, 0, 2).reshape((m + 1) * k, m * k)
        g = jnp.zeros(((m + 1) * k, k), dtype=dtype).at[:k].set(S0)
        Q, Rt = jnp.linalg.qr(Hbar, mode="reduced")
        # guard a (theoretically impossible, ridge ⇒ full rank) zero pivot
        d = jnp.diagonal(Rt)
        Rt = Rt + jnp.diag(jnp.where(d == 0.0, jnp.ones_like(d),
                                     jnp.zeros_like(d)))
        Qtg = _gram_rect(Q, g)
        Y = jax.scipy.linalg.solve_triangular(Rt, Qtg, lower=False)
        # step-granular residual estimates for free from the ONE full QR:
        # R is upper triangular, so span(H̄[:, :jk]) = span(Q[:, :jk]) and
        # the LS residual after j block-Arnoldi steps is per column
        # sqrt(‖(I−QQᵀ)g_c‖² + Σ_{i≥jk} (Qᵀg)²_{ic}) — the standard GMRES
        # estimate generalized to block prefixes, assembled as a SUFFIX
        # sum plus an explicitly-computed complement so there is no
        # ‖g‖²−cumsum cancellation (that form floors at ~‖g‖√eps and
        # misses deep tolerances).  est[j-1, c] = estimate after step j;
        # exact in exact arithmetic (the EXIT still uses the recomputed
        # true residual).
        tail = g - _mm_rect(Q, Qtg)                    # (I − QQᵀ)g
        tail2 = jnp.sum(tail * tail, axis=0)           # (k,)
        sq = Qtg * Qtg
        suffix = jnp.flip(jnp.cumsum(jnp.flip(sq, 0), axis=0), 0)  # (mk, k)
        suffix_at = jnp.concatenate(
            [suffix[k::k, :], jnp.zeros((1, k), dtype)], axis=0)   # j=1..m
        est = jnp.sqrt(tail2[None, :] + suffix_at)     # (m, k)
        C = _mm_rect(V.reshape(n, (m + 1) * k)[:, :m * k], Y)
        Xn = X + pc_b(C)
        Rn = B - op_b(Xn)
        return Xn, Rn, est

    # step-granular trace: each cycle writes its m per-step LS estimates,
    # then the recomputed end-of-cycle residual overwrites the last one;
    # `extra=m` slack lets the final (possibly maxit-overrunning) cycle
    # write at true positions — sliced back to maxit+1 below
    hist0 = history_init_block(opts, k, r0norm, extra=m)

    def cond(carry):
        it, X, R, res, nits, stall, done, hist = carry
        return (it < opts.maxit) & jnp.logical_not(done) \
            & jnp.any(res > tol)

    def body(carry):
        it, X, R, res, nits, stall, done, hist = carry
        Xn, Rn, est = cycle(X, R)
        res_new = jnp.sqrt(red(jnp.sum(Rn * Rn, axis=0)))
        ok = jnp.all(jnp.isfinite(res_new))  # NaN/Inf in X surfaces via Rn
        Xn = jnp.where(ok, Xn, X)
        Rn = jnp.where(ok, Rn, R)
        res_new = jnp.where(ok, res_new, res)
        # progress = an ACTIVE column shrank AT ALL (beyond rounding) or
        # crossed its tolerance; long-converged columns must not mask
        # stagnation of the rest.  The bar is deliberately "any strict
        # reduction", not a percentage: restarted GMRES on a hard problem
        # can legally crawl at <1%/cycle for many cycles before its
        # superlinear drop, and the user's maxit budget — not a heuristic
        # — owns that call.  The stall exit only catches a numerically
        # DEAD block (bit-stationary residuals, e.g. a vanished basis).
        active = res > tol
        improved = ok & jnp.any(active & ((res_new < res * (1.0 - 16.0 * eps))
                                          | (res_new <= tol)))
        stall = jnp.where(improved, 0, stall + 1)
        # step-granular count: within the cycle a column converged in, the
        # LS estimates locate the first block-Arnoldi step that crossed
        # its tolerance (fall back to the full cycle when only the
        # recomputed end-of-cycle residual crossed — estimate drift)
        hit = est <= tol[None, :]                           # (m, k)
        jstar = jnp.where(jnp.any(hit, axis=0),
                          jnp.argmax(hit, axis=0) + 1, m).astype(jnp.int32)
        nits = jnp.where((res > tol) & (res_new <= tol), it + jstar, nits)
        if opts.record_history:
            # per-step estimates at positions it+1..it+m, so the host
            # trace (which prints 1..nits) stays meaningful now that nits
            # are step-granular; a NaN/Inf-rejected cycle writes NaNs
            # (skipped by the printer) instead of its poisoned estimates
            est_w = jnp.where(ok, est.T.astype(hist.dtype), jnp.nan)
            hist = jax.lax.dynamic_update_slice(
                hist, est_w, (jnp.int32(0), it + 1))
        hist = history_update_block(opts, hist, it + m, res_new,
                                    r0norm, bnorm)
        return (it + m, Xn, Rn, res_new, nits,
                stall, jnp.logical_not(ok) | (stall >= 3), hist)

    init = (jnp.int32(0), X, R, r0norm,
            jnp.where(r0norm <= tol, 0, opts.maxit).astype(jnp.int32),
            jnp.int32(0), jnp.bool_(False), hist0)
    (it, X, R, res, nits, stall, done,
     hist) = jax.lax.while_loop(cond, body, init)
    # it advances by m past the maxit check, so cap the report at the
    # user's budget (callers assert nits <= maxit)
    nits = jnp.minimum(jnp.minimum(nits, it), jnp.int32(opts.maxit))
    if opts.record_history:
        hist = hist[:, :opts.maxit + 1]      # drop the cycle-overrun slack
    return X, SolveInfo(nits=nits, residual=res,
                        converged=res <= tol, r0norm=r0norm, bnorm=bnorm,
                        history=hist if opts.record_history else None)
