"""Block Conjugate Gradient for multiple right-hand sides (O'Leary 1980).

No reference counterpart (the serial C++ library re-solves per rhs,
lssp_solver_reset_rhs — /root/reference/src/lssp.cxx:470-489); this is the
serving answer beyond ``solve_multi``'s vmapped independent
solves: all k rhs share ONE Krylov search block, so

- the matrix is read once per iteration for the whole block (same traffic
  win as the vmapped path), and
- information mixes ACROSS rhs — the block converges in roughly the
  iterations of the single hardest rhs minus the shared spectral work,
  typically 1.3–2× fewer total iterations than k independent CGs, and
- every reduction is a k×k Gram matrix: ONE fused reduction (one psum when
  distributed) where k independent solves pay k separate dots per step —
  the communication-avoiding story compounds with the convergence one.

Preconditioned block CG recurrence (SPD A, SPD M):

    Z = M⁻¹R,  P = Z
    repeat:  Q = A P
             α = (PᵀQ)⁻¹ (ZᵀR)        (k×k solves)
             X += P α;  R -= Q α
             Z = M⁻¹R
             β = (ZᵀR)_old⁻¹ (ZᵀR)_new
             P = Z + P β

Breakdown: PᵀQ goes singular iff the residual block loses rank (duplicate
rhs, or columns whose errors converged together).  Three defenses, all
measured in: a relative O(eps) ridge on the k×k solves (duplicates then
converge in lock-step), residual replacement pinning the exit criterion
to a recomputed residual, and restart-on-breakdown (fresh search block);
two consecutive post-restart breakdowns exit honestly unconverged.

fp64-dot hazard: the k×k Grams are computed as mul+sum contractions via k
batched column reductions, never one (n,k)ᵀ(n,k) dot_general (whose
precision the backend may lower, see solvers/base.py: vdot).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from lssp_tpu.solvers.base import (SolveInfo, operator, identity_pc,
                                  history_init_block, history_update_block)

__all__ = ["block_cg"]


def _gram(U, V):
    """Gᵢⱼ = Σₙ U[n,i]·V[n,j] without a dot_general: k column-broadcast
    mul+sum reductions (k is small and static — unrolled)."""
    k = U.shape[1]
    return jnp.stack(
        [jnp.sum(U * V[:, j][:, None], axis=0) for j in range(k)], axis=1)


def _mm(P, S):
    """(n, k) @ (k, k) as k broadcast mul+sum combinations — same fp64
    dot_general avoidance as ``_gram`` (and no (n, k, k) temporary)."""
    k = S.shape[1]
    return jnp.stack(
        [jnp.sum(P * S[:, j][None, :], axis=1) for j in range(k)], axis=1)


def block_cg(A, B, X0=None, M=None, opts=None, reduce=None):
    """Solve A X = B for all columns of B (n, k) at once.

    Returns (X (n, k), SolveInfo with per-column (k,) nits/residual/
    converged).  Stopping rule matches ``cg``'s per column — the loop runs
    until EVERY column meets its tolerance (or maxit / breakdown).

    ``reduce``: cross-shard reduction applied to every column-sum
    contraction (Grams and residual norms²) — the distributed launcher
    passes ``lambda v: lax.psum(v, axis)`` so ONE psum of a k×k (or (k,))
    partial per reduction point replaces k independent dots."""
    op = operator(A)
    pc = M if M is not None else identity_pc
    red = reduce if reduce is not None else (lambda v: v)
    # vmap the (vector) preconditioner and operator over rhs columns when
    # they aren't natively batched: both receive (n,) and return (n,)
    pc_b = jax.vmap(lambda c: pc(c), in_axes=1, out_axes=1)
    op_b = jax.vmap(lambda c: op(c), in_axes=1, out_axes=1)

    n, k = B.shape
    X = jnp.zeros_like(B) if X0 is None else X0
    R = B - op_b(X)
    bnorm = jnp.sqrt(red(jnp.sum(B * B, axis=0)))
    r0norm = jnp.sqrt(red(jnp.sum(R * R, axis=0)))
    tol = jnp.maximum(jnp.maximum(opts.rtol * r0norm, opts.atol),
                      opts.rbtol * bnorm)

    hist0 = history_init_block(opts, k, r0norm)

    def cond(carry):
        it, X, R, P, rho_old, res, nits, fresh, done, hist = carry
        return (it < opts.maxit) & jnp.logical_not(done) \
            & jnp.any(res > tol)

    def body(carry):
        it, X, R, P, rho_old, res, nits, fresh, done, hist = carry
        Z = pc_b(R)
        rho = red(_gram(Z, R))                              # (k, k)
        # relative ridge on the k×k solves: a rank-deficient residual
        # block (duplicate or converged-together rhs) makes the Grams
        # singular; the ridge keeps the step well-defined on the dominant
        # subspace (duplicates then simply converge in lock-step) at a
        # perturbation of O(eps)·‖G‖ — measured no effect on healthy
        # iteration counts
        eps = jnp.finfo(B.dtype).eps
        ridge = lambda G: G + (64.0 * eps / k) * jnp.trace(G) \
            * jnp.eye(k, dtype=B.dtype)
        beta = jnp.where(fresh, jnp.zeros_like(rho),
                         jnp.linalg.solve(ridge(rho_old), rho))
        P = Z + _mm(P, beta)
        Q = op_b(P)
        alpha = jnp.linalg.solve(ridge(red(_gram(P, Q))), rho)
        Xn = X + _mm(P, alpha)
        Rn = R - _mm(Q, alpha)
        rec = jnp.sqrt(red(jnp.sum(Rn * Rn, axis=0)))
        # breakdown = singular Gram (residual block lost rank, typically
        # right at convergence): roll the step back and RESTART the
        # conjugacy (fresh search block from the true residual) instead
        # of giving up — two consecutive breakdowns = genuinely stuck
        okstep = jnp.all(jnp.isfinite(alpha)) & jnp.all(jnp.isfinite(rec))
        Xn = jnp.where(okstep, Xn, X)
        # residual replacement at apparent convergence, every 32 its, and
        # on breakdown: the k×k Gram solves drift the recursive residual
        # ~10× from the true one by convergence (measured on 64² Poisson
        # + iluk), so the loop only ever EXITS on a recomputed residual.
        # lax.cond, not where — where would run the SpMV every step.
        trigger = jnp.logical_not(okstep) | jnp.all(rec <= tol) \
            | (it % 32 == 31)
        Rn = jax.lax.cond(trigger,
                          lambda Xn, Rn: B - op_b(Xn),
                          lambda Xn, Rn: Rn,
                          Xn, jnp.where(okstep, Rn, R))
        res_new = jnp.sqrt(red(jnp.sum(Rn * Rn, axis=0)))
        nits = jnp.where((res > tol) & (res_new <= tol), it + 1, nits)
        hist = history_update_block(opts, hist, it + 1, res_new,
                                    r0norm, bnorm)
        # restart conjugacy only on BREAKDOWN — residual replacement
        # keeps the search block (van der Vorst/Ye); restarting on every
        # periodic replacement measured 2.4× the unpreconditioned count
        return (it + 1, Xn, Rn,
                jnp.where(okstep, P, jnp.zeros_like(P)),   # NaN-free restart
                rho, res_new, nits, jnp.logical_not(okstep),
                jnp.logical_not(okstep) & fresh, hist)

    init = (jnp.int32(0), X, R, jnp.zeros_like(B),
            jnp.eye(k, dtype=B.dtype), r0norm,
            jnp.where(r0norm <= tol, 0, opts.maxit
                      ).astype(jnp.int32), jnp.bool_(True), jnp.bool_(False),
            hist0)
    out = jax.lax.while_loop(cond, body, init)
    it, X, R, P, rho, res, nits = out[:7]
    hist = out[9]
    # a maxit/breakdown exit can leave `res` resting on a recursive
    # residual up to 31 steps stale for columns the jnp.all trigger never
    # recomputed — pin the REPORTED residual and flags to a recomputed one
    # unconditionally (one extra block SpMV per solve); columns the
    # recompute un-converges report nits = it (ran the full budget)
    Rf = B - op_b(X)
    res = jnp.sqrt(red(jnp.sum(Rf * Rf, axis=0)))
    nits = jnp.where(res <= tol, jnp.minimum(nits, it), it)
    if opts.record_history:
        # keep the trace self-consistent with the recomputed report: the
        # tail entry would otherwise stay the (drifting) recursive value
        hist = hist.at[:, jnp.minimum(it, opts.maxit)].set(res)
    return X, SolveInfo(nits=nits, residual=res,
                        converged=res <= tol, r0norm=r0norm, bnorm=bnorm,
                        history=hist if opts.record_history else None)
