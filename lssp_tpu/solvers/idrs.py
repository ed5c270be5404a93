"""IDR(s) (reference lssp_solver_idrs,
/root/reference/src/solver-idrs.cxx:86-283): s-dimensional shadow space P of
orthonormalized random vectors (deterministic seed, :139-144 — here a fixed
jax PRNG key), s warm-up minimal-residual steps building dX/dR and the s×s
Gram matrix M, then the IDR recurrence with ω recomputed every (s+1)-th step
(:190-215).  The s×s system Mc = m is solved with a dense LU
(jnp.linalg.solve) — a trivially small dense op."""
from __future__ import annotations

import jax
import jax.numpy as jnp

from lssp_tpu.solvers.base import (
    basis_combine,
    vdot, 
    SolveInfo, init_state, stopping_tol, history_init, history_update,
)
from lssp_tpu.solvers.registry import register_solver


@register_solver("idrs")
def idrs(A, b, x0=None, M=None, opts=None, dot=vdot):
    s = opts.idrs
    op, pc, x, r = init_state(A, b, x0, M)
    dtype = b.dtype
    n = b.shape[0]
    bnorm = jnp.sqrt(dot(b, b))
    r0norm = jnp.sqrt(dot(r, r))
    tol = stopping_tol(r0norm, bnorm, opts)
    hist = history_init(opts, r0norm)

    # deterministic shadow space (reference srand(0); fixed key here),
    # orthonormalized by MGS (idrs_orth, :4-21)
    key = jax.random.PRNGKey(0)
    P = jax.random.uniform(key, (s, n), dtype=dtype)

    def orth_body(j, P):
        pj = P[j] / jnp.sqrt(jnp.dot(P[j], P[j]))
        P = P.at[j].set(pj)
        def inner(i, P):
            d = jnp.dot(pj, P[i])
            return jax.lax.cond(i > j, lambda P: P.at[i].set(P[i] - d * pj),
                                lambda P: P, P)
        return jax.lax.fori_loop(0, s, inner, P)
    P = jax.lax.fori_loop(0, s, orth_body, P)

    # warm-up: s minimal-residual steps (:148-171)
    def warm(k, state):
        x, r, dX, dR, Mg, om, res, it, stopped, hist = state
        dx = pc(r)
        dr = op(dx)
        h = dot(dr, dr)
        om_k = dot(dr, r) / jnp.where(h == 0.0, 1.0, h)
        dx = om_k * dx
        dr = -om_k * dr
        go = jnp.logical_not(stopped)
        x = jnp.where(go, x + dx, x)
        r = jnp.where(go, r + dr, r)
        dX = jnp.where(go, dX.at[k].set(dx), dX)
        dR = jnp.where(go, dR.at[k].set(dr), dR)
        res_new = jnp.sqrt(dot(r, r))
        res = jnp.where(go, res_new, res)
        it = jnp.where(go, k + 1, it)
        hist = history_update(opts, hist, k + 1, res)
        Mg = jnp.where(go, Mg.at[:, k].set(jax.vmap(lambda p: dot(p, dR[k]))(P)), Mg)
        stopped = stopped | (res <= tol)
        return (x, r, dX, dR, Mg, om_k, res, it, stopped, hist)

    dX = jnp.zeros((s, n), dtype=dtype)
    dR = jnp.zeros((s, n), dtype=dtype)
    Mg = jnp.eye(s, dtype=dtype)
    state = (x, r, dX, dR, Mg, jnp.ones((), dtype), r0norm, jnp.int32(0),
             jnp.bool_(False), hist)
    x, r, dX, dR, Mg, om, res, it, stopped, hist = jax.lax.fori_loop(
        0, s, warm, state)

    m_vec = jax.vmap(lambda p: dot(p, r))(P)

    def cond(carry):
        it, x, r, dX, dR, Mg, m_vec, om, oldest, res, hist = carry
        return (it <= opts.maxit) & (res > tol)

    def body(carry):
        it, x, r, dX, dR, Mg, m_vec, om, oldest, res, hist = carry
        c = jnp.linalg.solve(Mg, m_vec)
        v = r - basis_combine(c, dR)
        av = pc(v)

        def with_omega():
            t = op(av)
            h = dot(t, t)
            om_new = dot(t, v) / jnp.where(h == 0.0, 1.0, h)
            dx = om_new * av - basis_combine(c, dX)
            dr = -om_new * t - basis_combine(c, dR)
            return dx, dr, om_new

        def without_omega():
            dx = om * av - basis_combine(c, dX)
            dr = op(dx)
            return dx, -dr, om

        dx, dr, om = jax.lax.cond(jnp.mod(it, s + 1) == s,
                                  with_omega, without_omega)
        r = r + dr
        x = x + dx
        dX = dX.at[oldest].set(dx)
        dR = dR.at[oldest].set(dr)
        it = it + 1
        res = jnp.sqrt(dot(r, r))
        hist = history_update(opts, hist, it, res)
        h_vec = jax.vmap(lambda p: dot(p, dr))(P)
        m_vec = m_vec + h_vec
        Mg = Mg.at[:, oldest].set(h_vec)
        oldest = jnp.mod(oldest + 1, s)
        return (it, x, r, dX, dR, Mg, m_vec, om, oldest, res, hist)

    init = (it, x, r, dX, dR, Mg, m_vec, om, jnp.int32(0), res, hist)
    out = jax.lax.while_loop(cond, body, init)
    it, x, res, hist = out[0], out[1], out[9], out[10]
    return x, SolveInfo(nits=it, residual=res, converged=res <= tol,
                        r0norm=r0norm, bnorm=bnorm,
                        history=hist if opts.record_history else None)
