"""Pipelined (single-reduction) Conjugate Gradient — Ghysels–Vanroose /
Chronopoulos–Gear PCG.

Mathematically equivalent to CG (lssp_tpu/solvers/cg.py; reference
lssp_solver_cg, /root/reference/src/solver-cg.cxx:8-136) but restructured
for multi-chip latency: standard CG's per-iteration dot census is 2 dots +
1 norm at TWO dependent synchronization points (ρ = ⟨z,r⟩ before the SpMV,
⟨q,p⟩ + ‖r‖ after it — SURVEY §3.3), each a separate ``psum`` on a mesh.
Here the three reductions are *merged into one* (γ = ⟨r,u⟩, δ = ⟨w,u⟩ and
‖r‖² share a single stacked psum via ``dot_many``) and all vector updates
hang off recurrences, so one iteration costs exactly ONE cross-chip
reduction latency — the answer when per-shard n is small enough that
interconnect latency, not bandwidth, dominates.

Trade-off: 4 extra vector recurrences (z, q, s, w) ⇒ more HBM traffic per
iteration and slightly weaker rounding behavior than classic CG (the
recurred residual can drift from the true one in long runs); iteration
counts match CG to ±1 in practice (golden-tested vs cg).

No reference analog — the reference is serial (SURVEY §2.7); this method
exists for the distributed path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from lssp_tpu.solvers.base import (
    vdot, dot_many,
    SolveInfo, init_state, stopping_tol, history_init, history_update,
)
from lssp_tpu.solvers.registry import register_solver


@register_solver("pipecg")
def pipecg(A, b, x0=None, M=None, opts=None, dot=vdot):
    op, pc, x, r = init_state(A, b, x0, M)
    bnorm = jnp.sqrt(dot(b, b))
    r0norm = jnp.sqrt(dot(r, r))
    tol = stopping_tol(r0norm, bnorm, opts)
    hist = history_init(opts, r0norm)

    u = pc(r)
    w = op(u)
    zero = jnp.zeros_like(r)
    one = jnp.ones((), b.dtype)

    def cond(carry):
        it = carry[0]
        res = carry[-2]
        return (it < opts.maxit) & (res > tol)

    def body(carry):
        (it, x, r, u, w, p, q, s, z, gamma_old, alpha_old, res, hist) = carry
        # THE one synchronization point: three reductions, one psum
        gamma, delta, rr = dot_many(dot, ((r, u), (w, u), (r, r)))
        m = pc(w)
        n = op(m)
        beta = jnp.where(it == 0, 0.0, gamma / gamma_old)
        denom = delta - beta * gamma / jnp.where(alpha_old == 0, one,
                                                 alpha_old)
        alpha = gamma / jnp.where(it == 0, delta, denom)
        z = n + beta * z          # = A M⁻¹ s recurrence
        q = m + beta * q          # = M⁻¹ s
        s = w + beta * s          # = A p
        p = u + beta * p
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        # rr is ‖r‖² of the state that ENTERED this iteration — the price
        # of pipelining is that the norm is known one reduction late, so
        # the loop runs one extra body relative to cg (nits parity ±1)
        res = jnp.sqrt(rr)
        hist = history_update(opts, hist, it + 1, res, r0norm, bnorm)
        return (it + 1, x, r, u, w, p, q, s, z, gamma, alpha, res, hist)

    init = (jnp.int32(0), x, r, u, w, zero, zero, zero, zero,
            one, jnp.zeros((), b.dtype), r0norm, hist)
    out = jax.lax.while_loop(cond, body, init)
    it, x, r = out[0], out[1], out[2]
    hist = out[-1]
    # the merged reduction reads ‖r‖ one step late (it measures the r that
    # ENTERED the final iteration); report the exact final norm
    res = jnp.sqrt(dot(r, r))
    return x, SolveInfo(nits=it, residual=res, converged=res <= tol,
                        r0norm=r0norm, bnorm=bnorm,
                        history=hist if opts.record_history else None)
