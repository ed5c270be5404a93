"""Batched tridiagonal solves via parallel cyclic reduction (PCR).

The data-parallel tridiagonal solver: the Thomas algorithm is a sequential
recurrence (unrunnable on SIMD hardware, like the triangular solves —
SURVEY §7 "hard parts"), but PCR eliminates the couplings in log2(n)
full-width steps, each a handful of shifted elementwise ops — pure
streaming, zero gathers (shifts are pads + static slices, the same
trick as the DIA SpMV).

Used by the multigrid LINE smoother (amg/sa.py): for strongly anisotropic
operators, point smoothers (Jacobi/Chebyshev) cannot damp errors that are
smooth along the strong direction, which is why iteration counts explode
with problem size; solving whole strong-direction lines restores
size-robust convergence (the standard structured-multigrid answer, here
with the data-parallel solver).

Zero off-diagonals decouple the system into independent lines
automatically, so a (n,) tridiagonal whose couplings vanish at grid-row
boundaries IS the batched per-line solve — no reshaping or line
bookkeeping needed.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _shift(a, s):
    """a shifted by s along the last axis, zero-filled (static s)."""
    n = a.shape[-1]
    if s == 0:
        return a
    if s > 0:        # a[..., i - s]
        pad = [(0, 0)] * (a.ndim - 1) + [(s, 0)]
        return jnp.pad(a, pad)[..., :n]
    pad = [(0, 0)] * (a.ndim - 1) + [(0, -s)]
    return jnp.pad(a, pad)[..., -n:]


@functools.partial(jax.jit, static_argnames=("steps",))
def pcr_solve(dl, d, du, b, steps=None):
    """Solve T x = b for a (batch of) tridiagonal system(s).

    ``dl``/``d``/``du``: sub-/main-/super-diagonal, shape (..., n) with
    ``dl[..., 0] == 0`` and ``du[..., n-1] == 0`` (standard banded layout);
    ``b``: right-hand side(s), same shape.  Returns x.

    Parallel cyclic reduction: at step k (stride s = 2^k) each equation i
    eliminates its couplings to i±s using rows i±s, doubling the coupling
    distance; after ceil(log2(n)) steps the system is diagonal.  Work is
    O(n log n) instead of Thomas's O(n), but every step is full-width
    vector arithmetic — the right trade on a machine with no fast serial
    path.  Numerically stable for diagonally dominant systems (the line
    -smoother case: grid operators are).
    """
    n = d.shape[-1]
    if steps is None:
        steps = max(1, int(np.ceil(np.log2(max(n, 2)))))

    # alpha eliminates the coupling to i-s, beta to i+s; out-of-range
    # neighbours are zero-filled and their dl/du are 0 there, so boundary
    # updates vanish automatically (garbage alphas at the edges only ever
    # multiply those zeros).  The stride doubles each step; the log-depth
    # loop is unrolled statically (steps <= ~25 for any practical n).
    s = 1
    for _ in range(steps):
        d_l = _shift(d, s)       # d[i-s]
        d_r = _shift(d, -s)      # d[i+s]
        dl_l = _shift(dl, s)
        du_r = _shift(du, -s)
        b_l = _shift(b, s)
        b_r = _shift(b, -s)
        dl_r = _shift(dl, -s)
        du_l = _shift(du, s)
        safe_l = jnp.where(d_l == 0, 1.0, d_l)
        safe_r = jnp.where(d_r == 0, 1.0, d_r)
        alpha = -dl / safe_l
        beta = -du / safe_r
        d = d + alpha * du_l + beta * dl_r
        b_new = b + alpha * b_l + beta * b_r
        dl = alpha * dl_l
        du = beta * du_r
        b = b_new
        s *= 2
    return b / jnp.where(d == 0, 1.0, d)


def tridiag_parts(A_dia):
    """Extract (dl, d, du) from a DIA container (offsets must include 0;
    -1/+1 taken when present, zeros otherwise) — the line-smoother setup."""
    offs = A_dia.offsets
    data = np.asarray(A_dia.data)
    n = A_dia.shape[0]

    def diag(off):
        if off in offs:
            return data[offs.index(off)].copy()
        return np.zeros(n, dtype=data.dtype)

    d = diag(0)
    # row-aligned convention: data[d, i] = A[i, i+off] ⇒ the subdiagonal
    # entry of ROW i is A[i, i-1] = data(-1)[i], the superdiagonal
    # A[i, i+1] = data(+1)[i]; banded layout wants dl[0] = du[n-1] = 0,
    # which the DIA storage already guarantees (out-of-range slots are 0)
    dl = diag(-1)
    du = diag(1)
    return dl, d, du


def dist_pcr_solve(dl, d, du, b, axis: str, nshards: int):
    """Distributed tridiagonal solve across a ``shard_map`` axis — the
    Spike / substructuring algorithm, exact even when lines CROSS shard
    boundaries (the restriction the shard-local smoother had):

    1. shard-local PCR with three stacked rhs: y = T_loc⁻¹ b and the two
       boundary spikes v = T_loc⁻¹(a_lo·e₁), w = T_loc⁻¹(a_hi·e_R), where
       a_lo = dl[0], a_hi = du[-1] are the cross-shard couplings (T_loc is
       the local tridiagonal with those zeroed);
    2. ONE all_gather of six interface scalars per shard;
    3. a redundant dense solve of the (2P, 2P) interface system coupling
       each shard's first/last unknowns;
    4. a local rank-2 correction  x = y − v·x_prev_last − w·x_next_first.

    When no line crosses a boundary the spikes are identically zero and
    the result equals plain per-shard PCR.  Inputs are this shard's (R,)
    slices; the banded layout guarantees dl[0] = du[-1] = 0 on the global
    edges, which is what makes the wrapped interface scatters below
    harmless (they only ever add zeros)."""
    P = nshards
    a_lo = dl[0]
    a_hi = du[-1]
    dl_l = dl.at[0].set(0.0)
    du_l = du.at[-1].set(0.0)
    e1 = jnp.zeros_like(b).at[0].set(1.0)
    eR = jnp.zeros_like(b).at[-1].set(1.0)
    y, v, w = pcr_solve(dl_l, d, du_l,
                        jnp.stack([b, a_lo * e1, a_hi * eR]))
    vals = jnp.stack([y[0], y[-1], v[0], v[-1], w[0], w[-1]])
    allv = jax.lax.all_gather(vals, axis)                     # (P, 6)
    y0, yR, v0, vR, w0, wR = (allv[:, j] for j in range(6))
    # interface unknowns u = [x_p[0], x_p[-1]] interleaved, length 2P:
    #   u_{2p}   + v0_p·u_{2p-1} + w0_p·u_{2p+2} = y0_p
    #   u_{2p+1} + vR_p·u_{2p-1} + wR_p·u_{2p+2} = yR_p
    p2 = 2 * jnp.arange(P)
    M = jnp.eye(2 * P, dtype=d.dtype)
    M = M.at[p2, (p2 - 1) % (2 * P)].add(v0)
    M = M.at[p2 + 1, (p2 - 1) % (2 * P)].add(vR)
    M = M.at[p2, (p2 + 2) % (2 * P)].add(w0)
    M = M.at[p2 + 1, (p2 + 2) % (2 * P)].add(wR)
    u = jnp.linalg.solve(M, jnp.stack([y0, yR], axis=1).reshape(-1))
    p = jax.lax.axis_index(axis)
    u_prev = jnp.where(p > 0, u[(2 * p - 1) % (2 * P)], 0.0)
    u_next = jnp.where(p < P - 1, u[(2 * p + 2) % (2 * P)], 0.0)
    return y - v * u_prev - w * u_next


def spike_interface_host(dl, d, du):
    """Precompute the b-INDEPENDENT parts of the Spike solve on the host
    at setup: per-shard boundary spikes v = T_loc⁻¹(a_lo·e₁),
    w = T_loc⁻¹(a_hi·e_R), and the inverse of the (2P, 2P) interface
    matrix they induce.  ``dl``/``d``/``du`` are the stacked (P, R)
    shard slices (cross-shard couplings in dl[p, 0] / du[p, -1]).

    Everything here is loop-invariant across smoothing sweeps — computed
    per hierarchy level once, instead of re-running two extra PCR rhs,
    a 6-scalar gather, the interface scatter-assembly, and a dense
    ``jnp.linalg.solve`` inside every sweep of every V-cycle of every
    Krylov iteration (relying on XLA LICM to hoist them)."""
    import scipy.linalg as sla
    dl = np.asarray(dl); d = np.asarray(d); du = np.asarray(du)
    P, R = d.shape
    v = np.zeros((P, R), d.dtype)
    w = np.zeros((P, R), d.dtype)
    for p in range(P):
        ab = np.zeros((3, R), np.float64)
        ab[0, 1:] = du[p, :-1]          # superdiag (du[i] = A[i, i+1])
        ab[1] = d[p]
        ab[2, :-1] = dl[p, 1:]          # subdiag (dl[i] = A[i, i-1])
        ab[1, ab[1] == 0.0] = 1.0       # decoupled slots: keep solvable
        rhs = np.zeros((R, 2), np.float64)
        rhs[0, 0] = dl[p, 0]            # a_lo · e1
        rhs[-1, 1] = du[p, -1]          # a_hi · eR
        sol = sla.solve_banded((1, 1), ab, rhs)
        v[p] = sol[:, 0]
        w[p] = sol[:, 1]
    p2 = 2 * np.arange(P)
    M = np.eye(2 * P)
    M[p2, (p2 - 1) % (2 * P)] += v[:, 0]
    M[p2 + 1, (p2 - 1) % (2 * P)] += v[:, -1]
    M[p2, (p2 + 2) % (2 * P)] += w[:, 0]
    M[p2 + 1, (p2 + 2) % (2 * P)] += w[:, -1]
    return v, w, np.linalg.inv(M).astype(d.dtype)


def dist_spike_solve(dl, d, du, vspike, wspike, Minv, b, axis: str,
                     nshards: int):
    """Prepared-interface Spike solve: same algebra as ``dist_pcr_solve``
    but with the spikes and interface inverse from
    ``spike_interface_host`` — per application only ONE local PCR rhs,
    a 2-scalar all_gather, and a small mul+sum matvec remain."""
    P = nshards
    dl_l = dl.at[0].set(0.0)
    du_l = du.at[-1].set(0.0)
    y = pcr_solve(dl_l, d, du_l, b)
    allv = jax.lax.all_gather(jnp.stack([y[0], y[-1]]), axis)   # (P, 2)
    rhs = allv.reshape(-1)
    # mul+sum, not @: no backend may route it through a reduced-precision
    # matrix unit (see solvers/base.py: vdot)
    u = jnp.sum(Minv * rhs[None, :], axis=1)
    p = jax.lax.axis_index(axis)
    u_prev = jnp.where(p > 0, u[(2 * p - 1) % (2 * P)], 0.0)
    u_next = jnp.where(p < P - 1, u[(2 * p + 2) % (2 * P)], 0.0)
    return y - vspike * u_prev - wspike * u_next


def line_jacobi_sweeps(tri, Aop, x, b, degree: int, damping: float = 0.7,
                       tri_solve=pcr_solve):
    """Damped line-Jacobi smoothing: ``degree`` sweeps of
    ``x += damping * T^{-1}(b - A x)`` with T the strong-direction
    tridiagonal part — THE shared kernel for the single-device and
    distributed saamg line smoothers (one copy of the damping constant;
    the distributed path passes a ``dist_pcr_solve`` partial)."""
    dl, d0, du = tri
    for _ in range(degree):
        x = x + damping * tri_solve(dl, d0, du, b - Aop(x))
    return x
