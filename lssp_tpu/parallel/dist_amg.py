"""Distributed AMG: the multilevel hierarchy row-partitioned over the mesh.

Every level's operators (A_l, P_l, R_l) are padded to a shard-divisible row
count and stored as stacked per-shard padded-ELL arrays; the V-cycle runs
entirely inside ``shard_map`` — smoothing and transfers use an all-gather of
the (small) level vector followed by local gathers, the coarsest solve is a
row-sharded dense matmul against the replicated coarse inverse.  This is
BASELINE config #5's "multi-host partition" path: the same program shape
scales from the 8-virtual-device CPU mesh to a real pod slice (all
collectives are `lax.all_gather`/`psum` over one mesh axis).

Communication accounting per V-cycle (P shards, level sizes n_l):
  all-gathers of x at each smoothing/transfer step — O(Σ n_l) ≈ 2·n_0 words,
  the same order as one fine-level halo exchange when levels coarsen by ~2×.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from lssp_tpu.amg.setup import AMGHierarchy
from lssp_tpu.sparse.types import CSR


@dataclasses.dataclass(frozen=True)
class DistAMGLevel:
    # all leaves carry a leading shard axis
    a_cols: Any     # (P, R_l, kA) — global (padded) column ids
    a_data: Any
    p_cols: Any     # (P, R_l, kP) into the coarse padded vector; None on last
    p_data: Any
    r_cols: Any     # (P, Rc_l, kR) into this level's padded vector; None on last
    r_data: Any
    dinv: Any       # (P, R_l)
    n_pad: int      # static: padded rows of this level
    nc_pad: int     # static: padded rows of the next level (0 on last)
    degree: int     # static: smoothing steps / Chebyshev degree
    omega: float    # static: Jacobi damping
    lmax: float     # static: λ_max(D⁻¹A) estimate (Chebyshev interval)
    smoother: str   # static: "jacobi" | "chebyshev"


jax.tree_util.register_pytree_node(
    DistAMGLevel,
    lambda l: ((l.a_cols, l.a_data, l.p_cols, l.p_data, l.r_cols, l.r_data,
                l.dinv), (l.n_pad, l.nc_pad, l.degree, l.omega, l.lmax,
                          l.smoother)),
    lambda aux, c: DistAMGLevel(*c, n_pad=aux[0], nc_pad=aux[1],
                                degree=aux[2], omega=aux[3], lmax=aux[4],
                                smoother=aux[5]))


@dataclasses.dataclass(frozen=True)
class DistAMG:
    levels: Tuple[DistAMGLevel, ...]
    coarse_inv: Any     # (P, Rc, nc_pad) — row-sharded dense inverse


jax.tree_util.register_pytree_node(
    DistAMG,
    lambda h: ((h.levels, h.coarse_inv), ()),
    lambda aux, c: DistAMG(levels=c[0], coarse_inv=c[1]))


def _pad_ell(S, nshards: int, ncols_pad: int, dtype):
    """scipy CSR → stacked per-shard padded ELL with global column ids.
    Rows padded to a shard-divisible count (zero rows)."""
    S = S.tocsr()
    n = S.shape[0]
    n_pad = ((n + nshards - 1) // nshards) * nshards
    R = n_pad // nshards
    rn = np.diff(S.indptr)
    k = max(1, int(rn.max()) if n else 1)
    cols = np.zeros((n_pad, k), dtype=np.int32)
    data = np.zeros((n_pad, k), dtype=dtype)
    valid = np.arange(k)[None, :] < rn[:, None]
    flat = (S.indptr[:-1][:, None] + np.arange(k)[None, :])[valid]
    cols[:n][valid] = S.indices[flat]
    data[:n][valid] = S.data[flat]
    return cols.reshape(nshards, R, k), data.reshape(nshards, R, k), n_pad


def build_dist_amg(hier: AMGHierarchy, nshards: int, dtype=np.float64,
                   degree: int = 2, omega: float = 2.0 / 3.0,
                   smoother: str = "chebyshev") -> DistAMG:
    levels = []
    n_pads = []
    for lev in hier.levels:
        ac, ad, n_pad = _pad_ell(lev.A.astype(dtype), nshards, 0, dtype)
        n_pads.append(n_pad)
    for i, lev in enumerate(hier.levels):
        ac, ad, n_pad = _pad_ell(lev.A.astype(dtype), nshards, 0, dtype)
        dinv = np.ones(n_pad, dtype=dtype)
        dinv[: len(lev.dinv)] = lev.dinv.astype(dtype)
        dinv = dinv.reshape(nshards, -1)
        if lev.P is not None:
            pc_, pd, _ = _pad_ell(lev.P.astype(dtype), nshards, 0, dtype)
            rc_, rd, _ = _pad_ell(lev.P.T.tocsr().astype(dtype), nshards, 0,
                                  dtype)
            nc_pad = n_pads[i + 1]
        else:
            pc_ = pd = rc_ = rd = None
            nc_pad = 0
        levels.append(DistAMGLevel(
            a_cols=ac, a_data=ad, p_cols=pc_, p_data=pd, r_cols=rc_,
            r_data=rd, dinv=jnp.asarray(dinv), n_pad=n_pad, nc_pad=nc_pad,
            degree=degree, omega=omega, lmax=float(lev.lmax),
            smoother=smoother))
    nc = hier.coarse_inv.shape[0]
    nc_pad = levels[-1].n_pad
    ci = np.zeros((nc_pad, nc_pad), dtype=dtype)
    ci[:nc, :nc] = hier.coarse_inv.astype(dtype)
    coarse_inv = ci.reshape(nshards, nc_pad // nshards, nc_pad)
    return DistAMG(levels=tuple(levels), coarse_inv=jnp.asarray(coarse_inv))


def _ag_spmv(cols, data, x_local, axis):
    """All-gather x over the mesh axis, then local padded-ELL row gather."""
    x_full = lax.all_gather(x_local, axis, tiled=True)
    return jnp.sum(data * x_full[cols], axis=1)


def dist_vcycle(h: DistAMG, b_local, axis: str):
    """One V-cycle on a row-sharded rhs (call inside shard_map).  Leaves of
    ``h`` must already be the per-shard slices (no leading shard axis)."""

    def smooth(lev, x_l, b_l):
        Aop = lambda v: _ag_spmv(lev.a_cols, lev.a_data, v, axis)
        if lev.smoother == "jacobi" or lev.lmax <= 0:
            for _ in range(lev.degree):
                x_l = x_l + lev.omega * lev.dinv * (b_l - Aop(x_l))
            return x_l
        # Chebyshev on [0.3·lmax, 1.1·lmax] of D⁻¹A (matches amg/cycle.py)
        ub, lb = 1.1 * lev.lmax, 0.3 * lev.lmax
        theta, delta = (ub + lb) / 2.0, (ub - lb) / 2.0
        sigma = theta / delta
        rho = 1.0 / sigma
        r = lev.dinv * (b_l - Aop(x_l))
        d = r / theta
        for _ in range(lev.degree):
            x_l = x_l + d
            r = r - lev.dinv * Aop(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            rho = rho_new
        return x_l

    def cycle(l, b_l, x_l):
        lev = h.levels[l]
        if l == len(h.levels) - 1:
            b_full = lax.all_gather(b_l, axis, tiled=True)
            return jnp.matmul(h.coarse_inv, b_full,
                              precision=jax.lax.Precision.HIGHEST)
        x_l = smooth(lev, x_l, b_l)
        r = b_l - _ag_spmv(lev.a_cols, lev.a_data, x_l, axis)
        rc = _ag_spmv(lev.r_cols, lev.r_data, r, axis)
        ec = cycle(l + 1, rc, jnp.zeros_like(rc))
        x_l = x_l + _ag_spmv(lev.p_cols, lev.p_data, ec, axis)
        return smooth(lev, x_l, b_l)

    return cycle(0, b_local, jnp.zeros_like(b_local))
