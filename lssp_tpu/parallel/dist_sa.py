"""Distributed structured smoothed-aggregation AMG.

The multi-device form of lssp_tpu/amg/sa.py — the V-cycle that runs
without gathers.  Key alignment property: with every level padded to a
multiple of P·g (P shards, aggregate size g), each shard's rows are whole
aggregates, so restriction/prolongation stay *shard-local reshapes* — the
only communication per level is the banded halo exchange of the A/B/C
SpMVs (`lax.ppermute` neighbour shifts) and the one all-gather feeding the
row-sharded dense coarse solve (exactly like parallel/dist_amg.py).

Planned-depth sizing: the fine level is padded once to a multiple of
P·g^L so every coarser size n₀/gˡ remains divisible by P·g — identity
padding rows are decoupled and cost nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from lssp_tpu.parallel.partition import DistELL, partition_matrix
from lssp_tpu.parallel.dist_ops import apply_dist_spmv
from lssp_tpu.sparse.types import CSR


@dataclasses.dataclass(frozen=True)
class DistSALevel:
    A: Any              # DistDIA (banded levels — gather-free) or DistELL
    B: Any              # DistDIA/DistELL or None (prolongator smoother)
    C: Any              # DistDIA/DistELL or None (restriction smoother)
    dinv: Any           # (P, R_l)
    lmax: float         # static
    g: int              # static
    smoother: str       # static
    degree: int         # static
    n_next: int = 0     # static: shard-LOCAL size of the next level
    agg: Any = None     # static shard-LOCAL aggregation descriptor
                        # (amg/sa.py agg_localize; None = flat g-ranges)
    tri: Any = None     # (dl, d, du, vspike, wspike, Minv_tiled) — LINE
                        # smoother; (P, R_l) each except Minv (P, 2P, 2P).
                        # Lines may cross shard boundaries (the Spike
                        # solve, ops/tridiag.dist_spike_solve, is exact
                        # either way; spikes precomputed at setup)
    nshards: int = 1    # static: mesh size (the Spike interface system
                        # is (2P, 2P) — needs P at trace time)


jax.tree_util.register_pytree_node(
    DistSALevel,
    lambda l: ((l.A, l.B, l.C, l.dinv, l.tri),
               (l.lmax, l.g, l.smoother, l.degree, l.n_next, l.agg,
                l.nshards)),
    lambda aux, c: DistSALevel(*c[:4], tri=c[4], lmax=aux[0], g=aux[1],
                               smoother=aux[2], degree=aux[3],
                               n_next=aux[4], agg=aux[5], nshards=aux[6]))


@dataclasses.dataclass(frozen=True)
class DistSA:
    levels: Tuple[DistSALevel, ...]
    coarse_inv: Any     # (P, Rc, nc) row-sharded dense inverse
    n_top: int          # static: size the hierarchy was BUILT on — the
                        # caller's n, EXCEPT after the grid→flat stall
                        # fallback, where the flat plan padded internally
                        # (the launcher re-pads the system when
                        # n_top != its own n)


jax.tree_util.register_pytree_node(
    DistSA,
    lambda h: ((h.levels, h.coarse_inv), (h.n_top,)),
    lambda aux, c: DistSA(levels=c[0], coarse_inv=c[1], n_top=aux[0]))


def planned_depth(n: int, g: int, coarse_size: int = 512,
                  max_levels: int = 12) -> int:
    """Number of levels the builder will create for an n-row system."""
    L, m = 0, max(n, 1)
    while m > coarse_size and L < max_levels:
        m = -(-m // g)
        L += 1
    return max(L, 1)


def planned_padded_size(n: int, nshards: int, g: int = 4,
                        coarse_size: int = 512, max_levels: int = 12) -> int:
    """Fine-level size after padding to a multiple of P·g^L (so every
    coarser level stays divisible by P·g).

    Iterated to a FIXED POINT: padding can itself push the planned depth up
    one level (the padded size re-crosses the coarse-size threshold), which
    grows the required multiple — the caller and the builder must agree on
    the final size, so keep padding until the plan is self-consistent
    (terminates: the size is nondecreasing and the depth is capped)."""
    n0 = max(n, 1)
    while True:
        L = planned_depth(n0, g, coarse_size, max_levels)
        m = nshards * g ** L
        n1 = ((n0 + m - 1) // m) * m
        if n1 == n0:
            return n0
        n0 = n1


def _dist_tri_parts(Ah, nshards: int, dtype):
    """(dl, d, du) stacked (P, R) for the distributed line smoother.
    Lines MAY cross shard boundaries: the cross couplings stay in this
    shard's dl[0]/du[-1] slots, exactly where ops/tridiag.dist_pcr_solve
    (Spike substructuring) expects them — no restriction, no fallback
    (round 2 required boundary-aligned lines and silently dropped to
    Chebyshev otherwise).

    O(nnz) extraction via the scipy diagonals — only the ±1/0 couplings
    matter here (the smoother's SpMV runs on the separately partitioned
    operator), so no DIA densification or diagonal-count cap applies."""
    from lssp_tpu.ops.tridiag import spike_interface_host
    nl = Ah.shape[0]
    R = nl // nshards
    d0 = np.asarray(Ah.diagonal(0))
    dl = np.zeros(nl); dl[1:] = Ah.diagonal(-1)   # dl[i] = A[i, i-1]
    du = np.zeros(nl); du[:-1] = Ah.diagonal(1)   # du[i] = A[i, i+1]
    dls = dl.astype(dtype).reshape(nshards, R)
    d0s = d0.astype(dtype).reshape(nshards, R)
    dus = du.astype(dtype).reshape(nshards, R)
    # b-independent Spike pieces once per level at setup (boundary spikes
    # + interface inverse); Minv is tiled (P, 2P, 2P) so the launcher's
    # uniform P(AXIS)-shard-then-[0] leaf convention replicates it
    v, w, Minv = spike_interface_host(dls, d0s, dus)
    return (jnp.asarray(dls), jnp.asarray(d0s), jnp.asarray(dus),
            jnp.asarray(v), jnp.asarray(w),
            jnp.asarray(np.tile(Minv[None], (nshards, 1, 1))))


def build_dist_sa(A: CSR, nshards: int, g: int = 4, max_levels: int = 12,
                  coarse_size: int = 512, smoother: str = "chebyshev",
                  degree: int = 2, filter_tol: float = 1e-3,
                  smooth_levels=None, dtype=None, grid=None) -> DistSA:
    """``grid``: (gy, gx) row-major dims → direction-aware grid
    aggregation with shard-aligned reshape groups (None auto-detects,
    False forces flat).  Grid mode needs gy % P == 0 (whole grid rows per
    shard) and then no padding at all; flat mode pre-pads to the planned
    P·gᴸ multiple as before.  ``smooth_levels=None``: all levels in grid
    mode (grid-independent convergence; B is pattern-bounded), 2 flat."""
    from lssp_tpu.amg.sa import (sa_host_levels, _pad_identity, detect_grid,
                                 agg_localize)

    dtype = dtype or np.asarray(A.data).dtype
    n = A.shape[0]
    if grid is None:
        grid = detect_grid(A)
    elif grid is False:
        grid = None
    if grid is not None and (grid[0] * grid[1] != n or n % nshards
                             or grid[0] % nshards):
        grid = None
    smooth_levels_arg = smooth_levels        # caller's explicit choice
    if smooth_levels is None:
        smooth_levels = max_levels if grid is not None else 2
    if grid is not None:
        levels, Al, _ = sa_host_levels(
            A, g=g, max_levels=max_levels, coarse_size=coarse_size,
            filter_tol=filter_tol, smooth_levels=smooth_levels,
            grid=grid, shards=nshards)
        if Al.shape[0] > 4 * coarse_size:
            # shard alignment stopped grid coarsening too early (e.g.
            # (gy/P) % g != 0 after the x-direction is exhausted): a
            # dense inverse of that operator would dominate setup and
            # every V-cycle — rebuild with the flat planned-padding
            # hierarchy, which coarsens any n to ~coarse_size
            from lssp_tpu.utils.log import warning
            warning(f"distributed saamg: shard alignment stopped grid "
                    f"coarsening at {Al.shape[0]} rows — falling back to "
                    "the flat hierarchy (grid-aware smoothing lost; "
                    "consider a shard count dividing the coarse grid)")
            grid = None
            # flat default only when the caller left the choice to us
            if smooth_levels_arg is None:
                smooth_levels = 2
    if grid is None:
        n0 = planned_padded_size(n, nshards, g, coarse_size, max_levels)
        # depth must be planned on the PADDED size (the fixed point
        # guarantees the padded size's own plan agrees with itself)
        L = planned_depth(n0, g, coarse_size, max_levels)
        Ap = CSR.from_scipy(_pad_identity(A.to_scipy().tocsr(), n0 - n))
        levels, Al, _ = sa_host_levels(
            Ap, g=g, max_levels=L, coarse_size=0, filter_tol=filter_tol,
            smooth_levels=smooth_levels, pad_mult=nshards * g)

    dlev = []
    for (Ah, B, C, dinv, lmax, n_c, agg) in levels:
        nl = Ah.shape[0]
        assert nl % nshards == 0
        if agg is None:
            assert (nl // nshards) % g == 0
        tri = None
        if smoother == "line":
            tri = _dist_tri_parts(Ah, nshards, dtype)
        dlev.append(DistSALevel(
            A=partition_matrix(CSR.from_scipy(Ah.astype(dtype)), nshards),
            B=(partition_matrix(CSR.from_scipy(B.astype(dtype)), nshards)
               if B is not None else None),
            C=(partition_matrix(CSR.from_scipy(C.astype(dtype)), nshards)
               if C is not None else None),
            dinv=jnp.asarray(dinv.astype(dtype).reshape(nshards, -1)),
            lmax=float(lmax), g=g, smoother=smoother, degree=degree,
            n_next=n_c // nshards, agg=agg_localize(agg, nshards),
            tri=tri, nshards=nshards))
    nc = Al.shape[0]
    nc_pad = ((nc + nshards - 1) // nshards) * nshards
    ci = np.zeros((nc_pad, nc_pad), dtype=dtype)
    ci[:nc, :nc] = np.linalg.inv(Al.toarray()).astype(dtype)
    coarse_inv = jnp.asarray(ci.reshape(nshards, nc_pad // nshards, nc_pad))
    # n_top = size the hierarchy was BUILT on.  Normally the caller's n
    # (grid mode: unpadded; flat mode: the caller pre-padded), but after
    # the grid→flat stall fallback the flat plan padded internally — the
    # launcher compares n_top to its own size and re-pads the system
    n_top = levels[0][0].shape[0] if levels else Al.shape[0]
    return DistSA(levels=tuple(dlev), coarse_inv=coarse_inv, n_top=n_top)


def dist_sa_vcycle(h: DistSA, b_local, axis: str):
    """One V-cycle on a row-sharded rhs; call inside shard_map (leaves of
    ``h`` are the per-shard slices)."""

    def smooth(lev, Aop, x_l, b_l):
        if lev.smoother == "line" and lev.tri is not None:
            # damped line Jacobi; the Spike tridiagonal solve is exact
            # even when lines cross shard boundaries.  Spikes + interface
            # inverse were precomputed at setup (_dist_tri_parts), so each
            # sweep runs one local PCR rhs + a 2-scalar all_gather
            from lssp_tpu.ops.tridiag import (line_jacobi_sweeps,
                                              dist_spike_solve)
            dl, d0, du, vs, ws, mi = lev.tri
            solve_t = lambda a, c, e, r: dist_spike_solve(
                a, c, e, vs, ws, mi, r, axis, lev.nshards)
            return line_jacobi_sweeps((dl, d0, du), Aop, x_l, b_l,
                                      lev.degree, tri_solve=solve_t)
        if lev.smoother == "jacobi" or lev.lmax <= 0:
            for _ in range(lev.degree):
                x_l = x_l + (2.0 / 3.0) * lev.dinv * (b_l - Aop(x_l))
            return x_l
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
        if l == len(h.levels):
            b_full = lax.all_gather(b_l, axis, tiled=True)
            return jnp.matmul(h.coarse_inv, b_full,
                              precision=jax.lax.Precision.HIGHEST)
        lev = h.levels[l]
        Aop = lambda v: apply_dist_spmv(lev.A, axis, v)
        x_l = smooth(lev, Aop, x_l, b_l)
        r = b_l - Aop(x_l)
        if lev.C is not None:
            r = apply_dist_spmv(lev.C, axis, r)
        # shard-local P0ᵀ / P0 — reshape groups never cross shards (flat
        # by planned padding; grid modes by the builder's alignment rules)
        from lssp_tpu.amg.sa import agg_restrict, agg_prolong
        rc = agg_restrict(lev.agg, lev.g, lev.n_next, r)
        ec = cycle(l + 1, rc, jnp.zeros_like(rc))
        e = agg_prolong(lev.agg, lev.g, lev.n_next, ec)
        if lev.B is not None:
            e = apply_dist_spmv(lev.B, axis, e)
        x_l = x_l + e
        return smooth(lev, Aop, x_l, b_l)

    return cycle(0, b_local, jnp.zeros_like(b_local))
