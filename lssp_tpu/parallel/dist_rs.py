"""Distributed gather-free classical AMG (rsamg over the mesh).

The classical hierarchy (amg/rs.py) rides the EXISTING dist_sa
machinery unchanged, through one identity:

    P·ec  =  P̂ · broadcast(ec)          P̂ square, banded
    Pᵀ·r  =  pairsum( P̂ᵀ · r )

where ``broadcast``/``pairsum`` are the shard-local pair reshapes
dist_sa already performs (its ``agg`` descriptors) and P̂ places each
interpolation weight P[i, c] at the fine column of c's PARITY-MATCHING
group member — making the column offset constant per coarse offset, so
P̂ partitions onto the DistDIA halo-exchange path like any banded
operator.  A distributed classical V-cycle is therefore literally a
``DistSA`` whose B := P̂ and C := P̂ᵀ, executed by ``dist_sa_vcycle``:
the only communication is the banded halo exchange of A/P̂/P̂ᵀ SpMVs
plus the coarse-solve all-gather — identical structure (and code) to
the distributed saamg cycle.

Shard-alignment gates (mirrored by the launcher's sizing): pair groups
must not straddle the row-shard cuts, so an axis is coarsenable only
when its extent is even and the outer row block divides the shard count
appropriately; coarsening stops early when no axis qualifies (the
row-sharded dense coarse solve absorbs the remainder, as in dist_sa).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from lssp_tpu.parallel.dist_sa import DistSA, DistSALevel
from lssp_tpu.parallel.partition import partition_matrix
from lssp_tpu.sparse.types import CSR

__all__ = ["build_dist_rs", "axis_feasible", "phat_from_p"]


def axis_feasible(dims, axis: int, P: int) -> bool:
    """Pair-coarsening along ``axis`` keeps groups shard-local: the axis
    extent must be even, and the pairs must sit inside one row shard.
    Row shards are blocks of n/P consecutive rows (row-major (z, y, x)):

    * axis 2 (x): view (nz·ny, nx) — sa "x" pairs live inside grid rows;
      shards must hold whole view rows: (nz·ny) % P == 0.
    * axis 1 (y): view (nz·ny, nx) — sa "y" pairs join view rows 2k,2k+1;
      needs whole view rows per shard, an even per-shard row count, and
      pairs that never straddle a z-plane: ny even (guaranteed by the
      even-extent gate) and (nz·ny) % P == 0, ((nz·ny)//P) % 2 == 0.
    * axis 0 (z): view (nz, ny·nx) — sa "y" pairs of whole planes:
      nz % P == 0 and (nz//P) % 2 == 0.
    """
    nz, ny, nx = dims
    if dims[axis] % 2:
        return False
    if axis == 2:
        return nx > 1 and (nz * ny) % P == 0
    if axis == 1:
        return ny > 1 and (nz * ny) % P == 0 and ((nz * ny) // P) % 2 == 0
    return nz > 1 and nz % P == 0 and (nz // P) % 2 == 0


def _local_agg(dims, axis: int, P: int):
    """Shard-LOCAL sa.py agg descriptor for the pair mode (the 2-D views
    of axis_feasible, outer dim divided by the shard count)."""
    nz, ny, nx = dims
    if axis == 2:
        return ("x", 2, (nz * ny) // P, nx, -(-nx // 2))
    if axis == 1:
        gy_l = (nz * ny) // P
        return ("y", 2, gy_l, nx, gy_l // 2)
    gy_l = nz // P
    return ("y", 2, gy_l, ny * nx, gy_l // 2)


def phat_from_p(Pm, grp: np.ndarray, dims, axis: int):
    """P̂ (n × n): every interpolation entry P[i, c] moved to the fine
    column of c's parity-matching member, so P̂·broadcast(ec) == P·ec.
    Even-extent coarsening (the feasibility gate) makes the mapping
    total; a clamp guards ragged edges anyway."""
    import scipy.sparse as sp
    nz, ny, nx = dims
    cd = [nz, ny, nx]
    cd[axis] = -(-dims[axis] // 2)
    Pm = Pm.tocsr()
    n = Pm.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(Pm.indptr))
    c = Pm.indices.astype(np.int64)
    ccoord = [c // (cd[1] * cd[2]), (c // cd[2]) % cd[1], c % cd[2]]
    icoord = [rows // (ny * nx), (rows // nx) % ny, rows % nx]
    jcoord = list(ccoord)
    for a in range(3):
        if a == axis:
            jcoord[a] = np.minimum(ccoord[a] * 2 + (icoord[a] % 2),
                                   dims[a] - 1)
        # non-coarsened axes: coarse coordinate IS the fine coordinate
    j = (jcoord[0] * ny + jcoord[1]) * nx + jcoord[2]
    return sp.csr_matrix((Pm.data.copy(), j.astype(np.int64),
                          Pm.indptr.copy()), shape=(n, n))


def build_dist_rs(A: CSR, nshards: int, theta: float = 0.25,
                  max_levels: int = 12, coarse_size: int = 512,
                  smoother: str = "chebyshev", degree: int = 2,
                  dtype=None, max_pdiags: int = 40,
                  theta_dir: float = 4.0) -> Optional[DistSA]:
    """Distributed classical hierarchy, or None when the matrix is not a
    shard-alignable lattice (the launcher falls back to dist saamg)."""
    import scipy.sparse as sp
    from lssp_tpu import native
    from lssp_tpu.amg.rs import (detect_grid3, _axis_strengths,
                                 group_index, axis_parity, elect_cpoints,
                                 cap_offsets, coarse_dims)
    from lssp_tpu.amg.setup import (strength_graph, direct_interpolation,
                                    lambda_est)

    dtype = dtype or np.asarray(A.data).dtype
    n = A.shape[0]
    dims = detect_grid3(A)
    if dims is None or dims[0] * dims[1] * dims[2] != n or n % nshards:
        return None
    if not any(axis_feasible(dims, a, nshards) for a in range(3)):
        return None

    Al = A.to_scipy().tocsr().astype(np.float64)
    host_levels = []
    prev_axis = None
    for _ in range(max_levels):
        if Al.shape[0] <= coarse_size:
            break
        s = _axis_strengths(Al, dims)
        ok = [axis_feasible(dims, a, nshards) for a in range(3)]
        axis = None
        for a in range(3):
            others = max(max((s[b] for b in range(3) if b != a),
                             default=0.0), 1e-300)
            if ok[a] and s[a] >= theta_dir * others:
                axis = a
                break
        if axis is None:
            start = (prev_axis + 1) if prev_axis is not None else 2
            for k in range(3):
                a = (start + k) % 3
                if ok[a]:
                    axis = a
                    break
        if axis is None:
            break                       # alignment exhausted: coarse here
        prev_axis = axis
        nl = Al.shape[0]
        agg = ("ax", axis, dims)
        grp, M = group_index(agg, 2, nl)
        parity = axis_parity(agg, nl)
        d = Al.diagonal().copy()
        d[d == 0] = 1.0
        dinv = 1.0 / d
        S = strength_graph(Al, theta)
        crows = elect_cpoints(S, grp, M, parity)
        state = np.full(nl, -1, dtype=np.int8)
        state[crows] = 1
        Pm = direct_interpolation(Al, S, state)
        cmap_grp = grp[np.sort(crows)]
        Pm = sp.csr_matrix((Pm.data, cmap_grp[Pm.indices], Pm.indptr),
                           shape=(nl, M))
        Pm, offsets, kept = cap_offsets(Pm, grp, max_pdiags)
        lmax = lambda_est(Al, dinv)
        Ac = native.rap(Al, Pm, np.arange(M, dtype=np.int64), M) \
            if native.available() else None
        if Ac is None:
            Ac = (Pm.T @ Al @ Pm).tocsr()
        Ac.eliminate_zeros()
        zd = Ac.diagonal() == 0
        if zd.any():
            Ac = (Ac + sp.diags(zd.astype(np.float64))).tocsr()
        Ac.sort_indices()
        Phat = phat_from_p(Pm, grp, dims, axis)
        host_levels.append((Al, Phat, dinv, lmax, axis, dims, M))
        Al = Ac
        dims = coarse_dims(agg)

    if not host_levels:
        return None

    dlev = []
    for (Ah, Phat, dinv, lmax, axis, ldims, M) in host_levels:
        nl = Ah.shape[0]
        assert nl % nshards == 0 and M % nshards == 0, (nl, M, nshards)
        dlev.append(DistSALevel(
            A=partition_matrix(CSR.from_scipy(Ah.astype(dtype)), nshards),
            B=partition_matrix(CSR.from_scipy(Phat.astype(dtype)),
                               nshards),
            C=partition_matrix(CSR.from_scipy(Phat.T.tocsr().astype(dtype)),
                               nshards),
            dinv=jnp.asarray(dinv.astype(dtype).reshape(nshards, -1)),
            lmax=float(lmax), g=2, smoother=smoother, degree=degree,
            n_next=M // nshards, agg=_local_agg(ldims, axis, nshards),
            tri=None, nshards=nshards))
    nc = Al.shape[0]
    nc_pad = ((nc + nshards - 1) // nshards) * nshards
    ci = np.zeros((nc_pad, nc_pad), dtype=dtype)
    ci[:nc, :nc] = np.linalg.pinv(Al.toarray()).astype(dtype)
    coarse_inv = jnp.asarray(ci.reshape(nshards, nc_pad // nshards, nc_pad))
    return DistSA(levels=tuple(dlev), coarse_inv=coarse_inv, n_top=n)
