"""Hierarchical strength aggregation ordering — gather-free AMG for
matrices the grid detector cannot handle.

The structured-SA machinery (amg/sa.py) needs aggregates that are
CONTIGUOUS index ranges so prolongation is a reshape (no gather).  For grid operators the facade's ordering already delivers that;
for genuinely unstructured sparsity the flat path falls back to *blind*
ranges, which may group weakly-coupled rows.

This module closes the gap the aggregate-then-renumber way: build the FULL
aggregation hierarchy on the host (greedy strength-graph aggregation with
exact size ``g`` per level, recursing on Galerkin coarse graphs), then
order the fine rows lexicographically by their aggregate chain (coarsest
id first).  In that ordering every level's true strength-based aggregates
are exactly the contiguous g-ranges the reshape machinery uses — the
quality of algebraic aggregation with zero device gathers, at every level.
The permutation is applied ONCE at setup by the facade (host side), like
RCM.

Capability match: AMG on any CSR (/root/reference/src/pc-amg.cxx:21-134,
/root/reference/src/solver-amg.cxx:64-130 — the reference gets this from
FASP); the realization has no structural analog in the reference.
"""
from __future__ import annotations

import numpy as np

__all__ = ["hierarchy_perm", "greedy_aggregate_exact"]


def _sym_strength(A, theta: float):
    """Symmetrized relative-strength graph: keep |a_ij| >= theta *
    sqrt(|a_ii a_jj|) (the same rule as sa.py's filters), OR its
    transpose — aggregation wants undirected connectivity."""
    import scipy.sparse as sp
    A = A.tocsr()
    n = A.shape[0]
    d = np.abs(A.diagonal())
    d[d == 0] = 1.0
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    keep = (np.abs(A.data) >= theta * np.sqrt(d[rows] * d[cols])) \
        & (rows != cols)
    S = sp.csr_matrix((np.ones(int(keep.sum()), np.int8),
                       (rows[keep], cols[keep])), shape=A.shape)
    S = ((S + S.T) != 0).tocsr()
    return S


def _bfs_ids(S, g: int, virt) -> np.ndarray:
    """Raw greedy strength-BFS ids (short aggregates left short, virtuals
    left -1) — Python oracle for native/src/aggregate.cpp."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    ids = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for v in range(n):
        if ids[v] >= 0 or virt[v]:
            continue
        members = [v]
        ids[v] = nxt
        frontier = [v]
        while len(members) < g and frontier:
            new = []
            for u in frontier:
                for w in indices[indptr[u]:indptr[u + 1]]:
                    if ids[w] < 0 and not virt[w]:
                        ids[w] = nxt
                        members.append(w)
                        new.append(w)
                        if len(members) >= g:
                            break
                if len(members) >= g:
                    break
            frontier = new
        nxt += 1
    return ids


def _fixup_exact(ids: np.ndarray, g: int, virt) -> np.ndarray:
    """Exactness fix-up shared by the Python and native BFS paths: pull the
    members of undersized aggregates plus all virtual vertices and re-chunk
    them in (id, index) order — real leftovers first, virtuals last, so at
    most one mixed group sits at the real/virtual boundary and every later
    group is pure virtual (the alignment invariant with sa_setup's
    end-of-vector padding)."""
    nxt = int(ids.max()) + 1 if (ids >= 0).any() else 0
    sizes = np.bincount(ids[ids >= 0], minlength=max(nxt, 1))
    short = sizes < g
    keep_ids = np.where(~short)[0] if nxt else np.empty(0, np.int64)
    remap = np.full(max(nxt, 1), -1, dtype=np.int64)
    remap[keep_ids] = np.arange(len(keep_ids))
    out = np.where(ids >= 0, remap[np.maximum(ids, 0)], -1)
    order = np.argsort(ids, kind="stable")       # -1 (virt) sorts first
    loose_real = order[(ids[order] >= 0) & short[np.maximum(ids[order], 0)]]
    loose = np.concatenate([loose_real, np.where(virt)[0]])
    k = len(keep_ids)
    out[loose] = k + np.arange(len(loose)) // g
    return out


def greedy_aggregate_exact(S, g: int, virt=None) -> np.ndarray:
    """Aggregate the (symmetric, boolean, no-diagonal) graph S into groups
    of EXACTLY ``g`` vertices: greedy BFS over strength edges in natural
    vertex order (post-RCM that is a locality order), then leftover
    members of short aggregates are re-chunked in id order.  Requires
    n % g == 0.  Returns ids (n,).

    ``virt`` (bool mask): vertices carrying virtual padding mass are kept
    OUT of real aggregates and chunked LAST (one mixed boundary group at
    most, then pure-virtual groups) — the hierarchy ordering's alignment
    with sa_setup's end-of-vector padding depends on this invariant at
    every level."""
    n = S.shape[0]
    assert n % g == 0, (n, g)
    if virt is None:
        virt = np.zeros(n, dtype=bool)
    return _fixup_exact(_bfs_ids(S, g, virt), g, virt)


def _consolidate_taint(ids, vcount, g: int) -> np.ndarray:
    """Repair ``ids`` so ALL tainted vertices (``vcount > 0``: they carry
    original virtual padding rows) live in one trailing CHAIN: the
    minimal ceil(k/g) aggregates, at most one of them mixed with real
    vertices.  Without this, coarse-level greedy passes may group virtual
    vertices with a second real chain (exact-g fill), creating two
    disjoint tainted key-blocks — and no ordering of disjoint blocks can
    put every virtual row in the trailing slots (measured: one real
    level-0 group splitting across a chunk boundary on 11^3 Poisson).
    The repair swaps at most g-1 real vertices per level into the mixed
    aggregate — the same bounded quality concession the boundary group
    already makes."""
    nag = int(ids.max()) + 1
    tv = np.where(vcount > 0)[0]
    k = len(tv)
    if k == 0:
        return ids
    ag_taint = np.bincount(ids[tv], minlength=nag)
    if np.count_nonzero(ag_taint) <= 1:
        return ids
    need = (k + g - 1) // g
    # designate the aggregates with the most tainted mass (tie: highest
    # id — prefer the ones the greedy already put last, disturbing the
    # early strength-preferred real groupings least)
    desig = np.lexsort((-np.arange(nag), -ag_taint))[:need]
    desig_set = np.zeros(nag, dtype=bool)
    desig_set[desig] = True
    n_fill = need * g - k      # 0 <= n_fill < g: the mixed group's reals
    # reals kept in the designated block: those already there (no
    # displacement needed — in-designated reals number need*g - X >=
    # n_fill since X <= k), most-tainted aggregate first
    real_v = np.where(vcount == 0)[0]
    in_desig = desig_set[ids[real_v]]
    keep = real_v[in_desig][np.argsort(
        -ag_taint[ids[real_v[in_desig]]], kind="stable")][:n_fill]
    # displaced reals: currently in designated aggregates but not kept
    kept = np.zeros(ids.shape[0], dtype=bool)
    kept[keep] = True
    displaced = real_v[desig_set[ids[real_v]] & ~kept[real_v]]
    # freed slots: tainted vertices leaving non-designated aggregates
    new_ids = ids.copy()
    freed_slots = ids[tv[~desig_set[ids[tv]]]]
    # lay the block out: the mixed aggregate (reals + partial taint)
    # FIRST of the designated ids in rank order handled later by cat;
    # here just assign: reals+t fill desig[0].., virtuals fill the rest
    order_members = np.concatenate([keep, tv[np.argsort(vcount[tv],
                                                        kind="stable")]])
    slots = np.repeat(np.sort(desig), g)
    new_ids[order_members] = slots[:len(order_members)]
    # displaced reals (in designated but not kept) refill the slots the
    # tainted vertices vacated in non-designated aggregates — counts are
    # equal by conservation: (need*g - X) - n_fill == k - X
    new_ids[displaced] = np.sort(freed_slots)[:len(displaced)]
    return new_ids


def hierarchy_perm(A, g: int = 4, coarse_size: int = 256,
                   max_levels: int = 12, theta: float = 0.08) -> np.ndarray:
    """Permutation (n,) ordering A's rows so that the greedy strength
    aggregates of every hierarchy level are contiguous g-ranges.

    The planned padded size (the P=1 fixed point of dist_sa's plan) keeps
    every level's size divisible by g; virtual padding vertices are
    isolated, processed last by the greedy pass, and dropped from the
    returned permutation — they occupy exactly the trailing slots that
    sa_setup's flat pre-padding appends.

    Host cost: O(nnz) python BFS per level — fine for the unstructured
    midsize matrices this path serves (15k rows ≈ 60 ms); large banded or
    grid matrices never reach it (the grid/band paths win those).
    """
    import scipy.sparse as sp
    from lssp_tpu.parallel.dist_sa import planned_padded_size

    n = A.shape[0]
    n_pad = planned_padded_size(n, 1, g, coarse_size, max_levels)
    if hasattr(A, "to_scipy"):              # lssp CSR container
        A = A.to_scipy()
    Al = A.tocsr().astype(np.float64)
    if n_pad != n:
        Al = sp.bmat([[Al, None],
                      [None, sp.eye(n_pad - n, format="csr")]],
                     format="csr")
    from lssp_tpu import native
    use_native = native.available()
    virt = np.zeros(n_pad, dtype=bool)
    virt[n:] = True
    vcount = virt.astype(np.int64)   # original virtual rows per vertex
    keys = []          # per level: fine-vertex -> RANKED level aggregate id
    cur = np.arange(n_pad)
    levels = 0
    while Al.shape[0] > coarse_size and levels < max_levels:
        if use_native:
            # C++ merge-walks A and A^T rows, evaluating the strength
            # predicate on the fly — identical ids to the Python oracle
            # without materialising the symmetrised graph (the measured
            # bottleneck: 16 of 23 s at 1M rows was the scipy build)
            raw = native.greedy_aggregate(Al, Al.T.tocsr(), g, theta, virt)
            ids = _fixup_exact(raw, g, virt)
        else:
            ids = greedy_aggregate_exact(_sym_strength(Al, theta), g, virt)
        ids = _consolidate_taint(ids, vcount, g)
        nag = Al.shape[0] // g
        # SORT-KEY RANKING: aggregates containing NO original virtual
        # row first, then the (single) mixed boundary chain, then pure
        # virtual — at EVERY level.  The raw greedy ids do not guarantee
        # this: the mixed group is classified real at the next level and
        # can aggregate mid-order there, which put its virtual fine rows
        # mid-permutation; after the final drop every later real row
        # shifted one slot and the g-chunks misaligned (measured: 33/333
        # level-0 chunks mixed on 11^3 Poisson).  Taint is counted in
        # ORIGINAL virtual rows carried by each vertex (``vcount``) — the
        # coarse virt flag alone launders the mixed vertex back to real
        # one level up.  Ranked keys keep every virtual-containing
        # aggregate trailing, so the dropped slots are exactly the ones
        # sa_setup's end-of-vector padding re-fills.
        vc_ag = np.bincount(ids, weights=vcount.astype(np.float64),
                            minlength=nag).astype(np.int64)
        tot = g * (n_pad // Al.shape[0])      # original rows per aggregate
        cat = np.where(vc_ag == 0, 0, np.where(vc_ag >= tot, 2, 1))
        rank = np.empty(nag, dtype=np.int64)
        rank[np.lexsort((np.arange(nag), cat))] = np.arange(nag)
        keys.append(rank[ids[cur]])
        cur = ids[cur]
        P0 = sp.csr_matrix((np.ones(Al.shape[0]), ids,
                            np.arange(Al.shape[0] + 1)),
                           shape=(Al.shape[0], nag))
        Al = (P0.T @ Al @ P0).tocsr()
        # a coarse vertex is virtual (for greedy last-processing) iff its
        # whole original slab is virtual; vcount carries the taint
        vcount = vc_ag
        virt = vc_ag >= tot
        levels += 1
    if not keys:
        return np.arange(n, dtype=np.int64)
    # lexicographic: coarsest id is the primary key (np.lexsort uses the
    # LAST key as primary), natural index breaks ties
    order = np.lexsort(tuple([np.arange(n_pad)] + keys))
    # ALIGNMENT INVARIANT (what consolidation + ranked keys guarantee):
    # the virtual padding slots occupy exactly the trailing positions, so
    # dropping them leaves every real aggregate in the intact contiguous
    # g-chunks that sa_setup's end-of-vector padding re-completes
    assert n_pad == n or (order[n:] >= n).all(), \
        "hierarchy_perm: virtual rows not trailing — alignment broken"
    return order[order < n].astype(np.int64) if n_pad != n \
        else order.astype(np.int64)
