"""Block-ILU(k) on uniform BSR (reference pc-biluk.cxx).

Host factorization reproduces the reference's math with row-major blocks:

- block symbolic = scalar ILU(k) on the block sparsity pattern
  (lssp_pc_biluk_symbolic__, pc-biluk.cxx:328-386)
- block ILU(0) numeric (lssp_pc_bilu0_fac, :198-277):
  ``A_ik ← A_ik · inv(A_kk)`` then Schur updates ``A_ij −= A_ik · A_kj``;
  diagonal blocks inverted explicitly (LAPACK dgetrf/dgetri there,
  ``np.linalg.inv`` here); a missing diagonal block becomes identity
  (:265-276)
- emit (lssp_pc_bilu_bcsr_to_lu, :104-196): unit-block-diagonal L holding
  the multipliers, unit-block-diagonal Û holding ``inv(A_ii)·A_ij``, and
  the block-diagonal D = inv(A_ii)

Apply (lssp_pc_bilu_solve, :22-60): z = Û⁻¹ · D · L⁻¹ · r.  Each piece is
block-granular: level-scheduled block sweeps (einsum batched GEMM) plus one
batched block-diagonal GEMV — no scalar expansion.
"""
from __future__ import annotations

import heapq

import numpy as np

from lssp_tpu.ops.block_trisolve import (
    BlockTriSchedule, block_level_schedule, block_trisweep, block_diag_apply,
)
from lssp_tpu.pc.base import Preconditioner, register_pc
from lssp_tpu.pc.ilu_host import iluk_symbolic
from lssp_tpu.sparse.types import CSR, BSR
from lssp_tpu.sparse.convert import csr_to_bsr


def _block_symbolic(A: BSR, level: int) -> BSR:
    """Scalar ILU(k) symbolic on the block pattern; original blocks scattered
    onto the grown pattern, fill blocks zero."""
    nrowb = A.nrowb
    bs = A.blocksize
    if level <= 0:
        return A
    pat = CSR(A.indptr, A.indices,
              np.zeros(A.nnzb, dtype=A.blocks.dtype), (nrowb, nrowb))
    grown = iluk_symbolic(pat, level)
    gip = np.asarray(grown.indptr).astype(np.int64)
    gidx = np.asarray(grown.indices).astype(np.int64)
    blocks = np.zeros((len(gidx), bs, bs), dtype=A.blocks.dtype)
    aip = np.asarray(A.indptr).astype(np.int64)
    aidx = np.asarray(A.indices).astype(np.int64)
    for i in range(nrowb):
        loc = np.searchsorted(gidx[gip[i]:gip[i + 1]], aidx[aip[i]:aip[i + 1]])
        blocks[gip[i] + loc] = np.asarray(A.blocks)[aip[i]:aip[i + 1]]
    return BSR(gip.astype(np.int32), gidx.astype(np.int32), blocks,
               A.shape, bs)


def bilu0_factor_bsr(T: BSR):
    """Block ILU(0) on the fixed block pattern of ``T`` (in place on a copy).
    Returns (blocks, inv) — the combined factor blocks and the per-row
    inverted diagonal blocks."""
    nrowb, bs = T.nrowb, T.blocksize
    ip = np.asarray(T.indptr).astype(np.int64)
    idx = np.asarray(T.indices).astype(np.int64)
    blocks = np.asarray(T.blocks).copy()
    inv = np.zeros((nrowb, bs, bs), dtype=blocks.dtype)
    eye = np.eye(bs, dtype=blocks.dtype)

    posmap = np.full(nrowb, -1, dtype=np.int64)
    for i in range(nrowb):
        s, e = ip[i], ip[i + 1]
        posmap[idx[s:e]] = np.arange(s, e)
        kpos = s
        while kpos < e and idx[kpos] < i:
            k = idx[kpos]
            a_ik = blocks[kpos] @ inv[k]
            blocks[kpos] = a_ik
            ks, ke = ip[k], ip[k + 1]
            tp = posmap[idx[ks:ke]]
            mask = tp > kpos
            if mask.any():
                # Schur updates: A_ij −= A_ik · A_kj  (batched)
                blocks[tp[mask]] -= a_ik @ blocks[ks:ke][mask]
            kpos += 1
        posmap[idx[s:e]] = -1
        if kpos < e and idx[kpos] == i:
            inv[i] = np.linalg.inv(blocks[kpos])
        else:
            inv[i] = eye           # missing diagonal block (:265-276)
    return blocks, inv


def biluk_factor_bsr(A: BSR, level: int = 1, raw: bool = False):
    """Returns (L_sched, Dinv, U_sched) device-ready pieces, or with
    ``raw=True`` the strict-factor CSR-of-blocks triples
    ((lp, lc, lb), Dinv, (up, uc, ub)) for the caller to pack."""
    T = _block_symbolic(A, level)
    blocks, inv = bilu0_factor_bsr(T)
    nrowb, bs = T.nrowb, T.blocksize
    ip = np.asarray(T.indptr).astype(np.int64)
    idx = np.asarray(T.indices).astype(np.int64)
    rows = np.repeat(np.arange(nrowb, dtype=np.int64), ip[1:] - ip[:-1])

    def strict(mask, transform=None):
        r, c = rows[mask], idx[mask]
        blk = blocks[mask]
        if transform is not None:
            blk = transform(r, blk)
        p = np.zeros(nrowb + 1, dtype=np.int64)
        np.add.at(p, r + 1, 1)
        p = np.cumsum(p)
        order = np.lexsort((c, r))
        return p, c[order], blk[order]

    lp, lc, lb = strict(idx < rows)
    # Û blocks are premultiplied by inv(A_ii) (pc-biluk.cxx:162)
    up, uc, ub = strict(idx > rows, transform=lambda r, blk: inv[r] @ blk)
    if raw:
        return (lp, lc, lb), inv, (up, uc, ub)
    sched_l = block_level_schedule(lp, lc, lb, nrowb, bs, lower=True)
    sched_u = block_level_schedule(up, uc, ub, nrowb, bs, lower=False)
    return sched_l, inv, sched_u


def bilut_factor_bsr(A: BSR, tol: float = 1e-3, p: int = -1,
                     raw: bool = False):
    """Block ILUT: dual-threshold incomplete factorization at block
    granularity (the reference's BILUT capability via ITSOL's ``vbilutC``,
    /root/reference/src/pc-bilut.cxx:12-112, with uniform blocks).

    Saad's ILUT drop rules lifted to blocks: a block is dropped when its
    Frobenius norm is below ``tol`` times the mean block norm of its row
    (cf. the scalar rule at pc-ilut.cxx:116-122); at most ``p`` blocks are
    kept in each of the L and U parts (largest-norm-first; p < 0 means the
    average block-row fill of A, the scalar default at pc-ilut.cxx:436-438).
    Returns the same (L_sched, Dinv, U_sched) triple as ``biluk_factor_bsr``.
    """
    nrowb, bs = A.nrowb, A.blocksize
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    ablocks = np.asarray(A.blocks)
    if p is None or p < 0:
        p = max(1, int(np.ceil(A.nnzb / max(1, nrowb))))
    eye = np.eye(bs, dtype=ablocks.dtype)

    Urows = []                      # per row: (cols array, blocks array) k>i
    Linv = np.zeros((nrowb, bs, bs), dtype=ablocks.dtype)
    Lrows = []
    for i in range(nrowb):
        s, e = ip[i], ip[i + 1]
        w = {int(c): ablocks[q].copy() for q, c in zip(range(s, e), idx[s:e])}
        rnorm = float(np.mean([np.linalg.norm(b) for b in w.values()]))
        droptol = tol * rnorm
        # ascending worklist — updates from U rows can add new fill at
        # columns k < j < i, which must itself be eliminated
        pending = [c for c in w if c < i]
        heapq.heapify(pending)
        done = set()
        while pending:
            k = heapq.heappop(pending)
            if k in done or k not in w:
                continue
            done.add(k)
            a_ik = w[k] @ Linv[k]
            if np.linalg.norm(a_ik) < droptol:
                del w[k]
                continue
            w[k] = a_ik
            ucols, ublks = Urows[k]
            for j, u_kj in zip(ucols, ublks):
                upd = a_ik @ u_kj
                j = int(j)
                if j in w:
                    w[j] -= upd
                elif np.linalg.norm(upd) >= droptol:
                    w[j] = -upd
                    if j < i:
                        heapq.heappush(pending, j)
        diag = w.pop(i, None)
        lcols = sorted(c for c in w if c < i)
        ucols = sorted(c for c in w if c > i)

        def keep_largest(cols):
            if len(cols) <= p:
                return cols
            norms = np.array([np.linalg.norm(w[c]) for c in cols])
            kept = np.argsort(-norms)[:p]
            return sorted(np.asarray(cols)[kept].tolist())

        lcols = keep_largest(lcols)
        ucols = keep_largest(ucols)
        if diag is None:
            diag = eye.copy()                 # missing diagonal block
        Linv[i] = np.linalg.inv(diag)
        Lrows.append((np.asarray(lcols, np.int64),
                      np.stack([w[c] for c in lcols]) if lcols
                      else np.zeros((0, bs, bs), ablocks.dtype)))
        Urows.append((np.asarray(ucols, np.int64),
                      np.stack([w[c] for c in ucols]) if ucols
                      else np.zeros((0, bs, bs), ablocks.dtype)))

    def pack(rows_list, transform=None):
        pptr = np.zeros(nrowb + 1, dtype=np.int64)
        for i, (c, _) in enumerate(rows_list):
            pptr[i + 1] = pptr[i] + len(c)
        cols = np.concatenate([c for c, _ in rows_list]) if pptr[-1] \
            else np.zeros(0, np.int64)
        blks = (np.concatenate([b for _, b in rows_list])
                if pptr[-1] else np.zeros((0, bs, bs), ablocks.dtype))
        if transform is not None:
            rr = np.repeat(np.arange(nrowb), pptr[1:] - pptr[:-1])
            blks = transform(rr, blks)
        return pptr, cols, blks

    lp, lc, lb = pack(Lrows)
    up, uc, ub = pack(Urows, transform=lambda r, blk: Linv[r] @ blk
                      if len(blk) else blk)
    if raw:
        return (lp, lc, lb), Linv, (up, uc, ub)
    sched_l = block_level_schedule(lp, lc, lb, nrowb, bs, lower=True)
    sched_u = block_level_schedule(up, uc, ub, nrowb, bs, lower=False)
    return sched_l, Linv, sched_u


def _bilu_apply(state, r):
    sched_l, dinv, sched_u = state
    y = block_trisweep(sched_l, r)
    z = block_diag_apply(dinv, y)
    return block_trisweep(sched_u, z)


def _bilu_neumann_apply(sweeps, state, r):
    """Chow-style iterative block-triangular solves: the unit-block factors
    L̂ = I + L_strict and Û = I + Û_strict invert as truncated Neumann
    series, each sweep one gather-free BDIA block SpMV — the block analog
    of the scalar path in ops/trisolve.py (``ilu_sweeps`` > 0)."""
    from lssp_tpu.ops.spmv import spmv
    Lb, dinv, Ub = state
    y = r
    for _ in range(sweeps):
        y = r - spmv(Lb, y)
    z = block_diag_apply(dinv, y)
    w = z
    for _ in range(sweeps):
        w = z - spmv(Ub, w)
    return w


def _pack_bilu_pc(factors, name, sweeps):
    """Assemble the block-ILU Preconditioner from raw strict factors:
    Neumann sweeps over BDIA factors (``ilu_sweeps`` != 0) when the factors are
    block-banded, exact block-level scheduling otherwise."""
    import functools

    (lp, lc, lb), inv, (up, uc, ub) = factors
    nrowb = len(lp) - 1
    bs = inv.shape[1]
    from lssp_tpu.ops.trisolve import default_ilu_sweeps, neumann_exact_depth
    if sweeps is None:
        sweeps = default_ilu_sweeps()
    if sweeps == -1:
        # exact via the COMPLETE Neumann series at BLOCK granularity (same
        # contract as the scalar ILU path)
        sweeps = neumann_exact_depth([(lp, lc, nrowb, True),
                                      (up, uc, nrowb, False)])
    if sweeps > 0:
        from lssp_tpu.sparse.convert import bsr_to_bdia
        n = nrowb * bs
        try:
            Lb = bsr_to_bdia(BSR(lp, lc, lb, (n, n), bs),
                             max_diags=48, fill=3.0)
            Ub = bsr_to_bdia(BSR(up, uc, ub, (n, n), bs),
                             max_diags=48, fill=3.0)
            import jax.numpy as jnp
            state = (Lb, jnp.asarray(inv), Ub)
            return Preconditioner(
                functools.partial(_bilu_neumann_apply, sweeps),
                state=state, name=f"{name}-n{sweeps}")
        except ValueError:
            pass                       # not block-banded — exact schedules
    sched_l = block_level_schedule(lp, lc, lb, nrowb, bs, lower=True)
    sched_u = block_level_schedule(up, uc, ub, nrowb, bs, lower=False)
    import jax.numpy as jnp
    return Preconditioner(_bilu_apply,
                          state=(sched_l, jnp.asarray(inv), sched_u),
                          name=name)


def _to_bsr(A, opts):
    if isinstance(A, BSR):
        return A
    n = A.shape[0]
    if opts.block_size:
        bs = int(opts.block_size)
    elif opts.num_blocks:
        bs = n // int(opts.num_blocks)
    else:
        raise ValueError("block ILU needs PCOptions.num_blocks or .block_size "
                         "(reference requires s.num_blks, pc-biluk.cxx:424)")
    return csr_to_bsr(A, bs)


@register_pc("biluk")
def setup_biluk(A, opts):
    """Reference lssp_pc_biluk_assemble (pc-biluk.cxx:418-431):
    bs = n / num_blocks; requires num_blocks (or an explicit block_size)."""
    B = _to_bsr(A, opts)
    factors = biluk_factor_bsr(B, level=opts.iluk_level, raw=True)
    return _pack_bilu_pc(factors, f"biluk({opts.iluk_level})",
                         opts.ilu_sweeps)


@register_pc("bilut")
def setup_bilut(A, opts):
    """Block ILUT (the reference's ITSOL BILUT adapter capability,
    pc-bilut.cxx:12-112)."""
    B = _to_bsr(A, opts)
    factors = bilut_factor_bsr(B, tol=opts.ilut_tol, p=opts.ilut_p, raw=True)
    return _pack_bilu_pc(factors, "bilut", opts.ilu_sweeps)


# --- variable-block ILU (the reference's ITSOL VBILUK/VBILUT adapters,
#     pc-vbiluk.cxx:8-65 / pc-vbilut.cxx:7-76, driven by the user-supplied
#     s.blk_size[] array, include/type-defs.h:288-289) -----------------------
#
# Design: variable blocks batch poorly (ragged GEMM shapes defeat XLA
# tiling), so each variable block is EMBEDDED into a
# uniform bs_max block — off-block padding is zero, padded diagonal slots
# carry 1 — and the uniform-BSR machinery above runs unchanged on static
# shapes.  The embedding indices live in the PC state; apply scatters r in,
# runs the uniform block solve, and gathers back.

def _vb_embedding(blk_sizes, n):
    """Map scalar index -> padded index for variable blocks padded to
    bs_max.  Returns (bs_max, n_pad, emb) with emb[i] = padded position."""
    blk_sizes = np.asarray(blk_sizes, dtype=np.int64)
    assert blk_sizes.sum() == n, "blk_sizes must sum to the matrix size"
    bs = int(blk_sizes.max())
    starts = np.concatenate([[0], np.cumsum(blk_sizes)])[:-1]
    emb = np.concatenate([
        kb * bs + np.arange(sz, dtype=np.int64)
        for kb, (st, sz) in enumerate(zip(starts, blk_sizes))])
    return bs, len(blk_sizes) * bs, emb


def _vb_embed_matrix(A: CSR, blk_sizes):
    n = A.shape[0]
    bs, n_pad, emb = _vb_embedding(blk_sizes, n)
    ip = np.asarray(A.indptr).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    # padded diagonal slots get 1 so diagonal blocks stay invertible
    pad = np.setdiff1d(np.arange(n_pad, dtype=np.int64), emb,
                       assume_unique=False)
    r = np.concatenate([emb[rows], pad])
    c = np.concatenate([emb[cols], pad])
    v = np.concatenate([dat, np.ones(len(pad), dtype=dat.dtype)])
    order = np.lexsort((c, r))
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(r, minlength=n_pad))]).astype(np.int64)
    return (CSR(indptr, c[order], v[order], (n_pad, n_pad)),
            bs, n_pad, emb)


def _vbilu_apply(n_pad, inner_fn, state, r):
    """Embed r into the padded uniform-block space, run the uniform block
    solve (Neumann or exact, whatever _pack_bilu_pc chose), gather back."""
    inner_state, emb = state
    import jax.numpy as jnp
    rp = jnp.zeros(n_pad, dtype=r.dtype).at[emb].set(r)
    return inner_fn(inner_state, rp)[emb]


def _setup_vbilu(A, opts, variant):
    if opts.block_sizes is None:
        raise ValueError("vbiluk/vbilut need PCOptions.block_sizes "
                         "(reference s.blk_size[], pc-vbiluk.cxx:26-34)")
    Ap, bs, n_pad, emb = _vb_embed_matrix(A, opts.block_sizes)
    B = csr_to_bsr(Ap, bs)
    if variant == "vbiluk":
        factors = biluk_factor_bsr(B, level=opts.iluk_level, raw=True)
    else:
        factors = bilut_factor_bsr(B, tol=opts.ilut_tol, p=opts.ilut_p,
                                   raw=True)
    # route through _pack_bilu_pc like biluk/bilut so PCOptions.ilu_sweeps
    # and the Neumann-sweep option apply uniformly to variable blocks
    inner = _pack_bilu_pc(factors, variant, opts.ilu_sweeps)
    import functools
    import jax.numpy as jnp
    state = (inner.state, jnp.asarray(emb, jnp.int32))
    # n_pad is a static shape — bind it into the apply fn, not the pytree
    return Preconditioner(functools.partial(_vbilu_apply, n_pad,
                                            inner.apply_fn),
                          state=state, name=inner.name)


@register_pc("vbiluk")
def setup_vbiluk(A, opts):
    return _setup_vbilu(A, opts, "vbiluk")


@register_pc("vbilut")
def setup_vbilut(A, opts):
    return _setup_vbilu(A, opts, "vbilut")
