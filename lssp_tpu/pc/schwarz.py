"""Restricted additive Schwarz (RAS) preconditioner.

Capability parity with the reference's FASP adapter, which routes Krylov
solves through ``fasp_solver_dcsr_krylov_Schwarz``
(/root/reference/src/solver-fasp.cxx:161-193); the reference has no native
implementation.

Construction: subdomains are **contiguous row ranges** (the same
banded-ordering assumption the rest of the framework relies on), extended
by ``overlap`` rows on both sides.  Because the ranges are uniform, each
subdomain's residual window is a *contiguous slice* of a padded vector —
no gathers.  The per-subdomain ILU factors are assembled into one
**block-diagonal** L/U over the concatenated windows, so the whole local
solve reuses the standard ILU apply machinery: exact level scheduling
batches all subdomains into shared level sweeps, and the Chow-style
Neumann sweeps (``ilu_sweeps`` > 0) run it as a handful of full-width SpMVs.
The "restricted" update takes only each subdomain's owned rows
(Cai & Sarkis RAS — generally better than classical AS as a PC).
"""
from __future__ import annotations

import functools

import numpy as np

from lssp_tpu.pc.base import Preconditioner, register_pc
from lssp_tpu.pc.ilu import make_ilu_pc
from lssp_tpu.pc.ilu_host import iluk_factor
from lssp_tpu.sparse.types import CSR


def _extract_window(A: CSR, lo: int, hi: int, E: int, at: int) -> CSR:
    """Rows/cols [lo, hi) of A embedded at offset ``at`` into an (E, E)
    block whose remaining diagonal entries are 1 (decoupled padding)."""
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    rows = np.repeat(np.arange(lo, hi, dtype=np.int64),
                     ip[lo + 1:hi + 1] - ip[lo:hi])
    sl = slice(ip[lo], ip[hi])
    keep = (idx[sl] >= lo) & (idx[sl] < hi)
    r = rows[keep] - lo + at
    c = idx[sl][keep] - lo + at
    v = dat[sl][keep]
    padr = np.setdiff1d(np.arange(E, dtype=np.int64),
                        np.arange(at, at + hi - lo, dtype=np.int64))
    r = np.concatenate([r, padr])
    c = np.concatenate([c, padr])
    v = np.concatenate([v, np.ones(len(padr), dtype=dat.dtype)])
    order = np.lexsort((c, r))
    p = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=E))])
    return CSR(p.astype(np.int64), c[order].astype(np.int64), v[order],
               (E, E))


def _block_diag_csr(blocks):
    """Concatenate (E, E) CSR blocks into one block-diagonal CSR."""
    E = blocks[0].shape[0]
    B = len(blocks)
    ips = [np.asarray(blk.indptr, np.int64) for blk in blocks]
    nnzs = [int(ip[-1]) for ip in ips]
    offs = np.concatenate([[0], np.cumsum(nnzs)])
    indptr = np.concatenate(
        [ips[i][:-1] + offs[i] for i in range(B)] + [[offs[-1]]])
    indices = (np.concatenate(
        [np.asarray(blk.indices, np.int64) + i * E
         for i, blk in enumerate(blocks)]) if offs[-1]
        else np.zeros(0, np.int64))
    data = (np.concatenate([np.asarray(blk.data) for blk in blocks])
            if offs[-1] else np.zeros(0))
    return CSR(indptr, indices, data, (B * E, B * E))


def _ras_apply(meta, inner_apply_fn, state, r):
    import jax
    import jax.numpy as jnp
    B, bs, o, n = meta
    npad = B * bs - n
    rp = jnp.pad(r, (o, o + npad))
    wins = jnp.stack([jax.lax.dynamic_slice(rp, (i * bs,), (bs + 2 * o,))
                      for i in range(B)])
    z = inner_apply_fn(state, wins.reshape(-1)).reshape(B, bs + 2 * o)
    owned = z[:, o:o + bs].reshape(-1)           # restricted update
    return owned[:n]


@register_pc("ras")
def setup_ras(A, opts):
    n = A.shape[0]
    B = int(opts.num_blocks) if opts.num_blocks else max(2, -(-n // 4096))
    o = int(opts.schwarz_overlap)
    bs = -(-n // B)
    E = bs + 2 * o
    Ls, Us = [], []
    for i in range(B):
        lo = max(0, i * bs - o)
        hi = min(n, (i + 1) * bs + o)
        at = lo - (i * bs - o)                   # clip shift at the edges
        blk = _extract_window(A, lo, hi, E, at)
        L, U = iluk_factor(blk, level=opts.iluk_level)
        Ls.append(L)
        Us.append(U)
    inner = make_ilu_pc(_block_diag_csr(Ls), _block_diag_csr(Us),
                        "ras-local", opts.ilu_sweeps)
    meta = (B, bs, o, n)
    return Preconditioner(
        functools.partial(_ras_apply, meta, inner.apply_fn),
        state=inner.state, name=f"ras(B={B},o={o})")


register_pc("schwarz")(setup_ras)


@register_pc("bjacobi")
def setup_bjacobi(A, opts):
    """Block-Jacobi with ILU local solves (the PETSc adapter's BJACOBI
    capability, solver-petsc.cxx:23-32) = RAS with zero overlap."""
    import dataclasses
    return setup_ras(A, dataclasses.replace(opts, schwarz_overlap=0))
