"""Relaxation preconditioners: SSOR, SOR, Gauss–Seidel.

Capability parity with the reference's external PC tables: LASPACK exposes
SSOR (/root/reference/src/solver-laspack.cxx:29-34) and LIS exposes
ssor/gs among its 10 PCs (/root/reference/src/solver-lis.cxx:8-41); the
reference has no native implementation.

Construction: both factor exactly into the ILU apply machinery,

    M_SSOR = 1/(ω(2−ω)) (D + ωLₛ) D⁻¹ (D + ωUₛ)
           = (I + ωLₛD⁻¹) · [ (D + ωUₛ) / (ω(2−ω)) ]      (unit-L · U)
    M_SOR  = (D/ω + Lₛ)
           = (I + ωLₛD⁻¹) · (D/ω)                          (unit-L · U)

so ``make_ilu_pc`` provides level-scheduled exact solves, Chow-style
Neumann sweeps (``ilu_sweeps`` > 0), and the transpose applies (BiCG/QMR) with zero new
device code.  Gauss–Seidel is SOR with ω = 1.
"""
from __future__ import annotations

import numpy as np

from lssp_tpu.config import Defaults
from lssp_tpu.pc.base import register_pc
from lssp_tpu.pc.ilu import make_ilu_pc
from lssp_tpu.sparse.types import CSR
from lssp_tpu.sparse.utils import split_ldu


def _safe_diag(d):
    small = np.abs(d) < Defaults.ZERO_DIAG_TOL
    return np.where(small, np.where(d >= 0, Defaults.ZERO_DIAG_VALUE,
                                    -Defaults.ZERO_DIAG_VALUE), d)


def _diag_csr(d, shape):
    n = shape[0]
    return CSR(np.arange(n + 1, dtype=np.int32),
               np.arange(n, dtype=np.int32), d, shape)


def _scale_rows(S: CSR, s: np.ndarray) -> CSR:
    ip = np.asarray(S.indptr)
    rows = np.repeat(np.arange(S.shape[0]), ip[1:] - ip[:-1])
    return CSR(S.indptr, S.indices, np.asarray(S.data) * s[rows], S.shape)


def _scale_cols(S: CSR, s: np.ndarray) -> CSR:
    return CSR(S.indptr, S.indices,
               np.asarray(S.data) * s[np.asarray(S.indices)], S.shape)


def _append_diag(S: CSR, d: np.ndarray) -> CSR:
    """Upper factor U = diag(d) + S (S strictly upper, columns sorted)."""
    n = S.shape[0]
    ip = np.asarray(S.indptr).astype(np.int64)
    nnz_row = ip[1:] - ip[:-1]
    new_ip = np.concatenate([[0], np.cumsum(nnz_row + 1)])
    new_idx = np.zeros(int(new_ip[-1]), dtype=np.int32)
    new_dat = np.zeros(int(new_ip[-1]), dtype=np.asarray(S.data).dtype)
    # diagonal first-in-row keeps columns sorted for a strict upper factor
    new_idx[new_ip[:-1]] = np.arange(n, dtype=np.int32)
    new_dat[new_ip[:-1]] = d
    keep = np.ones(int(new_ip[-1]), dtype=bool)
    keep[new_ip[:-1]] = False
    new_idx[keep] = np.asarray(S.indices)
    new_dat[keep] = np.asarray(S.data)
    return CSR(new_ip.astype(np.int32), new_idx, new_dat, S.shape)


@register_pc("ssor")
def setup_ssor(A, opts):
    if not 0.0 < opts.omega < 2.0:
        raise ValueError(f"SSOR requires 0 < omega < 2, got {opts.omega}")
    Ls, d, Us = split_ldu(A)
    d = _safe_diag(d)
    w = opts.omega
    # (D + ωLₛ)D⁻¹ = I + ωLₛD⁻¹ — column scaling, NOT row scaling (they
    # coincide only for constant-diagonal matrices)
    L = _scale_cols(Ls, w / d)                       # ω Lₛ D⁻¹
    U = _append_diag(_scale_rows(Us, np.full_like(d, w / (w * (2 - w)))),
                     d / (w * (2 - w)))              # (D + ωUₛ)/(ω(2−ω))
    return make_ilu_pc(L, U, f"ssor(w={w})", opts.ilu_sweeps,
                       transpose=opts.transpose)


def _setup_sor(A, opts, omega):
    if omega <= 0.0:
        raise ValueError(f"SOR requires omega > 0, got {omega}")
    Ls, d, Us = split_ldu(A)
    d = _safe_diag(d)
    L = _scale_cols(Ls, omega / d)                   # ω Lₛ D⁻¹
    U = _diag_csr(d / omega, A.shape)                # D/ω
    return make_ilu_pc(L, U, f"sor(w={omega})", opts.ilu_sweeps,
                       transpose=opts.transpose)


@register_pc("sor")
def setup_sor(A, opts):
    return _setup_sor(A, opts, opts.omega)


@register_pc("gs")
def setup_gs(A, opts):
    """Forward Gauss–Seidel (= SOR with ω = 1)."""
    return _setup_sor(A, opts, 1.0)
