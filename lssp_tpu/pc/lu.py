"""Exact sparse-LU preconditioner (and the engine of ``method="direct"``).

Replaces the reference's external direct solvers (UMFPACK/KLU/SuperLU/
MUMPS/PARDISO wrappers, SURVEY §2.5) and the "LU" entry of its PETSc PC
table (/root/reference/src/solver-petsc.cxx:23-32): Gilbert–Peierls
factorization on the host (lssp_tpu/pc/lu_host.py, C++ fast path), exact
level-scheduled triangular sweeps on the device.  One PC application is an
exact solve up to pivot clamping — as a preconditioner it converges any
Krylov method in one iteration; inside ``solve_ir`` it gives a direct
solver with fp64-quality answers from fp32 factors.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from lssp_tpu.ops.trisolve import level_schedule, ilu_apply
from lssp_tpu.pc.base import Preconditioner, register_pc
from lssp_tpu.pc.lu_host import splu_factor


def _lu_apply(state, r):
    sl, su, perm_in, perm_out = state[:4]
    y = ilu_apply(sl, su, r[perm_in])
    return y[perm_out]


def _lu_apply_t(state, r):
    """M⁻ᵀ for M x = (U⁻¹L⁻¹ (x[perm_in]))[perm_out]:
    z = (Lᵀ)⁻¹(Uᵀ)⁻¹ applied with the permutations transposed
    (gather by perm_out on input, perm_in on output)."""
    if len(state) < 8:
        raise ValueError("LU transpose apply requires "
                         "PCOptions(transpose=True) at setup")
    # inverse permutations are precomputed at setup: this apply runs once
    # per Krylov iteration inside a jitted while_loop, and a device argsort
    # per application would dominate the triangular sweeps
    _, _, _, _, sut, slt, inv_out, inv_in = state
    from lssp_tpu.ops.trisolve import ilu_apply_t
    y = ilu_apply_t(sut, slt, r[inv_out])
    return y[inv_in]


@register_pc("lu")
def setup_lu(A, opts):
    f = splu_factor(A, order=opts.lu_order,
                    pivot_tol=opts.lu_pivot_tol, method=opts.lu_method)
    dtype = np.asarray(A.data).dtype
    L = f.L.astype(dtype) if f.L.dtype != dtype else f.L
    U = f.U.astype(dtype) if f.U.dtype != dtype else f.U
    sl = level_schedule(L, lower=True)
    su = level_schedule(U, lower=False)
    state = (sl, su, jnp.asarray(f.perm_in), jnp.asarray(f.perm_out))
    if opts.transpose:
        from lssp_tpu.ops.trisolve import ilu_transpose_schedules
        state = state + ilu_transpose_schedules(L, U) + (
            jnp.asarray(np.argsort(f.perm_out)),
            jnp.asarray(np.argsort(f.perm_in)))
    return Preconditioner(_lu_apply, state=state, name="lu",
                          apply_t_fn=_lu_apply_t)
