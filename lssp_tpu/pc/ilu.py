"""ILU(k) / ILUT preconditioners: host factorization + device level-scheduled
triangular solves (reference assemble: pc-iluk.cxx:566-581, pc-ilut.cxx:429-456;
apply contract: lssp_pc_ilu_solve, solver-tri.cxx:48-60)."""
from __future__ import annotations

from lssp_tpu.ops.trisolve import (
    level_schedule, ilu_apply, ilu_apply_t, ilu_transpose_schedules,
    make_neumann_tri, neumann_ilu_apply, neumann_ilu_apply_t,
)
from lssp_tpu.pc.base import Preconditioner, register_pc
from lssp_tpu.pc.ilu_host import iluk_factor, ilut_factor


def _ilu_apply_fn(state, r):
    return ilu_apply(state[0], state[1], r)


def _ilu_apply_t_fn(state, r):
    if len(state) < 4:
        raise ValueError("ILU transpose apply requires "
                         "PCOptions(transpose=True) at setup")
    return ilu_apply_t(state[2], state[3], r)


def _neumann_apply_fn(state, r):
    return neumann_ilu_apply(state, r)


def _neumann_apply_t_fn(state, r):
    return neumann_ilu_apply_t(state, r)


def make_ilu_pc(L, U, name, sweeps=None, transpose=False):
    """Wrap split L/U factors as a device Preconditioner.

    sweeps=0: exact level-scheduled triangular solves.
    sweeps>0: Chow-style iterative solves — each sweep one SpMV (+0..3
    Krylov iterations at 6 sweeps on the acceptance problems).
    sweeps=-1: EXACT via the complete Neumann series — the strict factors
    are nilpotent, so `nlevels` sweeps reproduce the substitution result
    while every sweep stays a full-bandwidth SpMV.
    sweeps=None: auto — ``default_ilu_sweeps()`` (exact).
    transpose=True additionally installs the exact M⁻ᵀ apply (BiCG/QMR);
    the Neumann path supports it with no extra state."""
    from lssp_tpu.ops.trisolve import default_ilu_sweeps, neumann_exact_depth
    if sweeps is None:
        sweeps = default_ilu_sweeps()
    if sweeps == -1:
        from lssp_tpu.sparse.utils import split_ldu
        tris = []
        for T, lower in ((L, True), (U, False)):
            Ls, _, Us = split_ldu(T)
            S = Ls if lower else Us
            tris.append((S.indptr, S.indices, T.shape[0], lower))
        sweeps = neumann_exact_depth(tris)
    if sweeps > 0:
        state = make_neumann_tri(L, U, sweeps=sweeps)
        return Preconditioner(_neumann_apply_fn, state=state,
                              name=f"{name}-n{sweeps}",
                              apply_t_fn=_neumann_apply_t_fn)
    sl = level_schedule(L, lower=True)
    su = level_schedule(U, lower=False)
    state = (sl, su)
    if transpose:
        state = state + ilu_transpose_schedules(L, U)
    # always install the transpose fn: it raises a clear error when the
    # transposed schedules were not built (instead of silently falling back
    # to the forward apply, which would be numerically wrong for ILU)
    return Preconditioner(_ilu_apply_fn, state=state, name=name,
                          apply_t_fn=_ilu_apply_t_fn)


@register_pc("iluk")
def setup_iluk(A, opts):
    L, U = iluk_factor(A, level=opts.iluk_level,
                       num_blocks=opts.num_blocks or 1)
    return make_ilu_pc(L, U, f"iluk({opts.iluk_level})", opts.ilu_sweeps,
                       transpose=opts.transpose)


@register_pc("ilu0")
def setup_ilu0(A, opts):
    L, U = iluk_factor(A, level=0, num_blocks=opts.num_blocks or 1)
    return make_ilu_pc(L, U, "ilu0", opts.ilu_sweeps,
                       transpose=opts.transpose)


def _ilutp_apply(inner_fn, state, r):
    inner_state, iperm, perm = state
    return inner_fn(inner_state, r)[iperm]   # undo the column pivoting


def _ilutp_apply_t(inner_t_fn, state, r):
    # M⁻¹ = G·U⁻¹L⁻¹ with (Gy)[c] = y[iperm[c]] ⇒ M⁻ᵀ = L⁻ᵀU⁻ᵀ·Gᵀ,
    # Gᵀr = r[perm]
    inner_state, iperm, perm = state
    return inner_t_fn(inner_state, r[perm])


@register_pc("ilutp")
def setup_ilutp(A, opts):
    """ILUT with column pivoting (LIS ``ilutp`` capability) — robust on
    matrices with small/zero diagonals.  Factors L·U ≈ A[:, perm];
    the permuted factors ride the standard ILU apply machinery (exact
    level scheduling or Neumann sweeps via ``ilu_sweeps``), with the
    permutation undone in the apply."""
    import functools
    import jax.numpy as jnp
    import numpy as np
    from lssp_tpu.pc.ilu_host import ilutp_factor
    L, U, perm = ilutp_factor(A, tol=opts.ilut_tol, p=opts.ilut_p,
                              permtol=opts.ilutp_permtol)
    iperm = np.argsort(perm)
    dtype = np.asarray(A.data).dtype
    inner = make_ilu_pc(CSRcast(L, dtype), CSRcast(U, dtype), "ilutp-inner",
                        opts.ilu_sweeps, transpose=opts.transpose)
    state = (inner.state, jnp.asarray(iperm, jnp.int32),
             jnp.asarray(perm, jnp.int32))
    return Preconditioner(
        functools.partial(_ilutp_apply, inner.apply_fn), state=state,
        name=f"ilutp[{inner.name}]",
        apply_t_fn=(functools.partial(_ilutp_apply_t, inner.apply_t_fn)
                    if inner.apply_t_fn is not None else None))


def CSRcast(T, dtype):
    import dataclasses
    import numpy as np
    if np.asarray(T.data).dtype == dtype:
        return T
    return dataclasses.replace(T, data=np.asarray(T.data).astype(dtype))


@register_pc("ilut")
def setup_ilut(A, opts):
    L, U = ilut_factor(A, tol=opts.ilut_tol, p=opts.ilut_p,
                       num_blocks=opts.num_blocks or 1)
    return make_ilu_pc(L, U, "ilut", opts.ilu_sweeps,
                       transpose=opts.transpose)
