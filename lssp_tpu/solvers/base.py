"""Shared solver skeleton.

The reference's common pattern (SURVEY §2.3): read params → fall back to
global defaults → r0 = b − A·x → threshold ``max(rtol·‖r0‖, atol, rb·‖b‖)``
(/root/reference/src/solver-cg.cxx:66-70) → iterate → write residual/nits.
Here the iteration is a ``lax.while_loop`` and the result is a ``SolveInfo``
pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from lssp_tpu.ops.spmv import spmv


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SolveInfo:
    """Result metadata (reference solver.residual / solver.nits,
    /root/reference/src/lssp.cxx:520-528)."""

    nits: Any               # iteration count (int32 scalar)
    residual: Any           # final residual norm ‖b−Ax‖ (or method's estimate)
    converged: Any          # bool scalar
    r0norm: Any             # initial residual norm
    bnorm: Any              # ‖b‖
    history: Any = None     # optional (maxit+1,) residual trace, NaN-padded

    def tree_flatten(self):
        return (self.nits, self.residual, self.converged, self.r0norm,
                self.bnorm, self.history), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


def vdot(a, b):
    """Vector inner product as multiply + sum-reduce.

    NOT ``jnp.dot``: a ``dot_general`` may be lowered through a
    reduced-precision matrix unit (TF32 for fp32 on the GPU unless the
    precision is pinned), which breaks the Arnoldi/Givens residual
    recurrence and GMRES's in-cycle convergence test.  An elementwise
    multiply + ``jnp.sum`` reduction keeps the input precision and is
    equally fast for vectors on every backend (one fused pass)."""
    return jnp.sum(a * b)


def _vdot_many(pairs):
    return tuple(jnp.sum(a * b) for a, b in pairs)


# single-device batch form (XLA fuses the independent reductions); the
# distributed dot (make_psum_dot) overrides .many with a SINGLE psum of the
# stacked partials — the communication-avoiding solvers (pipecg, cagmres)
# route every group of simultaneous inner products through dot_many
vdot.many = _vdot_many


def dot_many(dot, pairs):
    """Batch of inner products ⟨aᵢ,bᵢ⟩ with ONE cross-chip reduction when
    the dot provides a ``.many`` (distributed: one psum of the stacked
    local partial sums instead of one per product)."""
    many = getattr(dot, "many", None)
    if many is not None:
        return many(pairs)
    return tuple(dot(a, b) for a, b in pairs)


def _vdot_rows(V, w):
    return jnp.sum(V * w, axis=1)


vdot.rows = _vdot_rows


def dot_rows(dot, V, w):
    """All basis inner products ⟨V[j], w⟩ at once: one fused elementwise
    multiply + row reduction (mul+sum — NOT a matvec, same fp64
    dot_general hazard as vdot), and in the distributed dot ONE psum of
    the whole coefficient vector.  The classical-Gram-Schmidt primitive
    behind cagmres."""
    rows = getattr(dot, "rows", None)
    if rows is not None:
        return rows(V, w)
    # fall back THROUGH the provided dot, never to a local row-sum: a
    # custom distributed dot without .rows must still get its cross-chip
    # reduction per row, or every Arnoldi coefficient silently becomes
    # shard-local (dot_many's fallback routes per pair the same way)
    return jnp.stack([dot(V[j], w) for j in range(V.shape[0])])


def basis_combine(ym, V):
    """x-correction Σ ym[i]·V[i] as broadcast-multiply + reduce.

    Same rationale as ``vdot``: ``ym @ V`` is a dot_general whose
    precision the backend may lower; the reduce formulation keeps the
    input precision."""
    return jnp.sum(ym[:, None] * V, axis=0)


def operator(A) -> Callable:
    """Wrap a matrix container (or callable) as x ↦ A@x."""
    if callable(A) and not hasattr(A, "shape"):
        return A
    return lambda v: spmv(A, v)


def operator_t(A) -> Callable:
    """Wrap a matrix container as x ↦ Aᵀ@x (for BiCG/QMR/CGNR/LSQR).
    Callables may carry their transpose as a ``t_op`` attribute (see
    lssp_tpu.parallel.dist_ops.OpWithTranspose)."""
    if callable(A) and not hasattr(A, "shape"):
        t_op = getattr(A, "t_op", None)
        if t_op is not None:
            return t_op
        raise TypeError("transpose-based solvers need a matrix container "
                        "or an operator with a .t_op transpose attribute; "
                        "otherwise use a transpose-free method")
    from lssp_tpu.ops.spmv import spmv_t
    return lambda v: spmv_t(A, v)


def pc_transpose(M) -> Callable:
    """Return the Mᵀ-apply for a preconditioner.

    A ``Preconditioner`` (or any callable) with a ``t`` attribute uses it —
    ``Preconditioner.t`` itself raises when no transpose apply was installed.
    A bare callable WITHOUT ``t`` raises too: silently reusing the forward
    apply would corrupt the two-sided recurrences of BiCG/QMR/CGNR/LSQR for
    any nonsymmetric M (a symmetric callable can declare itself so with
    ``M.t = M``)."""
    if M is None:
        return identity_pc
    t = getattr(M, "t", None)
    if t is not None:
        return t
    raise TypeError(
        "transpose-based solvers need a preconditioner with an M^-T apply; "
        "this callable M has no .t attribute — attach one (M.t = M if M is "
        "symmetric) or use a transpose-free method (gmres/bicgstab/...)")


def stopping_tol(r0norm, bnorm, opts):
    """tol = max(rtol·‖r0‖, atol, rbtol·‖b‖)
    (/root/reference/src/solver-cg.cxx:66-70)."""
    return jnp.maximum(jnp.maximum(opts.rtol * r0norm, opts.atol),
                       opts.rbtol * bnorm)


def identity_pc(r):
    """PC_NONE: solve = copy (/root/reference/src/pc.cxx:67-79)."""
    return r


def init_state(A, b, x0, M):
    """Common init: operators, x0 default 0, r0 = b − A x0."""
    op = operator(A)
    pc = M if M is not None else identity_pc
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - op(x)
    return op, pc, x, r


def history_init(opts, r0norm):
    """Fixed-size residual-trace buffer; a dummy (1,) array when disabled so
    the while-loop carry keeps a single static structure."""
    if not opts.record_history:
        return jnp.zeros(1, dtype=r0norm.dtype)
    h = jnp.full(opts.maxit + 1, jnp.nan, dtype=r0norm.dtype)
    return h.at[0].set(r0norm)


def history_update(opts, hist, it, res, r0norm=None, bnorm=None):
    """Record the residual trace and, at verbosity >= 1, emit the
    reference's per-iteration line (abs res / rel res / res-over-||b||,
    /root/reference/src/solver-cg.cxx:108-112) via jax.debug.print.
    On backends without host callbacks the print is skipped here and the
    facade emits the trace host-side instead (history_print_host)."""
    from lssp_tpu.utils.log import device_print_supported
    if opts.verbosity >= 1 and device_print_supported():
        if r0norm is not None and bnorm is not None:
            jax.debug.print(
                "itr: {it:5d}, abs res: {res:.6e}, rel res: {rel:.6e}, "
                "rbn: {rbn:.6e}", it=it, res=res,
                rel=res / jnp.maximum(r0norm, jnp.finfo(res.dtype).tiny),
                rbn=res / jnp.maximum(bnorm, jnp.finfo(res.dtype).tiny))
        else:
            jax.debug.print("itr: {it:5d}, abs res: {res:.6e}", it=it, res=res)
    if not opts.record_history:
        return hist
    return hist.at[it].set(res)


def history_init_block(opts, k, r0norm, extra=0):
    """Block-solver residual trace: per-column (k, maxit+1+extra) buffer
    with the same per-column layout as ``history_init`` (column c prints
    via history_print_host on info[c]); dummy (1, 1) when disabled.
    ``extra`` slack lets a cycle-stepped solver (block GMRES advances by
    the restart length past the maxit check) write at true positions and
    slice back to maxit+1 afterwards."""
    if not opts.record_history:
        return jnp.zeros((1, 1), dtype=r0norm.dtype)
    h = jnp.full((k, opts.maxit + 1 + extra), jnp.nan, dtype=r0norm.dtype)
    return h.at[:, 0].set(r0norm)


def history_update_block(opts, hist, it, res, r0norm=None, bnorm=None):
    """Record a block solver's per-column residual vector at iteration
    ``it`` and, at verbosity >= 1 where device prints work, emit one trace
    line with all k residuals in the scalar solvers' abs/rel/rbn format
    (backends without host callbacks get the host-side trace from the
    facade instead, as in history_update)."""
    from lssp_tpu.utils.log import device_print_supported
    if opts.verbosity >= 1 and device_print_supported():
        if r0norm is not None and bnorm is not None:
            tiny = jnp.finfo(res.dtype).tiny
            jax.debug.print(
                "itr: {it:5d}, abs res: {res}, rel res: {rel}, rbn: {rbn}",
                it=it, res=res, rel=res / jnp.maximum(r0norm, tiny),
                rbn=res / jnp.maximum(bnorm, tiny))
        else:
            jax.debug.print("itr: {it:5d}, abs res: {res}", it=it, res=res)
    if not opts.record_history:
        return hist
    return hist.at[:, jnp.minimum(it, hist.shape[1] - 1)].set(res)


def history_print_host_multi(info: "SolveInfo", k: int) -> None:
    """Per-rhs host-side trace for the multi/block paths: one ``rhs c:``
    header + history_print_host per column (the single protocol shared by
    solve_multi's vmapped and block branches and the distributed
    launcher)."""
    from lssp_tpu.utils.log import log as _log_line
    for c in range(k):
        _log_line(f"rhs {c}:", level=0)
        history_print_host(jax.tree_util.tree_map(lambda a: a[c], info))


def history_print_host(info: "SolveInfo") -> None:
    """Host-side fallback for the per-iteration trace: print the recorded
    residual history in the reference's line format after the solve
    completes.  Used when the backend cannot run jax.debug.print (PJRT
    plugins without host callbacks)."""
    import numpy as np
    from lssp_tpu.utils.log import log as _log_line

    if info.history is None:
        return
    h = np.asarray(info.history)
    if h.ndim != 1 or h.size < 2:
        return
    tiny = float(np.finfo(h.dtype).tiny)
    r0 = max(float(info.r0norm), tiny)
    bn = max(float(info.bnorm), tiny)
    last = min(int(info.nits), h.size - 1)
    for it in range(1, last + 1):
        res = float(h[it])
        if np.isnan(res):
            continue
        # level=0: SolverOptions.verbosity already authorized this trace —
        # the device jax.debug.print path is not gated by the global log
        # verbosity either, and the two must behave identically
        _log_line(f"itr: {it:5d}, abs res: {res:.6e}, "
                 f"rel res: {res / r0:.6e}, rbn: {res / bn:.6e}", level=0)
