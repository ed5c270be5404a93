"""Preconditioner protocol + registry.

Parity map (reference /root/reference/src/pc.cxx:81-239 dispatch):
  NONE   → identity copy              (pc.cxx:67-79)
  JACOBI → diagonal scaling           (new: trivial baseline)
  ILUK   → level-of-fill ILU          (pc-iluk.cxx)
  ILUT   → dual-threshold ILU         (pc-ilut.cxx)
  BILUK  → block ILU(k) on BSR        (pc-biluk.cxx)
  AMG    → native classical AMG V-cycle (replaces the FASP/SXAMG/MI20
           external AMG wrappers with a from-scratch implementation)
  USER   → caller-supplied setup/apply (pc.cxx:219-227)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax

from lssp_tpu.config import PCOptions


@dataclasses.dataclass(frozen=True)
class Preconditioner:
    """A static apply function + a pytree of device state.

    Calling ``M(r)`` applies M⁻¹ — the contract every Krylov solver uses
    (reference LSSP_PC_SOLVE typedef, include/type-defs.h:104).
    """

    apply_fn: Callable      # static: (state, r) -> z
    state: Any              # pytree of device arrays
    name: str = "user"
    apply_t_fn: Any = None  # static: (state, r) -> M⁻ᵀr, or None (symmetric)

    def __call__(self, r):
        return self.apply_fn(self.state, r)

    def t(self, r):
        """Apply M⁻ᵀ (needed by BiCG/QMR/CGNR/LSQR).  Raises when the PC
        has no transpose apply — silently substituting M⁻¹ would corrupt
        the two-sided recurrences (symmetric PCs install
        ``apply_t_fn = apply_fn`` explicitly at setup)."""
        if self.apply_t_fn is None:
            raise ValueError(
                f"preconditioner {self.name!r} has no transpose apply; "
                "use a transpose-free method (gmres/bicgstab/...) or a PC "
                "supporting M^-T (none/jacobi/ilu*/ssor/sor/gs/lu)")
        return self.apply_t_fn(self.state, r)


def _flatten(m):
    return (m.state,), (m.apply_fn, m.name, m.apply_t_fn)


def _unflatten(aux, leaves):
    return Preconditioner(apply_fn=aux[0], state=leaves[0], name=aux[1],
                          apply_t_fn=aux[2])


jax.tree_util.register_pytree_node(Preconditioner, _flatten, _unflatten)


PC_REGISTRY = {}


def register_pc(name):
    def deco(fn):
        PC_REGISTRY[name] = fn
        return fn
    return deco


def setup(A, pc_type: str = "none", opts: PCOptions = None) -> Preconditioner:
    """Assemble a preconditioner for CSR matrix ``A`` (host-side setup,
    device-ready state — reference lssp_pc_assemble, pc.cxx:81-239)."""
    opts = (opts or PCOptions()).resolved()
    if pc_type is None:
        pc_type = "none"
    key = pc_type.lower()
    if key not in PC_REGISTRY:
        raise ValueError(f"unknown preconditioner {pc_type!r}; "
                         f"available: {sorted(PC_REGISTRY)}")
    M = PC_REGISTRY[key](A, opts)
    # commit the state to the device once: host-numpy leaves passed as jit
    # arguments would otherwise be re-transferred on EVERY solve call,
    # a cost that grows with the matrix.
    # Leaf-guarded: user PCs may carry arbitrary host objects in their state.
    def _put(leaf):
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            return jax.device_put(leaf)
        return leaf
    return jax.tree_util.tree_map(_put, M)


# --- trivial PCs -----------------------------------------------------------

def _identity_apply(state, r):
    return r


@register_pc("none")
def _setup_none(A, opts):
    """solve = copy (reference lssp_pc_non_assemble/solve, pc.cxx:67-79)."""
    return Preconditioner(_identity_apply, state=(), name="none",
                          apply_t_fn=_identity_apply)


def _jacobi_apply(state, r):
    return state * r


@register_pc("jacobi")
def _setup_jacobi(A, opts):
    """Diagonal scaling z = D⁻¹r; zero diagonals clamped like the reference's
    ILU pivot guard (pc-iluk.cxx:367-374)."""
    import numpy as np
    from lssp_tpu.sparse.utils import diagonal
    from lssp_tpu.config import Defaults
    d = diagonal(A).copy()
    small = np.abs(d) < Defaults.ZERO_DIAG_TOL
    d[small] = np.where(d[small] > 0, Defaults.ZERO_DIAG_VALUE,
                        -Defaults.ZERO_DIAG_VALUE)
    inv = (opts.omega / d).astype(A.data.dtype)
    return Preconditioner(_jacobi_apply, state=inv, name="jacobi",
                          apply_t_fn=_jacobi_apply)


@register_pc("user")
def _setup_user(A, opts):
    """Caller-supplied hooks (reference LSSP_PC_USER, pc.cxx:219-227)."""
    if opts.user_apply is None:
        raise ValueError("user PC requires PCOptions.user_apply")
    state = opts.user_setup(A) if opts.user_setup is not None else ()
    return Preconditioner(opts.user_apply, state=state, name="user")
