"""Polynomial (Chebyshev) preconditioner.

The most data-parallel preconditioner class: the apply is ``degree`` SpMVs and
axpys — no triangular recurrences, no gathers, runs at full streaming
bandwidth for DIA matrices.  M⁻¹ ≈ p(A) where p is the degree-d Chebyshev
polynomial minimizing ‖1 − λ·p(λ)‖ over an eigenvalue interval
[λmax/ratio, 1.05·λmax] (λmax estimated by host power iteration at setup).
For SPD systems; symmetric by construction, so it is also valid inside CG
and supplies its own transpose apply.

No single reference analog (its external packages lean on ILU/AMG), but
polynomial preconditioning is the standard accelerator-first choice and
complements the Chebyshev smoothers already used in the multigrids.
"""
from __future__ import annotations

import functools

import numpy as np

from lssp_tpu.pc.base import Preconditioner, register_pc
from lssp_tpu.sparse.types import CSR


def _power_lmax(A: CSR, iters: int = 20) -> float:
    rng = np.random.default_rng(0)
    S = A.to_scipy()
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = S @ v
        lam = float(np.linalg.norm(w))
        if lam == 0:
            return 1.0
        v = w / lam
    return 1.1 * lam


def _poly_apply(degree, lb, ub, state, r, transpose=False):
    """z = p(A) r via the Chebyshev iteration for A z = r with x0 = 0
    (equivalently: z is the degree-``degree`` Chebyshev polynomial in A
    applied to r over [lb, ub]).  ``transpose`` runs p(Aᵀ) = p(A)ᵀ."""
    import jax.numpy as jnp
    from lssp_tpu.ops.spmv import spmv as _fwd, spmv_t as _tr
    spmv = _tr if transpose else _fwd
    Adev = state
    theta = (ub + lb) / 2.0
    delta = (ub - lb) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    z = jnp.zeros_like(r)
    res = r                                   # r - A·0
    d = res / theta
    for _ in range(degree):
        z = z + d
        res = res - spmv(Adev, d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
        rho = rho_new
    return z


@register_pc("poly")
def setup_poly(A, opts):
    from lssp_tpu.sparse.convert import to_device_format
    if opts.poly_degree < 1:
        raise ValueError(f"poly PC requires poly_degree >= 1, "
                         f"got {opts.poly_degree}")
    lmax = _power_lmax(A)
    ub = 1.05 * lmax
    lb = ub / max(opts.poly_ratio, 1.0 + 1e-6)
    # same execution-format thresholds as the solver's own matrix
    Adev = to_device_format(A)
    d = int(opts.poly_degree)
    apply_fn = functools.partial(_poly_apply, d, lb, ub)
    # p(A)ᵀ = p(Aᵀ): the transpose apply runs the same recurrence on spmv_t
    apply_t = functools.partial(_poly_apply, d, lb, ub, transpose=True)
    return Preconditioner(apply_fn, state=Adev,
                          name=f"poly(d={opts.poly_degree})",
                          apply_t_fn=apply_t)


register_pc("chebyshev")(setup_poly)
