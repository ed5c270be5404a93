"""Device-side AMG V-cycle.

The hierarchy is converted once into device execution formats (DIA for the
stencil-structured fine grid, ELL for coarse/interpolation operators); the
V-cycle itself is a pure jittable function unrolled over the (static) level
count, with pointwise smoothers only — weighted Jacobi or Chebyshev
(preconditioned by D⁻¹) — so every device op is a bandwidth-bound SpMV or
elementwise work, never a sequential sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lssp_tpu.ops.spmv import spmv
from lssp_tpu.sparse.types import CSR
from lssp_tpu.sparse.convert import to_device_format, csr_to_ell
from lssp_tpu.amg.setup import AMGHierarchy, amg_setup


@dataclasses.dataclass(frozen=True)
class DeviceLevel:
    A: Any          # device-format matrix (DIA/ELL)
    P: Any          # ELL (n_f, n_c) or None on coarsest
    R: Any          # ELL (n_c, n_f) or None
    dinv: Any       # (n,)
    lmax: float     # static: λ_max(D⁻¹A) estimate
    smoother: str   # static
    degree: int     # static: smoothing steps / Chebyshev degree
    omega: float    # static: Jacobi damping


jax.tree_util.register_pytree_node(
    DeviceLevel,
    lambda l: ((l.A, l.P, l.R, l.dinv),
               (l.lmax, l.smoother, l.degree, l.omega)),
    lambda aux, c: DeviceLevel(*c, lmax=aux[0], smoother=aux[1],
                               degree=aux[2], omega=aux[3]))


@dataclasses.dataclass(frozen=True)
class DeviceAMG:
    levels: Tuple[DeviceLevel, ...]
    coarse_inv: Any
    cycles: int     # static: cycles per application
    gamma: int = 1  # static: 1 = V-cycle, 2 = W-cycle


jax.tree_util.register_pytree_node(
    DeviceAMG,
    lambda h: ((h.levels, h.coarse_inv), (h.cycles, h.gamma)),
    lambda aux, c: DeviceAMG(levels=c[0], coarse_inv=c[1], cycles=aux[0],
                             gamma=aux[1]))


def build_device_amg(hier: AMGHierarchy, dtype=np.float64,
                     smoother: str = "chebyshev", degree: int = 2,
                     omega: float = 2.0 / 3.0, cycles: int = 1,
                     gamma: int = 1) -> DeviceAMG:
    levels = []
    for lev in hier.levels:
        Ad = to_device_format(CSR.from_scipy(lev.A.astype(dtype)))
        if lev.P is not None:
            P = csr_to_ell(CSR.from_scipy(lev.P.astype(dtype)))
            R = csr_to_ell(CSR.from_scipy(lev.P.T.tocsr().astype(dtype)))
        else:
            P = R = None
        levels.append(DeviceLevel(
            A=Ad, P=P, R=R, dinv=jnp.asarray(lev.dinv.astype(dtype)),
            lmax=float(lev.lmax), smoother=smoother, degree=degree,
            omega=omega))
    return DeviceAMG(levels=tuple(levels),
                     coarse_inv=jnp.asarray(hier.coarse_inv.astype(dtype)),
                     cycles=cycles, gamma=gamma)


def _smooth(lev: DeviceLevel, x, b):
    if lev.degree <= 0:
        return x
    if lev.smoother == "jacobi":
        for _ in range(lev.degree):
            x = x + lev.omega * lev.dinv * (b - spmv(lev.A, x))
        return x
    if lev.smoother == "l1jacobi":
        # dinv here is 1/diag; l1 damping folded into omega conservatively
        for _ in range(lev.degree):
            x = x + 0.5 * lev.dinv * (b - spmv(lev.A, x))
        return x
    # Chebyshev on [0.3·lmax, 1.1·lmax] of D⁻¹A (hypre's cheby_fraction=0.3:
    # the coarse grid owns modes below 0.3·lmax, the polynomial equi-damps
    # everything above)
    ub = 1.1 * lev.lmax
    lb = 0.3 * lev.lmax
    theta = (ub + lb) / 2.0
    delta = (ub - lb) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    r = lev.dinv * (b - spmv(lev.A, x))
    d = r / theta
    for _ in range(lev.degree):
        x = x + d
        r = r - lev.dinv * spmv(lev.A, d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x


def _cycle_at(h: DeviceAMG, l: int, b_l, x_l):
    """One V-cycle starting at level ``l`` (0 = finest)."""
    lev = h.levels[l]
    if l == len(h.levels) - 1:
        return jnp.matmul(h.coarse_inv, b_l,
                          precision=jax.lax.Precision.HIGHEST)
    x_l = _smooth(lev, x_l, b_l)
    r = b_l - spmv(lev.A, x_l)
    rc = spmv(lev.R, r)
    ec = _cycle_at(h, l + 1, rc, jnp.zeros_like(rc))
    for _ in range(getattr(h, "gamma", 1) - 1):
        # W-cycle: revisit the coarse hierarchy warm-started
        ec = _cycle_at(h, l + 1, rc, ec)
    x_l = x_l + spmv(lev.P, ec)
    return _smooth(lev, x_l, b_l)


def vcycle(h: DeviceAMG, b, x=None):
    """One (or h.cycles) V-cycle(s); x0 defaults to 0 (PC application)."""
    if x is None:
        x = jnp.zeros_like(b)
    for _ in range(h.cycles):
        x = _cycle_at(h, 0, b, x)
    return x


def fmg_initial(h: DeviceAMG, b):
    """Full-multigrid (nested-iteration) initial guess: restrict b down
    the hierarchy, solve the coarsest exactly, then interpolate up with
    one V-cycle per level — the reference's FMG solver capability
    (fasp_solver_famg, /root/reference/src/solver-amg.cxx:99)."""
    bs = [b]
    for l in range(len(h.levels) - 1):
        bs.append(spmv(h.levels[l].R, bs[-1]))
    x = jnp.matmul(h.coarse_inv, bs[-1],
                   precision=jax.lax.Precision.HIGHEST)
    for l in range(len(h.levels) - 2, -1, -1):
        x = spmv(h.levels[l].P, x)
        x = _cycle_at(h, l, bs[l], x)
    return x


def amg_solve(A: CSR, b, x0=None, rtol: float = 1e-7, atol: float = 1e-7,
              maxit: int = 100, theta: float = 0.25,
              smoother: str = "chebyshev", degree: int = 2,
              dtype=np.float64, fmg: bool = False):
    """Standalone AMG solver (stationary V-cycle iteration) — parity with
    the reference's lssp_solver_amg wrapper around FASP
    (/root/reference/src/solver-amg.cxx:64-130).  ``fmg=True`` starts
    from the full-multigrid (nested-iteration) guess — the reference's
    FMG solver type (fasp_solver_famg, solver-amg.cxx:99)."""
    hier = amg_setup(A, theta=theta)
    h = build_device_amg(hier, dtype=dtype, smoother=smoother, degree=degree)
    b = jnp.asarray(b, dtype=dtype)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dtype=dtype)
    if fmg and x0 is None:
        x = fmg_initial(h, b)

    @jax.jit
    def run(x, b):
        r0 = jnp.linalg.norm(b - spmv(h.levels[0].A, x))
        tol = jnp.maximum(rtol * r0, atol)

        def cond(carry):
            it, x, res = carry
            return (it < maxit) & (res > tol)

        def body(carry):
            it, x, res = carry
            r = b - spmv(h.levels[0].A, x)
            x = x + vcycle(h, r)
            res = jnp.linalg.norm(b - spmv(h.levels[0].A, x))
            return (it + 1, x, res)

        return jax.lax.while_loop(cond, body, (jnp.int32(0), x, r0))

    it, x, res = run(x, b)
    return x, {"nits": int(it), "residual": float(res),
               "complexity": hier.complexity()}
