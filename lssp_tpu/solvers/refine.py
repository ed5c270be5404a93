"""Mixed-precision iterative refinement (Krylov-IR).

SpMV-bound Krylov loops move half the bytes in fp32.  Classic iterative
refinement keeps that saving while delivering fp64-quality answers:

    repeat:  r = b − A·x          (fp64, one SpMV per outer step)
             d ≈ A⁻¹ r            (fp32 Krylov solve)
             x = x + d            (fp64 accumulation)

The inner solve only needs a few digits (inner_rtol default 1e-3;
tighter sits on the fp32 stall floor and burns iterations — measured
647 vs 44 total inner iterations at 1e-4 vs 1e-3 for GMRES(30)+saamg on
a 256-squared anisotropic Poisson), so it converges fast in fp32; the
outer loop recovers the rest.  This subsumes
the reference's fp64-only design (its convergence targets, residuals to
1e-8, are met while the hot loops run in fp32).  Whether refinement beats
a plain fp64 solve on a GPU with native fp64 is not measured yet.

No reference analog.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lssp_tpu.config import SolverOptions, PCOptions
from lssp_tpu.ops.spmv import spmv
from lssp_tpu.solvers.base import SolveInfo
from lssp_tpu.solvers.facade import _unpermute
from lssp_tpu.solvers.registry import get_solver
from lssp_tpu.sparse.types import CSR


import functools


def _pc_options_key(pc_options):
    """Collision-proof cache key for a PCOptions: array-valued fields hash
    their full bytes (repr() summarizes numpy arrays above ~1000 elements,
    so two different block_sizes arrays could repr identically and reuse a
    stale factorization)."""
    if pc_options is None:
        return None
    import zlib
    parts = []
    for f in dataclasses.fields(pc_options):
        v = getattr(pc_options, f.name)
        if (hasattr(v, "__array__") or isinstance(v, (list, tuple))) \
                and not isinstance(v, str):
            try:
                a = np.asarray(v)
                parts.append((f.name, a.shape, str(a.dtype),
                              zlib.crc32(np.ascontiguousarray(a))))
            except (TypeError, ValueError):
                parts.append((f.name, repr(v)))
        else:
            parts.append((f.name, repr(v)))
    return tuple(parts)


@functools.partial(jax.jit,
                   static_argnames=("fn", "inner_opts", "max_outer",
                                    "inner_dtype"))
def _fused_ir(fn, A64, A32, M32, b, x, tol, inner_opts, max_outer,
              inner_dtype):
    """Device-side iterative-refinement loop (see solve_ir).  Returns
    (x, final_res, r0, total_inner_its)."""
    from lssp_tpu.solvers.base import vdot

    def norm64(v):
        return jnp.sqrt(vdot(v, v))          # mul+sum (fp64 dot is lossy)

    r0n = norm64(b - spmv(A64, x))

    def cond(c):
        x, res, outer, tot = c
        return (res > tol) & (outer < max_outer)

    def body(c):
        x, res, outer, tot = c
        r = b - spmv(A64, x)
        scale = norm64(r)
        safe = jnp.where(scale == 0, 1.0, scale)
        r32 = (r / safe).astype(inner_dtype)
        d32, info = fn(A32, r32, jnp.zeros_like(r32), M32, opts=inner_opts)
        x = x + d32.astype(jnp.float64) * safe
        res = norm64(b - spmv(A64, x))
        return (x, res, outer + 1, tot + info.nits)

    x, res, _, tot = jax.lax.while_loop(
        cond, body, (x, r0n, jnp.int32(0), jnp.int32(0)))
    return x, res, r0n, tot


@functools.partial(jax.jit,
                   static_argnames=("fn", "block", "inner_opts", "max_outer",
                                    "inner_dtype"))
def _fused_ir_multi(fn, block, A64, A32, M32, B, X, tol, inner_opts,
                    max_outer, inner_dtype):
    """Device-side multi-rhs refinement loop (see solve_ir_multi).
    Returns (X, final per-column res, r0 (k,), per-column inner its)."""
    spmv_b = jax.vmap(lambda v: spmv(A64, v), in_axes=1, out_axes=1)

    def norms64(V):
        return jnp.sqrt(jnp.sum(V * V, axis=0))   # mul+sum, never a matvec

    r0 = norms64(B - spmv_b(X))

    def cond(c):
        X, res, outer, tot = c
        return jnp.any(res > tol) & (outer < max_outer)

    def body(c):
        X, res, outer, tot = c
        R = B - spmv_b(X)
        scale = norms64(R)
        safe = jnp.where(scale == 0, 1.0, scale)
        # freeze converged columns: their inner rhs becomes zero, so the
        # inner solver exits at 0 iterations for them (r0 = 0 ≤ tol), the
        # correction is exactly zero, and every column's trajectory is
        # IDENTICAL to its own single-rhs solve_ir run — no tail
        # perturbation while the slowest column finishes
        active = scale > tol
        R32 = jnp.where(active[None, :],
                        R / safe[None, :], 0.0).astype(inner_dtype)
        if block:
            # ONE shared search block across all rhs corrections: the
            # fp32 inner pays stacked-Gram reductions instead of k dot
            # chains, and mixes information across columns
            D32, info = fn(A32, R32, jnp.zeros_like(R32), M32,
                           opts=inner_opts)
        else:
            def one(r32):
                return fn(A32, r32, jnp.zeros_like(r32), M32,
                          opts=inner_opts)
            D32, info = jax.vmap(one, in_axes=1, out_axes=(1, 0))(R32)
        X = X + D32.astype(jnp.float64) * safe[None, :]
        res = norms64(B - spmv_b(X))
        return (X, res, outer + 1, tot + info.nits)

    k = B.shape[1]
    X, res, _, tot = jax.lax.while_loop(
        cond, body, (X, r0, jnp.int32(0), jnp.zeros(k, jnp.int32)))
    return X, res, r0, tot


def prepare_ir(A, method: str = "gmres", pc: Optional[str] = "none",
               pc_options: Optional[PCOptions] = None,
               inner_dtype=jnp.float32, reorder: str = "auto"):
    """Setup phase of ``solve_ir`` alone: reorder, convert, device-upload
    both precisions of the execution format, and factor/build the
    preconditioner — filling the per-container memo so a following
    ``solve_ir`` finds everything cached.  Returns (A_host, A64, A32,
    perm, M32).  Lets callers time setup separately from compile+solve
    (the reference's phase-timing protocol,
    /root/reference/src/pc.cxx:83-236, example/exam.cxx:109-113)."""
    from lssp_tpu.solvers.facade import (_prepare_matrix, _fingerprint,
                                         needs_transpose_pc,
                                         resolve_reorder)
    from lssp_tpu import pc as pc_mod

    if method.lower() in ("direct", "splu") and pc in (None, "none"):
        pc = "lu"   # IR around a direct solve: exact fp32 LU inner
    # same shared rule as solve()/Solver.assemble: explicit grid dims pin
    # the original ordering; auto + multigrid PC → hierarchy ordering
    reorder = resolve_reorder(pc, pc_options, reorder)

    # repeated solve_ir calls with the same container must not re-reorder,
    # re-convert, re-upload, or re-FACTOR (the PC setup dominated measured
    # time-to-solution: e.g. 262k-row ILU(0) host factor + schedule build
    # per call).  Memoized on the container, crc-fingerprint invalidated —
    # same contract as the facade's _prepare_matrix cache.  Two levels:
    # the matrix preparation (A_host/A64/A32 device uploads) depends only
    # on (reorder, dtype, backend) and is shared across methods/PCs —
    # keying it by pc would pin duplicate hundreds-of-MB device copies.
    transpose_pc = needs_transpose_pc(method)
    mat_key = ("ir-mat", reorder, str(np.dtype(inner_dtype)),
               jax.default_backend())
    pc_key = ("ir-pc", mat_key, pc, transpose_pc,
              _pc_options_key(pc_options))
    fp = _fingerprint(A)
    cache = getattr(A, "_ir_cache", None)
    if cache is None:
        cache = {}
        try:
            object.__setattr__(A, "_ir_cache", cache)
        except Exception:
            pass               # non-dataclass containers: per-call cache
    if fp is None or cache.get("fp") != fp:
        cache.clear()          # content changed: all entries stale
        cache["fp"] = fp

    from lssp_tpu.utils import profile as _prof

    if mat_key in cache:
        A_host, A64, A32, perm = cache[mat_key]
    else:
        # build_device=False: both precisions are rebuilt below, so the
        # facade must not construct (or pin) an unused device format
        with _prof.phase("reorder_convert"):
            A_host, _, perm = _prepare_matrix(A, reorder=reorder,
                                              build_device=False)
            # both precisions of the execution format from the (possibly
            # reordered) host matrix
            from lssp_tpu.sparse.convert import to_device_format
            A64h = to_device_format(A_host)
        with _prof.phase("upload"):
            A64 = jax.device_put(A64h)
            A32 = jax.device_put(jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, inner_dtype)
                if jnp.asarray(a).dtype in (jnp.float64, jnp.float32) else a,
                A64))
            _prof.add_bytes("upload", _prof.tree_device_bytes(A64)
                            + _prof.tree_device_bytes(A32))
        cache[mat_key] = (A_host, A64, A32, perm)

    if pc_key in cache:
        M32 = cache[pc_key]
    else:
        M32 = None
        if pc not in (None, "none"):
            if transpose_pc:
                pc_options = dataclasses.replace(pc_options or PCOptions(),
                                                 transpose=True)
            with _prof.phase("pc_build"):
                M32 = pc_mod.setup(A_host.astype(np.dtype(inner_dtype)), pc,
                                   pc_options)
                _prof.add_bytes("pc_build",
                                _prof.tree_device_bytes(M32.state))
        cache[pc_key] = M32
    return A_host, A64, A32, perm, M32


def _inner_plan(method, opts, inner_rtol):
    """Shared fp32-inner policy for solve_ir / solve_ir_multi: pick the
    inner solver function and its options.

    Inner cap: bounds the damage when the fp32 attainable-accuracy floor
    sits just ABOVE inner_rtol — the solve then stalls and a generous cap
    burns hundreds of useless iterations per round (the outer loop
    re-measures in fp64 and collects the achieved progress either way, so
    cutting a stalled round early costs one cheap fp64 residual).
    Restarted GMRES variants finish healthy rounds well under 2 restarts;
    non-restarted methods keep the wider budget.

    Right preconditioning: fp32 inner GMRES must be the RIGHT-
    preconditioned variant — the left-preconditioned Givens residual
    estimate stalls on an fp32 floor well above inner_rtol with strong
    preconditioners (measured 854 vs 60 total inner iterations for gmres
    vs rgmres with saamg on a 512² anisotropic Poisson).  fgmres maps to
    rgmres too: solve_ir's preconditioner is always a FIXED operator, for
    which the two are mathematically identical — and fp32 fgmres has a
    measurably higher attainable-accuracy floor (512² aniso + saamg: 256
    vs 28 total inner iterations; the stored-Z update accumulates what
    rgmres's single end-of-cycle M⁻¹(Vy) apply does not).
    block_gmres is right-preconditioned by construction."""
    from lssp_tpu.solvers.registry import get_block_solver

    key = method.lower()
    if key in ("gmres", "rgmres", "lgmres", "rlgmres", "fgmres",
               "cagmres", "cargmres", "blockgmres", "block_gmres"):
        inner_cap = max(2 * opts.restart, 64)
    else:
        inner_cap = 200
    inner_opts = dataclasses.replace(
        opts, rtol=inner_rtol, atol=0.0, rbtol=0.0,
        maxit=min(opts.maxit, inner_cap))
    if key in ("blockgmres", "block_gmres"):
        # the block inner resolves at restart-cycle granularity, and the
        # ~1e-3 inner target needs far fewer steps than an outer-solve
        # restart — a full user cycle overshoots every fp32 round
        # (measured on 48² convdiff+ilut: 60 total inner its at restart 30
        # vs 24 at 12; weak-PC penalty of the shorter cycle is ~17%).
        # Shorter cycles also shrink the (m+1)·n·k basis the fp32 round
        # holds live.
        inner_opts = dataclasses.replace(inner_opts,
                                         restart=min(opts.restart, 16))
    inner_method = {"gmres": "rgmres", "lgmres": "rlgmres",
                    "fgmres": "rgmres",
                    "cagmres": "cargmres"}.get(key, method)
    fn = get_block_solver(inner_method) or get_solver(inner_method)
    return fn, inner_opts


def solve_ir(A, b, x0=None, method: str = "gmres",
             pc: Optional[str] = "none",
             options: Optional[SolverOptions] = None,
             pc_options: Optional[PCOptions] = None,
             inner_rtol: float = 1e-3, max_outer: int = 20,
             inner_dtype=jnp.float32, reorder: str = "auto"):
    """Solve to fp64 accuracy with fp32 inner Krylov solves.

    ``A``: host CSR (fp64).  Returns (x fp64, SolveInfo) where nits counts
    *total inner iterations* and the residual is the true fp64 residual.
    """
    from lssp_tpu.solvers.facade import _jitted

    from lssp_tpu.solvers.registry import get_block_solver
    if get_block_solver(method) is not None:
        raise ValueError(f"{method!r} is a multi-rhs block method; "
                         "use solve_ir_multi for (n, k) right-hand sides")
    opts = (options or SolverOptions()).resolved()
    from lssp_tpu.solvers.facade import validate_system
    b = validate_system(A, b, method)
    # direct/splu → pc="lu" happens inside prepare_ir (one copy of the rule)

    A_host, A64, A32, perm, M32 = prepare_ir(
        A, method=method, pc=pc, pc_options=pc_options,
        inner_dtype=inner_dtype, reorder=reorder)

    b = jnp.asarray(b, jnp.float64)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, jnp.float64)
    if perm is not None:
        b = b[perm]
        x = x[perm]

    bnorm = float(jnp.linalg.norm(b))
    tol = max(opts.rtol * bnorm, opts.atol)

    fn, inner_opts = _inner_plan(method, opts, inner_rtol)

    if opts.verbosity < 1:
        # fused path: the ENTIRE mixed-precision solve — fp64 residuals,
        # fp32 inner Krylov while_loops, fp64 accumulation — is one device
        # program (one dispatch).  The host loop below costs one host round
        # trip per outer round; verbose runs keep it for the per-round
        # trace.
        x, res, r0, total_inner = _fused_ir(
            fn, A64, A32, M32, b, x, jnp.float64(tol), inner_opts,
            max_outer, inner_dtype)
        res, r0, total_inner = float(res), float(r0), int(total_inner)
        if perm is not None:
            x = _unpermute(x, perm)
        return x, SolveInfo(nits=jnp.int32(total_inner),
                            residual=jnp.float64(res),
                            converged=jnp.bool_(res <= tol),
                            r0norm=jnp.float64(r0),
                            bnorm=jnp.float64(bnorm), history=None)

    residual64 = jax.jit(lambda x: b - spmv(A64, x))
    total_inner = 0
    res = float(jnp.linalg.norm(residual64(x)))
    r0 = res
    outer = 0
    while res > tol and outer < max_outer:
        r = residual64(x)
        scale = jnp.linalg.norm(r)
        safe = jnp.where(scale == 0, 1.0, scale)
        r32 = (r / safe).astype(inner_dtype)
        d32, info = _jitted(fn)(A32, r32, jnp.zeros_like(r32), M32,
                                opts=inner_opts)
        x = x + d32.astype(jnp.float64) * safe
        total_inner += int(info.nits)
        res = float(jnp.linalg.norm(residual64(x)))
        outer += 1
        if opts.verbosity >= 1:
            # host-side (works on every backend, incl. those where the
            # inner solver's device-side prints are unavailable)
            from lssp_tpu.utils.log import log as _log_line
            _log_line(f"ir outer: {outer:3d}, inner its: {int(info.nits):4d}, "
                      f"true res: {res:.6e}, rel res: "
                      f"{res / max(r0, np.finfo(np.float64).tiny):.6e}",
                      level=0)

    if perm is not None:
        x = _unpermute(x, perm)
    return x, SolveInfo(nits=jnp.int32(total_inner), residual=jnp.float64(res),
                        converged=jnp.bool_(res <= tol),
                        r0norm=jnp.float64(r0), bnorm=jnp.float64(bnorm),
                        history=None)


def solve_ir_multi(A, B, X0=None, method: str = "blockgmres",
                   pc: Optional[str] = "none",
                   options: Optional[SolverOptions] = None,
                   pc_options: Optional[PCOptions] = None,
                   inner_rtol: float = 1e-3, max_outer: int = 20,
                   inner_dtype=jnp.float32, reorder: str = "auto"):
    """Mixed-precision refinement for k right-hand sides at once: fp64
    outer residuals per column, ONE fp32 inner solve per round for the
    whole block.  ``B``: (n, k).  Returns (X fp64 (n, k), SolveInfo with
    per-column (k,) nits — total inner iterations — residuals, and
    convergence flags).

    The default inner is ``blockgmres`` (general matrices; ``blockcg``
    for SPD): the k residual corrections share one block-Krylov basis, so
    the fp32 hot loop pays stacked-Gram reductions instead of k dot
    chains AND converges in fewer iterations than k independent inners.
    Any ordinary method name runs the vmapped per-column inner instead
    (the matrix still streams once per iteration for all columns).

    The serving answer for many-rhs fp64 workloads — no
    reference analog (the serial library re-solves per rhs in fp64,
    lssp_solver_reset_rhs, /root/reference/src/lssp.cxx:470-489)."""
    from lssp_tpu.solvers.registry import get_block_solver

    opts = (options or SolverOptions()).resolved()
    A_host, A64, A32, perm, M32 = prepare_ir(
        A, method=method, pc=pc, pc_options=pc_options,
        inner_dtype=inner_dtype, reorder=reorder)

    B = jnp.asarray(B, jnp.float64)
    if B.ndim != 2:
        raise ValueError(f"B must be (n, k) for solve_ir_multi, "
                         f"got {B.shape}")
    X = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0, jnp.float64)
    if perm is not None:
        B = B[perm, :]
        X = X[perm, :]

    bnorm = jnp.sqrt(jnp.sum(B * B, axis=0))
    tol = jnp.maximum(opts.rtol * bnorm, opts.atol)

    fn, inner_opts = _inner_plan(method, opts, inner_rtol)
    block = get_block_solver(method) is not None

    X, res, r0, tot = _fused_ir_multi(
        fn, block, A64, A32, M32, B, X, tol, inner_opts, max_outer,
        inner_dtype)
    if perm is not None:
        X = _unpermute(X, perm)
    if opts.verbosity >= 1:
        from lssp_tpu.utils.log import log as _log_line
        for j in range(B.shape[1]):
            _log_line(f"ir rhs {j}: inner its {int(tot[j]):4d}, true res "
                      f"{float(res[j]):.6e}", level=0)
    return X, SolveInfo(nits=tot, residual=res, converged=res <= tol,
                        r0norm=r0, bnorm=bnorm, history=None)
