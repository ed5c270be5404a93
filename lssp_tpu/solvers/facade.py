"""Public solve API.

Functional one-shot ``solve()`` plus a ``Solver`` lifecycle object with the
reference's create → assemble → solve protocol
(/root/reference/include/lssp.h:44-53, doc/solver.tex:143-202): assembly
converts the matrix to its device execution format and builds the
preconditioner once; repeated solves (new rhs / warm restart from the
previous x, reference lssp_solver_reset_rhs/_unknown, lssp.cxx:416-433)
reuse the compiled iteration and the factorization.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lssp_tpu.config import SolverOptions, PCOptions
from lssp_tpu.sparse.types import CSR, BSR, ELL, DIA, COO
from lssp_tpu.sparse.convert import to_device_format, coo_to_csr
from lssp_tpu.sparse.reorder import maybe_rcm
from lssp_tpu.sparse.utils import sort_columns
from lssp_tpu.solvers.base import (SolveInfo, history_print_host,
                                   history_print_host_multi)
from lssp_tpu.utils.log import device_print_supported
from lssp_tpu.solvers.registry import get_solver, get_block_solver
from lssp_tpu import pc as pc_mod


TRANSPOSE_METHODS = frozenset(("bicg", "qmr", "cgnr", "cgn", "lsqr"))


def needs_transpose_pc(method: str) -> bool:
    """Whether the method applies M^-T (the facade auto-injects
    PCOptions(transpose=True) for these — ONE list for every entry
    point)."""
    return method.lower() in TRANSPOSE_METHODS


def saamg_keeps_ordering(pc, pc_options) -> bool:
    """Whether an EXPLICIT saamg grid (user-supplied (gy, gx) dims) pins
    the original row ordering — reordering would scramble the boxes.  ONE
    predicate for every entry point (solve / solve_multi / Solver.assemble
    / solve_ir).  ``saamg_grid=None`` (auto-detect from the reordered
    sparsity) and ``False`` (forced flat) impose no ordering constraint."""
    if pc != "saamg" or pc_options is None:
        return False
    g = pc_options.saamg_grid
    # identity checks, not `in (None, False)`: grid dims may be a numpy
    # array, whose == against tuple members raises/broadcasts
    return g is not None and g is not False


def resolve_reorder(pc, pc_options, reorder):
    """ONE reorder-resolution rule for every entry point (solve /
    solve_multi / Solver.assemble / solve_ir).  Explicit saamg grid dims
    pin the original ordering; ``auto`` + a multigrid PC routes through
    the hierarchical-aggregation ordering (``hier:g:coarse:levels`` —
    amg/aggregate.py) so that on a matrix with NO detectable grid the flat
    reshape aggregates are true strength aggregates at every level.
    rsamg's flat levels use the same contiguous reshape groups, so both
    get the same treatment."""
    if reorder != "auto" or not isinstance(pc, str):
        return reorder
    if saamg_keeps_ordering(pc, pc_options):
        return None   # explicit grid dims need the original ordering
    if pc in ("saamg", "rsamg"):
        o = pc_options or PCOptions()
        return (f"hier:{o.saamg_aggregate}:{o.amg_coarse_size}:"
                f"{o.amg_max_levels}")
    return reorder


# methods that legitimately accept rectangular operators (least squares)
_RECTANGULAR_OK = frozenset(("lsqr",))


def validate_system(A, b, method: str):
    """The reference's assemble-time validation (square operator,
    matching rhs length — /root/reference/src/lssp.cxx:147-160) plus an
    inexact-dtype cast for the rhs: an integer b would silently break the
    jitted while_loop carry types, and a shape mismatch used to surface
    as a raw broadcasting TypeError deep inside the first SpMV.  ONE
    helper for every entry point (solve / solve_multi / Solver.assemble /
    solve_ir).  Returns b (cast to float when needed)."""
    shape = getattr(A, "shape", None)
    if shape is not None and len(shape) == 2 \
            and shape[0] != shape[1] \
            and method.lower() not in _RECTANGULAR_OK:
        raise ValueError(
            f"method={method!r} needs a SQUARE matrix, got {shape}; use "
            "method='lsqr' or solve_lsq() for least-squares systems")
    if b is not None:
        n = getattr(b, "shape", (None,))[0]
        if shape is not None and n is not None and n != shape[0]:
            raise ValueError(
                f"rhs length {n} does not match the matrix rows "
                f"{shape[0]}")
        if not jnp.issubdtype(jnp.asarray(b).dtype, jnp.inexact):
            b = jnp.asarray(b, jnp.float64)
    return b


def _unpermute(x, perm):
    if perm is None:
        return x
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return x[inv]


@functools.cache
def _jitted(fn):
    return jax.jit(fn, static_argnames=("opts",))


# the closure cache is bounded: every fresh lambda is a distinct key, so an
# unbounded cache would pin each operator closure and its compiled
# executable for the process lifetime
@functools.lru_cache(maxsize=64)
def _jitted_closed(fn, A_op, M_op):
    """jit of ``fn`` with the bare-callable operands (either or both of
    A/M) closed over; a closed-over operand's positional slot receives
    None at call time."""
    def g(A, b, x0, M, opts):
        return fn(A if A_op is None else A_op, b, x0,
                  M if M_op is None else M_op, opts=opts)
    return jax.jit(g, static_argnames=("opts",))


def _dispatch_solve(fn, A_dev, b, x0, M, opts):
    """Route bare callables (operator A and/or preconditioner M) into jit
    closures: a plain Python function is not a pytree of arrays, so it
    cannot be a traced argument.  Preconditioner objects and matrix
    containers ARE pytrees and pass through as arguments (so repeated
    solves with fresh instances of the same structure reuse one compile)."""
    from lssp_tpu.pc.base import Preconditioner
    a_bare = callable(A_dev) and not hasattr(A_dev, "shape")
    m_bare = (M is not None and callable(M)
              and not isinstance(M, Preconditioner))
    if not (a_bare or m_bare):
        return _jitted(fn)(A_dev, b, x0, M, opts=opts)
    return _jitted_closed(fn, A_dev if a_bare else None,
                          M if m_bare else None)(
        None if a_bare else A_dev, b, x0, None if m_bare else M, opts=opts)


# one shared memo discipline (content fingerprint + per-container cache)
# for every prepared-state cache in the library — see utils/memo.py
from lssp_tpu.utils.memo import fingerprint as _fingerprint
from lssp_tpu.utils.memo import memo_get as _memo_get
from lssp_tpu.utils.memo import memo_put as _memo_put


def _memoize_prepared(A, reorder, out):
    _memo_put(A, "_prepared_cache", (reorder, jax.default_backend()),
              _fingerprint(A), out)


def _maybe_hierarchy(A, perm, mode):
    """Apply the hierarchical-aggregation ordering (amg/aggregate.py) for a
    ``hier:g:coarse:levels`` reorder mode.  Returns (reordered A or None,
    composed perm).  Skipped when the (possibly RCM'd) matrix has a
    detectable grid — direction-aware grid aggregation beats any flat
    ordering there."""
    from lssp_tpu.amg.sa import detect_grid
    from lssp_tpu.amg.aggregate import hierarchy_perm
    from lssp_tpu.sparse.reorder import permute_symmetric

    if detect_grid(A) is not None:
        return None, perm
    g, coarse, levels = (int(v) for v in mode.split(":")[1:])
    p2 = hierarchy_perm(A, g=g, coarse_size=coarse, max_levels=levels)
    if np.array_equal(p2, np.arange(A.shape[0])):
        return None, perm
    return permute_symmetric(A, p2), (p2 if perm is None else perm[p2])


def _prepare_matrix(A, reorder="auto", build_device=True):
    """Host CSR → device execution format; COO → CSR first; device formats
    and callables pass through.

    ``reorder``: "rcm" forces a bandwidth-reducing symmetric permutation;
    None and "auto" keep the given ordering (a ``hier:`` mode applies the
    hierarchical-aggregation ordering).  Returns (host_csr, device_fmt,
    perm).
    ``build_device=False`` skips (and does not cache) the device execution
    format — for callers like solve_ir that rebuild their own precisions.
    """
    # repeated solve() calls with the same container must not re-convert and
    # re-upload the matrix (336 MB at 16.8M rows); the prepared triple is
    # memoized on the container itself,
    # invalidated by a content fingerprint when buffers are mutated in place
    A_orig = A
    backend = jax.default_backend()
    if build_device:
        hit = _memo_get(A, "_prepared_cache", (reorder, backend),
                        _fingerprint(A))
        if hit is not None:
            return hit
    if isinstance(A, COO):
        A = coo_to_csr(A)
    if isinstance(A, BSR):
        # execution-format preference for block matrices: banded block
        # matrices run as *scalar* diagonal streams; BDIA is the fallback
        # when the scalar diagonal count explodes (large bs), gather ELL
        # the last resort.  The GPU cost of each is not measured.  The
        # scalar CSR view feeds preconditioner factorization either way.
        from lssp_tpu.sparse.convert import (
            bsr_to_csr, bsr_to_bdia, csr_to_dia, csr_to_ell)
        csr = bsr_to_csr(A)
        if not build_device:
            return csr, None, None
        try:
            dev = csr_to_dia(csr, max_diags=64)
            if len(dev.offsets) * csr.shape[0] > 3.0 * max(csr.nnz, 1):
                raise ValueError("scalar-DIA padding waste too large")
        except ValueError:
            try:
                dev = bsr_to_bdia(A, max_diags=32, fill=2.0)
            except ValueError:
                # raw BSR is not jit-safe as a traced argument (its SpMV
                # needs host-side row expansion) — gather ELL is
                dev = csr_to_ell(csr)
        from lssp_tpu.utils.profile import add_bytes, tree_device_bytes
        add_bytes("upload", tree_device_bytes(dev))
        out = (csr, jax.device_put(dev), None)
        _memoize_prepared(A_orig, reorder, out)
        return out
    if isinstance(A, CSR):
        A = sort_columns(A)
        perm = None
        hier = isinstance(reorder, str) and reorder.startswith("hier:")
        if reorder == "rcm":
            A2, perm = maybe_rcm(A)
            if perm is not None:
                A = A2
        if hier:
            A2, perm = _maybe_hierarchy(A, perm, reorder)
            if A2 is not None:
                A = A2
        if not build_device:
            return A, None, perm
        dev = to_device_format(A)
        from lssp_tpu.utils.profile import add_bytes, tree_device_bytes
        add_bytes("upload", tree_device_bytes(dev))
        out = (A, jax.device_put(dev), perm)
        _memoize_prepared(A_orig, reorder, out)
        return out
    return None, A, None


def solve(A, b, x0=None, method: str = "gmres", pc: Optional[str] = "none",
          options: Optional[SolverOptions] = None,
          pc_options: Optional[PCOptions] = None,
          M=None, reorder: str = "auto"):
    """Solve A x = b.  Returns ``(x, SolveInfo)``.

    ``A``: CSR/COO (host; auto-converted to DIA/ELL execution format), or an
    already-converted device format, or a callable ``x ↦ A@x``.
    ``pc``: registry name ("none", "jacobi", "ilu0", "iluk", "ilut", ...) or
    ``M`` a prebuilt Preconditioner / callable.
    """
    opts = (options or SolverOptions()).resolved()
    b = validate_system(A, b, method)
    # backends without host callbacks can't run jax.debug.print: record the
    # residual trace instead and print it host-side after the solve
    host_trace = opts.verbosity >= 1 and not device_print_supported()
    user_history = opts.record_history
    if host_trace and not opts.record_history:
        opts = dataclasses.replace(opts, record_history=True)
    reorder = resolve_reorder(pc, pc_options, reorder)
    if method.lower() in ("direct", "splu") and pc in (None, "none") and M is None:
        pc = "lu"   # direct solve = one application of the exact-LU PC
    A_host, A_dev, perm = _prepare_matrix(A, reorder=reorder)
    if M is None and pc not in (None, "none"):
        if A_host is None:
            raise ValueError("preconditioner setup needs a host CSR matrix; "
                             "pass M= explicitly for operator inputs")
        if needs_transpose_pc(method):
            # transpose-based methods need the exact M⁻ᵀ apply
            pc_options = dataclasses.replace(pc_options or PCOptions(),
                                             transpose=True)
        M = pc_mod.setup(A_host, pc, pc_options)
    fn = get_solver(method)
    b = jnp.asarray(b)
    if x0 is None:
        # the unknown lives in the COLUMN space: for rectangular systems
        # (lsqr) zeros_like(b) has the wrong length
        ncols = getattr(A_dev, "shape", (None, b.shape[0]))[1] \
            if not callable(A_dev) or hasattr(A_dev, "shape") \
            else b.shape[0]
        x0 = jnp.zeros(ncols if ncols is not None else b.shape[0],
                       dtype=b.dtype)
    if perm is not None:
        b = b[perm]
        x0 = x0[perm]
    x, info = _dispatch_solve(fn, A_dev, b, x0, M, opts)
    x = _unpermute(x, perm)
    if host_trace:
        history_print_host(info)
        if not user_history:
            # the trace buffer was forced on for printing only — the
            # caller's SolveInfo contract (history=None) is preserved
            info = dataclasses.replace(info, history=None)
    return x, info


@functools.lru_cache(maxsize=64)
def _jitted_multi(fn, A_op, M_op):
    """jit of the rhs-vmapped solver; bare-callable A/M close over like
    _jitted_closed."""
    def g(A, Bt, X0t, M, opts):
        def one(b, x0):
            return fn(A if A_op is None else A_op, b, x0,
                      M if M_op is None else M_op, opts=opts)
        return jax.vmap(one)(Bt, X0t)
    return jax.jit(g, static_argnames=("opts",))


def solve_multi(A, B, X0=None, method: str = "cg",
                pc: Optional[str] = "none",
                options: Optional[SolverOptions] = None,
                pc_options: Optional[PCOptions] = None,
                M=None, reorder: str = "auto"):
    """Solve A·X = B for k right-hand sides at once (B: (n, k), columns are
    the rhs vectors, LAPACK-style).  Returns (X (n, k), SolveInfo whose
    scalar fields are (k,) arrays — per-rhs iteration counts, residuals,
    and convergence flags).

    The k solves run as ONE vmapped device program sharing the matrix and
    preconditioner state: the batched SpMV reads the matrix once
    per iteration for ALL rhs (traffic (ndiag·n + 2kn) instead of
    k·(ndiag·n + 2n)), so many-rhs production serving amortizes the
    dominant stream.  Each lane runs until the slowest lane's stopping
    rule is met; per-lane counts report the true individual convergence.
    No reference analog (the serial library re-solves per rhs,
    lssp_solver_reset_rhs — which `Solver.reset_rhs` also provides)."""
    opts = (options or SolverOptions()).resolved()
    validate_system(A, None, method)        # square check
    B = jnp.asarray(B)
    if not jnp.issubdtype(B.dtype, jnp.inexact):
        B = B.astype(jnp.float64)
    _shape = getattr(A, "shape", None)
    if _shape is not None and B.shape[0] != _shape[0]:
        raise ValueError(f"rhs rows {B.shape[0]} do not match the "
                         f"matrix rows {_shape[0]}")
    reorder = resolve_reorder(pc, pc_options, reorder)
    if method.lower() in ("direct", "splu") and pc in (None, "none") \
            and M is None:
        pc = "lu"   # direct solve = one application of the exact-LU PC
    A_host, A_dev, perm = _prepare_matrix(A, reorder=reorder)
    if M is None and pc not in (None, "none"):
        if A_host is None:
            raise ValueError("preconditioner setup needs a host CSR matrix; "
                             "pass M= explicitly for operator inputs")
        if needs_transpose_pc(method):
            pc_options = dataclasses.replace(pc_options or PCOptions(),
                                             transpose=True)
        M = pc_mod.setup(A_host, pc, pc_options)
    return _run_multi(method, A_dev, M, B, X0, perm, opts)


def _run_multi(method, A_dev, M, B, X0, perm, opts):
    """Multi-rhs execution on PREPARED device state (shared by the
    module-level solve_multi and the Solver lifecycle): block-Krylov or
    vmapped dispatch, unpermute, host-side trace."""
    from lssp_tpu.pc.base import Preconditioner

    host_trace = opts.verbosity >= 1 and not device_print_supported()
    user_history = opts.record_history
    if host_trace and not opts.record_history:
        opts = dataclasses.replace(opts, record_history=True)
    block_fn = get_block_solver(method)
    fn = None if block_fn is not None else get_solver(method)
    B = jnp.asarray(B)
    if B.ndim != 2:
        raise ValueError(f"B must be (n, k) for solve_multi, got {B.shape}")
    X0 = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0)
    if perm is not None:
        B = B[perm, :]
        X0 = X0[perm, :]
    if block_fn is not None:
        # block-Krylov path: ONE shared search block for all rhs (stacked
        # Gram reductions instead of k independent dot chains) — see
        # solvers/block_cg.py (SPD, like cg) and solvers/block_gmres.py
        # (nonsymmetric, restarted).
        # block solvers share the scalar (A, b, x0, M, opts=) positional
        # signature, so the same bare-callable routing + jit caches apply
        X, info = _dispatch_solve(block_fn, A_dev, B, X0, M, opts)
    else:
        a_bare = callable(A_dev) and not hasattr(A_dev, "shape")
        m_bare = (M is not None and callable(M)
                  and not isinstance(M, Preconditioner))
        vf = _jitted_multi(fn, A_dev if a_bare else None,
                           M if m_bare else None)
        X, info = vf(None if a_bare else A_dev, B.T, X0.T,
                     None if m_bare else M, opts=opts)
        X = X.T
    X = _unpermute(X, perm)
    if host_trace:
        history_print_host_multi(info, X.shape[1])
        if not user_history:
            info = dataclasses.replace(info, history=None)
    return X, info


class Solver:
    """Lifecycle API with reference-parity setters
    (/root/reference/src/lssp.cxx:416-535)."""

    def __init__(self, method: str = "gmres", pc: Optional[str] = "none",
                 options: Optional[SolverOptions] = None,
                 pc_options: Optional[PCOptions] = None):
        self.method = method
        self.pc_type = pc
        self.options = options or SolverOptions()
        self.pc_options = pc_options or PCOptions()
        self.A_host = None
        self.A_dev = None
        self.M = None
        self.b = None
        self.x = None
        self.info: Optional[SolveInfo] = None
        self.assembled = False

    # -- setters (lssp_solver_set_*, include/lssp.h:65-89) --
    def set_rtol(self, v):   self.options = dataclasses.replace(self.options, rtol=v);   return self
    def set_atol(self, v):   self.options = dataclasses.replace(self.options, atol=v);   return self
    def set_rbtol(self, v):  self.options = dataclasses.replace(self.options, rbtol=v);  return self
    def set_maxit(self, v):  self.options = dataclasses.replace(self.options, maxit=v);  return self
    def set_restart(self, v): self.options = dataclasses.replace(self.options, restart=v); return self
    def set_augk(self, v):   self.options = dataclasses.replace(self.options, aug_k=v);  return self
    def set_bgsl(self, v):   self.options = dataclasses.replace(self.options, bgsl=v);   return self
    def set_idrs(self, v):   self.options = dataclasses.replace(self.options, idrs=v);   return self

    def set_log(self, f):
        """Tee this solver's output to a file object (reference
        lssp_solver_set_log, lssp.cxx:530-535; the reference's log is
        process-global underneath, as here)."""
        from lssp_tpu.utils.log import set_log
        set_log(f)
        return self

    def reset_type(self, method: str):
        """Switch the Krylov method, keeping the assembled matrix
        (reference lssp_solver_reset_type, lssp.cxx:426-433).  Switching to
        a transpose-based method rebuilds the PC with the M⁻ᵀ apply
        installed (unless it was already set up with transpose=True)."""
        self.method = method
        if (self.assembled and self.M is not None
                and self.pc_type not in (None, "none")
                and needs_transpose_pc(method)
                and not (self.pc_options and self.pc_options.transpose)):
            pc_options = dataclasses.replace(self.pc_options or PCOptions(),
                                             transpose=True)
            self.M = pc_mod.setup(self.A_host, self.pc_type, pc_options)
        return self

    def assemble(self, A, b=None, x0=None, reorder: str = "auto"):
        """Convert the matrix, build the PC (factorization cost lives here —
        reference lssp_solver_assemble → lssp_pc_assemble, lssp.cxx:142-189)."""
        from lssp_tpu.utils.log import Timer
        b = validate_system(A, b, self.method)
        reorder = resolve_reorder(self.pc_type, self.pc_options, reorder)
        # timing prints mirror the reference: assemble at verb>1
        # (lssp.cxx:162-184), pc assemble at verb>0 (pc.cxx:83-236)
        with Timer("solver: assemble (matrix conversion)", level=2):
            self.A_host, self.A_dev, self.perm = _prepare_matrix(
                A, reorder=reorder)
        if self.method.lower() in ("direct", "splu") and \
                self.pc_type in (None, "none"):
            self.pc_type = "lu"
        if self.pc_type not in (None, "none"):
            pc_options = self.pc_options
            if needs_transpose_pc(self.method):
                pc_options = dataclasses.replace(pc_options or PCOptions(),
                                                 transpose=True)
            with Timer(f"pc: assemble ({self.pc_type})", level=1):
                self.M = pc_mod.setup(self.A_host, self.pc_type, pc_options)
        if b is not None:
            self.b = jnp.asarray(b)
        if x0 is not None:
            self.x = jnp.asarray(x0)
        self.assembled = True
        return self

    def reset_rhs(self, b):
        """New rhs, keep factorization (reference lssp_solver_reset_rhs)."""
        self.b = jnp.asarray(b)
        return self

    def reset_unknown(self, x0):
        """New initial guess (reference lssp_solver_reset_unknown)."""
        self.x = jnp.asarray(x0)
        return self

    def solve(self, b=None, x0=None):
        assert self.assembled, "call assemble() first"
        if get_block_solver(self.method) is not None:
            raise ValueError(f"{self.method!r} is a multi-rhs block "
                             "method; use Solver.solve_multi")
        if b is not None:
            self.b = jnp.asarray(b)
        if x0 is not None:
            self.x = jnp.asarray(x0)
        opts = self.options.resolved()
        host_trace = (opts.verbosity >= 1
                      and not device_print_supported())
        user_history = opts.record_history
        if host_trace and not opts.record_history:
            opts = dataclasses.replace(opts, record_history=True)
        fn = get_solver(self.method)
        # a prior solve_multi leaves an (n, k) solution in self.x — never
        # a valid scalar warm start; only reuse a rank-1 previous x
        x0v = (self.x if self.x is not None
               and getattr(self.x, "ndim", 1) == 1
               else jnp.zeros_like(self.b))
        b, perm = self.b, getattr(self, "perm", None)
        if perm is not None:
            b = b[perm]
            x0v = x0v[perm]
        x, info = _dispatch_solve(fn, self.A_dev, b, x0v, self.M, opts)
        x = _unpermute(x, perm)
        if host_trace:
            history_print_host(info)
            if not user_history:
                info = dataclasses.replace(info, history=None)
        self.x, self.info = x, info
        return x

    def solve_multi(self, B, X0=None):
        """Solve A·X = B for k right-hand sides (B: (n, k)) with the
        ASSEMBLED matrix/preconditioner state — the lifecycle analog of
        the module-level ``solve_multi`` (where the reference re-solves
        per rhs via lssp_solver_reset_rhs, /root/reference/src/lssp.cxx:
        470-489).  Block methods (blockcg/blockgmres) share one Krylov
        search block; other methods run the vmapped per-rhs program.
        Stores per-rhs SolveInfo arrays in ``self.info``; returns X."""
        assert self.assembled, "call assemble() first"
        X, info = _run_multi(self.method, self.A_dev, self.M, B, X0,
                             getattr(self, "perm", None),
                             self.options.resolved())
        self.x, self.info = X, info
        return X

    # -- getters (lssp_solver_get_residual/_nits, lssp.cxx:520-528) --
    # scalar after solve(); per-rhs (k,) arrays after solve_multi()
    @property
    def residual(self):
        if self.info is None:
            return None
        r = np.asarray(self.info.residual)
        return float(r) if r.ndim == 0 else r

    @property
    def nits(self):
        if self.info is None:
            return None
        n = np.asarray(self.info.nits)
        return int(n) if n.ndim == 0 else n
