"""Runtime defaults and option dataclasses.

The reference keeps mutable global defaults (/root/reference/src/lssp.cxx:5-14
and /root/reference/src/pc.cxx:3-7) that solvers fall back to when a per-solver
value is unset/negative.  Here the same table lives in frozen dataclasses; an
unset field (``None`` or negative) resolves to the default at solve time, which
reproduces the reference's "negative means use global" convention
(/root/reference/src/solver-cg.cxx:36-38).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


class Defaults:
    """Global defaults, mirroring /root/reference/src/lssp.cxx:5-14."""

    RESTART = 50        # LSSP_RESTART
    AUG_K = 3           # LSSP_AUG_K     (LGMRES augmentation depth)
    BGSL = 4            # LSSP_BGSL      (BiCGSTAB(l) polynomial degree)
    IDRS = 4            # LSSP_IDRS      (IDR(s) shadow-space size)
    MAXIT = 1000        # LSSP_MAXIT
    ATOL = 1e-7         # LSSP_ATOL
    RTOL = 1e-7         # LSSP_RTOL
    RBTOL = 1e-7        # LSSP_RB  (residual / ||b|| tolerance)
    BREAKDOWN = 1e-40   # LSSP_BREAKDOWN

    # Preconditioner defaults, /root/reference/src/pc.cxx:3-7.
    ILUK_LEVEL = 1          # lssp_pc_iluk_level_default
    ILUT_TOL = 1e-3         # lssp_pc_ilut_tol
    ILUT_P = -1             # lssp_pc_ilut_p  (-1 => auto: avg nnz/row)
    ZERO_DIAG_VALUE = 1e-3  # mat_zero_diag_value
    ZERO_DIAG_TOL = 1e-10   # mat_zero_diag_tol


def _resolve(value, default):
    """Reference convention: unset/negative falls back to the global default."""
    if value is None:
        return default
    if isinstance(value, (int, float)) and value < 0:
        return default
    return value


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Per-solve options (parity with LSSP_SOLVER fields,
    /root/reference/include/type-defs.h:225-304 and setters
    /root/reference/include/lssp.h:65-89)."""

    rtol: Optional[float] = None       # relative tolerance (vs ||r0||)
    atol: Optional[float] = None       # absolute tolerance
    rbtol: Optional[float] = None      # tolerance relative to ||b||
    maxit: Optional[int] = None
    restart: Optional[int] = None      # GMRES/ORTHOMIN restart / truncation
    aug_k: Optional[int] = None        # LGMRES augmentation vectors
    bgsl: Optional[int] = None         # BiCGSTAB(l) degree
    idrs: Optional[int] = None         # IDR(s) shadow dimension
    breakdown: Optional[float] = None
    verbosity: int = 0                 # 0 silent; >=1 per-iteration prints
    record_history: bool = False       # keep per-iteration residual trace
    dtype: Any = None                  # None => inherit from inputs

    def resolved(self) -> "SolverOptions":
        d = Defaults
        return dataclasses.replace(
            self,
            rtol=_resolve(self.rtol, d.RTOL),
            atol=_resolve(self.atol, d.ATOL),
            rbtol=_resolve(self.rbtol, d.RBTOL),
            maxit=int(_resolve(self.maxit, d.MAXIT)),
            restart=int(_resolve(self.restart, d.RESTART)),
            aug_k=int(_resolve(self.aug_k, d.AUG_K)),
            bgsl=int(_resolve(self.bgsl, d.BGSL)),
            idrs=int(_resolve(self.idrs, d.IDRS)),
            breakdown=_resolve(self.breakdown, d.BREAKDOWN),
        )


@dataclasses.dataclass(frozen=True)
class PCOptions:
    """Preconditioner options (parity with LSSP_PC fields,
    /root/reference/include/type-defs.h:107-151)."""

    iluk_level: Optional[int] = None      # ILU(k) fill level
    ilut_tol: Optional[float] = None      # ILUT drop tolerance
    ilut_p: Optional[int] = None          # ILUT max fill per row (-1 = auto)
    ilutp_permtol: float = 0.1            # ILUTP pivot threshold (swap when
                                          # |diag| < permtol * max upper)
    num_blocks: Optional[int] = None      # block count for block-ILU
    block_size: Optional[int] = None      # uniform block size for BSR paths
    block_sizes: Any = None               # variable block sizes (vbiluk /
                                          # vbilut; reference s.blk_size[])
    ilu_sweeps: Optional[int] = None      # triangular-solve strategy:
                                          # None = auto (exact level
                                          # scheduling); 0 = force exact (level
                                          # scan); -1 = exact via COMPLETE
                                          # Neumann series (nilpotent strict
                                          # factors, one SpMV per sweep);
                                          # k>0 = k iterative SpMV sweeps
    omega: float = 1.0                    # damping (Jacobi/smoothers)
    poly_degree: int = 8                  # polynomial-PC Chebyshev degree
    poly_ratio: float = 30.0              # covered spectrum: [lmax/ratio,
                                          # 1.05*lmax] (SPD)
    lu_method: str = "auto"               # direct-LU engine: "auto" =
                                          # supernodal multifrontal (BLAS-3
                                          # fronts, pc/multifrontal.py) for
                                          # n >= 512 with the native
                                          # toolchain, scalar Gilbert-
                                          # Peierls otherwise; "mf"/
                                          # "supernodal" force the former,
                                          # "gp" the latter
    lu_order: str = "amd"                 # direct-LU fill-reducing ordering:
                                          # "amd" (minimum degree — measured
                                          # 3.5-7x lower fill than rcm on the
                                          # vendored matrices, beats scipy's
                                          # COLAMD on both) | "rcm" | None
    lu_pivot_tol: float = 0.1             # diagonal-preference threshold for
                                          # partial pivoting (1.0 = strict)
    transpose: bool = False               # also build the exact M⁻ᵀ apply
                                          # (needed by BiCG/QMR with exact
                                          # level-scheduled ILU; the Neumann
                                          # ILU path supports Mᵀ for free)
    # ARMS multilevel recursive Schur (reference ITSOL ARMS adapter,
    # pc-arms.cxx:83-153; ipar/droptol analogs)
    schwarz_overlap: int = 8              # RAS subdomain overlap (rows)
    arms_tol: float = 1e-3                # Schur drop tolerance
    arms_max_levels: int = 10
    arms_coarse_size: int = 200           # direct-LU below this size
    # AMG knobs (native classical AMG — new construction, no reference analog)
    amg_max_levels: int = 12
    amg_coarse_size: int = 64
    amg_theta: float = 0.25               # strength-of-connection threshold
    amg_presmooth: int = 2
    amg_postsmooth: int = 2
    amg_smooth_interp: bool = True        # Jacobi-smoothed+truncated P
    amg_trunc: float = 0.2                # interpolation truncation
    amg_smoother: str = "chebyshev"       # "jacobi" | "chebyshev" | "l1jacobi"
                                          # | "line" (saamg only: damped
                                          # line Jacobi, PCR tridiagonal
                                          # solves - the anisotropic fix)
    amg_cycles: int = 1                   # cycles per PC application
    amg_cycle_type: str = "V"             # "V" | "W" (gamma=2 recursion —
                                          # the FASP AMG_param cycle_type
                                          # capability; W visits coarse
                                          # levels twice per descent)
    amg_max_pdiags: int = 40              # offset cap for the gather-free
                                          # classical cycle's aggregated-
                                          # diagonal interpolation (amg/rs.py:
                                          # cap_offsets; entries at rarer
                                          # offsets drop with a row-sum-
                                          # preserving rescale)
    saamg_aggregate: int = 4              # structured-SA aggregate size
                                          # (contiguous ranges; see amg/sa.py)
    saamg_grid: Any = None                # grid-aware saamg aggregation:
                                          # None = auto-detect (gy, gx) from
                                          # the sparsity; (gy, gx) = explicit
                                          # row-major dims (pins the original
                                          # ordering); False = force flat
                                          # contiguous ranges.  Grid mode
                                          # chooses x/y semicoarsening or 2x2
                                          # box per level from the measured
                                          # coupling strengths (anisotropy-
                                          # robust direction-aware coarsening)
    # user-PC hooks (parity with LSSP_PC_USER, /root/reference/src/pc.cxx:219-227)
    user_setup: Optional[Callable] = None
    user_apply: Optional[Callable] = None

    def resolved(self) -> "PCOptions":
        d = Defaults
        return dataclasses.replace(
            self,
            iluk_level=int(_resolve(self.iluk_level, d.ILUK_LEVEL)),
            ilut_tol=_resolve(self.ilut_tol, d.ILUT_TOL),
            ilut_p=self.ilut_p if self.ilut_p is not None else d.ILUT_P,
        )


def smoother_degree(pre: int, post: int) -> int:
    """Map the reference's separate pre-/post-smoothing counts onto the
    symmetric-degree V-cycle kernels (which smooth the same number of times
    on both sides of coarse correction): preserve total smoothing work,
    degree = ceil((pre + post) / 2).  An explicit 0/0 disables smoothing."""
    pre, post = int(pre), int(post)
    if pre <= 0 and post <= 0:
        return 0
    return max(1, (pre + post + 1) // 2)
