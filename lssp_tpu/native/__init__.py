"""Native C++ host kernels (setup-phase hot loops), loaded via ctypes.

The shared library is built on demand with g++ (-O3, no host-specific
``-march``) into ``lssp_tpu/native/_build/``, under a file name keyed on a
hash of the sources, the compiler flags and the host architecture — a
library built from other sources or with other flags is never loaded.  If no
compiler is available the
Python implementations in lssp_tpu/pc/ilu_host.py and ops/trisolve.py are
used instead (identical outputs, slower).  Set ``LSSP_TPU_NO_NATIVE=1`` to
force the Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "src", "ilu.cpp"),
         os.path.join(_HERE, "src", "splu.cpp"),
         os.path.join(_HERE, "src", "spqr.cpp"),
         os.path.join(_HERE, "src", "aggregate.cpp"),
         os.path.join(_HERE, "src", "amd.cpp"),
         os.path.join(_HERE, "src", "amgfilter.cpp"),
         os.path.join(_HERE, "src", "rap.cpp"),
         os.path.join(_HERE, "src", "mf.cpp")]
_BUILD_DIR = os.path.join(_HERE, "_build")
# -ffp-contract=off: no FMA contraction, so outputs are bit-identical to
# the pure-Python oracle implementations (these kernels are gather-bound;
# the cost is negligible)
_FLAGS = ("-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def build_key(srcs=_SRCS, flags=_FLAGS) -> str:
    """Hash of the host architecture, the compiler flags and the source
    bytes — the identity of one built library."""
    h = hashlib.sha256(platform.machine().encode())
    for f in flags:
        h.update(f.encode() + b"\0")
    for path in srcs:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(_BUILD_DIR, f"liblssp_native-{build_key()}.so")


def _build(out: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a private name and rename: concurrent test workers may
    # build the same key at once, and a reader must never see half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_FLAGS, *_SRCS, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def load():
    """Return the ctypes library or None (fallback to Python)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LSSP_TPU_NO_NATIVE"):
            return None
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            # built against another C++ runtime: rebuild here, once
            if not _build(path):
                return None
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                return None
        lib.lssp_levels.argtypes = [_i64p, _i64p, ctypes.c_int64,
                                    ctypes.c_int, _i64p]
        lib.lssp_ilu0.argtypes = [_i64p, _i64p, _f64p, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double]
        lib.lssp_iluk_symbolic.argtypes = [_i64p, _i64p, ctypes.c_int64,
                                           ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_int64)]
        lib.lssp_iluk_symbolic.restype = ctypes.c_void_p
        lib.lssp_ilut.argtypes = [_i64p, _i64p, _f64p, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.lssp_ilut.restype = ctypes.c_void_p
        lib.lssp_pattern_fetch.argtypes = [ctypes.c_void_p, _i64p, _i64p,
                                           ctypes.c_void_p]
        lib.lssp_pattern_free.argtypes = [ctypes.c_void_p]
        lib.lssp_splu.argtypes = [_i64p, _i64p, _f64p, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double,
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.lssp_splu.restype = ctypes.c_void_p
        lib.lssp_splu_sizes.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int64),
                                        ctypes.POINTER(ctypes.c_int64)]
        lib.lssp_splu_fetch.argtypes = [ctypes.c_void_p, _i64p, _i64p, _f64p,
                                        _i64p, _i64p, _f64p, _i64p]
        lib.lssp_splu_free.argtypes = [ctypes.c_void_p]
        lib.lssp_spqr.argtypes = [_i64p, _i64p, _f64p, ctypes.c_int64,
                                  ctypes.c_int64, _f64p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.lssp_spqr.restype = ctypes.c_void_p
        lib.lssp_spqr_fetch.argtypes = [ctypes.c_void_p, _i64p, _i64p, _f64p,
                                        _f64p]
        lib.lssp_spqr_free.argtypes = [ctypes.c_void_p]
        lib.lssp_amd_order.argtypes = [_i64p, _i64p, ctypes.c_int64, _i64p]
        _i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        _f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        for suf, ptr in (("_i32", _i32p), ("_i64", _i64p)):
            fl = getattr(lib, "lssp_filter_lumped" + suf)
            fl.argtypes = [ptr, ptr, _f64p, ctypes.c_int64, ctypes.c_double,
                           ptr, ptr, _f64p]
            fl.restype = ctypes.c_int64
            lp = getattr(lib, "lssp_lump_pattern" + suf)
            lp.argtypes = [ptr, ptr, _f64p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int64, ptr, ptr, _f64p]
            lp.restype = ctypes.c_int64
            do = getattr(lib, "lssp_dia_offsets" + suf)
            do.argtypes = [ptr, ptr, ctypes.c_int64, ctypes.c_int64, _i64p]
            do.restype = ctypes.c_int64
            d32 = getattr(lib, "lssp_dia_fill_f32" + suf)
            d32.argtypes = [ptr, ptr, _f64p, ctypes.c_int64, _i64p,
                            ctypes.c_int64, _f32p]
            d64 = getattr(lib, "lssp_dia_fill_f64" + suf)
            d64.argtypes = [ptr, ptr, _f64p, ctypes.c_int64, _i64p,
                            ctypes.c_int64, _f64p]
        for suf, ptr in (("_i32", _i32p), ("_i64", _i64p)):
            gs = getattr(lib, "lssp_gersh" + suf)
            gs.argtypes = [ptr, _f64p, _f64p, ctypes.c_long]
            gs.restype = ctypes.c_double
            rp = getattr(lib, "lssp_rap" + suf)
            rp.argtypes = [ptr, ptr, _f64p, ctypes.c_long,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ptr, ctypes.c_long, ptr, ptr, _f64p,
                           ctypes.c_long]
            rp.restype = ctypes.c_long
        lib.lssp_mf_symbolic.argtypes = [_i64p, _i64p, ctypes.c_long,
                                         _i64p, _i64p, _i64p, _i64p, _i64p,
                                         ctypes.c_long]
        lib.lssp_mf_symbolic.restype = ctypes.c_long
        lib.lssp_mf_numeric.argtypes = [
            _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, ctypes.c_long,
            _i64p, _i64p, _i64p, _i64p, ctypes.c_long,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            _i64p, _i64p, _f64p, ctypes.c_long,
            _i64p, _i64p, _f64p, ctypes.c_long, _i64p]
        lib.lssp_mf_numeric.restype = ctypes.c_long
        lib.lssp_greedy_aggregate.argtypes = [
            _i64p, _i64p, _f64p, _i64p, _i64p, _f64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), _i64p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


# --- typed wrappers --------------------------------------------------------

def levels(indptr: np.ndarray, indices: np.ndarray, n: int,
           lower: bool) -> np.ndarray:
    lib = load()
    out = np.zeros(n, dtype=np.int64)
    lib.lssp_levels(np.ascontiguousarray(indptr, np.int64),
                    np.ascontiguousarray(indices, np.int64),
                    n, 1 if lower else 0, out)
    return out


def amd_order(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Minimum-degree ordering on the A+Aᵀ pattern (exact external degrees,
    element absorption) — identical output to the Python oracle
    sparse/reorder.py: amd_permutation."""
    lib = load()
    perm = np.empty(n, dtype=np.int64)
    lib.lssp_amd_order(np.ascontiguousarray(indptr, np.int64),
                       np.ascontiguousarray(indices, np.int64), n, perm)
    return perm


def ilu0(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
         ztol: float, zval: float) -> np.ndarray:
    lib = load()
    data = np.ascontiguousarray(data, np.float64).copy()
    lib.lssp_ilu0(np.ascontiguousarray(indptr, np.int64),
                  np.ascontiguousarray(indices, np.int64),
                  data, len(indptr) - 1, ztol, zval)
    return data


def iluk_symbolic(indptr: np.ndarray, indices: np.ndarray, n: int,
                  level: int):
    lib = load()
    nnz = ctypes.c_int64(0)
    h = lib.lssp_iluk_symbolic(np.ascontiguousarray(indptr, np.int64),
                               np.ascontiguousarray(indices, np.int64),
                               n, level, ctypes.byref(nnz))
    new_ip = np.zeros(n + 1, dtype=np.int64)
    new_idx = np.zeros(nnz.value, dtype=np.int64)
    lib.lssp_pattern_fetch(h, new_ip, new_idx, None)
    lib.lssp_pattern_free(h)
    return new_ip, new_idx


def splu(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, n: int,
         pivot_tol: float, ztol: float, zval: float):
    """Left-looking sparse LU with threshold partial pivoting.  Input is CSC
    (Ap, Ai, Ax); returns (Lp, Li, Lx, Up, Ui, Ux, pinv, nclamped) — L
    unit-diagonal (diag not stored), U with diagonal, both CSC in pivot-row
    numbering; pinv maps original row -> pivot position."""
    lib = load()
    info = ctypes.c_int64(0)
    h = lib.lssp_splu(np.ascontiguousarray(indptr, np.int64),
                      np.ascontiguousarray(indices, np.int64),
                      np.ascontiguousarray(data, np.float64),
                      n, pivot_tol, ztol, zval, ctypes.byref(info))
    lnnz, unnz = ctypes.c_int64(0), ctypes.c_int64(0)
    lib.lssp_splu_sizes(h, ctypes.byref(lnnz), ctypes.byref(unnz))
    Lp = np.zeros(n + 1, dtype=np.int64)
    Li = np.zeros(lnnz.value, dtype=np.int64)
    Lx = np.zeros(lnnz.value, dtype=np.float64)
    Up = np.zeros(n + 1, dtype=np.int64)
    Ui = np.zeros(unnz.value, dtype=np.int64)
    Ux = np.zeros(unnz.value, dtype=np.float64)
    pinv = np.zeros(n, dtype=np.int64)
    lib.lssp_splu_fetch(h, Lp, Li, Lx, Up, Ui, Ux, pinv)
    lib.lssp_splu_free(h)
    return Lp, Li, Lx, Up, Ui, Ux, pinv, int(info.value)


def spqr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
         m: int, n: int, b=None):
    """George–Heath sparse QR merge loop (rows pre-ordered, columns
    pre-permuted by the caller).  Returns (Rp, Rj, Rx, crhs, res2) — R in
    CSR-by-pivot-row form with the diagonal first in each row."""
    lib = load()
    res2 = ctypes.c_double(0.0)
    rnnz = ctypes.c_int64(0)
    has_b = 0 if b is None else 1
    bv = (np.zeros(1, np.float64) if b is None
          else np.ascontiguousarray(b, np.float64))
    h = lib.lssp_spqr(np.ascontiguousarray(indptr, np.int64),
                      np.ascontiguousarray(indices, np.int64),
                      np.ascontiguousarray(data, np.float64),
                      m, n, bv, has_b, ctypes.byref(res2),
                      ctypes.byref(rnnz))
    Rp = np.zeros(n + 1, dtype=np.int64)
    Rj = np.zeros(rnnz.value, dtype=np.int64)
    Rx = np.zeros(rnnz.value, dtype=np.float64)
    crhs = np.zeros(n, dtype=np.float64)
    lib.lssp_spqr_fetch(h, Rp, Rj, Rx, crhs)
    lib.lssp_spqr_free(h)
    return Rp, Rj, Rx, crhs, float(res2.value)


def greedy_aggregate(A, T, g: int, theta: float,
                     virt: np.ndarray) -> np.ndarray:
    """Raw greedy strength-BFS aggregate ids over the symmetrised strength
    graph of CSR ``A`` (``T`` = A transposed, also CSR) — identical output
    to the Python oracle in amg/aggregate.py (which does the exactness
    fix-up for both paths)."""
    lib = load()
    n = A.shape[0]
    ids = np.empty(n, dtype=np.int64)
    lib.lssp_greedy_aggregate(
        np.ascontiguousarray(A.indptr, np.int64),
        np.ascontiguousarray(A.indices, np.int64),
        np.ascontiguousarray(A.data, np.float64),
        np.ascontiguousarray(T.indptr, np.int64),
        np.ascontiguousarray(T.indices, np.int64),
        np.ascontiguousarray(T.data, np.float64),
        n, g, theta, np.ascontiguousarray(virt, np.uint8), ids)
    return ids


def _isuf(indptr):
    return "_i32" if indptr.dtype == np.int32 else "_i64"


def filter_lumped(indptr, indices, data, n: int, tol: float):
    """Fused drop+lump filter (oracle: amg/sa.py _filter_lumped).  Returns
    (indptr, indices, data) of the filtered CSR, or None when some lumped
    row has no kept structural diagonal (caller takes the Python
    allocating fallback) — identical outputs either way."""
    lib = load()
    if indptr.dtype != indices.dtype:
        indices = indices.astype(indptr.dtype, copy=False)
    nnz = len(indices)
    oip = np.empty(n + 1, dtype=indptr.dtype)
    oix = np.empty(nnz, dtype=indptr.dtype)
    oax = np.empty(nnz, dtype=np.float64)
    fn = getattr(lib, "lssp_filter_lumped" + _isuf(indptr))
    out = fn(indptr, indices, np.ascontiguousarray(data, np.float64),
             n, tol, oip, oix, oax)
    if out < 0:
        return None
    return oip, oix[:out], oax[:out]


def lump_pattern(indptr, indices, data, n: int, gx: int, ry: int, rx: int):
    """Fused grid-stencil lumping (oracle: amg/sa.py _lump_to_pattern).
    Same return contract as filter_lumped."""
    lib = load()
    if indptr.dtype != indices.dtype:
        indices = indices.astype(indptr.dtype, copy=False)
    nnz = len(indices)
    oip = np.empty(n + 1, dtype=indptr.dtype)
    oix = np.empty(nnz, dtype=indptr.dtype)
    oax = np.empty(nnz, dtype=np.float64)
    fn = getattr(lib, "lssp_lump_pattern" + _isuf(indptr))
    out = fn(indptr, indices, np.ascontiguousarray(data, np.float64),
             n, gx, ry, rx, oip, oix, oax)
    if out < 0:
        return None
    return oip, oix[:out], oax[:out]


def _blas_ptr(modname, fname):
    """Raw function pointer from a scipy cython_blas/lapack capsule."""
    import importlib
    mod = importlib.import_module("scipy.linalg." + modname)
    cap = None
    for k, v in mod.__pyx_capi__.items():
        if k == fname:
            cap = v
            break
    ctypes.pythonapi.PyCapsule_GetName.restype = ctypes.c_char_p
    ctypes.pythonapi.PyCapsule_GetName.argtypes = [ctypes.py_object]
    nm = ctypes.pythonapi.PyCapsule_GetName(cap)
    ctypes.pythonapi.PyCapsule_GetPointer.restype = ctypes.c_void_p
    ctypes.pythonapi.PyCapsule_GetPointer.argtypes = [ctypes.py_object,
                                                      ctypes.c_char_p]
    return ctypes.pythonapi.PyCapsule_GetPointer(cap, nm)


def mf_symbolic(Mp, Mi, n: int):
    """Native multifrontal symbolic (oracle: pc/multifrontal.py
    mf_symbolic).  Returns (post, sn_start, sn_parent, rs_ptr, rs_idx) or
    None."""
    lib = load()
    if lib is None:
        return None
    Mp = np.ascontiguousarray(Mp, np.int64)
    Mi = np.ascontiguousarray(Mi, np.int64)
    post = np.empty(n, dtype=np.int64)
    sn_start = np.empty(n + 1, dtype=np.int64)
    sn_parent = np.empty(n, dtype=np.int64)
    rs_ptr = np.empty(n + 1, dtype=np.int64)
    cap = int(4 * len(Mi) + 16 * n + 64)
    for _ in range(6):
        rs_idx = np.empty(cap, dtype=np.int64)
        nsn = lib.lssp_mf_symbolic(Mp, Mi, n, post, sn_start, sn_parent,
                                   rs_ptr, rs_idx, cap)
        if nsn >= 0:
            return (post, sn_start[:nsn + 1], sn_parent[:nsn],
                    rs_ptr[:nsn + 1], rs_idx[:rs_ptr[nsn]].copy())
        cap *= 2
    return None


def mf_numeric(B, C, sn_start, sn_parent, rs_ptr, rs_idx,
               ztol: float, zval: float):
    """Native multifrontal numeric (oracle: pc/multifrontal.py
    mf_factor_arrays).  B/C: CSR/CSC scipy of the permuted matrix.
    Returns (Lr, Lc, Lv, Ur, Uc, Uv, rowof, nclamped) or None."""
    lib = load()
    if lib is None:
        return None
    n = B.shape[0]
    nsn = len(sn_start) - 1
    w = np.diff(sn_start)
    nR = np.diff(rs_ptr)
    capL = int((w * (w - 1) // 2 + (nR - w) * w).sum())
    capU = int((w * (w + 1) // 2 + (nR - w) * w).sum())
    Lr = np.empty(capL, np.int64); Lc = np.empty(capL, np.int64)
    Lv = np.empty(capL, np.float64)
    Ur = np.empty(capU, np.int64); Uc = np.empty(capU, np.int64)
    Uv = np.empty(capU, np.float64)
    rowof = np.empty(n, np.int64)
    out = lib.lssp_mf_numeric(
        np.ascontiguousarray(B.indptr, np.int64),
        np.ascontiguousarray(B.indices, np.int64),
        np.ascontiguousarray(B.data, np.float64),
        np.ascontiguousarray(C.indptr, np.int64),
        np.ascontiguousarray(C.indices, np.int64),
        np.ascontiguousarray(C.data, np.float64),
        n, np.ascontiguousarray(sn_start, np.int64),
        np.ascontiguousarray(sn_parent, np.int64),
        np.ascontiguousarray(rs_ptr, np.int64),
        np.ascontiguousarray(rs_idx, np.int64), nsn,
        ztol, zval,
        _blas_ptr("cython_blas", "dgemm"),
        _blas_ptr("cython_blas", "dtrsm"),
        _blas_ptr("cython_lapack", "dgetrf"),
        Lr, Lc, Lv, capL, Ur, Uc, Uv, capU, rowof)
    if out < 0:
        return None
    return Lr, Lc, Lv, Ur, Uc, Uv, rowof, int(out)


def gersh(indptr, data, dinv, n: int):
    """Gershgorin bound max_i dinv_i Σ_j |a_ij| (oracle:
    amg/setup.py lambda_gershgorin).  Returns None when unavailable."""
    lib = load()
    if lib is None or data.dtype != np.float64:
        return None
    fn = getattr(lib, "lssp_gersh" + _isuf(indptr))
    return float(fn(indptr, np.ascontiguousarray(data, np.float64),
                    np.ascontiguousarray(dinv, np.float64), n))


def rap(A, B, p0_cols, nc: int):
    """Fused Galerkin product Ac = (B·P0)ᵀ · A · (B·P0) with P0 the
    aggregation map ``p0_cols`` (per-row coarse column); ``B`` may be None
    (tentative P0).  Oracle: the scipy triple product in amg/sa.py
    sa_host_levels.  Returns a scipy CSR or None when native is
    unavailable."""
    import scipy.sparse as sp
    lib = load()
    if lib is None:
        return None
    A = A.tocsr()
    if A.data.dtype != np.float64:
        return None
    n = A.shape[0]
    ip = A.indptr
    ix = A.indices.astype(ip.dtype, copy=False)
    p0 = np.ascontiguousarray(p0_cols, dtype=ip.dtype)
    fn = getattr(lib, "lssp_rap" + _isuf(ip))
    if B is not None:
        B = B.tocsr()
        bp = np.ascontiguousarray(B.indptr, dtype=ip.dtype)
        bj = np.ascontiguousarray(B.indices, dtype=ip.dtype)
        bx = np.ascontiguousarray(B.data, dtype=np.float64)
        bargs = (bp.ctypes.data, bj.ctypes.data, bx.ctypes.data)
        keep = (bp, bj, bx)          # keep alive across the call
    else:
        bargs = (None, None, None)
        keep = ()
    # modest first cap (coarse nnz is typically ~0.45x fine for these
    # hierarchies); the kernel reports a refined estimate on overflow.
    # Copy the used slices out so the cap-sized buffers don't stay alive
    # as the bases of per-level views (measured: holding them degraded
    # the later levels' kernels by 2-3x via memory pressure).
    cap = int(A.nnz * 0.6 + 16 * max(nc, 1))
    for _ in range(4):
        oip = np.empty(nc + 1, dtype=ip.dtype)
        oix = np.empty(cap, dtype=ip.dtype)
        oax = np.empty(cap, dtype=np.float64)
        out = fn(ip, ix, np.ascontiguousarray(A.data, np.float64), n,
                 *bargs, p0, nc, oip, oix, oax, cap)
        if out >= 0:
            del keep
            return sp.csr_matrix((oax[:out].copy(), oix[:out].copy(),
                                  oip), shape=(nc, nc))
        cap = int(-out)
    return None


def dia_convert(indptr, indices, data, n: int, max_diags: int, out_dtype):
    """Fused CSR→DIA (oracle: sparse/convert.py csr_to_dia).  Returns
    (offsets int64 (ndiag,), data (ndiag, n) of out_dtype), or None when
    the matrix has more than max_diags distinct diagonals."""
    lib = load()
    if indptr.dtype != indices.dtype:
        indices = indices.astype(indptr.dtype, copy=False)
    offs = np.empty(max_diags, dtype=np.int64)
    suf = _isuf(indptr)
    ndiag = getattr(lib, "lssp_dia_offsets" + suf)(indptr, indices, n,
                                                   max_diags, offs)
    if ndiag < 0:
        return None
    offs = offs[:ndiag].copy()
    out = np.empty((ndiag, n), dtype=out_dtype)
    ax = np.ascontiguousarray(data, np.float64)
    if out_dtype == np.float32:
        getattr(lib, "lssp_dia_fill_f32" + suf)(indptr, indices, ax, n,
                                                offs, ndiag, out)
    else:
        getattr(lib, "lssp_dia_fill_f64" + suf)(indptr, indices, ax, n,
                                                offs, ndiag, out)
    return offs, out


def ilut(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, n: int,
         tol: float, p: int, ztol: float, zval: float):
    lib = load()
    nnz = ctypes.c_int64(0)
    h = lib.lssp_ilut(np.ascontiguousarray(indptr, np.int64),
                      np.ascontiguousarray(indices, np.int64),
                      np.ascontiguousarray(data, np.float64),
                      n, tol, p, ztol, zval, ctypes.byref(nnz))
    new_ip = np.zeros(n + 1, dtype=np.int64)
    new_idx = np.zeros(nnz.value, dtype=np.int64)
    new_dat = np.zeros(nnz.value, dtype=np.float64)
    lib.lssp_pattern_fetch(h, new_ip, new_idx,
                           new_dat.ctypes.data_as(ctypes.c_void_p))
    lib.lssp_pattern_free(h)
    return new_ip, new_idx, new_dat
