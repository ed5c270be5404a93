"""Profiling hooks (the device analog of the reference's wall-clock timers,
SURVEY §5: jax.profiler traces + derived bandwidth counters)."""
from __future__ import annotations

import contextlib
import os
import time

# fixed in-checkout cache location (listed in .gitignore): the cache key
# includes the directory, so it must not move between processes
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (open in TensorBoard / xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (shows up on the xprof timeline)."""
    import jax
    with jax.profiler.TraceAnnotation(name):
        yield


def spmv_counters(A, seconds: float, iters: int = 1) -> dict:
    """Derived throughput counters for an SpMV-dominated phase — nnz/s and
    effective GB/s under the standard traffic model (values + indices read
    once, x read once, y written once).  These are the BASELINE.md metrics
    the reference could not measure."""
    nnz = int(A.nnz)
    n = int(A.shape[0])
    itemsize = getattr(A.dtype, "itemsize", 8)
    bytes_per = nnz * itemsize + nnz * 4 + 2 * n * itemsize
    t = seconds / max(1, iters)
    return {"nnz_per_s": nnz / t, "gbytes_per_s": bytes_per / t / 1e9,
            "seconds_per_iter": t}


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` at the
    root of the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE_DIR


def enable_persistent_cache():
    """Turn on XLA's persistent compilation cache so first-touch compiles
    amortize across processes — the shared protocol of bench.py,
    benchmarks/acceptance.py and chip_smoke.py.  When
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and no other
    directory is set here.  Returns the cache dir."""
    import jax
    cache_dir = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


# --- setup-phase itemization -------------------------------------------------
# The reference times assemble and PC-assemble separately
# (/root/reference/src/lssp.cxx:162-184, /root/reference/src/pc.cxx:83-236);
# prepare_ir/assemble fill this ledger so harnesses can itemize where setup
# wall-clock goes (reorder+convert vs device upload vs PC factor).

_phase_times: dict = {}
_phase_bytes: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Accumulate wall-clock for a named setup phase into the ledger."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _phase_times[name] = (_phase_times.get(name, 0.0)
                              + time.perf_counter() - t0)


def add_bytes(name: str, nbytes: int) -> None:
    """Attribute ``nbytes`` of host→device transfer to a phase, so the
    harnesses can report an upload phase's bytes beside its time."""
    _phase_bytes[name] = _phase_bytes.get(name, 0) + int(nbytes)


def tree_device_bytes(tree) -> int:
    """Total bytes of the array leaves of a pytree (device or host — the
    committed execution state that must cross the link once)."""
    import jax
    total = 0
    for leaf in jax.tree_util.tree_leaves(tree):
        nb = getattr(leaf, "nbytes", None)
        if nb is not None:
            total += int(nb)
    return total


def reset_phases() -> None:
    _phase_times.clear()
    _phase_bytes.clear()


def phase_times() -> dict:
    """Snapshot of the accumulated {phase: seconds} ledger."""
    return dict(_phase_times)


def phase_bytes() -> dict:
    """Snapshot of the accumulated {phase: bytes-uploaded} ledger."""
    return dict(_phase_bytes)
