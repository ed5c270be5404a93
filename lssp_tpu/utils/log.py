"""Logging + wall-clock timers (reference /root/reference/src/utils.cxx:
lssp_printf tee at :93-112, global verbosity :20, timer :40-46)."""
from __future__ import annotations

import sys
import time
from typing import Optional, TextIO

_verbosity = 2              # reference default lssp_verbosity = 2
_log_file: Optional[TextIO] = None


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = int(v)


def get_verbosity() -> int:
    return _verbosity


def set_log(f: Optional[TextIO]) -> None:
    """Tee output to a file as well (reference lssp_set_log)."""
    global _log_file
    _log_file = f


def log(msg: str, level: int = 1) -> None:
    if _verbosity >= level:
        sys.stdout.write(msg if msg.endswith("\n") else msg + "\n")
        if _log_file is not None:
            _log_file.write(msg if msg.endswith("\n") else msg + "\n")


def warning(msg: str) -> None:
    """Non-fatal warning tee'd like log() (reference lssp_warning,
    /root/reference/src/utils.cxx:137-157 — prints, does not exit)."""
    line = f"warning: {msg}"
    if _verbosity >= 1:
        sys.stderr.write(line + "\n")
        if _log_file is not None:
            _log_file.write(line + "\n")


class Timer:
    """Context-manager wall timer (reference lssp_get_time wrapping,
    e.g. solver-cg.cxx:42,129-133)."""

    def __init__(self, name: str = "", level: int = 2):
        self.name = name
        self.level = level
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        if self.name:
            log(f"{self.name}: {self.elapsed:.6f} s", self.level)
        return False


_device_print_ok: Optional[bool] = None


def device_print_supported() -> bool:
    """Whether the default JAX backend can run device-side host callbacks
    (``jax.debug.print``).  Some PJRT plugins cannot (UNIMPLEMENTED: host
    send/recv callbacks); per-iteration solver prints
    then fall back to a host-side trace printed after the solve (see
    lssp_tpu.solvers.base.history_print_host).  Probed once per process."""
    global _device_print_ok
    if _device_print_ok is not None:
        return _device_print_ok
    import jax
    import jax.numpy as jnp

    try:
        @jax.jit
        def _probe(x):
            jax.debug.callback(lambda v: None, x)
            return x + 1.0

        # ensure_compile_time_eval: the first call often happens while
        # TRACING a solver (history_update) — without it the probe's own
        # callback would be staged into the caller's program, baking in the
        # very op being probed for.  Fetching the scalar forces
        # completion.
        with jax.ensure_compile_time_eval():
            float(_probe(jnp.zeros((), jnp.float32)))
        _device_print_ok = True
    except Exception:
        _device_print_ok = False
    return _device_print_ok
