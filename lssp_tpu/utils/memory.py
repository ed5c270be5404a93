"""Memory observability (reference lssp_mem_cur/peak via getrusage RSS,
/root/reference/src/utils.cxx:68-91, API doc/utils.tex:48-52) plus device
device live-byte accounting."""
from __future__ import annotations

import resource


def host_memory_mb() -> tuple:
    """(current_rss_mb, peak_rss_mb) of this process."""
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cur_kb = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    cur_kb = int(line.split()[1])
                    break
    except OSError:
        cur_kb = peak_kb
    return cur_kb / 1024.0, peak_kb / 1024.0


def device_memory_mb() -> dict:
    """Per-device live HBM bytes (MB) as reported by the runtime."""
    import jax
    out = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
            out[str(d)] = {
                "in_use_mb": stats.get("bytes_in_use", 0) / 2**20,
                "peak_mb": stats.get("peak_bytes_in_use", 0) / 2**20,
                "limit_mb": stats.get("bytes_limit", 0) / 2**20,
            }
        except Exception:
            out[str(d)] = {}
    return out
