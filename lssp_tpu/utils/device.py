"""The device a measurement ran on.

Every benchmark line names its device (platform, ``device_kind``, device
count, and the card's name and power limit from ``nvidia-smi``), and a
measurement path that finds no GPU fails instead of timing the CPU.
"""
from __future__ import annotations

import subprocess


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    as it prints it, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_stamp() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    cards' name and power limit.  Raises RuntimeError unless JAX's first
    device is a GPU."""
    import jax
    devs = jax.devices()
    stamp = {"platform": devs[0].platform, "kind": devs[0].device_kind,
             "count": len(devs)}
    if stamp["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {stamp['platform']!r} "
            f"({stamp['kind']}); device measurements need the card")
    stamp["name_power_limit"] = nvidia_smi_name_power()
    return stamp
