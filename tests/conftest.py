"""Test configuration: CPU with 8 virtual devices unless JAX_PLATFORMS says
otherwise (distributed tests run on a simulated mesh, SURVEY §4), and x64 so
convergence parity with the fp64 serial reference is exact.  The tests
marked ``gpu`` run on the card with ``JAX_PLATFORMS=cuda`` or from
chip_smoke.py."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# XLA:CPU concurrency-scheduler miscompile guard (also set by the package
# import, but conftest runs first — see lssp_tpu/__init__.py for the note)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_cpu_enable_concurrency_optimized_scheduler" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_enable_concurrency_optimized_scheduler=false").strip()

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# ---------------------------------------------------------------------------
# Two-tier suite (VERDICT r4 #7: the default run drifted to ~19 min).
# tests/slow_manifest.txt lists tests measured >= 2 s; the default tier
# skips them (fast feedback, ~5 min), `--runslow` executes everything
# (zero coverage loss across tiers; CI-full protocol in CLAUDE.md).
# ---------------------------------------------------------------------------

def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run the slow tier too (tests/slow_manifest.txt)")


def _slow_set():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "slow_manifest.txt")
    if not os.path.exists(path):
        return frozenset()
    with open(path) as f:
        return frozenset(line.strip() for line in f
                         if line.strip() and not line.startswith("#"))


def pytest_collection_modifyitems(config, items):
    slow = _slow_set()
    if not slow:
        return
    for item in items:
        if item.nodeid in slow:
            item.add_marker(pytest.mark.slow)
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier: run with --runslow")
    for item in items:
        if item.nodeid in slow:
            item.add_marker(skip)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules(request):
    """Full-tier (--runslow) runs push several thousand XLA:CPU
    compilations through one process; jax 0.9.0's CPU compiler was
    observed to segfault deterministically late in such runs (round 5:
    twice at the same test, which passes in isolation and in any
    file subset tried).  Dropping the compilation caches between test
    modules bounds the compiler-side state; the cost is re-compiling the
    few programs shared across files.  Default-tier runs are short
    enough that the flush is unnecessary — skipped to keep them fast."""
    yield
    if request.config.getoption("--runslow"):
        jax.clear_caches()
