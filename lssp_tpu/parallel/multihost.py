"""Multi-host runtime helpers.

The reference's wrappers use strictly serial builds (`MPI_COMM_SELF`,
/root/reference/src/solver-petsc.cxx:71); the multi-host story here is the
JAX distributed runtime: each host runs the same program, GSPMD places the
collectives within and across hosts — no hand-written networking
(SURVEY §2.7).  These helpers make the common paths one-liners.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the JAX distributed runtime (idempotent).

    Pass ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly where no cluster environment provides them.
    Must be called before any device access on every host.
    """
    if jax.process_count() > 1:
        return                          # already initialized
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                    num_processes=num_processes,
                                    process_id=process_id)
    except (RuntimeError, ValueError):
        # single-process environments (tests, one host): nothing to do
        pass


def global_mesh(axis: str = "shard"):
    """1-D mesh over ALL devices of ALL hosts, for dist_solve."""
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis,))


def is_coordinator() -> bool:
    return jax.process_index() == 0


def host_local_slice(n: int):
    """The [lo, hi) row range this host owns under an even row partition of
    a global n-row system (global indices kept int64-safe — SURVEY §5's
    int32-overflow note)."""
    p = jax.process_index()
    np_ = jax.process_count()
    per = -(-n // np_)
    lo = min(int(p) * per, n)
    return lo, min(lo + per, n)
