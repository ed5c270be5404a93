"""AMG V-cycle as a preconditioner (replaces the reference's external
FASP/SXAMG/MI20 AMG PC wrappers, /root/reference/src/pc-amg.cxx,
pc-sxamg.cxx, pc-mi20.cxx — one V-cycle per application, maxit=1 per the
SXAMG wrapper's convention at pc-sxamg.cxx:23)."""
from __future__ import annotations

import numpy as np

from lssp_tpu.amg.setup import amg_setup
from lssp_tpu.amg.cycle import build_device_amg, vcycle
from lssp_tpu.config import smoother_degree
from lssp_tpu.pc.base import Preconditioner, register_pc


def _amg_apply(state, r):
    return vcycle(state, r)


@register_pc("amg")
def setup_amg(A, opts):
    hier = amg_setup(A, theta=opts.amg_theta, max_levels=opts.amg_max_levels,
                     coarse_size=opts.amg_coarse_size,
                     smooth_interp=opts.amg_smooth_interp,
                     trunc=opts.amg_trunc)
    h = build_device_amg(
        hier, dtype=np.asarray(A.data).dtype, smoother=opts.amg_smoother,
        degree=smoother_degree(opts.amg_presmooth, opts.amg_postsmooth),
        cycles=opts.amg_cycles,
        gamma=2 if str(opts.amg_cycle_type).upper() == "W" else 1)
    return Preconditioner(_amg_apply, state=h, name="amg")


@register_pc("saamg")
def setup_saamg(A, opts):
    """Structured smoothed-aggregation AMG — the gather-free multigrid
    (LIS saamg capability; see lssp_tpu/amg/sa.py)."""
    from lssp_tpu.amg.sa import setup_saamg_pc
    return setup_saamg_pc(A, opts)


@register_pc("rsamg")
def setup_rsamg(A, opts):
    """Gather-free classical (Ruge–Stüben-type) AMG: aligned axis-pair
    coarsening, classical direct interpolation, aggregated-diagonal
    transfers (see lssp_tpu/amg/rs.py).  pc='amg' builds the classical
    ELL hierarchy instead."""
    from lssp_tpu.amg.rs import setup_rs_pc
    return setup_rs_pc(A, opts)
