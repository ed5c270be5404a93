"""Native classical AMG (replaces the reference's external FASP/SXAMG/MI20
AMG wrappers, SURVEY §2.5, with a from-scratch device implementation:
strength-of-connection -> PMIS coarsening -> direct interpolation -> Galerkin
RAP via SpGEMM -> Jacobi/Chebyshev smoothers -> device V-cycle)."""

from lssp_tpu.amg.setup import (
    amg_setup, AMGHierarchy, AMGLevel, strength_graph, pmis_coarsen,
    direct_interpolation,
)
from lssp_tpu.amg.cycle import build_device_amg, vcycle, amg_solve, DeviceAMG

__all__ = ["amg_setup", "AMGHierarchy", "AMGLevel", "strength_graph",
           "pmis_coarsen", "direct_interpolation", "build_device_amg",
           "vcycle", "amg_solve", "DeviceAMG"]
