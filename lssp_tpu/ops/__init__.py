"""Device math kernels: SpMV, fused BLAS-1, level-scheduled triangular solve.

These replace the reference's L2 layer (/root/reference/src/mvops.cxx,
src/vector.cxx, src/solver-tri.cxx) with data-parallel designs: SpMV dispatches
on execution format (DIA streaming / ELL gather / BSR batched-GEMM / CSR
segment-sum), BLAS-1 is plain jnp (XLA fuses it into the solver step), and
the inherently sequential triangular recurrence becomes a host-computed level
schedule executed as one `lax.scan` sweep per solve.
"""

from lssp_tpu.ops.spmv import (
    spmv, mv_amxpby, mv_amxpbyz, mv_amxy, mv_mxy, csr_row_ids,
)
from lssp_tpu.ops.blas1 import dot, norm2, axpy, axpby, axpbyz
from lssp_tpu.ops.trisolve import (
    TriSchedule, level_schedule, trisolve_lower_unit, trisolve_upper,
    ilu_apply, make_ilu_apply,
)

__all__ = [
    "spmv", "mv_amxpby", "mv_amxpbyz", "mv_amxy", "mv_mxy", "csr_row_ids",
    "dot", "norm2", "axpy", "axpby", "axpbyz",
    "TriSchedule", "level_schedule", "trisolve_lower_unit", "trisolve_upper",
    "ilu_apply", "make_ilu_apply",
]
