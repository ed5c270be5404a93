"""lssp_tpu — a sparse linear-solver framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the serial C++
reference library huiscliu/lssp (solving sparse ``Ax = b``): CSR/BSR/ELL/DIA
sparse matrices resident in device memory, the full Krylov suite, ILU-family
and AMG preconditioners, and a row-partitioned multi-device distribution
layer built on ``jax.sharding.Mesh`` + ``shard_map`` collectives.

Public API (functional):

    >>> import lssp_tpu as lt
    >>> A = lt.sparse.laplacian_2d(128)           # CSR pytree
    >>> b = jnp.ones(A.shape[0])
    >>> x, info = lt.solve(A, b, method="gmres", pc="iluk")

Lifecycle API (parity with the reference's create/assemble/solve/destroy
protocol, /root/reference/include/lssp.h:44-53):

    >>> s = lt.Solver(method="gmres", pc="iluk")
    >>> s.assemble(A, b)
    >>> x = s.solve()
    >>> s.info.nits, s.info.residual
"""

import os as _os

# XLA:CPU MISCOMPILE GUARD — must run before the first jax computation
# initializes the backend.  XLA CPU's concurrency-optimized scheduler races
# two *independent* lax.scan level-sweeps inside one jit program over shared
# scratch buffers: any program applying an exact (level-scheduled) ILU/BILU
# twice to different vectors — every product-type Krylov solver — returned
# O(1)-wrong results (bicrsafe+biluk diverged to 1e61; jit-vs-eager diff
# 3.0 on `pc(v) + A@pc(2v)`; jax 0.9.0).  Chained applies, single applies,
# and fully-unrolled scans are unaffected, which is why only the
# multi-apply solvers saw it.  Disabling the scheduler restores correct
# results at a minor CPU-only scheduling cost; the GPU backend ignores the
# flag.  Regression: tests/test_ops.py::TestTriSweepCarryMiscompile.
_flag = "--xla_cpu_enable_concurrency_optimized_scheduler=false"
if _flag not in _os.environ.get("XLA_FLAGS", ""):
    _os.environ["XLA_FLAGS"] = (
        _os.environ.get("XLA_FLAGS", "") + " " + _flag).strip()
    try:     # too late if a jax computation already initialized a backend
        # _backends is private API (verified against jax 0.9.0); probe a
        # second attribute spelling so a rename degrades to a loud
        # AttributeError-free miss on at most one of them
        from jax._src import xla_bridge as _xb
        if (getattr(_xb, "_backends", None)
                or getattr(_xb, "backends_cache", None)):
            import warnings
            warnings.warn(
                "lssp_tpu: the jax backend was initialized before "
                "`import lssp_tpu`, so the XLA:CPU miscompile guard "
                f"({_flag}) could not take effect — exact level-scheduled "
                "ILU/BILU preconditioners in product-type solvers may "
                "return wrong results on CPU.  Import lssp_tpu before "
                "running any jax computation, or set the flag in "
                "XLA_FLAGS yourself.", RuntimeWarning)
    except ImportError:
        pass

from lssp_tpu import sparse
from lssp_tpu import ops
from lssp_tpu import solvers
from lssp_tpu import pc
from lssp_tpu import amg
from lssp_tpu import parallel
from lssp_tpu.config import SolverOptions, PCOptions, Defaults
from lssp_tpu.solvers.facade import solve, solve_multi, Solver, SolveInfo
from lssp_tpu.solvers.refine import solve_ir, solve_ir_multi, prepare_ir
from lssp_tpu.solvers.direct import solve_lsq
from lssp_tpu.sparse import CSR, COO, BSR, ELL, DIA

__version__ = "0.1.0"

__all__ = [
    "sparse", "ops", "solvers", "pc", "amg", "parallel",
    "SolverOptions", "PCOptions", "Defaults",
    "solve", "solve_multi", "solve_ir", "solve_ir_multi", "prepare_ir",
    "solve_lsq", "Solver", "SolveInfo",
    "CSR", "COO", "BSR", "ELL", "DIA",
]
