"""Distributed solve example: the same Krylov code over a device mesh.

Runs over every device JAX sees (e.g. the GPUs of one host):

    python examples/distributed.py

With ``--cpu`` it simulates 8 devices on the CPU instead:

    python examples/distributed.py --cpu

On multi-host, call lssp_tpu.parallel.multihost.initialize() first on
every host.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the platform must be chosen before the backend initializes — a
# config.update after first backend use is a no-op
if "--cpu" in sys.argv[1:]:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax
import lssp_tpu as lt   # before any backend init: injects the XLA:CPU
                        # scheduler guard flag (see lssp_tpu/__init__.py)

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh


def main():
    mesh = make_mesh()
    print(f"mesh: {mesh.devices.size} devices ({jax.default_backend()})")

    A = lt.sparse.laplacian_2d(64)
    n = A.shape[0]
    b = jnp.ones(n, dtype=jnp.float64)

    for method, pc in [("cg", "bjilu"), ("cg", "saamg"),
                       ("bicgstab", "bjilu")]:
        x, info = dist_solve(A, b, method=method, pc=pc, mesh=mesh,
                             options=lt.SolverOptions(maxit=500))
        res = float(np.linalg.norm(
            np.asarray(b, np.float64) - A.to_scipy() @ np.asarray(x, np.float64)))
        print(f"  {method}+{pc:6s}: nits={int(info.nits):4d} "
              f"true-res={res:.2e} converged={bool(info.converged)}")


if __name__ == "__main__":
    main()
