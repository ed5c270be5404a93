"""The reference's example program, reproduced
(/root/reference/example/exam.cxx:61-127): 2-D 5-point Laplacian at N=100,
GMRES(60) + ILU(1), maxit 3000, b=1, x0=0, with the post-solve independent
true-residual verification (:115-116).

Run:  python examples/exam.py [N]
Expected (matching the serial C reference): ~49 iterations,
residual ≈ 8.2e-6.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from lssp_tpu import Solver
from lssp_tpu.sparse import laplacian_2d


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 100

    A = laplacian_2d(N)
    n = A.shape[0]
    print(f"CSR: laplacian, grid size {N}")
    print(f"CSR: rows: {n} nonzeros: {A.nnz} "
          f"mem (csr): {((A.nnz + n) * 4 + A.nnz * 8) / 2**20:.3f} Mb")

    b = jnp.ones(n, dtype=jnp.float64)

    s = Solver(method="gmres", pc="iluk")
    s.set_restart(60).set_maxit(3000)

    t0 = time.perf_counter()
    s.assemble(A, b)
    print(f"solver: assemble time: {time.perf_counter() - t0:.6g}")

    t0 = time.perf_counter()
    x = s.solve()
    print(f"gmres: total iteration: {s.nits}")
    print(f"total solver time: {time.perf_counter() - t0:.6g}")
    residual = s.residual

    print(f"solution L2 norm: {float(jnp.linalg.norm(x)):.8e} "
          f"residual: {residual:.8e}")

    # independent verification (exam.cxx:115-116)
    r = np.ones(n) - A.to_scipy() @ np.asarray(x, np.float64)
    print(f"verification, residual: {float(np.linalg.norm(r)):.8e}")


if __name__ == "__main__":
    main()
