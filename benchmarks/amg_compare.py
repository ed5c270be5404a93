"""Classical (Ruge–Stüben) AMG vs smoothed aggregation: iteration-count
comparison across matrix classes (VERDICT r3 #9).

Three AMG realizations ship: classical ELL (``pc="amg"``), gather-free
classical (``rsamg``) and structured smoothed aggregation (``saamg``).
Choosing among them per matrix class needs their CONVERGENCE side by side;
this harness measures exactly that — preconditioned Krylov iteration
counts with each hierarchy on the matrix classes the library ships, on CPU
where every cycle is exact.

Iteration counts are timing-free (contention-safe) and deterministic.  Reference capability anchor: FASP/SXAMG/MI20
AMG PC wrappers, /root/reference/src/pc-amg.cxx:21-134.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from lssp_tpu import solve, SolverOptions
    from lssp_tpu.sparse import (laplacian_2d, laplacian_3d,
                                 anisotropic_poisson_2d,
                                 convection_diffusion_2d)
    from lssp_tpu.sparse.io import read_matrix_market

    matdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "matrices")

    cases = [
        ("poisson2d_256", "cg", lambda: laplacian_2d(256)),
        ("poisson3d_32", "cg", lambda: laplacian_3d(32)),
        ("aniso_eps0.01_256", "cg",
         lambda: anisotropic_poisson_2d(256, epsilon=0.01)),
        ("convdiff_2d_128", "gmres",
         lambda: convection_diffusion_2d(128)),
        ("convdiff_rot_mtx", "gmres", lambda: read_matrix_market(
            os.path.join(matdir, "convdiff_rot_128.mtx.gz"))),
        ("coupled3d_mtx", "gmres", lambda: read_matrix_market(
            os.path.join(matdir, "coupled3d_25.mtx.gz"))),
    ]

    opts = SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=600,
                         restart=30)
    rows = []
    for name, method, gen in cases:
        A = gen()
        b = jnp.ones(A.shape[0], dtype=jnp.float64)
        rec = {"case": name, "n": A.shape[0], "method": method}
        for pc, po in (("amg", None), ("rsamg", None), ("saamg", None)):
            try:
                x, info = solve(A, b, method=method, pc=pc, options=opts,
                                pc_options=po)
                res = float(np.linalg.norm(
                    np.asarray(b) - A.to_scipy() @ np.asarray(x)))
                rec[f"{pc}_nits"] = int(info.nits)
                rec[f"{pc}_conv"] = bool(
                    bool(info.converged)
                    and res <= 1e-7 * np.sqrt(A.shape[0]))
            except Exception as e:                  # noqa: BLE001
                rec[f"{pc}_nits"] = None
                rec[f"{pc}_err"] = type(e).__name__
        a, s = rec.get("amg_nits"), rec.get("saamg_nits")
        if a and s:
            rec["saamg_over_amg"] = round(s / a, 2)
        rows.append(rec)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
