"""A tour of capabilities beyond the reference's example (exam.py):
direct solve, multilevel preconditioners, transpose-based Krylov methods,
mixed-precision refinement, and checkpoint/resume.

Run: python examples/tour.py  (CPU or GPU)
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

import lssp_tpu as lt  # noqa: E402
from lssp_tpu.utils.checkpoint import checkpointed_solve  # noqa: E402


def residual(A, x, b):
    return float(np.linalg.norm(np.asarray(b) - A.to_scipy() @ np.asarray(x, np.float64)))


def main():
    A = lt.sparse.convection_diffusion_2d(48, beta=15.0)   # nonsymmetric
    S = lt.sparse.laplacian_2d(64)                          # SPD
    b = jnp.ones(A.shape[0], dtype=jnp.float64)
    bs = jnp.ones(S.shape[0], dtype=jnp.float64)

    print("== native sparse direct LU (UMFPACK/KLU role) ==")
    x, info = lt.solve(A, b, method="direct")
    print(f"  nits={int(info.nits)}  true-res={residual(A, x, b):.2e}")

    print("== multilevel PCs: ARMS vs AMG vs ILU(1) ==")
    for pc in ("arms", "amg", "rsamg", "iluk"):
        x, info = lt.solve(S, bs, method="cg", pc=pc)
        print(f"  cg+{pc:5s} nits={int(info.nits):3d}  res={residual(S, x, bs):.2e}")

    print("== transpose-based methods on the nonsymmetric system ==")
    for m in ("bicg", "qmr", "cgnr", "lsqr"):
        x, info = lt.solve(A, b, method=m, pc="ilut")
        print(f"  {m:5s} nits={int(info.nits):4d}  res={residual(A, x, b):.2e}")

    print("== mixed-precision iterative refinement (fp32 inner) ==")
    x, info = lt.solve_ir(S, bs, method="cg", pc="amg")
    print(f"  inner-nits={int(info.nits)}  res={residual(S, x, bs):.2e}")

    print("== sparse QR least squares (QR_MUMPS role) ==")
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    T0 = sp.random(240, 120, density=0.03, random_state=1, format="csr")
    T0 = (T0 + sp.vstack([sp.eye(120), sp.csr_matrix((120, 120))])).tocsr()
    T = lt.sparse.CSR.from_scipy(T0 @ sp.diags(np.logspace(0, -8, 120)))
    xt = rng.standard_normal(120)
    bt = T.to_scipy() @ xt
    xq, _ = lt.solve_lsq(T, bt)                      # QR (cond-robust)
    xn, _ = lt.solve_lsq(T, bt, method="normal")     # squared condition
    print(f"  cond~1e8: qr err {np.linalg.norm(np.asarray(xq)-xt)/np.linalg.norm(xt):.1e}"
          f"  normal-eq err {np.linalg.norm(np.asarray(xn)-xt)/np.linalg.norm(xt):.1e}")

    print("== hybrid band+remainder execution format ==")
    Sh = lt.sparse.laplacian_2d(48).to_scipy().tolil()
    for i, j in zip(rng.integers(0, 2304, 40), rng.integers(0, 2304, 40)):
        Sh[i, j] += 0.02
    Ah = lt.sparse.CSR.from_scipy(Sh.tocsr())
    from lssp_tpu.sparse.convert import to_device_format
    H = to_device_format(Ah, max_diags=32, dia_fill=2.0)
    xh, ih = lt.solve(Ah, jnp.ones(2304), method="gmres")
    print(f"  format={type(H).__name__} (band {len(H.dia.offsets)} diagonals"
          f" + {H.nnz_rem} remainder nnz)  gmres nits={int(ih.nits)}")

    print("== bfloat16 inner refinement ==")
    x, info = lt.solve_ir(S, bs, method="cg", pc="ilu0",
                          inner_dtype=jnp.bfloat16, inner_rtol=3e-2,
                          options=lt.SolverOptions(rtol=1e-8, atol=0.0,
                                                   rbtol=0.0), max_outer=60)
    print(f"  inner-nits={int(info.nits)}  res={residual(S, x, bs):.2e}"
          "  (half the HBM bytes per inner iteration)")

    print("== multiple right-hand sides (one vmapped program) ==")
    Bm = jnp.stack([bs, jnp.asarray(rng.standard_normal(S.shape[0]))], axis=1)
    Xm, im = lt.solve_multi(S, Bm, method="cg", pc="iluk")
    print(f"  k=2 rhs: nits={[int(v) for v in im.nits]}  "
          f"res={[f'{np.linalg.norm(np.asarray(Bm[:, j]) - S.to_scipy() @ np.asarray(Xm[:, j])):.1e}' for j in range(2)]}")

    print("== block Krylov: one SHARED search block for all rhs ==")
    Xb, ib = lt.solve_multi(S, Bm, method="blockcg", pc="iluk")
    print(f"  blockcg nits={[int(v) for v in ib.nits]} (vs vmapped "
          f"{[int(v) for v in im.nits]}) — information mixes across rhs; "
          "blockgmres is the nonsymmetric analog")

    print("== multi-rhs mixed precision (fp32 block inner, fp64 answers) ==")
    Xr, ir_ = lt.solve_ir_multi(S, Bm, method="blockcg", pc="iluk",
                                options=lt.SolverOptions(rtol=1e-10,
                                                         atol=0.0))
    print(f"  inner its={[int(v) for v in ir_.nits]}  "
          f"res={[f'{np.linalg.norm(np.asarray(Bm[:, j]) - S.to_scipy() @ np.asarray(Xr[:, j])):.1e}' for j in range(2)]}")

    print("== checkpoint / resume ==")
    # checkpointed_solve needs a path that may not exist yet, so a private
    # fresh directory (not racy mktemp) is the right shape
    path = os.path.join(tempfile.mkdtemp(prefix="lssp_tour_"), "run.ckpt")
    x, info = checkpointed_solve(S, bs, path, every=20, method="cg",
                                 pc="iluk", max_rounds=1)
    print(f"  interrupted at nits={int(info.nits)} (converged={bool(info.converged)})")
    x, info = checkpointed_solve(S, bs, path, every=20, method="cg", pc="iluk")
    print(f"  resumed: total nits={int(info.nits)}  res={residual(S, x, bs):.2e}")


if __name__ == "__main__":
    main()
