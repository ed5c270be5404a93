"""Acceptance-config benchmark harness (BASELINE.md).

Runs the acceptance configurations to a **relative residual of 1e-8**
through the mixed-precision entry points (``prepare_ir`` then
``solve_ir``) at full problem size, and reports per config: iteration
count, the relative residual recomputed on the host with scipy in fp64,
setup seconds (with the per-phase split), first-call seconds (compile +
solve) and warm seconds.  Times are host-clock around work that ends in
``block_until_ready``.

Config ``gmres30_ilut_convdiff_mtx`` uses the *vendored* general-pattern
matrix ``benchmarks/matrices/convdiff_rot_128.mtx.gz`` through the
MatrixMarket reader (``lssp_tpu.sparse.io``) — a recirculating-wind
variable-coefficient convection–diffusion discretization this library does
not generate itself.  A second vendored matrix, ``coupled3d_25.mtx.gz``
(RCM-resistant couplings), pins the HYB band+remainder execution path.

Usage:
    python benchmarks/acceptance.py [--xl] [--json] [--out results.json]

Measurement protocol follows the reference example
(/root/reference/example/exam.cxx:109-116): wall-clock around the solve,
then an independent ||b - Ax|| recompute.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MATDIR = os.path.join(ROOT, "benchmarks", "matrices")

MAXIT = 5000        # iteration budget; the nits gate defaults to it
RTOL = 1e-8


def acceptance_configs(xl=False, scale=1):
    """The acceptance configurations.  ``scale`` divides every generated
    grid side (scale=1 is the full size; larger values give the small
    shapes of a CPU rehearsal).  ``xl`` adds the 16.8M-row CG+saamg
    anisotropic Poisson."""
    from lssp_tpu import SolverOptions, PCOptions
    from lssp_tpu.sparse import (
        laplacian_2d, laplacian_3d, elasticity_2d, anisotropic_poisson_2d)
    from lssp_tpu.sparse.io import read_matrix_market

    def side(n):
        return max(n // scale, 4)

    def vendored(name):
        return read_matrix_market(os.path.join(MATDIR, name))

    restart30 = SolverOptions(restart=30)
    configs = [
        dict(name="cg_poisson2d_128", method="cg", pc="none",
             gen=lambda: laplacian_2d(side(128))),
        dict(name="cg_ilu0_poisson3d_64", method="cg", pc="ilu0",
             gen=lambda: laplacian_3d(side(64))),
        dict(name="gmres30_ilut_convdiff_mtx", method="gmres", pc="ilut",
             opts=restart30, gen=lambda: vendored("convdiff_rot_128.mtx.gz")),
        dict(name="bicgstab_iluk_coupled3d_mtx", method="bicgstab",
             pc="iluk", gen=lambda: vendored("coupled3d_25.mtx.gz")),
        dict(name="bicgstabl_biluk_elasticity", method="bicgstabl",
             pc="biluk", pc_opts=PCOptions(block_size=2),
             gen=lambda: elasticity_2d(side(48))),
        dict(name="gmres_amg_aniso_1m", method="gmres", pc="amg",
             opts=restart30,
             gen=lambda: anisotropic_poisson_2d(side(1024))),
    ]
    if xl:
        # max_nits pins the grid-robust convergence of the
        # direction-aware semicoarsening (18-19 its from 512² to 2048²)
        configs.append(dict(
            name="cg_saamg_aniso_16m", method="cg", pc="saamg",
            max_nits=250,
            gen=lambda: anisotropic_poisson_2d(side(4096))))
    return configs


def run_config(cfg, A=None):
    """Setup, first call and warm call of one config (on ``A`` when given,
    else on ``cfg["gen"]()``); returns its record.  The residual is
    recomputed on the host with scipy in fp64."""
    import jax
    import jax.numpy as jnp
    from lssp_tpu import SolverOptions, prepare_ir, solve_ir
    from lssp_tpu.utils import profile as prof

    if A is None:
        A = cfg["gen"]()
    n = A.shape[0]
    b = jnp.ones(n, dtype=jnp.float64)
    opts = dataclasses.replace(cfg.get("opts") or SolverOptions(),
                               rtol=RTOL, atol=0.0, rbtol=0.0, maxit=MAXIT)
    kw = dict(method=cfg["method"], pc=cfg["pc"],
              pc_options=cfg.get("pc_opts"))

    # setup alone: reorder + convert + device upload + PC factor
    # (reference protocol separates PC assemble, pc.cxx:83-236)
    prof.reset_phases()
    t0 = time.perf_counter()
    jax.block_until_ready(prepare_ir(A, **kw)[1:])
    t_setup = time.perf_counter() - t0
    split = {k: round(v, 3) for k, v in prof.phase_times().items()}

    def solve_once():
        t0 = time.perf_counter()
        x, info = solve_ir(A, b, options=opts, **kw)
        jax.block_until_ready(x)
        return x, info, time.perf_counter() - t0

    _, _, t_first = solve_once()                # compile + solve
    x, info, t_warm = solve_once()              # everything cached

    r = np.ones(n) - A.to_scipy() @ np.asarray(x, np.float64)
    rel = float(np.linalg.norm(r)) / np.sqrt(float(n))   # ||b|| = sqrt(n)
    nits = int(info.nits)
    rec = dict(config=cfg["name"], n=n, nnz=A.nnz, method=cfg["method"],
               pc=cfg["pc"], nits=nits, rel_residual=rel,
               converged=bool(info.converged), setup_s=t_setup,
               setup_split=split, first_call_s=t_first, warm_s=t_warm)
    rec["ok"] = (rec["converged"] and rel <= 1.1 * RTOL
                 and nits <= cfg.get("max_nits", MAXIT))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--xl", action="store_true",
                    help="add the 16.8M-row anisotropic Poisson, CG+saamg")
    ap.add_argument("--json", action="store_true", help="JSON-lines output")
    ap.add_argument("--out", default=None,
                    help="also write JSON-lines records to this file")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from lssp_tpu.utils.profile import enable_persistent_cache
    enable_persistent_cache()
    from lssp_tpu.utils.device import device_stamp
    stamp = device_stamp()
    print(json.dumps(stamp))

    out_f = open(args.out, "w") if args.out else None
    results = []
    try:
        for cfg in acceptance_configs(xl=args.xl):
            rec = dict(run_config(cfg), **stamp)
            results.append(rec)
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
            if args.json:
                print(json.dumps(rec))
            else:
                print(f"{rec['config']:30s} n={rec['n']:9d} "
                      f"nits={rec['nits']:5d} rel={rec['rel_residual']:9.2e} "
                      f"setup={rec['setup_s']:8.3f}s "
                      f"first={rec['first_call_s']:8.3f}s "
                      f"warm={rec['warm_s']:8.4f}s")
    finally:
        if out_f:
            out_f.close()
    ok = all(r["ok"] for r in results)
    print("ALL CONVERGED to rel 1e-8" if ok else "SOME CONFIGS FAILED",
          file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
