"""Benchmark: the BASELINE metric set on one GPU.

Prints exactly ONE JSON line, stamped with the device it ran on.  The
headline metric is the sustained DIA SpMV bandwidth (``vs_peak`` = fraction
of the card's published HBM bandwidth); ``extra`` carries the rest:

  spmv_nnz_per_s        — same kernel, useful-nonzeros throughput
  dist_spmv_gbps        — DistDIA under shard_map (shared XLA DIA op +
                          ppermute halo exchange) over every visible device
  hyb_spmv_gbps         — hybrid band+remainder SpMV on a nearly-banded
                          (unstructured-remainder) matrix
  tts1e8_cg_ilu0_s      — wall seconds to relative residual 1e-8, CG+ILU(0)
                          on the 3-D 7-pt Poisson 64^3 via mixed-precision
                          iterative refinement
  tts1e8_gmres_saamg_s  — same target, GMRES(30)+saamg on a 1M-row
                          anisotropic Poisson
  serving8_*            — 8 rhs in one block program vs 8 sequential solves

Kernel times are host-clock around a jitted scan of SpMVs that ends in
``block_until_ready`` (best of 5, divided by the scan length).  Solve
timings are second-call wall times (compile cached), which is what a
production re-solve costs.  A device without a peak entry is an error.
"""
import json
import time

import numpy as np

# published HBM bandwidth (GB/s) by JAX ``device_kind``: NVIDIA H100 SXM
# data sheet (80 GB HBM3 at 3.35 TB/s)
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

SPMV_SIDE = 4096        # 16.8M rows: 335 MB of fp32 diagonals, > 4x the L2
SCAN_ITERS = 200


def peak_hbm_gbps(kind: str) -> float:
    if kind not in PEAK_HBM_GBPS:
        raise KeyError(f"no published HBM peak for device kind {kind!r}; "
                       "add it to bench.PEAK_HBM_GBPS with its source")
    return PEAK_HBM_GBPS[kind]


def scan_seconds(op, M, x, iters=SCAN_ITERS, reps=5):
    """Seconds per application of ``op(M, v)``: a jitted scan of ``iters``
    applications, best of ``reps`` block_until_ready timings."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(M, v):
        def step(v, _):
            return op(M, v) * 0.25, None     # 0.25 keeps the feedback bounded
        v, _ = jax.lax.scan(step, v, None, length=iters)
        return jnp.sum(v)

    jax.block_until_ready(run(M, x))         # compile + warm-up
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(M, x))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def bench_spmv(D, x, n, ndiag):
    from lssp_tpu.ops.spmv import spmv
    dt = scan_seconds(spmv, D, x)
    bytes_per = (ndiag * n + n + n) * 4          # values + x + y, fp32
    return bytes_per / dt / 1e9, dt


def bench_dist_spmv(A, n, ndiag):
    """DistDIA under shard_map over every visible device: shared XLA DIA
    op per shard + ppermute halo exchange."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from lssp_tpu.parallel.dist_ops import make_dist_spmv
    from lssp_tpu.parallel.dist_solve import make_mesh, AXIS
    from lssp_tpu.parallel.partition import partition_csr_dia

    nd = len(jax.devices())
    mesh = make_mesh(nd)
    M = partition_csr_dia(A, nd)
    op = make_dist_spmv(M, AXIS)

    def body(d, v):
        return op(d[0], v[0])[None]

    mapped = jax.shard_map(body, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
                           out_specs=P(AXIS), check_vma=False)
    data = jnp.asarray(M.data)
    x = jnp.ones((nd, n // nd), dtype=jnp.float32)
    dt = scan_seconds(mapped, data, x)
    bytes_per = (ndiag * n + n + n) * 4
    return bytes_per / dt / 1e9


def bench_hyb_spmv(seed=5):
    """Nearly-banded matrix (stencil + random off-band sprinkle on 0.5% of
    the rows): the HYB split streams the band, gathers only the
    remainder."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from lssp_tpu.sparse import laplacian_2d, CSR
    from lssp_tpu.sparse.convert import csr_to_hyb
    from lssp_tpu.ops.spmv import spmv

    rng = np.random.default_rng(seed)
    S = laplacian_2d(SPMV_SIDE, dtype=np.float32).to_scipy().tocoo()
    n = S.shape[0]
    n_extra = n // 200
    r = rng.integers(0, n, n_extra)
    c = rng.integers(0, n, n_extra)
    E = sp.coo_matrix((np.full(n_extra, 0.01, np.float32), (r, c)),
                      shape=S.shape)
    H = jax.device_put(csr_to_hyb(CSR.from_scipy((S + E).tocsr())))
    dt = scan_seconds(spmv, H, jnp.ones(n, dtype=jnp.float32))
    ndiag = len(H.dia.offsets)
    nrem = int(H.rem_vals.shape[0])
    # traffic model: streamed diagonals + x + y + remainder triplets
    bytes_per = (ndiag * n + 2 * n + 3 * nrem) * 4
    return bytes_per / dt / 1e9


def bench_serving(A, k, pc="ilu0"):
    """Multi-rhs serving: wall seconds (warm) for k rhs solved to relative
    residual 1e-8 in ONE program — solve_ir_multi with the shared-block
    fp32 inner — vs the same k rhs solved sequentially with solve_ir.
    Returns (t_multi, t_seq, max rel res of the multi solve)."""
    import jax
    import jax.numpy as jnp
    from lssp_tpu import solve_ir, solve_ir_multi, SolverOptions

    n = A.shape[0]
    rng = np.random.default_rng(0)
    B = jnp.asarray(rng.standard_normal((n, k)))
    opts = SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    kw = dict(method="blockcg", pc=pc, options=opts)
    jax.block_until_ready(solve_ir_multi(A, B, **kw)[0])   # compile + warm
    t0 = time.perf_counter()
    X, info = solve_ir_multi(A, B, **kw)
    jax.block_until_ready(X)
    t_multi = time.perf_counter() - t0

    skw = dict(method="cg", pc=pc, options=opts)
    jax.block_until_ready(solve_ir(A, B[:, 0], **skw)[0])  # compile + warm
    t0 = time.perf_counter()
    for j in range(k):
        xj, _ = solve_ir(A, B[:, j], **skw)
        jax.block_until_ready(xj)
    t_seq = time.perf_counter() - t0

    S = A.to_scipy()
    res = np.linalg.norm(np.asarray(B) - S @ np.asarray(X, np.float64),
                         axis=0)
    rel = float((res / np.linalg.norm(np.asarray(B), axis=0)).max())
    return t_multi, t_seq, rel


def bench_tts(A, method, pc, restart, pc_options=None):
    """Wall seconds (second call — compile cached) to relative residual
    1e-8 via mixed-precision iterative refinement; verifies the residual
    independently on the host."""
    import jax
    import jax.numpy as jnp
    from lssp_tpu import solve_ir, SolverOptions

    n = A.shape[0]
    b = jnp.ones(n, dtype=jnp.float64)
    opts = SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000,
                         restart=restart)
    kw = dict(method=method, pc=pc, options=opts, pc_options=pc_options)
    jax.block_until_ready(solve_ir(A, b, **kw)[0])  # compile + warm caches
    t0 = time.perf_counter()
    x, info = solve_ir(A, b, **kw)
    jax.block_until_ready(x)
    dt = time.perf_counter() - t0
    res = float(np.linalg.norm(np.asarray(b, np.float64)
                               - A.to_scipy() @ np.asarray(x, np.float64)))
    rel = res / np.sqrt(float(n))                # ||b|| = sqrt(n)
    return dt, rel, int(info.nits)


def main():
    import jax
    # fp64 outer residuals for the 1e-8 refinement targets (the kernel
    # benches pin fp32 explicitly, so this only affects the tts solves)
    jax.config.update("jax_enable_x64", True)
    from lssp_tpu.utils.profile import enable_persistent_cache
    enable_persistent_cache()
    from lssp_tpu.utils.device import device_stamp
    import jax.numpy as jnp
    from lssp_tpu.sparse import (laplacian_2d, laplacian_3d,
                                 anisotropic_poisson_2d, csr_to_dia)

    stamp = device_stamp()
    peak = peak_hbm_gbps(stamp["kind"])

    A = laplacian_2d(SPMV_SIDE, dtype=np.float32)
    D = csr_to_dia(A)
    n = A.shape[0]
    ndiag = len(D.offsets)
    D = jax.device_put(D)
    x = jnp.ones(n, dtype=jnp.float32)

    gbps, dt = bench_spmv(D, x, n, ndiag)
    dist_gbps = bench_dist_spmv(A, n, ndiag)
    hyb_gbps = bench_hyb_spmv()

    tts_cg, rel_cg, nits_cg = bench_tts(laplacian_3d(64), "cg", "ilu0", 50)
    Aa = anisotropic_poisson_2d(1024, epsilon=0.01)
    tts_gm, rel_gm, nits_gm = bench_tts(Aa, "gmres", "saamg", 30)

    # multi-rhs serving: 8 rhs in ONE block program vs 8 sequential solves
    t_multi, t_seq, rel_sv = bench_serving(laplacian_3d(48), 8)

    print(json.dumps({
        "metric": "spmv_gbps",
        "value": gbps,
        "unit": "GB/s",
        "vs_peak": gbps / peak,
        "device": stamp,
        "extra": {
            "spmv_nnz_per_s": A.nnz / dt,
            "dist_spmv_gbps": dist_gbps,
            "hyb_spmv_gbps": hyb_gbps,
            "tts1e8_cg_ilu0_s": tts_cg,
            "tts1e8_cg_ilu0_relres": rel_cg,
            "tts1e8_cg_ilu0_nits": nits_cg,
            "tts1e8_gmres_saamg_s": tts_gm,
            "tts1e8_gmres_saamg_relres": rel_gm,
            "tts1e8_gmres_saamg_nits": nits_gm,
            "serving8_blockir_s": t_multi,
            "serving8_sequential_s": t_seq,
            "serving8_speedup": t_seq / max(t_multi, 1e-9),
            "serving8_relres": rel_sv,
        },
    }))


if __name__ == "__main__":
    main()
