#!/usr/bin/env python3
"""Smoke run of the solver on one NVIDIA GPU, at full problem size.

    python chip_smoke.py           # phases (a)-(e) on one card
    python chip_smoke.py --four    # only the 4-card distributed phase

Phases (one process, one card):
  (a) device  — JAX's first device must be a GPU; prints device kind and
                count, the cards' name and power limit from nvidia-smi, and
                requires the native host library to load.
  (b) spmv    — DIA on the fp32 5-point Laplacian 4096² (16.8M rows), HYB on
                the same grid with 0.5% random strays, ELL on a 1M-row
                random matrix: each against scipy's fp64 product on the host
                (max-norm relative error ≤ 1e-5), with its bandwidth from
                shape-computed bytes beside a device copy of equal bytes.
  (c) solves  — every acceptance config (benchmarks/acceptance.py, the
                16.8M-row CG+saamg included) through ``solve_ir`` to a
                relative residual of 1e-8 recomputed on the host in fp64;
                the reference's example (GMRES(60)+ILU(1) on 100², 49
                iterations) through ``Solver``; ``solve``,
                ``solve_ir_multi`` and ``dist_solve`` once each.
  (d) memory  — ``memory_analysis()`` of the largest solve's program and
                the device's ``peak_bytes_in_use``.
  (e) tests   — the tests marked ``gpu`` (tests/test_gpu.py), in-process.

``--four`` runs DistDIA CG+jacobi and CG+saamg on the 2-D Poisson 4096² and
``dist_solve_multi`` blockcg+bjilu on a 4-card mesh, each against the same
solve on one card (iterations within ±1, host residual ≤ 1e-8 relative;
plain CG's recurred residual drifts from the true one over thousands of
iterations, so a CG that stops short of the target on the host gets one
warm restart), and prints every card's ``bytes_in_use``.

Any failed phase exits non-zero.  The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SPMV_TOL = 1e-5          # fp32 kernel vs scipy fp64, max-norm relative
RTOL = 1e-8              # solves: host-recomputed relative residual


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


# ---- (a) device ------------------------------------------------------------

def phase_device():
    """Return the device stamp; raises unless JAX's first device is a GPU
    and the native host library loads."""
    from lssp_tpu import native
    from lssp_tpu.utils.device import device_stamp
    stamp = device_stamp()                   # raises off the GPU
    log(f"[a] platform={stamp['platform']} kind={stamp['kind']} "
        f"count={stamp['count']}")
    log(f"[a] nvidia-smi name, power.limit: {stamp['name_power_limit']}")
    avail = native.available()
    log(f"[a] lssp_tpu.native.available() = {avail}")
    check(avail, "native host library failed to build or load")
    return stamp


# ---- (b) spmv --------------------------------------------------------------

def _max_rel_err(y, ref):
    return float(np.max(np.abs(np.asarray(y, np.float64) - ref))
                 / np.max(np.abs(ref)))


def _copy_gbps(nbytes):
    """Rate of a device copy moving ``nbytes`` (half read, half written),
    timed like the SpMVs."""
    import jax.numpy as jnp
    from bench import scan_seconds
    v = jnp.ones(nbytes // 8, dtype=jnp.float32)
    dt = scan_seconds(lambda M, u: u, None, v)
    return nbytes / dt / 1e9


def _spmv_case(label, M, S, n, nbytes, seed):
    """Check one fp32 device format against scipy's fp64 product and time
    it beside a copy of equal bytes."""
    import jax
    import jax.numpy as jnp
    from bench import scan_seconds
    from lssp_tpu.ops.spmv import spmv
    x = np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)
    y = jax.jit(spmv)(M, jnp.asarray(x))
    err = _max_rel_err(y, S @ x.astype(np.float64))
    dt = scan_seconds(spmv, M, jnp.asarray(x))
    gbps = nbytes / dt / 1e9
    copy = _copy_gbps(nbytes)
    log(f"[b] {label}: n={n} max_rel_err={err:.3e} "
        f"spmv={dt * 1e6:.1f}us {gbps:.1f} GB/s  copy={copy:.1f} GB/s "
        f"ratio={gbps / copy:.3f}")
    check(err <= SPMV_TOL, f"{label}: error {err:.3e} > {SPMV_TOL}")
    return dict(n=n, err=err, seconds=dt, gbps=gbps, copy_gbps=copy)


def dia_fusion_count(D, x):
    """Number of fusions and custom calls in the ENTRY computation of the
    compiled DIA SpMV (1 = the product is one streaming kernel)."""
    import jax
    from lssp_tpu.ops.spmv import spmv
    text = jax.jit(spmv).lower(D, x).compile().as_text()
    entry = text[text.index("ENTRY"):]
    entry = entry[:entry.index("\n}")]
    return sum(1 for ln in entry.splitlines()
               if " fusion(" in ln or " custom-call(" in ln)


def phase_spmv(side=4096, ell_rows=1 << 20, seed=0):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from lssp_tpu.sparse import CSR, laplacian_2d, random_sparse
    from lssp_tpu.sparse.convert import csr_to_dia, csr_to_ell, csr_to_hyb

    out = {}
    A = laplacian_2d(side, dtype=np.float32)
    n = A.shape[0]
    S = A.to_scipy().astype(np.float64)
    D = jax.device_put(csr_to_dia(A))
    nd = len(D.offsets)
    out["dia"] = _spmv_case("DIA", D, S, n, (nd * n + 2 * n) * 4, seed)
    nf = dia_fusion_count(D, jnp.ones(n, jnp.float32))
    log(f"[b] DIA compiled program: {nf} fusion/custom-call kernel(s)")
    out["dia"]["kernels"] = nf

    rng = np.random.default_rng(seed + 1)
    k = n // 200                               # 0.5% of rows get a stray
    E = sp.coo_matrix((np.full(k, 0.01, np.float32),
                       (rng.integers(0, n, k), rng.integers(0, n, k))),
                      shape=(n, n))
    Ah = CSR.from_scipy((A.to_scipy() + E).tocsr())
    H = jax.device_put(csr_to_hyb(Ah))
    nrem = int(H.rem_vals.shape[0])
    nbytes = (len(H.dia.offsets) * n + 2 * n + 3 * nrem) * 4
    out["hyb"] = _spmv_case("HYB", H, Ah.to_scipy().astype(np.float64), n,
                            nbytes, seed + 2)

    R = random_sparse(ell_rows, 8, seed=seed + 3, dtype=np.float32)
    L = jax.device_put(csr_to_ell(R))
    out["ell"] = _spmv_case("ELL", L, R.to_scipy().astype(np.float64),
                            ell_rows, (2 * ell_rows * L.k + 2 * ell_rows) * 4,
                            seed + 4)
    return out


# ---- (c) solves ------------------------------------------------------------

def _host_rel_res(A, x, b):
    b = np.asarray(b, np.float64)
    r = b - A.to_scipy() @ np.asarray(x, np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def run_exam():
    """The reference's example (examples/exam.py): GMRES(60)+ILU(1) on the
    100² Laplacian through ``Solver``; 49 iterations."""
    import jax.numpy as jnp
    from lssp_tpu import Solver
    from lssp_tpu.sparse import laplacian_2d
    A = laplacian_2d(100)
    b = jnp.ones(A.shape[0], dtype=jnp.float64)
    s = Solver(method="gmres", pc="iluk")
    s.set_restart(60).set_maxit(3000)
    s.assemble(A, b)
    x = s.solve()
    res = float(np.linalg.norm(np.ones(A.shape[0])
                               - A.to_scipy() @ np.asarray(x, np.float64)))
    log(f"[c] exam gmres(60)+iluk(1) 100²: nits={s.nits} "
        f"host residual={res:.3e} solver residual={s.residual:.3e}")
    check(abs(s.nits - 49) <= 1, f"exam: {s.nits} iterations, expected 49")
    check(abs(res - s.residual) <= 1e-3 * res,
          "exam: host residual disagrees with the solver's")


def run_entry_points(scale=1):
    """``solve``, ``solve_ir_multi`` and ``dist_solve`` once each, on
    problems from the acceptance set."""
    import jax
    import jax.numpy as jnp
    import lssp_tpu as lt
    from lssp_tpu.parallel.dist_solve import dist_solve, make_mesh
    opts = lt.SolverOptions(rtol=RTOL, atol=0.0, rbtol=0.0, maxit=5000)

    A = lt.sparse.laplacian_3d(max(64 // scale, 4))
    b = jnp.ones(A.shape[0], dtype=jnp.float64)
    t0 = time.perf_counter()
    x, info = lt.solve(A, b, method="cg", pc="ilu0", options=opts)
    jax.block_until_ready(x)
    rel = _host_rel_res(A, x, b)
    log(f"[c] solve cg+ilu0 fp64 n={A.shape[0]}: nits={int(info.nits)} "
        f"rel={rel:.3e} first_call={time.perf_counter() - t0:.3f}s")
    check(rel <= 1.1 * RTOL, f"solve: relative residual {rel:.3e}")

    As = lt.sparse.laplacian_3d(max(48 // scale, 4))
    B = jnp.asarray(np.random.default_rng(0).standard_normal(
        (As.shape[0], 8)))
    t0 = time.perf_counter()
    X, info = lt.solve_ir_multi(As, B, method="blockcg", pc="ilu0",
                                options=opts)
    jax.block_until_ready(X)
    rels = [_host_rel_res(As, X[:, j], B[:, j]) for j in range(8)]
    log(f"[c] solve_ir_multi blockcg+ilu0 n={As.shape[0]} k=8: "
        f"nits={int(np.max(np.asarray(info.nits)))} max rel={max(rels):.3e} "
        f"first_call={time.perf_counter() - t0:.3f}s")
    check(max(rels) <= 1.1 * RTOL, f"solve_ir_multi: rel {max(rels):.3e}")

    Ad = lt.sparse.laplacian_2d(max(1024 // scale, 8))
    bd = jnp.ones(Ad.shape[0], dtype=jnp.float64)
    t0 = time.perf_counter()
    xd, info = dist_solve(Ad, bd, method="cg", pc="saamg",
                          mesh=make_mesh(1), options=opts)
    jax.block_until_ready(xd)
    rel = _host_rel_res(Ad, xd, bd)
    log(f"[c] dist_solve cg+saamg 1-card mesh n={Ad.shape[0]}: "
        f"nits={int(info.nits)} rel={rel:.3e} "
        f"first_call={time.perf_counter() - t0:.3f}s")
    check(rel <= 1.1 * RTOL, f"dist_solve: relative residual {rel:.3e}")


def phase_solves(scale=1):
    """Returns the largest config's matrix, for phase (d)."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from acceptance import acceptance_configs, run_config
    largest = None
    for cfg in acceptance_configs(xl=True, scale=scale):
        A = cfg["gen"]()
        if largest is None or A.shape[0] > largest[1].shape[0]:
            largest = (cfg, A)
        rec = run_config(cfg, A)
        log(f"[c] {rec['config']}: n={rec['n']} nits={rec['nits']} "
            f"rel={rec['rel_residual']:.3e} setup={rec['setup_s']:.3f}s "
            f"{rec['setup_split']} first_call={rec['first_call_s']:.3f}s "
            f"warm={rec['warm_s']:.4f}s")
        check(rec["ok"], f"{rec['config']} failed: {rec}")
    run_exam()
    run_entry_points(scale)
    return largest


# ---- (d) memory ------------------------------------------------------------

def phase_memory(largest):
    """Compiled memory of the largest solve (its setup and program are
    cached by phase (c)) and the device's peak bytes in use."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from lssp_tpu import SolverOptions, prepare_ir
    from lssp_tpu.solvers.refine import _fused_ir, _inner_plan

    cfg, A = largest
    opts = dataclasses.replace(cfg.get("opts") or SolverOptions(), rtol=RTOL,
                               atol=0.0, rbtol=0.0, maxit=5000).resolved()
    _, A64, A32, perm, M32 = prepare_ir(A, method=cfg["method"], pc=cfg["pc"],
                                        pc_options=cfg.get("pc_opts"))
    fn, inner_opts = _inner_plan(cfg["method"], opts, 1e-3)
    b = jnp.ones(A.shape[0], jnp.float64)
    compiled = _fused_ir.lower(fn, A64, A32, M32, b, jnp.zeros_like(b),
                               jnp.float64(RTOL), inner_opts, 20,
                               jnp.float32).compile()
    ma = compiled.memory_analysis()
    log(f"[d] largest solve {cfg['name']} (n={A.shape[0]}) memory_analysis: "
        f"argument={ma.argument_size_in_bytes} "
        f"output={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
        f"generated_code={ma.generated_code_size_in_bytes}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[d] peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
        f"bytes_limit={stats.get('bytes_limit')}")
    check((stats.get("peak_bytes_in_use") or 0) > 0, "no device memory stats")


# ---- (e) gpu-marked tests --------------------------------------------------

class _Tally:
    def __init__(self):
        self.passed, self.bad = 0, []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed or report.skipped:
            self.bad.append(f"{report.nodeid} {report.outcome}")


def phase_tests():
    import pytest
    tally = _Tally()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[tally])
    log(f"[e] gpu tests: rc={int(rc)} passed={tally.passed} "
        f"not passed={tally.bad}")
    check(rc == 0 and tally.passed > 0 and not tally.bad,
          "gpu-marked tests did not all pass")


# ---- --four ----------------------------------------------------------------

def phase_four(side=4096, ndev=4):
    """DistDIA CG+jacobi / CG+saamg and dist_solve_multi blockcg+bjilu on
    an ``ndev``-card mesh against the same solve on one card."""
    import jax
    import jax.numpy as jnp
    import lssp_tpu as lt
    from lssp_tpu.parallel.dist_solve import (dist_solve, dist_solve_multi,
                                              make_mesh)
    from lssp_tpu.parallel.partition import DistDIA, partition_matrix

    check(len(jax.devices()) >= ndev,
          f"--four needs {ndev} devices, JAX sees {len(jax.devices())}")
    mesh, one = make_mesh(ndev), make_mesh(1)
    opts = lt.SolverOptions(rtol=RTOL / 2, atol=0.0, rbtol=0.0,
                            maxit=40000)
    # warm restart: stop on the recurred residual once it is half the
    # target relative to ||b||, starting from the true residual of x0
    polish = lt.SolverOptions(rtol=0.0, atol=0.0, rbtol=RTOL / 2,
                              maxit=40000)
    A = lt.sparse.laplacian_2d(side)
    check(isinstance(partition_matrix(A, ndev), DistDIA),
          "Poisson did not partition as DistDIA")
    b = jnp.ones(A.shape[0], dtype=jnp.float64)
    keep = []

    def cg_to_target(pc, m):
        """(x, total iterations) of dist_solve CG to a host-checked relative
        residual of RTOL.  Plain fp64 CG stops on its recurred residual,
        which drifts from the true one over thousands of iterations (the
        Jacobi-CG on this grid stalls near 1.3e-8 true); one warm restart
        from the true residual finishes the job."""
        x, info = dist_solve(A, b, method="cg", pc=pc, mesh=m, options=opts)
        nits = int(info.nits)
        if _host_rel_res(A, x, b) > RTOL:
            x, info = dist_solve(A, b, x0=x, method="cg", pc=pc, mesh=m,
                                 options=polish)
            nits += int(info.nits)
        return x, nits

    def compare(label, run_many, run_one, rel_fn):
        t0 = time.perf_counter()
        xm, nm = run_many()
        jax.block_until_ready(xm)
        t_many = time.perf_counter() - t0
        t0 = time.perf_counter()
        x1, n1 = run_one()
        jax.block_until_ready(x1)
        t_one = time.perf_counter() - t0
        rm, r1 = rel_fn(xm), rel_fn(x1)
        log(f"[four] {label}: {ndev} cards nits={nm} rel={rm:.3e} "
            f"first_call={t_many:.3f}s | 1 card nits={n1} rel={r1:.3e} "
            f"first_call={t_one:.3f}s")
        check(abs(nm - n1) <= 1,
              f"{label}: iterations {nm} vs {n1} on one card")
        check(max(rm, r1) <= RTOL, f"{label}: residual {max(rm, r1):.3e}")
        keep.append(xm)

    for pc in ("jacobi", "saamg"):
        compare(f"DistDIA cg+{pc} n={A.shape[0]}",
                lambda: cg_to_target(pc, mesh), lambda: cg_to_target(pc, one),
                lambda x: _host_rel_res(A, x, b))

    # dist_solve_multi at the sizes of __graft_entry__._dryrun_multichip_x64
    # against solve_multi with the same block-diagonal ILU(k) (one block
    # per shard)
    Am = lt.sparse.laplacian_2d(128)
    bm = np.ones(Am.shape[0])
    B = jnp.asarray(np.stack([bm] + [np.linspace(0.5, j + 2.0, Am.shape[0])
                                     for j in range(2)], axis=1))
    mopts = lt.SolverOptions(rtol=RTOL / 2, atol=0.0, rbtol=0.0, maxit=400)
    def most_nits(out):
        return out[0], int(np.asarray(out[1].nits).max())

    compare("dist_solve_multi blockcg+bjilu n=16384 k=3",
            lambda: most_nits(dist_solve_multi(
                Am, B, method="blockcg", pc="bjilu", mesh=mesh,
                options=mopts)),
            lambda: most_nits(lt.solve_multi(
                Am, B, method="blockcg", pc="iluk", options=mopts,
                pc_options=lt.PCOptions(num_blocks=ndev))),
            lambda X: max(_host_rel_res(Am, X[:, j], B[:, j])
                          for j in range(B.shape[1])))

    used = [(d.memory_stats() or {}).get("bytes_in_use")
            for d in jax.devices()]
    log(f"[four] bytes_in_use per device: {used}")
    check(all(u and u > 0 for u in used[:ndev]),
          "a mesh device holds no data")
    return keep


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name} passed in {time.perf_counter() - t0:.1f}s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card distributed phase")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)
    from lssp_tpu.utils.profile import enable_persistent_cache
    log(f"compile cache: {enable_persistent_cache()}")

    t_all = time.perf_counter()
    stamp = phase_device()
    if args.four:
        timed("four", phase_four)
    else:
        timed("spmv", phase_spmv)
        largest = timed("solves", phase_solves)
        timed("memory", phase_memory, largest)
        timed("tests", phase_tests)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": stamp["platform"], "kind": stamp["kind"],
        "count": stamp["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
