"""Benchmark: SPIKE banded factor and solve at the BASELINE.json flagship on a
CUDA card.

Flagship: N=1e6, kl=ku=100 (bandwidth 201), K=64 partitions of 128-blocks,
f32 factors with bf16 stored V/W spikes.  The baseline is LAPACK banded
factor/solve on this host's CPU in the same precision (sgbtrf/sgbtrs, the
PETSc-CPU ``-pc_type lu`` path of the reference's canned recipe,
/root/reference/src/makefile:17-18).

Prints progress on stderr and ONE JSON line on stdout:
  {"metric": ..., "value": <solve ms>, "unit": "ms",
   "vs_baseline": <cpu_solve_ms / solve_ms>, "device": {...}, ...stages}

Every time is the median of ``SPIKE_BENCH_REPS`` (default 5, at least 3)
warm calls, each ended by ``block_until_ready``; ``*_spread_ms`` gives
[min, max] of the same calls.  Compiles are reported separately.  The run
fails (non-zero exit) when the default backend is not a GPU or any stage
fails: a GMRES run must converge with a true relative residual (f32) of at
most 1e-5, the native-f64 refinement must reach 1e-10.

Env: SPIKE_BENCH_N, SPIKE_BENCH_HALFBW, SPIKE_BENCH_PARTS,
SPIKE_BENCH_DTYPE (f32|bf16 factor storage), SPIKE_BENCH_INVERTER,
SPIKE_BENCH_STAGES (comma list of the extra stages to run; default all),
SPIKE_BENCH_SKIP_CPU=1 (no CPU baseline).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

OUT: dict = {}
REPS = max(3, int(os.environ.get("SPIKE_BENCH_REPS", 5)))


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def timed(name: str, fn, *args, reps: int = REPS, per: float = 1.0):
    """Record ``name``_ms (median) and ``name``_spread_ms ([min, max]) of
    ``reps`` warm calls; the first call compiles (``name``_compile_s).
    ``per`` divides every time (e.g. per right-hand side).  Returns the
    last result."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    OUT[f"{name}_compile_s"] = round(time.perf_counter() - t0, 2)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3 / per)
    ts.sort()
    OUT[f"{name}_ms"] = ts[len(ts) // 2]
    OUT[f"{name}_spread_ms"] = [ts[0], ts[-1]]
    return out


def require(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit) unless ``ok``."""
    if not ok:
        raise SystemExit(f"bench: check failed: {what}")


def card() -> dict:
    import jax
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]}


def main() -> None:
    n = int(os.environ.get("SPIKE_BENCH_N", 1_000_000))
    k = int(os.environ.get("SPIKE_BENCH_HALFBW", 100))
    K = int(os.environ.get("SPIKE_BENCH_PARTS", 64))
    store = os.environ.get("SPIKE_BENCH_DTYPE", "f32")
    inverter = os.environ.get("SPIKE_BENCH_INVERTER", "auto")
    r_serve = 32
    only = os.environ.get("SPIKE_BENCH_STAGES")
    stages = set(s.strip() for s in only.split(",")) if only else None
    w = 2 * k + 1

    import jax
    import jax.numpy as jnp
    from functools import partial

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: needs a CUDA GPU, default backend is "
                         f"{jax.default_backend()!r}")
    from spike_petsc_tpu.utils.platform import enable_compile_cache
    enable_compile_cache()
    from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
    from spike_petsc_tpu.ops.spike import (spike_factor, spike_solve,
                                           spike_solve_many)

    OUT.update({"metric": f"spike_banded_solve_n{n}_bw{w}_wallclock",
                "value": None, "unit": "ms", "vs_baseline": None,
                "device": card(), "partitions": K,
                "factor_store_dtype": store, "inverter": inverter})
    log(f"device {OUT['device']}")
    store_dtype = jnp.bfloat16 if store == "bf16" else None
    dtype = jnp.float32

    # diagonally dominant random band, built on the card from a seed
    key = jax.random.PRNGKey(0)
    data = jax.random.uniform(key, (n, w), dtype, minval=-1.0, maxval=1.0)
    data = data.at[:, k].set(jnp.sum(jnp.abs(data), axis=1) + 1.0)
    band = BandedMatrix(data=data, kl=k, ku=k)
    rhs = jax.block_until_ready(banded_matvec(band, jnp.ones((n,), dtype)))

    @partial(jax.jit, static_argnames=("kp",))
    def factor_fn(d, kp):
        return spike_factor(BandedMatrix(data=d, kl=k, ku=k), K=kp,
                            block_b=128, store_spikes=True,
                            store_dtype=store_dtype,
                            spike_dtype=jnp.bfloat16, inverter=inverter)

    sf = timed("factor", factor_fn, data, K)
    solve_fn = {impl: jax.jit(partial(spike_solve, impl=impl))
                for impl in ("auto", "xla")}
    x = timed("solve", solve_fn["auto"], sf, rhs)
    timed("solve_xla_scan", solve_fn["xla"], sf, rhs)
    OUT["value"] = OUT["solve_ms"]
    OUT["rel_residual_f32"] = float(
        jnp.linalg.norm(banded_matvec(band, x) - rhs)
        / jnp.linalg.norm(rhs))
    require(np.isfinite(OUT["rel_residual_f32"]), "finite direct solve")
    # bytes the solve must stream: the factors once (one sweep pair with
    # stored spikes) plus the V/W spikes
    fact_bytes = sum(l.size * l.dtype.itemsize
                     for l in jax.tree_util.tree_leaves(sf.fact))
    vw_bytes = sum(l.size * l.dtype.itemsize
                   for l in jax.tree_util.tree_leaves((sf.V, sf.W)))
    OUT["solve_stream_gb"] = (fact_bytes + vw_bytes) / 1e9
    OUT["solve_stream_gbs"] = OUT["solve_stream_gb"] / OUT["solve_ms"] * 1e3
    log(f"factor {OUT['factor_ms']:.3f} ms, solve {OUT['solve_ms']:.4f} ms")

    if os.environ.get("SPIKE_BENCH_SKIP_CPU") != "1":
        cpu_baseline(n, k, w)

    def want(name: str) -> bool:
        return stages is None or name in stages

    def stage_gmres():
        from spike_petsc_tpu.solvers.krylov import gmres

        # the PC's sweeps as chosen ('auto': the kernels on a GPU) and as
        # the XLA scan, so the kernels' end-to-end gain is measured
        for impl, suffix in (("auto", ""), ("xla", "_xla_scan")):
            @jax.jit
            def run(d, s, b, impl=impl):
                bm = BandedMatrix(data=d, kl=k, ku=k)
                res = gmres(lambda v: banded_matvec(bm, v), b, None,
                            lambda v: spike_solve(s, v, impl=impl),
                            rtol=1e-8, maxit=30, restart=30)
                return res.x, res.its, res.reason
            xg, its, reason = timed(f"gmres_wall{suffix}", run, data, sf,
                                    rhs)
            OUT[f"gmres{suffix}_its"] = int(its)
            OUT[f"gmres{suffix}_reason"] = int(reason)
            # the true residual ||b - A x|| / ||b||, evaluated in f32 (its
            # own rounding sits near 1e-7): the recurrence residual GMRES
            # reports can converge while x does not
            rr = float(jnp.linalg.norm(banded_matvec(band, xg) - rhs)
                       / jnp.linalg.norm(rhs))
            OUT[f"gmres{suffix}_true_relres"] = rr
            require(int(reason) > 0,
                    f"gmres{suffix} converged (reason {int(reason)})")
            require(rr <= 1e-5, f"gmres{suffix} true relative residual "
                                f"{rr:.3e} <= 1e-5")

    def stage_serve():
        B = jax.random.normal(jax.random.PRNGKey(1), (n, r_serve), dtype)
        for impl in ("auto", "xla"):
            timed(f"serve_{impl}_per_rhs_r{r_serve}",
                  jax.jit(partial(spike_solve_many, impl=impl)), sf, B,
                  per=r_serve)

    def stage_band_mv():
        from spike_petsc_tpu.solvers.operator import as_matvec_split
        xv = jax.random.normal(jax.random.PRNGKey(2), (n,), dtype)
        for impl in ("xla", "blocktri"):
            mv, operand, _, _ = as_matvec_split(band, impl=impl)
            timed(f"band_mv_{impl}", jax.jit(mv), operand, xv)
        OUT["band_mv_bytes_gb"] = n * w * 4 / 1e9

    def stage_f64_refine():
        # native f64 operator residuals around the f32 factorization:
        # richardson refinement to an f64-grade relative residual
        from spike_petsc_tpu.solvers.krylov import richardson
        jax.config.update("jax_enable_x64", True)
        try:
            d64 = data.astype(jnp.float64)
            b64 = banded_matvec(BandedMatrix(data=d64, kl=k, ku=k),
                                jnp.ones((n,), jnp.float64))

            @jax.jit
            def run(d, s, b):
                bm = BandedMatrix(data=d, kl=k, ku=k)
                res = richardson(
                    lambda v: banded_matvec(bm, v), b, None,
                    lambda r: spike_solve(s, r.astype(jnp.float32)).astype(
                        b.dtype), rtol=1e-12, maxit=20)
                return res.its, res.rnorm / jnp.linalg.norm(b)
            its, rr = timed("f64_refine_wall", run, d64, sf, b64)
            OUT["f64_refine_its"] = int(its)
            OUT["f64_refine_relres"] = float(rr)
            require(float(rr) <= 1e-10, f"f64 refinement relative residual "
                                        f"{float(rr):.3e} <= 1e-10")
        finally:
            jax.config.update("jax_enable_x64", False)

    def stage_transpose():
        from spike_petsc_tpu.ops.band import banded_transpose
        from spike_petsc_tpu.ops.spike import spike_transpose
        tr = jax.jit(lambda s, d: spike_transpose(
            s, band=BandedMatrix(data=d, kl=k, ku=k)))
        sft = timed("transpose_setup", tr, sf, data)
        xt = timed("transpose_solve", solve_fn["auto"], sft, rhs)
        OUT["transpose_relres"] = float(jnp.linalg.norm(
            banded_matvec(banded_transpose(band), xt) - rhs)
            / jnp.linalg.norm(rhs))

    def stage_factor_native():
        from spike_petsc_tpu.models.problems import blocktri_diagdom_device
        from spike_petsc_tpu.ops.blocktri import BlockTridiagonal
        from spike_petsc_tpu.ops.spike import spike_factor_blocks
        Tn, _ = blocktri_diagdom_device(n, k, k, K, 128, seed=0)
        fn = jax.jit(lambda D, L, U: spike_factor_blocks(
            BlockTridiagonal(D=D, L=L, U=U), n=n, K=K, kl=k, ku=k,
            store_spikes=True, store_dtype=store_dtype,
            spike_dtype=jnp.bfloat16, inverter=inverter))
        timed("factor_native", fn, Tn.D, Tn.L, Tn.U)

    def stage_krylov_serve():
        from spike_petsc_tpu.solvers.krylov_many import bicgstab_many
        from spike_petsc_tpu.solvers.operator import as_matvec_many
        B = jax.random.normal(jax.random.PRNGKey(3), (n, r_serve), dtype)
        mv_many, _, _ = as_matvec_many(band)
        OUT["krylov_serve_mv_route"] = mv_many._route
        for rtol in (1e-8, 1e-4):
            @jax.jit
            def run(s, b, rtol=rtol):
                res = bicgstab_many(mv_many, b, None,
                                    lambda X: spike_solve_many(s, X),
                                    rtol=rtol, maxit=20)
                return jnp.max(res.its)
            its = timed(f"krylov_serve_per_rhs_r{r_serve}_rtol{rtol:g}",
                        run, sf, B, per=r_serve)
            OUT[f"krylov_serve_max_its_rtol{rtol:g}"] = int(its)

    def stage_ordering():
        from spike_petsc_tpu import sparse as hsparse
        from spike_petsc_tpu.models import problems
        from spike_petsc_tpu.ordering.awbm import awbm
        from spike_petsc_tpu.ordering.fiedler import fiedler
        from spike_petsc_tpu.ordering.mc64 import mc64
        from spike_petsc_tpu.ordering.rcm import rcm
        from spike_petsc_tpu.solvers.krylov import bicgstab

        n_ord = int(os.environ.get("SPIKE_BENCH_ORD_N", 1_000_000))
        a = problems.illscaled_nonsym(n_ord, 6, 6, seed=0)
        OUT["ordering_n"], OUT["ordering_nnz"] = n_ord, int(a.nnz)
        host = {}

        def clock(name, fn):
            t0 = time.perf_counter()
            out = fn()
            host[name] = (time.perf_counter() - t0) * 1e3
            OUT[f"ordering_{name}_ms"] = host[name]
            return out
        r5 = clock("mc64_job5", lambda: mc64(a, job=5))
        clock("awbm", lambda: awbm(a))
        pa = clock("apply", lambda: r5.apply(a, scale=True))
        pb = clock("rcm", lambda: rcm(pa).apply(pa))
        ext = clock("extract", lambda: hsparse.extract_banded(
            pb, kmax=50, frac=0.9999))
        d_np, okl, oku = clock("pack", lambda: hsparse.csr_to_banded_arrays(
            ext.matrix, ext.k, ext.k))
        OUT["ordering_band_k"] = int(ext.k)
        od = jnp.asarray(d_np, jnp.float32)
        Ko = min(64, max(1, n_ord // (4 * 128)))
        osf = timed("ordering_factor", jax.jit(lambda d: spike_factor(
            BandedMatrix(data=d, kl=okl, ku=oku), K=Ko, block_b=128)), od)
        ob = banded_matvec(BandedMatrix(data=od, kl=okl, ku=oku),
                           jnp.ones((n_ord,), jnp.float32))

        @jax.jit
        def osolve(d, s, b):
            bm = BandedMatrix(data=d, kl=okl, ku=oku)
            res = bicgstab(lambda v: banded_matvec(bm, v), b, None,
                           lambda v: spike_solve(s, v), rtol=1e-8, maxit=50)
            return res.its, res.rnorm
        its, rn = timed("ordering_bcgs_solve", osolve, od, osf, ob)
        OUT["ordering_bcgs_its"] = int(its)
        OUT["ordering_bcgs_relres"] = float(rn / jnp.linalg.norm(ob))
        OUT["ordering_e2e_ms"] = (sum(v for kk, v in host.items()
                                      if kk != "awbm")
                                  + OUT["ordering_factor_ms"]
                                  + OUT["ordering_bcgs_solve_ms"])
        nx = int(np.sqrt(n_ord))
        lap = problems.laplacian_2d(nx, nx)
        clock("fiedler", lambda: fiedler(lap))

    for name, fn in (("gmres", stage_gmres), ("serve", stage_serve),
                     ("band_mv", stage_band_mv),
                     ("f64_refine", stage_f64_refine),
                     ("transpose", stage_transpose),
                     ("factor_native", stage_factor_native),
                     ("krylov_serve", stage_krylov_serve),
                     ("ordering", stage_ordering)):
        if want(name):
            t0 = time.perf_counter()
            fn()
            log(f"{name} done in {time.perf_counter() - t0:.1f} s")


def cpu_baseline(n: int, k: int, w: int) -> None:
    """LAPACK sgbtrf/sgbtrs on this host, same problem class and
    precision, generated with NumPy (a timing, not a parity check)."""
    from scipy.linalg import lapack
    rng = np.random.default_rng(0)
    data = rng.random((n, w), dtype=np.float32) * 2.0 - 1.0
    data[:, k] = np.abs(data).sum(axis=1) + 1.0
    ab = np.zeros((3 * k + 1, n), dtype=np.float32, order="F")
    for d in range(-k, k + 1):
        ab[2 * k - d, max(0, d):n + min(0, d)] = \
            data[max(0, -d):n - max(0, d), d + k]
    rhs = np.ones((n,), dtype=np.float32)
    t0 = time.perf_counter()
    lub, ipiv, info = lapack.sgbtrf(ab, k, k)
    OUT["cpu_factor_ms"] = (time.perf_counter() - t0) * 1e3
    if info != 0:
        raise RuntimeError(f"sgbtrf failed: {info}")
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        lapack.sgbtrs(lub, k, k, rhs, ipiv)
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    OUT["cpu_solve_ms"] = ts[len(ts) // 2]
    OUT["vs_baseline"] = OUT["cpu_solve_ms"] / OUT["solve_ms"]
    OUT["factor_speedup"] = OUT["cpu_factor_ms"] / OUT["factor_ms"]


if __name__ == "__main__":
    try:
        main()
    finally:
        if OUT:
            print(json.dumps(OUT), flush=True)
