#!/usr/bin/env python3
"""Smoke run of the SPIKE solve path on CUDA cards, checked against SciPy.

    python chip_smoke.py             # one card, every phase below
    python chip_smoke.py --chips 4   # only the 4-card distributed path

One card, in order:

  gpu_tests  ``pytest -m gpu`` in a subprocess, before this process touches
             the card (one process holds the card at a time)
  device     the default backend is the GPU; card name and power limit
  testbed    BASELINE config 3 through ``testbed.main``: ill-scaled
             nonsymmetric n=1e6 -> MC64 scale+permute -> RCM -> banded
             extraction -> banded-PC BiCGStab
  flagship   ``solve(..., ksp_type="gmres", pc_type="spike")`` at N=1e6,
             kl=ku=100, K=64, b=128, f32 factors, bf16 stored spikes
  kernels    the Pallas sweep kernels against the XLA scan and SciPy at the
             flagship widths: inv f32/bf16 factors and spd f32, r=1 and 32
  f64        a native-f64 SPIKE solve at N=1e6, bw=201

``--chips 4`` runs BASELINE config 5 alone: ``dist_spike_factor`` +
``make_dist_solver`` (GMRES) on a 1-D mesh of 4 cards, N=4e6, kl=ku=100,
K=256, against SciPy.

Every phase prints its error beside its tolerance.  A failed phase prints
its traceback and the later phases still run, so that one run on the card
reports every fault; any failure makes the process exit non-zero without a
result line.  Otherwise the last line of standard output is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# the flagship: N rows, kl = ku = KL, K_PARTS partitions of BLOCK-blocks;
# the 4-card path: N_DIST rows, K_PARTS partitions on each card
N, KL, K_PARTS, BLOCK, N_DIST = 1_000_000, 100, 64, 128, 4_000_000


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


FAILED: list = []


def phase(name: str, fn, *args):
    """Run one phase; a failure is printed and recorded, and the caller
    goes on with the next phase.  Returns ``fn``'s result (None if it
    failed)."""
    t0 = time.perf_counter()
    log(f"== {name}")
    try:
        out = fn(*args)
    except Exception:                  # recorded: the run exits non-zero
        log(traceback.format_exc().rstrip())
        log(f"== {name} FAILED ({time.perf_counter() - t0:.1f} s)")
        FAILED.append(name)
        return None
    log(f"== {name} ok ({time.perf_counter() - t0:.1f} s)")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def backend_in_subprocess() -> tuple:
    """(backend, device count) from a child process, so that this one has
    not touched the card before the GPU tests run."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.default_backend(), len(jax.devices()))"],
        capture_output=True, text=True, cwd=ROOT)
    check(out.returncode == 0, f"JAX starts (stderr: {out.stderr[-500:]})")
    backend, count = out.stdout.split()[-2:]
    return backend, int(count)


# ---------------------------------------------------------------------------
# host references (f64)
# ---------------------------------------------------------------------------

def host_matvec(data: np.ndarray, kl: int, x: np.ndarray) -> np.ndarray:
    """y = A x in f64 from band storage data[i, d] = A[i, i + d - kl]."""
    n, w = data.shape
    x = x.reshape(n, -1).astype(np.float64)
    xp = np.zeros((n + w - 1, x.shape[1]))
    xp[kl:kl + n] = x
    y = np.zeros_like(x)
    for d in range(w):
        y += data[:, d:d + 1].astype(np.float64) * xp[d:d + n]
    return y


def scipy_solve(data: np.ndarray, kl: int, ku: int, b: np.ndarray):
    """scipy.linalg.solve_banded in f64 on the same band."""
    from scipy.linalg import solve_banded
    n, w = data.shape
    ab = np.zeros((w, n))
    for d in range(w):
        off = d - kl
        ab[ku - off, max(0, off):min(n, n + off)] = \
            data[max(0, -off):min(n, n - off), d]
    return solve_banded((kl, ku), ab, b, overwrite_ab=True,
                        check_finite=False)


def rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(b))


def relres(data, kl, x, b) -> float:
    r = host_matvec(data, kl, np.asarray(x)) - b.reshape(len(b), -1)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def timed_ms(fn, *args, reps: int = 5) -> str:
    """Median of ``reps`` warm calls, each ended by block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return f"{ts[len(ts) // 2]:.4f} ms (min {ts[0]:.4f}, max {ts[-1]:.4f})"


def random_band(n: int, k: int, seed: int) -> np.ndarray:
    """Diagonally dominant random band [n, 2k+1] (f32), zero outside A."""
    rng = np.random.default_rng(seed)
    w = 2 * k + 1
    data = rng.uniform(-1.0, 1.0, (n, w)).astype(np.float32)
    for d in range(k):                       # entries that fall outside A
        data[:k - d, d] = 0
        data[n - k + d:, w - 1 - d] = 0
    data[:, k] = np.abs(data).sum(axis=1) + 1.0
    return data


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def gpu_tests() -> None:
    env = dict(os.environ, SPIKE_TEST_PLATFORM="cuda")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-rs"],
        capture_output=True, text=True, cwd=ROOT, env=env)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    log(f"pytest -m gpu: {tail}")
    check(out.returncode == 0, f"gpu tests pass:\n{out.stdout[-3000:]}"
                               f"\n{out.stderr[-2000:]}")
    check(re.search(r"\d+ passed", tail) is not None
          and "skipped" not in tail and "deselected" in tail,
          "every gpu test ran and passed")


def device(chips: int):
    import jax
    check(jax.default_backend() == "gpu",
          f"default backend is gpu (got {jax.default_backend()})")
    dev = jax.devices()
    log(f"device_kind: {dev[0].device_kind}, count: {len(dev)}")
    log(f"nvidia-smi: {card_line()}")
    check(len(dev) >= chips, f"{chips} card(s) visible, {len(dev)} found")
    return dev[0]


def testbed() -> None:
    from spike_petsc_tpu import testbed as tb
    argv = ["-problem", "illscaled:1000000:6:6",
            "-mat_ordering_type", "wbm", "-mat_ordering_scale", "1",
            "-mat_ordering_type2", "rcm", "-banded_pre_mat", "1",
            "-pc_banded_frac", "0.9999", "-ksp_type", "bcgs",
            "-pc_type", "banded", "-ksp_rtol", "1e-10",
            "-banded_pc_spike_partitions", "8", "-ksp_converged_reason"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tb.main(argv)
    out = buf.getvalue()
    log(out.rstrip())
    check(rc == 0, f"testbed exit code 0 (got {rc})")
    check("Reduced bandwidth" in out, "'Reduced bandwidth' printed")
    err = float(re.search(r"Error in solution: (\S+)", out).group(1))
    # u = ones(1e6): ||x - u||_2 / ||u||_2 in an f32 solve
    tol = 1e-5
    log(f"testbed: ||x - u|| / ||u|| = {err / 1e3:.3e} (tolerance {tol:g})")
    check(err / 1e3 <= tol, "testbed solution error")


def problem(pool) -> dict:
    """The flagship band and 33 right-hand sides; their SciPy solutions are
    computed on the host while the card works (``ref``, a future)."""
    data = random_band(N, KL, seed=0)
    xs = np.random.default_rng(1).standard_normal((N, 33))
    b_all = host_matvec(data, KL, xs)                    # [N, 33] f64
    return dict(data=data, b_all=b_all,
                ref=pool.submit(scipy_solve, data, KL, KL, b_all))


def flagship(ctx) -> None:
    import jax
    import jax.numpy as jnp
    from spike_petsc_tpu import BandedMatrix, Options
    from spike_petsc_tpu.ops.spike import spike_factor
    from spike_petsc_tpu.solvers.ksp import make_solver, solve
    from spike_petsc_tpu.solvers.pc import make_pc

    data, b_all = ctx["data"], ctx["b_all"]
    band = BandedMatrix(data=jnp.asarray(data), kl=KL, ku=KL)
    b = jnp.asarray(b_all[:, 0], jnp.float32)
    opts = Options({"pc_spike_partitions": K_PARTS, "pc_spike_block": BLOCK,
                    "pc_spike_store_spikes": True,
                    "pc_spike_spike_dtype": "bf16", "ksp_rtol": 1e-8,
                    "ksp_max_it": 30})
    t0 = time.perf_counter()
    pc = make_pc("spike", band, opts)
    log(f"flagship: spike PC set-up {time.perf_counter() - t0:.1f} s "
        f"(compiles and the factor's probe solve included)")
    t0 = time.perf_counter()
    res = solve(band, b, options=opts, ksp_type="gmres", pc=pc)
    x = np.asarray(res.x)
    log(f"flagship: gmres + spike PC, {int(res.its)} its, reason "
        f"{int(res.reason)}, recurrence residual "
        f"{float(res.rnorm) / float(jnp.linalg.norm(b)):.3e}, first call "
        f"{time.perf_counter() - t0:.1f} s (compiles included)")
    x_ref = ctx["ref"].result()[:, 0]
    e, rr = rel(x, x_ref), relres(data, KL, x, b_all[:, 0])
    # f32 operator and iterates; the Krylov and factor products run at
    # HIGHEST precision, the bf16 spikes only touch the PC: both bounds
    # are f32-level
    log(f"flagship: ||x - x_scipy|| / ||x_scipy|| = {e:.3e} (tolerance 1e-5),"
        f" f64 host relative residual = {rr:.3e} (tolerance 1e-6)")
    ok = int(res.reason) > 0 and e <= 1e-5 and rr <= 1e-6
    if not ok:
        # diagnosis only: the same solve with every unpinned product at
        # HIGHEST tells a precision fault from an algorithmic one
        with jax.default_matmul_precision("highest"):
            xh = np.asarray(solve(band, b, options=opts, ksp_type="gmres",
                                  pc=pc).x)
        log(f"flagship (diagnosis, all products HIGHEST): f64 host relative "
            f"residual = {relres(data, KL, xh, b_all[:, 0]):.3e}")

    # the jitted solver (operator and factors enter as arguments)
    solver = make_solver(band, options=opts, ksp_type="gmres", pc=pc)
    x_j = np.asarray(solver(b).x)
    rr_j = relres(data, KL, x_j, b_all[:, 0])
    log(f"flagship: make_solver gmres f64 host relative residual = "
        f"{rr_j:.3e} (tolerance 1e-6); warm solve "
        f"{timed_ms(lambda v: solver(v).x, b)}")
    # the factor with each inverse engine ('auto' takes newton on a GPU)
    for inv in ("newton", "lapack"):
        fac = jax.jit(lambda d, inv=inv: spike_factor(
            BandedMatrix(data=d, kl=KL, ku=KL), K=K_PARTS, block_b=BLOCK,
            store_spikes=True, spike_dtype=jnp.bfloat16, inverter=inv))
        log(f"flagship: spike_factor inverter={inv} "
            f"{timed_ms(fac, band.data, reps=3)}")
    check(ok, "flagship accuracy")
    check(rr_j <= 1e-6, "make_solver accuracy")


def kernels(ctx, pool) -> None:
    import jax
    import jax.numpy as jnp
    from spike_petsc_tpu import BandedMatrix
    from spike_petsc_tpu.ops.blocktri import cast_factor
    from spike_petsc_tpu.ops.spike import (spike_factor, spike_solve,
                                           spike_solve_many)
    import dataclasses

    data, b_all = ctx["data"], ctx["b_all"]
    band = BandedMatrix(data=jnp.asarray(data), kl=KL, ku=KL)
    # the spd case: the symmetric part of the same band (SPD: symmetric,
    # strictly diagonally dominant, positive diagonal)
    sym = data.copy()
    for d in range(KL):
        sym[KL - d:, d] = 0.5 * (data[KL - d:, d]
                                 + data[:N - KL + d, 2 * KL - d])
        sym[:N - KL + d, 2 * KL - d] = sym[KL - d:, d]
    sym_b = host_matvec(sym, KL, np.random.default_rng(2).standard_normal(
        (N, 33)))
    sym_ref = pool.submit(scipy_solve, sym, KL, KL, sym_b)

    # f32 spikes here: the check is on the sweeps, not on the bf16 spike
    # correction the flagship phase exercises
    fac = jax.jit(lambda d, method: spike_factor(
        BandedMatrix(data=d, kl=KL, ku=KL), K=K_PARTS, block_b=BLOCK,
        method=method, store_spikes=True), static_argnums=1)
    sf_inv = fac(band.data, "inv")
    sf_spd = fac(jnp.asarray(sym), "spd")
    sym_ref, x_ref = sym_ref.result(), ctx["ref"].result()
    cases = [("inv", "f32", sf_inv, data, b_all, x_ref),
             ("inv", "bf16", dataclasses.replace(
                 sf_inv, fact=cast_factor(sf_inv.fact, jnp.bfloat16)),
              data, b_all, x_ref),
             ("spd", "f32", sf_spd, sym, sym_b, sym_ref)]
    for method, store, sf, dat, bb, xr in cases:
        # f32 factors: a direct solve (no Krylov correction) carries the
        # factor's f32 rounding, accumulated along 122-block chains, so the
        # SciPy bound is f32-level (1e-4); the kernel repeats the XLA scan's
        # arithmetic on the same factor, so that bound is tight (1e-5).
        # bf16 factor storage is preconditioner-grade (SciPy bound 5e-2);
        # kernel and XLA scan then both run one TF32 pass per multi-RHS
        # product, so they agree to ~1e-3, not to f32 rounding
        tol_ref = 1e-4 if store == "f32" else 5e-2
        tol_xla = 1e-5 if store == "f32" else 1e-3
        for r in (1, 32):
            cols = slice(0, 1) if r == 1 else slice(1, 33)
            rhs = jnp.asarray(bb[:, cols], jnp.float32)
            ref = xr[:, cols]
            fn = spike_solve_many
            if r == 1:
                rhs, ref, fn = rhs[:, 0], ref[:, 0], spike_solve
            kern = jax.jit(lambda s, v, fn=fn: fn(s, v, impl="pallas_fused"))
            xla = jax.jit(lambda s, v, fn=fn: fn(s, v, impl="xla"))
            x_k, x_x = np.asarray(kern(sf, rhs)), np.asarray(xla(sf, rhs))
            e_ref, e_xla = rel(x_k, ref), rel(x_k, x_x)
            log(f"kernels {method} {store} r={r}: vs SciPy {e_ref:.3e} "
                f"(tolerance {tol_ref:g}), vs XLA {e_xla:.3e} "
                f"(tolerance {tol_xla:g})")
            log(f"    {fn.__name__} pallas_fused {timed_ms(kern, sf, rhs)};"
                f" xla {timed_ms(xla, sf, rhs)}")
            check(e_ref <= tol_ref and e_xla <= tol_xla,
                  f"kernel accuracy {method} {store} r={r}")


def f64(ctx) -> None:
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from spike_petsc_tpu import BandedMatrix
    from spike_petsc_tpu.ops.spike import spike_factor, spike_solve

    data, b_all, x_ref = ctx["data"], ctx["b_all"], ctx["ref"].result()
    band = BandedMatrix(data=jnp.asarray(data, jnp.float64), kl=KL, ku=KL)
    sf = jax.jit(lambda d: spike_factor(
        BandedMatrix(data=d, kl=KL, ku=KL), K=K_PARTS, block_b=BLOCK,
        store_spikes=True))(band.data)
    check(sf.fact.F.dtype == jnp.float64, "f64 factors")
    x = np.asarray(spike_solve(sf, jnp.asarray(b_all[:, 0])))
    e, rr = rel(x, x_ref[:, 0]), relres(data, KL, x, b_all[:, 0])
    log(f"f64: ||x - x_scipy|| / ||x_scipy|| = {e:.3e} (tolerance 1e-8), "
        f"f64 relative residual = {rr:.3e} (tolerance 1e-8)")
    log(f"f64: spike_solve {timed_ms(jax.jit(spike_solve), sf, jnp.asarray(b_all[:, 0]))}")
    check(e <= 1e-8 and rr <= 1e-8, "f64 parity bar")


def dist4(pool) -> None:
    import jax
    import jax.numpy as jnp
    from spike_petsc_tpu import BandedMatrix
    from spike_petsc_tpu.parallel import (dist_spike_factor,
                                          make_dist_solver, make_mesh)

    n, ndev = N_DIST, 4
    data = random_band(n, KL, seed=3)
    b = host_matvec(data, KL, np.random.default_rng(4).standard_normal(n))
    ref = pool.submit(scipy_solve, data, KL, KL, b[:, 0])
    mesh = make_mesh(ndev, axis="p")
    t0 = time.perf_counter()
    # a host band: each card receives only its own shard
    dsf = dist_spike_factor(BandedMatrix(data=data, kl=KL, ku=KL), mesh,
                            block_b=BLOCK, parts_per_device=K_PARTS,
                            store_spikes=True, spike_dtype=jnp.bfloat16)
    jax.block_until_ready(dsf)
    log(f"dist: factor K={dsf.K} over {ndev} cards "
        f"{time.perf_counter() - t0:.1f} s (compiles included)")
    devs = jax.devices()[:ndev]
    live = [0.0] * ndev
    for a in jax.live_arrays():
        for sh in a.addressable_shards:
            live[devs.index(sh.device)] += sh.data.nbytes / 2**30
    log("dist: live GiB per card after factor: "
        + ", ".join(f"{v:.2f}" for v in live))
    stats = [d.memory_stats() for d in devs]
    peaks = None
    if all(stats):                     # the allocator's high-water marks
        peaks = [st["peak_bytes_in_use"] / 2**30 for st in stats]
        log("dist: peak GiB per card: " + ", ".join(f"{p:.2f}"
                                                    for p in peaks))
    solver = make_dist_solver(dsf, mesh, ksp_type="gmres", rtol=1e-8,
                              maxit=30)
    b32 = jnp.asarray(b[:, 0], jnp.float32)
    t0 = time.perf_counter()
    res = solver(b32)
    x = np.asarray(res.x)
    log(f"dist: gmres {int(res.its)} its, reason {int(res.reason)}, first "
        f"call {time.perf_counter() - t0:.1f} s (compiles included); warm "
        f"solve {timed_ms(lambda v: solver(v).x, b32, reps=3)}")
    e, rr = rel(x, ref.result()), relres(data, KL, x, b[:, 0])
    log(f"dist: ||x - x_scipy|| / ||x_scipy|| = {e:.3e} (tolerance 1e-5), "
        f"f64 host relative residual = {rr:.3e} (tolerance 1e-6)")
    ok = int(res.reason) > 0 and e <= 1e-5 and rr <= 1e-6
    if not ok:
        # diagnosis only: every unpinned product at HIGHEST
        with jax.default_matmul_precision("highest"):
            xh = np.asarray(make_dist_solver(
                dsf, mesh, ksp_type="gmres", rtol=1e-8, maxit=30)(b32).x)
        log(f"dist (diagnosis, all products HIGHEST): f64 host relative "
            f"residual = {relres(data, KL, xh, b[:, 0]):.3e}")
    check(max(live) <= 1.25 * min(live), "no card holds much more than "
          "the others (nothing piles up on device 0)")
    check(peaks is None or max(peaks) <= 1.5 * min(peaks),
          "no card peaks far above the others")
    check(ok, "dist accuracy")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import spike_petsc_tpu  # noqa: F401  (fails outside a checkout)

    backend, count = backend_in_subprocess()
    check(backend == "gpu", f"JAX finds a GPU (backend {backend!r})")
    if args.chips == 1:
        phase("gpu_tests", gpu_tests)
    from spike_petsc_tpu.utils.platform import enable_compile_cache
    enable_compile_cache()
    dev = phase("device", device, args.chips)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        if args.chips == 4:
            phase("dist4", dist4, pool)
        else:
            ctx = problem(pool)
            phase("testbed", testbed)
            phase("flagship", flagship, ctx)
            phase("kernels", kernels, ctx, pool)
            phase("f64", f64, ctx)
    if FAILED:
        log(f"FAILED: {', '.join(FAILED)}")
        return 1
    import jax
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
