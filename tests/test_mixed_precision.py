"""Mixed-precision factorization: bf16 factor storage + iterative
refinement recovers working-precision accuracy (SURVEY.md §7 hard-part 3)."""

import numpy as np
import jax.numpy as jnp

from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
from spike_petsc_tpu.ops.spike import spike_factor, spike_solve
from spike_petsc_tpu.solvers.krylov import richardson


def _setup(n=800, k=4, seed=3):
    a = problems.spd_banded(n, k, seed=seed)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data, jnp.float32), kl=kl, ku=ku)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(n).astype(np.float32)
    return a, bm, u


def test_bf16_factor_solve_coarse_accuracy():
    a, bm, u = _setup()
    sf = spike_factor(bm, K=8, block_b=8, store_dtype=jnp.bfloat16)
    rhs = banded_matvec(bm, jnp.asarray(u))
    x = np.asarray(spike_solve(sf, rhs))
    rel = np.linalg.norm(x - u) / np.linalg.norm(u)
    assert rel < 5e-2  # bf16 has ~3 decimal digits


def test_bf16_plus_refinement_reaches_f32_accuracy():
    a, bm, u = _setup()
    sf = spike_factor(bm, K=8, block_b=8, store_dtype=jnp.bfloat16)
    rhs = banded_matvec(bm, jnp.asarray(u))
    res = richardson(lambda v: banded_matvec(bm, v), rhs, None,
                     lambda v: spike_solve(sf, v), rtol=1e-6, maxit=20)
    x = np.asarray(res.x)
    rel = np.linalg.norm(x - u) / np.linalg.norm(u)
    assert int(res.reason) > 0
    assert rel < 1e-5
    assert int(res.its) <= 8  # refinement converges fast off a bf16 factor


def test_refinement_iteration_count_vs_full_precision():
    a, bm, u = _setup()
    rhs = banded_matvec(bm, jnp.asarray(u))
    sf32 = spike_factor(bm, K=8, block_b=8)
    res32 = richardson(lambda v: banded_matvec(bm, v), rhs, None,
                       lambda v: spike_solve(sf32, v), rtol=1e-6, maxit=20)
    assert int(res32.its) <= 2  # f32 factor: essentially direct


def test_bf16_spike_dtype_only_near_exact():
    """spike_dtype=bf16 (factors stay f32) costs only the spikes' own
    rounding (~1e-4 solution error here) — orders better than full-bf16
    storage (~5e-2), and below the f32 residual floor at the production
    bench config (f64-checked there: 8.29e-5 vs 8.25e-5)."""
    a, bm, u = _setup()
    rhs = banded_matvec(bm, jnp.asarray(u))
    sfbf = spike_factor(bm, K=8, block_b=8, store_spikes=True,
                        spike_dtype=jnp.bfloat16)
    assert sfbf.V.dtype == jnp.bfloat16 and sfbf.fact.F.dtype == jnp.float32
    xbf = np.asarray(spike_solve(sfbf, rhs))
    rbf = np.linalg.norm(xbf - u) / np.linalg.norm(u)
    assert rbf < 5e-4


def test_pc_spike_dtype_options():
    """-pc_spike_store_dtype / -pc_spike_spike_dtype plumb the mixed-
    precision storage modes through the PC layer."""
    from spike_petsc_tpu import Options, make_pc
    from spike_petsc_tpu.solvers.krylov import gmres

    a, bm, u = _setup()
    rhs = banded_matvec(bm, jnp.asarray(u))
    pc = make_pc("spike", bm, Options({"pc_spike_partitions": "8",
                                       "pc_spike_block": "8",
                                       "pc_spike_store_spikes": "1",
                                       "pc_spike_spike_dtype": "bf16"}))
    assert pc.info.get("spike_dtype") == "bfloat16"
    x = np.asarray(pc.apply(rhs))
    assert np.linalg.norm(x - u) / np.linalg.norm(u) < 1e-3

    pcb = make_pc("spike", bm, Options({"pc_spike_partitions": "8",
                                        "pc_spike_block": "8",
                                        "pc_spike_store_dtype": "bf16"}))
    assert pcb.info.get("store_dtype") == "bfloat16"
    res = gmres(lambda v: banded_matvec(bm, v), rhs, None, pcb.apply,
                rtol=1e-8, maxit=30)
    assert int(res.reason) > 0 and int(res.its) <= 5


def test_factor_dtype_refinement_reaches_f64_grade():
    """-pc_spike_factor_dtype f32 on an f64 operator: the band is cast and
    factored in f32 while PCApply casts at the boundary, so a plain f64
    richardson becomes mixed-precision iterative refinement reaching
    f64-grade residuals (the mixed-precision refinement recipe, SURVEY §7
    hard-part 3)."""
    from spike_petsc_tpu import Options
    from spike_petsc_tpu.solvers.ksp import solve

    n, k = 6000, 6
    rng = np.random.default_rng(7)
    data = rng.uniform(-1, 1, (n, 2 * k + 1))
    data[:, k] = np.abs(data).sum(axis=1) + 1.0
    band = BandedMatrix(data=jnp.asarray(data, jnp.float64), kl=k, ku=k)
    u = rng.standard_normal(n)
    rhs = banded_matvec(band, jnp.asarray(u))
    res = solve(band, rhs, options=Options({
        "ksp_type": "richardson", "pc_type": "spike",
        "pc_spike_partitions": "8", "pc_spike_factor_dtype": "f32",
        "pc_spike_store_spikes": "1", "ksp_rtol": "1e-13",
        "ksp_max_it": "30"}))
    assert res.x.dtype == jnp.float64
    rel = float(jnp.linalg.norm(banded_matvec(band, res.x) - rhs)
                / jnp.linalg.norm(rhs))
    assert rel < 1e-12 and int(res.its) <= 5
