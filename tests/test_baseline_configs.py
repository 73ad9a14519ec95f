"""The five BASELINE.json parity configurations at test scale (SURVEY.md §6,
BASELINE.md).  Full-scale numbers live in bench.py; these tests pin the
end-to-end behavior of each configuration.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse.linalg as spla

from spike_petsc_tpu import Options, solve
from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
from spike_petsc_tpu.ops.spike import (spike_factor, spike_solve,
                                       spike_solve_many)
from spike_petsc_tpu.solvers.reorder import solve_reordered


def banded_of(a):
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)


def test_config1_tridiag_laplacian_gmres():
    """1D Laplacian tridiagonal: single-partition SPIKE LU + GMRES, the
    CPU testbed parity run."""
    n = 10_000
    a = problems.tridiag_laplacian(n)
    u = np.ones(n)
    res = solve(banded_of(a), jnp.asarray(a @ u), ksp_type="gmres",
                pc_type="lu", rtol=1e-10)
    assert int(res.reason) > 0 and int(res.its) <= 2
    err = np.linalg.norm(np.asarray(res.x) - u)
    assert err < 1e-7, err


def test_config1_residual_history_matches_scipy():
    """Convergence parity: unpreconditioned GMRES residual history must
    match SciPy's GMRES iteration-for-iteration (+-1) — the 'same residual
    histories to tolerance' requirement."""
    n = 400
    a = problems.nonsym_banded(n, 2, 2, seed=3, dominance=0.5)
    b = a @ np.ones(n)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gmres", rtol=1e-8,
                restart=30, maxit=2000)
    hist_sp = []
    x_sp, info = spla.gmres(a, b, rtol=1e-8, restart=30, maxiter=2000,
                            callback=lambda r: hist_sp.append(float(r)),
                            callback_type="pr_norm")
    assert info == 0 and int(res.reason) > 0
    assert abs(int(res.its) - len(hist_sp)) <= 1
    ours = np.asarray(res.history)[1:int(res.its) + 1]
    m = min(len(ours), len(hist_sp)) - 1
    # normalized residual curves agree to a few percent until the tail
    np.testing.assert_allclose(ours[:m] / ours[0],
                               np.asarray(hist_sp[:m]) / hist_sp[0],
                               rtol=0.2)


def test_config2_spd_banded_truncated_spike_batched():
    """SPD banded: 16-partition truncated SPIKE, batched multi-RHS solves."""
    n, k = 4096, 8
    a = problems.spd_banded(n, k, seed=2)
    bm = banded_of(a)
    sf = spike_factor(bm, K=16, block_b=16, truncated=True)
    rng = np.random.default_rng(0)
    U = rng.standard_normal((n, 4))
    X = np.asarray(spike_solve_many(sf, jnp.asarray(a @ U)))
    # truncated reduced system on an SPD dominant band: high accuracy
    rel = np.linalg.norm(X - U) / np.linalg.norm(U)
    assert rel < 1e-5, rel
    # and as a preconditioner it converges CG in a handful of iterations
    res = solve(bm, jnp.asarray(a @ U[:, 0]), ksp_type="cg",
                pc=__import__("spike_petsc_tpu").PC(
                    name="spike", apply=lambda v: spike_solve(sf, v)),
                rtol=1e-12, maxit=50)
    assert int(res.reason) > 0 and int(res.its) <= 5


def test_config3_illscaled_mc64_bicgstab():
    """Nonsymmetric ill-scaled: MC64 WBM scaling+permutation pre-pass, then
    SPIKE-preconditioned BiCGStab."""
    n = 2000
    a = problems.illscaled_nonsym(n, 6, 6, seed=4)
    u = np.random.default_rng(1).uniform(size=n)
    b = a @ u
    opts = Options({"reorder_pc_spike_partitions": "8"})
    res = solve_reordered(a, b, ordering="wbm", scale=True, options=opts,
                          ksp_type="bcgs", pc_type="spike", rtol=1e-12,
                          maxit=60)
    assert int(res.reason) > 0
    rel = np.linalg.norm(np.asarray(res.x) - u) / np.linalg.norm(u)
    assert rel < 1e-6, rel


def test_config4_general_sparse_fiedler_dropoff():
    """General sparse: Fiedler reorder + banded extraction as the drop-off
    preconditioner."""
    n = 1500
    a = problems.general_sparse(n, seed=6)
    rng = np.random.default_rng(2)
    p = rng.permutation(n)
    a = hsp.permute(a, p, p)          # hide the structure
    u = np.ones(n)
    b = a @ u
    opts = Options({
        "reorder_pc_banded_kmax": "80",
        "reorder_pc_banded_frac": "0.999",
        "reorder_banded_pc_spike_partitions": "4",
    })
    res = solve_reordered(a, b, ordering="fiedler", options=opts,
                          ksp_type="gmres", pc_type="banded", rtol=1e-10,
                          maxit=300)
    assert int(res.reason) > 0
    rel = np.linalg.norm(np.asarray(res.x) - u)
    assert rel < 1e-4, rel


def test_config5_multichip_spike():
    """Multi-chip SPIKE: per-chip band partitions, reduced system via an
    all-gather — on the virtual 8-device mesh."""
    from spike_petsc_tpu.parallel import (dist_spike_factor, make_dist_solver,
                                          make_mesh)
    mesh = make_mesh(8, axis="p")
    n = 1024
    a = problems.spd_banded(n, 4, seed=8)
    bm = banded_of(a)
    dsf = dist_spike_factor(bm, mesh, block_b=8)
    solver = make_dist_solver(dsf, mesh, ksp_type="gmres", rtol=1e-10,
                              maxit=30)
    u = np.random.default_rng(3).standard_normal(n)
    res = solver(jnp.asarray(a @ u))
    assert int(res.reason) > 0 and int(res.its) <= 3
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-6, atol=1e-7)
