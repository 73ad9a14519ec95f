"""Distributed-path feature parity with the single-chip SPIKE (VERDICT r2
item 1): stored V/W spikes (1-sweep PCApply), bf16 factor/spike storage,
diagonal shift, inverter safety net, and true multi-RHS distributed serving
(item 2) — all on the 8-device virtual CPU mesh (the reference's analogue is
``mpiexec -n N`` on one host, /root/reference/src/makefile:18)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops.band import BandedMatrix
from spike_petsc_tpu.parallel import (dist_spike_factor, dist_spike_solve,
                                      dist_spike_solve_many,
                                      make_dist_solver,
                                      make_dist_solver_batched, make_mesh)
from spike_petsc_tpu.ops.spike import spike_factor, spike_solve


def banded_of(acsr, dtype=None):
    data, kl, ku = hsp.csr_to_banded_arrays(acsr)
    data = jnp.asarray(data) if dtype is None else jnp.asarray(data, dtype)
    return BandedMatrix(data=data, kl=kl, ku=ku)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, axis="p")


def test_dist_stored_spikes_matches_recompute(mesh):
    """store_spikes=True: PCApply becomes one factor sweep + V/W correction
    (ops.spike's 1-sweep form) and must agree with the 2-sweep recompute."""
    n = 640
    a = problems.spd_banded(n, 4, seed=31)
    bm = banded_of(a)
    dsf_r = dist_spike_factor(bm, mesh, block_b=8, parts_per_device=2)
    dsf_s = dist_spike_factor(bm, mesh, block_b=8, parts_per_device=2,
                              store_spikes=True)
    assert dsf_s.V is not None and dsf_s.V.shape == (16, dsf_s.nb,
                                                     dsf_s.b, dsf_s.k)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(n)
    rhs = jnp.asarray(a @ u)
    x_r = np.asarray(dist_spike_solve(dsf_r, rhs, mesh))
    x_s = np.asarray(dist_spike_solve(dsf_s, rhs, mesh))
    np.testing.assert_allclose(x_s, u, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(x_s, x_r, rtol=1e-9, atol=1e-10)
    # and matches the single-chip stored-spike factorization
    sf = spike_factor(bm, K=16, block_b=8, store_spikes=True)
    x_single = np.asarray(spike_solve(sf, rhs))
    np.testing.assert_allclose(x_s, x_single, rtol=1e-9, atol=1e-10)


def test_dist_mixed_precision_storage(mesh):
    """bf16-stored factors / bf16 spikes on the mesh: PC-grade accuracy,
    exact within the mode's documented floor (the flagship bench config's
    mixed-precision modes, now distributed)."""
    n = 512
    a = problems.spd_banded(n, 3, seed=37)
    bm = banded_of(a, jnp.float32)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(n).astype(np.float32)
    rhs = jnp.asarray(np.asarray(a @ u, dtype=np.float32))

    # bf16 factor storage
    dsf_bf = dist_spike_factor(bm, mesh, block_b=8, store_dtype=jnp.bfloat16)
    assert dsf_bf.fact.F.dtype == jnp.bfloat16
    x = np.asarray(dist_spike_solve(dsf_bf, rhs, mesh))
    assert np.linalg.norm(x - u) / np.linalg.norm(u) < 5e-2

    # bf16 spikes only (factors stay f32)
    dsf_sp = dist_spike_factor(bm, mesh, block_b=8, store_spikes=True,
                               spike_dtype=jnp.bfloat16)
    assert dsf_sp.fact.F.dtype == jnp.float32
    assert dsf_sp.V.dtype == jnp.bfloat16
    x2 = np.asarray(dist_spike_solve(dsf_sp, rhs, mesh))
    assert np.linalg.norm(x2 - u) / np.linalg.norm(u) < 5e-3


def test_dist_shift_nonzero(mesh):
    """Diagonal-shift pivot boosting on the mesh: the zero-diagonal
    tridiagonal (singular pivot blocks at odd block sizes) factors finite,
    reports boosted pivots, and the shifted PC still drives the in-mesh
    GMRES to the exact solution (PETSc -pc_factor_shift_type nonzero
    parity, distributed)."""
    n = 120
    a = problems.zero_diag_tridiag(n)
    bm = banded_of(a)
    dsf = dist_spike_factor(bm, mesh, block_b=3, shift="nonzero")
    assert dsf.fact.nshift is not None
    assert int(np.asarray(dsf.fact.nshift).sum()) >= 1
    rng = np.random.default_rng(2)
    rhs = rng.standard_normal(n)
    x = np.asarray(dist_spike_solve(dsf, jnp.asarray(rhs), mesh))
    assert np.all(np.isfinite(x))
    # the in-mesh Krylov solver recovers full accuracy on the shifted PC
    solver = make_dist_solver(dsf, mesh, ksp_type="gmres", rtol=1e-10,
                              maxit=300)
    res = solver(jnp.asarray(rhs))
    assert int(res.reason) > 0
    import scipy.sparse.linalg as spla
    xs = spla.spsolve(a.tocsc(), rhs)
    np.testing.assert_allclose(np.asarray(res.x), xs, rtol=1e-5, atol=1e-6)


def test_dist_inverter_safety_net(mesh):
    """A non-diagonally-dominant matrix factored with the Newton inverter on
    the mesh must either recover (probe + blocked re-factor) or fail loudly —
    never silently return a garbage preconditioner (ADVICE r2 medium)."""
    n = 320
    # an indefinite-ish banded matrix: Newton-Schulz with Jacobi init
    # diverges (Jacobi iteration matrix spectral radius > 1)
    rng = np.random.default_rng(5)
    import scipy.sparse as sp
    diags = {0: 0.05 * rng.standard_normal(n) + 0.1,
             1: np.ones(n - 1), -1: np.ones(n - 1),
             2: 0.8 * np.ones(n - 2), -2: 0.8 * np.ones(n - 2)}
    a = sp.diags(list(diags.values()), list(diags.keys())).tocsr()
    bm = banded_of(a)
    dsf = dist_spike_factor(bm, mesh, block_b=4, inverter="newton")
    rhs = rng.standard_normal(n)
    x = np.asarray(dist_spike_solve(dsf, jnp.asarray(rhs), mesh))
    import scipy.sparse.linalg as spla
    xs = spla.spsolve(a.tocsc(), rhs)
    # with the safety net the dist factor fell back to 'blocked' and the
    # direct solve is accurate
    assert np.linalg.norm(x - xs) / np.linalg.norm(xs) < 1e-6


def test_dist_safety_net_not_triggered_when_healthy(mesh):
    """The probe must NOT re-factor diagonally-dominant systems (the fast
    path keeps the Newton inverses)."""
    n = 256
    a = problems.spd_banded(n, 3, seed=43)
    bm = banded_of(a)
    dsf_net = dist_spike_factor(bm, mesh, block_b=4, inverter="newton")
    dsf_raw = dist_spike_factor(bm, mesh, block_b=4, inverter="newton",
                                safety_net=False)
    # identical factors -> the net accepted the newton factorization
    np.testing.assert_array_equal(np.asarray(dsf_net.fact.Sinv),
                                  np.asarray(dsf_raw.fact.Sinv))


def test_dist_solve_many_matches_single_chip(mesh):
    """dist_spike_solve_many: factors stream once for all r right-hand
    sides; exact agreement with per-RHS solves and the single-chip
    multi-RHS path (VERDICT r2 item 2)."""
    from spike_petsc_tpu.ops.spike import spike_solve_many
    n, r = 512, 5
    a = problems.nonsym_banded(n, 3, 2, seed=47)
    bm = banded_of(a)
    dsf = dist_spike_factor(bm, mesh, block_b=8, parts_per_device=2,
                            store_spikes=True)
    rng = np.random.default_rng(3)
    U = rng.standard_normal((n, r))
    B = np.stack([a @ U[:, j] for j in range(r)], axis=1)
    X = np.asarray(dist_spike_solve_many(dsf, jnp.asarray(B), mesh))
    assert X.shape == (n, r)
    np.testing.assert_allclose(X, U, rtol=1e-7, atol=1e-8)
    sf = spike_factor(bm, K=16, block_b=8, store_spikes=True)
    Xs = np.asarray(spike_solve_many(sf, jnp.asarray(B)))
    np.testing.assert_allclose(X, Xs, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("serve_mode", ["preonly", "richardson"])
def test_dist_batched_serving_true_multirhs(serve_mode):
    """make_dist_solver_batched's true multi-RHS local engines on the 2-D
    (rhs x p) mesh: no lax.map of one-RHS solves — the whole local batch
    rides one multi-RHS SPIKE apply (+ refinement for 'richardson')."""
    from spike_petsc_tpu.parallel import make_mesh_2d
    mesh2 = make_mesh_2d((2, 4), axes=("rhs", "p"))
    n = 512
    a = problems.spd_banded(n, 3, seed=53)
    bm = banded_of(a)
    dsf = dist_spike_factor(bm, mesh2, axis="p", block_b=8,
                            parts_per_device=2, store_spikes=True)
    solver = make_dist_solver_batched(dsf, mesh2, ksp_type=serve_mode,
                                      rtol=1e-10, maxit=20)
    rng = np.random.default_rng(7)
    U = rng.standard_normal((6, n))
    B = np.stack([a @ U[i] for i in range(6)])
    X = np.asarray(solver(jnp.asarray(B)))
    np.testing.assert_allclose(X, U, rtol=1e-7, atol=1e-8)


def test_dist_batched_refinement_recovers_bf16(mesh):
    """richardson serving mode + bf16-stored factors: multi-RHS iterative
    refinement recovers full accuracy from reduced-precision storage — the
    distributed serving recipe for the mixed-precision flagship config."""
    from spike_petsc_tpu.parallel import make_mesh_2d
    mesh2 = make_mesh_2d((2, 4), axes=("rhs", "p"))
    n = 384
    a = problems.spd_banded(n, 3, seed=59)
    bm = banded_of(a, jnp.float32)
    dsf = dist_spike_factor(bm, mesh2, axis="p", block_b=8,
                            store_spikes=True, store_dtype=jnp.bfloat16,
                            spike_dtype=jnp.bfloat16)
    solver = make_dist_solver_batched(dsf, mesh2, ksp_type="richardson",
                                      rtol=1e-6, maxit=30)
    rng = np.random.default_rng(11)
    U = rng.standard_normal((4, n)).astype(np.float32)
    B = np.stack([np.asarray(a @ U[i], dtype=np.float32) for i in range(4)])
    X = np.asarray(solver(jnp.asarray(B)))
    for i in range(4):
        rel = np.linalg.norm(a @ X[i] - B[i]) / np.linalg.norm(B[i])
        assert rel < 1e-5, rel


def test_multislice_stored_spikes_and_bf16():
    """Multislice factor accepts the parity options: stored PC-tip spikes
    (intra-slice 1-sweep PCApply) and bf16 spike storage."""
    from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                          make_dist_solver_multislice,
                                          make_mesh_multislice)
    n = 768
    a = problems.spd_banded(n, 4, seed=61)
    bm = banded_of(a)
    mesh = make_mesh_multislice((2, 4))
    dsf = dist_spike_factor_multislice(bm, mesh, block_b=8,
                                       parts_per_device=2,
                                       store_spikes=True)
    assert dsf.V is not None
    solver = make_dist_solver_multislice(dsf, mesh, ksp_type="gmres",
                                         rtol=1e-10, maxit=40)
    rng = np.random.default_rng(13)
    u = rng.standard_normal(n)
    res = solver(jnp.asarray(a @ u))
    assert int(res.reason) > 0 and int(res.its) <= 15
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-7, atol=1e-8)


def test_multislice_batched_richardson_converges():
    """Huge-N serving layout: rows span the whole (slice, p) mesh, every
    device solves ALL r right-hand sides on its shard.  Richardson keeps
    the exact cross-slice matvec, so it converges to the true solution
    even though the PC drops cross-slice coupling."""
    from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                          make_dist_solver_multislice_batched,
                                          make_mesh_multislice)
    n, r = 768, 5
    a = problems.spd_banded(n, 4, seed=71)
    bm = banded_of(a)
    mesh = make_mesh_multislice((2, 4))
    dsf = dist_spike_factor_multislice(bm, mesh, block_b=8,
                                       parts_per_device=2, store_spikes=True)
    solver = make_dist_solver_multislice_batched(
        dsf, mesh, ksp_type="richardson", rtol=1e-9, maxit=40)
    rng = np.random.default_rng(72)
    U = rng.standard_normal((n, r))
    B = jnp.asarray(a @ U)
    X = np.asarray(solver(B))
    for i in range(r):
        rel = np.linalg.norm(a @ X[:, i] - np.asarray(B[:, i])) \
            / np.linalg.norm(B[:, i])
        assert rel < 1e-6, (i, rel)


def test_multislice_batched_preonly_is_pc_grade():
    """preonly = one block-Jacobi-across-slices PCApply: exact within each
    slice, approximate at slice boundaries — a genuine PC application (and
    exactly the single-slice answer when n_slices == 1)."""
    from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                          make_dist_solver_multislice_batched,
                                          make_mesh_multislice)
    n, r = 512, 3
    a = problems.spd_banded(n, 3, seed=73)
    bm = banded_of(a)
    rng = np.random.default_rng(74)
    U = rng.standard_normal((n, r))
    B = jnp.asarray(a @ U)

    mesh1 = make_mesh_multislice((1, 8))       # single slice: exact SPIKE
    dsf1 = dist_spike_factor_multislice(bm, mesh1, block_b=8)
    X1 = np.asarray(make_dist_solver_multislice_batched(
        dsf1, mesh1, ksp_type="preonly")(B))
    np.testing.assert_allclose(X1, U, rtol=1e-6, atol=1e-7)

    mesh2 = make_mesh_multislice((2, 4))       # 2 slices: PC-grade only
    dsf2 = dist_spike_factor_multislice(bm, mesh2, block_b=8)
    X2 = np.asarray(make_dist_solver_multislice_batched(
        dsf2, mesh2, ksp_type="preonly")(B))
    # a real preconditioner: much closer than the rhs, not exact
    err = np.linalg.norm(X2 - U) / np.linalg.norm(U)
    assert 1e-10 < err < 0.5, err


@pytest.mark.parametrize("store", [False, True])
def test_dist_spike_transpose(mesh, store):
    """dist_spike_transpose reuses the mesh factorization for A^T solves
    (distributed MatSolveTranspose): transposed local sweeps, k-wide
    ppermute tip exchange, reassembled replicated reduced system — and the
    resulting factor drives make_dist_solver on A^T too."""
    from spike_petsc_tpu.parallel import dist_spike_transpose
    n = 640
    a = problems.nonsym_banded(n, 3, 2, seed=7)
    bm = banded_of(a)
    dsf = dist_spike_factor(bm, mesh, block_b=8, parts_per_device=2,
                            store_spikes=store)
    dsft = dist_spike_transpose(dsf, mesh)
    rng = np.random.default_rng(41)
    g = rng.standard_normal(n)
    lam = np.asarray(dist_spike_solve(dsft, jnp.asarray(g), mesh))
    lam_e = np.linalg.solve(a.toarray().T, g)
    np.testing.assert_allclose(lam, lam_e, rtol=1e-9, atol=1e-10)
    G = rng.standard_normal((n, 3))
    Lam = np.asarray(dist_spike_solve_many(dsft, jnp.asarray(G), mesh))
    np.testing.assert_allclose(Lam, np.linalg.solve(a.toarray().T, G),
                               rtol=1e-9, atol=1e-10)
    # in-mesh Krylov on A^T with the transpose SPIKE PC (blocks_t matvec)
    res = make_dist_solver(dsft, mesh, ksp_type="gmres", rtol=1e-10,
                           maxit=20)(jnp.asarray(a.T @ np.ones(n)))
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), np.ones(n), rtol=1e-7,
                               atol=1e-8)


def test_dist_bicg_with_transpose_factor(mesh):
    """Distributed BiCG: the shadow recurrence runs on A^T in-mesh via the
    transpose factor's halo matvec + SPIKE solve (KSPBICG on a mesh)."""
    from spike_petsc_tpu.parallel import dist_spike_transpose
    n = 640
    a = problems.nonsym_banded(n, 3, 2, seed=7)
    bm = banded_of(a)
    dsf = dist_spike_factor(bm, mesh, block_b=8, parts_per_device=2,
                            store_spikes=True)
    dsft = dist_spike_transpose(dsf, mesh)
    u = np.random.default_rng(51).standard_normal(n)
    res = make_dist_solver(dsf, mesh, ksp_type="bicg", dsf_transpose=dsft,
                           rtol=1e-12, maxit=40)(jnp.asarray(a @ u))
    assert int(res.reason) > 0 and int(res.its) <= 3
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-8, atol=1e-9)
    with pytest.raises(ValueError, match="dist_spike_transpose"):
        make_dist_solver(dsf, mesh, ksp_type="bicg")


def test_dist_spike_transpose_multislice():
    """Multislice transpose reuse: per-slice transpose SPIKE PC (slice-edge
    PC tips re-masked), exact A^T cross-slice matvec."""
    from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                          dist_spike_transpose_multislice,
                                          make_dist_solver_multislice,
                                          make_mesh_multislice)
    n = 640
    a = problems.nonsym_banded(n, 3, 2, seed=9)
    bm = banded_of(a)
    mesh = make_mesh_multislice((2, 4))
    dsf = dist_spike_factor_multislice(bm, mesh, block_b=8,
                                       parts_per_device=2, store_spikes=True)
    dsft = dist_spike_transpose_multislice(dsf, mesh)
    g = np.random.default_rng(42).standard_normal(n)
    res = make_dist_solver_multislice(dsft, mesh, ksp_type="gmres",
                                      rtol=1e-11, maxit=30)(jnp.asarray(g))
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x),
                               np.linalg.solve(a.toarray().T, g),
                               rtol=1e-8, atol=1e-9)
    # multislice BiCG: shadow recurrence on A^T in the same (slice, p) mesh
    u = np.random.default_rng(43).standard_normal(n)
    res_b = make_dist_solver_multislice(
        dsf, mesh, ksp_type="bicg", dsf_transpose=dsft, rtol=1e-11,
        maxit=40)(jnp.asarray(a @ u))
    assert int(res_b.reason) > 0
    np.testing.assert_allclose(np.asarray(res_b.x), u, rtol=1e-8,
                               atol=1e-9)


def test_3d_mesh_replicated_multislice_serving():
    """(rhs, slice, p) 3-D serving mesh: each rhs-row is a full multislice
    replica solving its own batch — the replica axis carries no solver
    communication, so results must match the 1-replica multislice answer
    column for column."""
    from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                          make_dist_solver_3d,
                                          make_dist_solver_multislice_batched,
                                          make_mesh_3d, make_mesh_multislice)
    n, R = 512, 4
    a = problems.spd_banded(n, 3, seed=81)
    bm = banded_of(a)
    mesh3 = make_mesh_3d((2, 2, 2))
    # factoring on the 3-D mesh shards over (slice, p) and replicates
    # across the rhs axis for free (specs never mention it)
    dsf = dist_spike_factor_multislice(bm, mesh3, block_b=8,
                                       parts_per_device=2, store_spikes=True)
    solver = make_dist_solver_3d(dsf, mesh3, ksp_type="richardson",
                                 rtol=1e-9, maxit=40)
    rng = np.random.default_rng(82)
    U = rng.standard_normal((R, n))
    B = jnp.asarray((a @ U.T).T)
    X = np.asarray(solver(B))
    for i in range(R):
        rel = np.linalg.norm(a @ X[i] - np.asarray(B[i])) \
            / np.linalg.norm(B[i])
        assert rel < 1e-6, (i, rel)
    # parity with the single-replica multislice engine on the same columns
    mesh2 = make_mesh_multislice((2, 2))
    dsf2 = dist_spike_factor_multislice(bm, mesh2, block_b=8,
                                        parts_per_device=4,
                                        store_spikes=True)
    Xref = np.asarray(make_dist_solver_multislice_batched(
        dsf2, mesh2, ksp_type="richardson", rtol=1e-9, maxit=40)(
            jnp.asarray(B.T)))
    np.testing.assert_allclose(X, Xref.T, rtol=1e-6, atol=1e-8)


def test_3d_mesh_trip_count_sync_no_deadlock():
    """Regression: replicas whose convergence loops take DIFFERENT trip
    counts execute mismatched collective sequences — a deadlock on
    XLA:CPU's rendezvous (hit at ppd=1 with uneven column batches).  The
    engines now pmax the keep-iterating decision over the replica axis
    (solvers.krylov._keep_iterating / the richardson rel pmax)."""
    from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                          make_dist_solver_3d, make_mesh_3d)
    n = 512
    a = problems.spd_banded(n, 3, seed=5)
    bm = banded_of(a)
    mesh3 = make_mesh_3d((2, 2, 2))
    dsf = dist_spike_factor_multislice(bm, mesh3, block_b=8)  # ppd=1 repro
    rng = np.random.default_rng(7)
    # deliberately heterogeneous difficulty across the two replicas
    U = rng.standard_normal((6, n))
    U[3:] *= 1e6
    B = jnp.asarray((a @ U.T).T)
    for kt in ("richardson", "gmres"):
        X = np.asarray(make_dist_solver_3d(dsf, mesh3, ksp_type=kt,
                                           rtol=1e-10, maxit=60)(B))
        rel = np.linalg.norm(X - U) / np.linalg.norm(U)
        assert rel < 1e-8, (kt, rel)


def test_3d_mesh_preonly_and_krylov():
    """The other two per-replica engines on the 3-D mesh: preonly replica
    consistency (same rhs on both replicas -> identical answers) and
    per-RHS Krylov convergence."""
    from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                          make_dist_solver_3d, make_mesh_3d)
    n = 384
    a = problems.nonsym_banded(n, 3, 2, seed=83)
    bm = banded_of(a)
    mesh3 = make_mesh_3d((2, 2, 2))
    dsf = dist_spike_factor_multislice(bm, mesh3, block_b=8,
                                       parts_per_device=2)
    rng = np.random.default_rng(84)
    u = rng.standard_normal(n)
    b = jnp.asarray(a @ u)
    B = jnp.stack([b, b])                      # same rhs to both replicas
    Xp = np.asarray(make_dist_solver_3d(dsf, mesh3, ksp_type="preonly")(B))
    np.testing.assert_array_equal(Xp[0], Xp[1])
    Xk = np.asarray(make_dist_solver_3d(dsf, mesh3, ksp_type="gmres",
                                        rtol=1e-10, maxit=40)(B))
    np.testing.assert_allclose(Xk[0], u, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(Xk[1], u, rtol=1e-6, atol=1e-7)


def test_multislice_batched_krylov_per_rhs():
    from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                          make_dist_solver_multislice_batched,
                                          make_mesh_multislice)
    n, r = 512, 3
    a = problems.nonsym_banded(n, 3, 2, seed=75)
    bm = banded_of(a)
    mesh = make_mesh_multislice((2, 4))
    dsf = dist_spike_factor_multislice(bm, mesh, block_b=8)
    solver = make_dist_solver_multislice_batched(
        dsf, mesh, ksp_type="gmres", rtol=1e-10, maxit=40)
    rng = np.random.default_rng(76)
    U = rng.standard_normal((n, r))
    B = jnp.asarray(a @ U)
    X = np.asarray(solver(B))
    np.testing.assert_allclose(X, U, rtol=1e-6, atol=1e-7)


def test_dist_normal_equations_and_transpose_free_ksps(mesh):
    """The new KSP families on the mesh: cgne/lsqr ride the transposed
    distributed factorization (same threading as bicg); cgs/tfqmr are
    transpose-free and need only the forward halo matvec."""
    from spike_petsc_tpu.parallel import dist_spike_transpose
    n = 640
    a = problems.nonsym_banded(n, 3, 2, seed=7)
    bm = banded_of(a)
    dsf = dist_spike_factor(bm, mesh, block_b=8, parts_per_device=2,
                            store_spikes=True)
    dsft = dist_spike_transpose(dsf, mesh)
    u = np.random.default_rng(53).standard_normal(n)
    b = jnp.asarray(a @ u)
    for kt in ("cgne", "lsqr"):
        res = make_dist_solver(dsf, mesh, ksp_type=kt, dsf_transpose=dsft,
                               rtol=1e-12, maxit=60)(b)
        assert int(res.reason) > 0, (kt, int(res.reason))
        np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-7,
                                   atol=1e-8, err_msg=kt)
        with pytest.raises(ValueError, match="dist_spike_transpose"):
            make_dist_solver(dsf, mesh, ksp_type=kt)
    for kt in ("cgs", "tfqmr", "gcr", "bcgsl"):
        res = make_dist_solver(dsf, mesh, ksp_type=kt, rtol=1e-12,
                               maxit=60)(b)
        assert int(res.reason) > 0, (kt, int(res.reason))
        np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-7,
                                   atol=1e-8, err_msg=kt)


def test_dist_batched_serving_batched_krylov():
    """ksp_type='bcgs' on the (rhs x p) serving mesh now runs the BATCHED
    Krylov engine (one iteration loop, multi-RHS matvec/PCApply, per-column
    convergence) instead of lax.map of one-RHS solves."""
    from spike_petsc_tpu.parallel import make_mesh_2d
    mesh2 = make_mesh_2d((2, 4), axes=("rhs", "p"))
    n = 512
    a = problems.nonsym_banded(n, 3, 3, seed=61)
    bm = banded_of(a)
    dsf = dist_spike_factor(bm, mesh2, axis="p", block_b=8,
                            parts_per_device=2, store_spikes=True)
    solver = make_dist_solver_batched(dsf, mesh2, ksp_type="bcgs",
                                      rtol=1e-11, maxit=30)
    rng = np.random.default_rng(13)
    U = rng.standard_normal((6, n))
    B = np.stack([a @ U[i] for i in range(6)])
    X = np.asarray(solver(jnp.asarray(B)))
    np.testing.assert_allclose(X, U, rtol=1e-7, atol=1e-8)


def test_multislice_batched_krylov_serving():
    """Batched BiCGStab on the multislice (slice, p) serving surface: the
    per-slice SPIKE PC's multi-RHS apply + the exact cross-slice multi-RHS
    matvec drive all columns in one loop; block-Jacobi-across-slices PC is
    inexact, so the Krylov iteration must still converge to the TRUE
    solution."""
    from spike_petsc_tpu.parallel import (dist_spike_factor_multislice,
                                          make_dist_solver_multislice_batched,
                                          make_mesh_multislice)
    n = 512
    a = problems.nonsym_banded(n, 3, 2, seed=63)
    bm = banded_of(a)
    mesh = make_mesh_multislice((2, 4))
    dsf = dist_spike_factor_multislice(bm, mesh, block_b=8,
                                       parts_per_device=2,
                                       store_spikes=True)
    solver = make_dist_solver_multislice_batched(dsf, mesh, ksp_type="bcgs",
                                                 rtol=1e-11, maxit=40)
    rng = np.random.default_rng(17)
    U = rng.standard_normal((n, 5))
    B = a @ U
    X = np.asarray(solver(jnp.asarray(B)))
    np.testing.assert_allclose(X, U, rtol=1e-7, atol=1e-8)
