"""Batched multi-RHS Krylov engines (solvers/krylov_many.py): per-column
parity with the single-RHS methods, per-column convergence freezing, and
the make_solver_many composition with native PC.apply_many."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spike_petsc_tpu import BandedMatrix
from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops.band import banded_matvec
from spike_petsc_tpu.ops.spike import spike_factor, spike_solve_many
from spike_petsc_tpu.solvers import krylov, krylov_many
from spike_petsc_tpu.solvers.ksp import make_solver_many
from spike_petsc_tpu.solvers.types import reason_str


def banded_of(acsr, dtype=None):
    data, kl, ku = hsp.csr_to_banded_arrays(acsr)
    d = jnp.asarray(data)
    if dtype is not None:
        d = d.astype(dtype)
    return BandedMatrix(data=d, kl=kl, ku=ku)


def test_bicgstab_many_matches_single_rhs_per_column():
    a = problems.nonsym_banded(256, 3, 3, seed=5, dominance=0.6)
    A = banded_of(a)
    rng = np.random.default_rng(0)
    U = rng.standard_normal((256, 5))
    B = jnp.asarray(a @ U)
    mv_many = jax.vmap(lambda x: banded_matvec(A, x), in_axes=1, out_axes=1)
    res = krylov_many.bicgstab_many(mv_many, B, rtol=1e-10, maxit=400)
    assert all(int(r) > 0 for r in np.asarray(res.reason))
    # every column solves the system (long unpreconditioned BiCGStab runs
    # are rounding-chaotic in trip count — [n, r] reductions round
    # differently than [n] ones — so exact iteration parity is checked on
    # the short PRECONDITIONED runs below and in the cg test instead)
    np.testing.assert_allclose(np.asarray(res.x), U, rtol=1e-6, atol=1e-7)
    mv = lambda x: banded_matvec(A, x)
    for j in range(5):
        r1 = krylov.bicgstab(mv, B[:, j], rtol=1e-10, maxit=400)
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(r1.x), rtol=1e-6,
                                   atol=1e-8, err_msg=f"col {j}")
        # the first iterations agree before rounding divergence sets in
        np.testing.assert_allclose(np.asarray(res.history[:3, j]),
                                   np.asarray(r1.history[:3]), rtol=1e-6)


def test_cg_many_per_column_freeze_independent_difficulty():
    """Columns of very different difficulty: the easy column's solution
    must be bit-identical to solving it alone (frozen once converged, no
    contamination from the hard column's extra iterations)."""
    a = problems.spd_banded(200, 2, seed=3)
    A = banded_of(a)
    e = np.zeros(200); e[0] = 1.0
    rng = np.random.default_rng(1)
    B = jnp.asarray(np.column_stack([a @ e, rng.standard_normal(200)]))
    mv_many = jax.vmap(lambda x: banded_matvec(A, x), in_axes=1, out_axes=1)
    res = krylov_many.cg_many(mv_many, B, rtol=1e-11, maxit=600)
    assert all(int(r) > 0 for r in np.asarray(res.reason))
    mv = lambda x: banded_matvec(A, x)
    r0 = krylov.cg(mv, B[:, 0], rtol=1e-11, maxit=600)
    r1 = krylov.cg(mv, B[:, 1], rtol=1e-11, maxit=600)
    assert int(res.its[0]) == int(r0.its)
    assert int(res.its[1]) == int(r1.its)
    assert int(res.its[0]) != int(res.its[1])   # genuinely different costs
    np.testing.assert_allclose(np.asarray(res.x[:, 0]), np.asarray(r0.x),
                               rtol=1e-12, atol=1e-14)


def test_make_solver_many_with_spike_pc():
    """The composed batched solver: vmapped operator + the spike PC's
    NATIVE multi-RHS apply (spike_solve_many)."""
    a = problems.nonsym_banded(300, 3, 3, seed=9)
    A = banded_of(a)
    rng = np.random.default_rng(2)
    U = rng.standard_normal((300, 8))
    B = jnp.asarray(a @ U)
    solver = make_solver_many(A, ksp_type="bcgs", pc_type="spike",
                              rtol=1e-11, maxit=50)
    res = solver(B)
    assert all(int(r) > 0 for r in np.asarray(res.reason))
    assert int(np.asarray(res.its).max()) <= 2
    np.testing.assert_allclose(np.asarray(res.x), U, rtol=1e-8, atol=1e-9)


def test_make_solver_many_rejects_unbatched_method():
    a = problems.nonsym_banded(100, 2, 2, seed=1)
    with pytest.raises(ValueError, match="no batched engine"):
        make_solver_many(banded_of(a), ksp_type="tfqmr")


def test_bicgstab_many_mixed_precision_pc():
    """bf16-stored spike PC through PC.apply_many: batched Krylov recovers
    full f32 accuracy from reduced-precision factor storage."""
    from spike_petsc_tpu import Options
    from spike_petsc_tpu.solvers.pc import make_pc

    a = problems.spd_banded(256, 3, seed=7)
    A = banded_of(a, jnp.float32)
    opts = Options.from_argv(
        "-pc_spike_store_dtype bf16 -pc_spike_spike_dtype bf16 "
        "-pc_spike_store_spikes 1".split())
    pc = make_pc("spike", A, opts)
    assert pc.apply_many is not None
    solver = make_solver_many(A, pc=pc, ksp_type="bcgs", rtol=1e-6,
                              maxit=60)
    rng = np.random.default_rng(3)
    U = rng.standard_normal((256, 4)).astype(np.float32)
    B = jnp.asarray((a @ U).astype(np.float32))
    res = solver(B)
    assert all(int(r) > 0 for r in np.asarray(res.reason))
    for j in range(4):
        rel = np.linalg.norm(a @ np.asarray(res.x[:, j]) -
                             np.asarray(B[:, j])) / np.linalg.norm(B[:, j])
        assert rel < 1e-5, (j, rel)


def test_richardson_many_refinement_and_preonly_many():
    """The full single-chip batched serving trio: preonly (one multi-RHS
    PCApply), richardson (multi-RHS refinement), bcgs (batched Krylov)."""
    a = problems.spd_banded(200, 2, seed=5)
    A = banded_of(a)
    rng = np.random.default_rng(4)
    U = rng.standard_normal((200, 3))
    B = jnp.asarray(a @ U)
    for kt, tol in (("preonly", 1e-8), ("richardson", 1e-9),
                    ("bcgs", 1e-9)):
        solver = make_solver_many(A, ksp_type=kt, pc_type="lu",
                                  rtol=1e-11, maxit=30)
        res = solver(B)
        assert all(int(r) > 0 for r in np.asarray(res.reason)), kt
        np.testing.assert_allclose(np.asarray(res.x), U, rtol=tol,
                                   atol=tol, err_msg=kt)


def test_gmres_many_exact_per_column_parity():
    """Batched GMRES is algebraically IDENTICAL per column to single-RHS
    gmres (unlike bcgs, its reductions are per-column separable): same
    iteration counts, same histories, same solutions — including a column
    that freezes mid-restart-cycle while others keep iterating."""
    a = problems.nonsym_banded(256, 3, 3, seed=5, dominance=0.4)
    A = banded_of(a)
    rng = np.random.default_rng(0)
    e = np.zeros(256); e[0] = 1.0              # easy column (converges early)
    U = np.column_stack([e, rng.standard_normal(256)])
    B = jnp.asarray(a @ U)
    mv_many = jax.vmap(lambda x: banded_matvec(A, x), in_axes=1, out_axes=1)
    res = krylov_many.gmres_many(mv_many, B, rtol=1e-10, maxit=600,
                                 restart=30)
    assert all(int(r) > 0 for r in np.asarray(res.reason))
    mv = lambda x: banded_matvec(A, x)
    for j in range(2):
        r1 = krylov.gmres(mv, B[:, j], rtol=1e-10, maxit=600, restart=30)
        assert int(res.its[j]) == int(r1.its), j
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(r1.x), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(res.history[: int(r1.its) + 1, j]),
            np.asarray(r1.history[: int(r1.its) + 1]), rtol=1e-5)
    assert int(res.its[0]) != int(res.its[1])


def test_make_solver_many_gmres_with_pc():
    a = problems.nonsym_banded(300, 3, 3, seed=9)
    A = banded_of(a)
    rng = np.random.default_rng(2)
    U = rng.standard_normal((300, 4))
    B = jnp.asarray(a @ U)
    solver = make_solver_many(A, ksp_type="gmres", pc_type="spike",
                              rtol=1e-11, maxit=60, restart=20)
    res = solver(B)
    assert all(int(r) > 0 for r in np.asarray(res.reason))
    assert int(np.asarray(res.its).max()) <= 2
    np.testing.assert_allclose(np.asarray(res.x), U, rtol=1e-8, atol=1e-9)


def test_make_solver_many_transpose():
    """Batched A^T serving on the same stored factors (KSPSolveTranspose
    composed with the multi-RHS engines)."""
    a = problems.nonsym_banded(200, 3, 2, seed=11)
    A = banded_of(a)
    rng = np.random.default_rng(6)
    U = rng.standard_normal((200, 3))
    B = jnp.asarray(a.T @ U)
    solver = make_solver_many(A, ksp_type="bcgs", pc_type="spike",
                              rtol=1e-11, maxit=40, transpose=True)
    res = solver(B)
    assert all(int(r) > 0 for r in np.asarray(res.reason))
    np.testing.assert_allclose(np.asarray(res.x), U, rtol=1e-7, atol=1e-8)


def test_as_matvec_many_routes_and_parity(monkeypatch):
    """as_matvec_many: the blocktri_many route (operator streamed once for
    all r columns as batched [b,b]@[b,r] matmuls) matches the vmapped
    single-RHS matvec; narrow bands fall back to the vmap route; dense
    operators batch natively."""
    from spike_petsc_tpu.solvers import operator as op_mod

    n, k, r = 1024, 50, 5
    w = 2 * k + 1
    key = jax.random.PRNGKey(7)
    data = jax.random.uniform(key, (n, w), jnp.float32, minval=-1, maxval=1)
    data = data.at[:, k].set(jnp.sum(jnp.abs(data), axis=1) + 1)
    bm = BandedMatrix(data=data, kl=k, ku=k)
    X = jax.random.uniform(jax.random.fold_in(key, 1), (n, r), jnp.float32)
    ref = np.stack([np.asarray(banded_matvec(bm, X[:, j]))
                    for j in range(r)], axis=1)

    # wide band: the true multi-RHS blocktri route
    mvm, nn, _ = op_mod.as_matvec_many(bm)
    assert nn == n and mvm._route == "blocktri_many"
    np.testing.assert_allclose(np.asarray(mvm(X)), ref, rtol=2e-5, atol=2e-5)
    # forced blocktri on a narrow band also works
    bm_narrow = BandedMatrix(data=data[:, k - 3:k + 4], kl=3, ku=3)
    mvn, _, _ = op_mod.as_matvec_many(bm_narrow, impl="blocktri")
    assert mvn._route == "blocktri_many"
    ref_n = np.stack([np.asarray(banded_matvec(bm_narrow, X[:, j]))
                      for j in range(r)], axis=1)
    np.testing.assert_allclose(np.asarray(mvn(X)), ref_n,
                               rtol=2e-5, atol=2e-5)
    # narrow band 'auto' stays on the vmapped single-RHS route
    mva, _, _ = op_mod.as_matvec_many(bm_narrow)
    assert mva._route.startswith("vmap_")
    np.testing.assert_allclose(np.asarray(mva(X)), ref_n,
                               rtol=2e-5, atol=2e-5)

    # an explicit band-form request keeps the vmapped single-RHS route
    mvc, _, _ = op_mod.as_matvec_many(bm, impl="xla")
    assert mvc._route == "vmap_xla"
    np.testing.assert_allclose(np.asarray(mvc(X)), ref, rtol=2e-5, atol=2e-5)

    # dense batches natively
    A = np.asarray(jax.random.uniform(jax.random.fold_in(key, 2), (64, 64)))
    mvd, nd, _ = op_mod.as_matvec_many(A)
    assert nd == 64 and mvd._route == "dense_many"
    Xd = np.asarray(X[:64, :3])
    np.testing.assert_allclose(np.asarray(mvd(jnp.asarray(Xd))), A @ Xd,
                               rtol=1e-4, atol=1e-5)


def test_make_solver_many_blocktri_many_route(monkeypatch):
    """make_solver_many rides the TRUE multi-RHS blocktri operator route
    end-to-end.  The operator is built in f32 — the conversion's
    itemsize<=4 gate rejects f64 (under the x64 conftest the old version
    of this test silently took the vmap fallback: ADVICE r3) — and the
    route is asserted before the solve-parity check."""
    from spike_petsc_tpu.solvers import operator as op_mod
    from spike_petsc_tpu.solvers.ksp import make_solver

    n, k, r = 1536, 48, 3
    w = 2 * k + 1
    key = jax.random.PRNGKey(11)
    data = jax.random.uniform(key, (n, w), jnp.float32, minval=-1, maxval=1)
    data = data.at[:, k].set(jnp.sum(jnp.abs(data), axis=1) + 1)
    bm = BandedMatrix(data=data, kl=k, ku=k)
    B = jax.random.uniform(jax.random.fold_in(key, 1), (n, r), jnp.float32)

    # the route gate itself: f32 + wide band -> blocktri_many, not vmap
    mv_many, _, _ = op_mod.as_matvec_many(bm)
    assert mv_many._route == "blocktri_many"

    solver = make_solver_many(bm, ksp_type="bcgs", pc_type="spike",
                              rtol=1e-6, maxit=60, jit=False)
    res = solver(B)
    # converged through the multi-RHS route: true residual per column
    for j in range(r):
        rr = np.linalg.norm(np.asarray(
            banded_matvec(bm, res.x[:, j]) - B[:, j]))
        assert rr / np.linalg.norm(np.asarray(B[:, j])) < 5e-6
    # per-column agreement with single-RHS solves (f32 rounding differs
    # between the batched and single-RHS matvec kernels, so the match is
    # convergence-level, not bitwise)
    single = make_solver(bm, ksp_type="bcgs", pc_type="spike",
                         rtol=1e-6, maxit=60, jit=False)
    for j in range(r):
        rj = single(B[:, j])
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(rj.x), rtol=5e-4, atol=5e-5)


def test_make_solver_many_f64_vmap_fallback(monkeypatch):
    """f64 operators exceed the blocktri conversion's itemsize gate: the
    multi-RHS route falls back to vmapped single-RHS matvecs with exact
    per-column parity to single-RHS solves."""
    from spike_petsc_tpu.solvers import operator as op_mod
    from spike_petsc_tpu.solvers.ksp import make_solver

    n, k, r = 1536, 48, 3
    w = 2 * k + 1
    key = jax.random.PRNGKey(11)
    data = jax.random.uniform(key, (n, w), jnp.float64, minval=-1, maxval=1)
    data = data.at[:, k].set(jnp.sum(jnp.abs(data), axis=1) + 1)
    bm = BandedMatrix(data=data, kl=k, ku=k)
    B = jax.random.uniform(jax.random.fold_in(key, 1), (n, r), jnp.float64)

    mv_many, _, _ = op_mod.as_matvec_many(bm)
    assert mv_many._route.startswith("vmap_")

    solver = make_solver_many(bm, ksp_type="bcgs", pc_type="spike",
                              rtol=1e-10, maxit=40, jit=False)
    res = solver(B)
    single = make_solver(bm, ksp_type="bcgs", pc_type="spike",
                         rtol=1e-10, maxit=40, jit=False)
    for j in range(r):
        rj = single(B[:, j])
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(rj.x), rtol=1e-8, atol=1e-10)


def test_gmres_many_cgs_refinement_parity():
    """cgs_refinement threads through the batched GMRES: 'never' and
    'ifneeded' keep per-column parity with the single-RHS method under the
    same policy ('ifneeded' fires batched — a no-op refinement on a
    column that did not need it stays parity up to roundoff)."""
    a = problems.nonsym_banded(256, 3, 3, seed=6, dominance=0.4)
    A = banded_of(a)
    rng = np.random.default_rng(1)
    U = rng.standard_normal((256, 2))
    B = jnp.asarray(a @ U)
    mv_many = jax.vmap(lambda x: banded_matvec(A, x), in_axes=1, out_axes=1)
    mv = lambda x: banded_matvec(A, x)
    for mode in ("never", "ifneeded"):
        res = krylov_many.gmres_many(mv_many, B, rtol=1e-10, maxit=600,
                                     restart=30, cgs_refinement=mode)
        assert all(int(r) > 0 for r in np.asarray(res.reason)), mode
        for j in range(2):
            r1 = krylov.gmres(mv, B[:, j], rtol=1e-10, maxit=600,
                              restart=30, cgs_refinement=mode)
            np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                       np.asarray(r1.x), rtol=1e-7,
                                       atol=1e-9, err_msg=mode)
            np.testing.assert_allclose(np.asarray(res.x[:, j]), U[:, j],
                                       rtol=1e-6, atol=1e-8, err_msg=mode)
    import pytest as _pytest
    with _pytest.raises(ValueError, match="cgs_refinement"):
        krylov_many.gmres_many(mv_many, B, maxit=2, cgs_refinement="bogus")
