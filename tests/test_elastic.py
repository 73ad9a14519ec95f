"""Elastic / fault-tolerant distributed solves (SURVEY §5 failure-detection
row — a capability the reference lacks; its model is fail-fast SETERRQ).

Scenarios on the 8-device virtual CPU mesh: plain segmented solve matches
the one-shot solver, checkpoint/resume across "process restarts", and an
injected device failure mid-solve recovered by rebuilding a 4-device mesh
and resuming from the checkpointed iterate.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops.band import BandedMatrix
from spike_petsc_tpu.parallel import (SolveCheckpoint, make_dist_solver,
                                      make_mesh, dist_spike_factor,
                                      resilient_solve)
from spike_petsc_tpu.solvers.types import CONVERGED_RTOL


def banded_of(acsr):
    data, kl, ku = hsp.csr_to_banded_arrays(acsr)
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)


def _problem(n=512, k=3, seed=7):
    a = problems.spd_banded(n, k, seed=seed)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(n)
    return a, banded_of(a), u, jnp.asarray(a @ u)


def test_segmented_matches_oneshot():
    a, bm, u, rhs = _problem()
    res = resilient_solve(bm, rhs, n_devices=8, parts_per_device=1,
                          block_b=8, rtol=1e-10, maxit=60, segment_its=5)
    assert res.reason == CONVERGED_RTOL
    assert res.failures == 0 and res.segments >= 1
    np.testing.assert_allclose(res.x, u, rtol=1e-7, atol=1e-8)
    # against the one-shot in-mesh solver
    mesh = make_mesh(8)
    dsf = dist_spike_factor(bm, mesh, block_b=8)
    ref = make_dist_solver(dsf, mesh, rtol=1e-10, maxit=60)(rhs)
    np.testing.assert_allclose(res.x, np.asarray(ref.x), rtol=1e-9,
                               atol=1e-10)


def test_checkpoint_resume(tmp_path):
    """Kill the run after one segment (simulated process death), then resume
    from the npz checkpoint and converge."""
    a, bm, u, rhs = _problem(seed=9)
    path = str(tmp_path / "solve.npz")

    class _Stop(RuntimeError):
        pass

    def die_after_first(segment):
        if segment >= 1:
            raise _Stop("simulated process death")

    # unpreconditioned CG so convergence genuinely spans many segments
    with pytest.raises(_Stop):
        resilient_solve(bm, rhs, n_devices=8, block_b=8, rtol=1e-8,
                        maxit=400, segment_its=3, ckpt_path=path,
                        ksp_type="cg", use_pc=False,
                        fault_injector=die_after_first, max_failures=0)
    st = SolveCheckpoint.load(path)
    assert st.segments >= 1 and st.its_done >= 1
    assert np.linalg.norm(st.x) > 0          # partial progress persisted

    res = resilient_solve(bm, rhs, n_devices=8, block_b=8, rtol=1e-8,
                          maxit=400, segment_its=50, ckpt_path=path,
                          ksp_type="cg", use_pc=False, resume=True)
    assert res.reason == CONVERGED_RTOL
    np.testing.assert_allclose(res.x, u, rtol=1e-5, atol=1e-6)


def test_device_failure_recovery():
    """Injected failure after the first segment with an explicit shrink
    policy: the solve rebuilds on a halved (4-device) mesh, re-factors
    there, resumes from the checkpointed iterate, and still converges."""
    a, bm, u, rhs = _problem(n=768, k=4, seed=3)
    fired = []

    def fail_once(segment):
        if segment == 0 and not fired:
            fired.append(True)
            raise RuntimeError("injected: DEVICE_SHUTTING_DOWN")

    res = resilient_solve(bm, rhs, n_devices=8, block_b=8, rtol=1e-10,
                          maxit=80, segment_its=4,
                          fault_injector=fail_once, max_failures=2,
                          on_failure=lambda ndev, exc: ndev // 2)
    assert res.failures == 1
    assert res.meshes_used[0] == (8,) and res.meshes_used[-1] == (4,)
    assert res.reason == CONVERGED_RTOL
    np.testing.assert_allclose(res.x, u, rtol=1e-7, atol=1e-8)


def test_transient_fault_retries_same_mesh():
    """Default policy re-probes device health before shrinking: an injected
    fault while every device still reports healthy retries at the SAME mesh
    size instead of permanently halving (VERDICT r2 weak #2)."""
    a, bm, u, rhs = _problem(n=768, k=4, seed=3)
    fired = []

    def fail_once(segment):
        if segment == 0 and not fired:
            fired.append(True)
            raise RuntimeError("injected: transient collective timeout")

    res = resilient_solve(bm, rhs, n_devices=8, block_b=8, rtol=1e-10,
                          maxit=80, segment_its=4,
                          fault_injector=fail_once, max_failures=2)
    assert res.failures == 1
    # the solver (and 8-device mesh) is REUSED — no rebuild, no shrink
    assert all(m == (8,) for m in res.meshes_used)
    assert res.reason == CONVERGED_RTOL
    np.testing.assert_allclose(res.x, u, rtol=1e-7, atol=1e-8)


def test_in_segment_failure_recovery(monkeypatch):
    """Failure raised from INSIDE the solver call (the np.asarray readback
    path, where a real device loss surfaces) — not from the post-segment
    fault hook.  Recovery must rebuild and still converge (VERDICT r2 #7)."""
    import spike_petsc_tpu.parallel.elastic as elastic_mod
    a, bm, u, rhs = _problem(n=768, k=4, seed=5)
    real_make = elastic_mod.make_dist_solver
    state = {"calls": 0}

    def flaky_make(dsf, mesh, **kw):
        solver = real_make(dsf, mesh, **kw)

        def wrapped(r, x0=None):
            state["calls"] += 1
            if state["calls"] == 1:
                # die mid-segment, before any checkpoint for it exists
                raise RuntimeError("injected: in-segment DEVICE_UNAVAILABLE")
            return solver(r, x0)
        return wrapped

    monkeypatch.setattr(elastic_mod, "make_dist_solver", flaky_make)
    res = resilient_solve(bm, rhs, n_devices=8, block_b=8, rtol=1e-10,
                          maxit=80, segment_its=4,
                          max_failures=2,
                          on_failure=lambda ndev, exc: ndev // 2)
    assert res.failures == 1
    assert res.meshes_used[0] == (8,) and res.meshes_used[-1] == (4,)
    assert res.reason == CONVERGED_RTOL
    np.testing.assert_allclose(res.x, u, rtol=1e-7, atol=1e-8)


def test_global_maxit_clamped():
    """The final segment's iteration budget is clamped so the GLOBAL maxit
    is exact, not rounded up to a segment multiple (ADVICE r2)."""
    a, bm, u, rhs = _problem()
    # unpreconditioned CG needs many iterations -> hits the maxit path
    res = resilient_solve(bm, rhs, n_devices=8, block_b=8, rtol=1e-14,
                          maxit=7, segment_its=5, ksp_type="cg",
                          use_pc=False)
    assert res.its <= 7


def test_persistent_fault_halves_after_one_same_size_retry():
    """When the health probe keeps reporting all devices alive but failures
    persist (a fault the probe cannot see), the default policy allows ONE
    same-size retry per failure streak and then halves the mesh anyway
    (code-review r3: len(jax.devices()) is a cached enumeration, so a real
    chip loss can look 'healthy' forever)."""
    a, bm, u, rhs = _problem(n=768, k=4, seed=5)
    fails = []

    def fail_twice(segment):
        if segment == 0 and len(fails) < 2:
            fails.append(True)
            raise RuntimeError("injected: persistent fault, healthy probe")

    res = resilient_solve(bm, rhs, n_devices=8, block_b=8, rtol=1e-10,
                          maxit=80, segment_its=4,
                          fault_injector=fail_twice, max_failures=3)
    assert res.failures == 2
    # first failure: same-size retry (8); second: halved mesh (4)
    assert (8,) in res.meshes_used and (4,) in res.meshes_used
    assert res.reason == CONVERGED_RTOL
    np.testing.assert_allclose(res.x, u, rtol=1e-7, atol=1e-8)


def test_multislice_slice_loss_recovery():
    """Elastic solves on a (slice, p) mesh: recovery drops whole slices —
    the unit a multi-host deployment loses — keeping the per-slice width
    fixed.  A persistent fault (healthy probe) retries once at full size,
    then drops to one slice and converges there."""
    a, bm, u, rhs = _problem(n=768, k=4, seed=8)
    fails = []

    def fail_twice(segment):
        if segment == 0 and len(fails) < 2:
            fails.append(True)
            raise RuntimeError("injected: slice fault")

    res = resilient_solve(bm, rhs, mesh_shape=(2, 4), block_b=8,
                          rtol=1e-10, maxit=80, segment_its=4,
                          fault_injector=fail_twice, max_failures=3)
    assert res.failures == 2
    assert (2, 4) in res.meshes_used and (1, 4) in res.meshes_used
    assert res.reason == CONVERGED_RTOL
    np.testing.assert_allclose(res.x, u, rtol=1e-7, atol=1e-8)


def test_multislice_checkpoint_resume(tmp_path):
    """Multislice elastic solves checkpoint/resume across processes like
    the 1-D path (the x0 thread through make_dist_solver_multislice)."""
    a, bm, u, rhs = _problem(n=512, k=3, seed=9)
    ck = str(tmp_path / "ms.npz")
    res1 = resilient_solve(bm, rhs, mesh_shape=(2, 4), block_b=8,
                           rtol=1e-30, maxit=3, segment_its=3,
                           ckpt_path=ck)
    assert res1.its == 3
    res2 = resilient_solve(bm, rhs, mesh_shape=(2, 4), block_b=8,
                           rtol=1e-10, maxit=80, segment_its=8,
                           ckpt_path=ck, resume=True)
    assert res2.reason == CONVERGED_RTOL
    np.testing.assert_allclose(res2.x, u, rtol=1e-7, atol=1e-8)


def test_resilient_serve_replica_loss_3d():
    """Elastic serving on the (rhs, slice, p) mesh: losing a replica costs
    throughput only — the batch is re-served on a rebuilt mesh with fewer
    replicas, same inner (slice, p) shape."""
    from spike_petsc_tpu.parallel import resilient_serve

    n, R = 512, 5
    a = problems.spd_banded(n, 3, seed=5)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    U = np.random.default_rng(0).standard_normal((R, n))
    B = (a @ U.T).T

    def inject(i):
        if i == 0:
            raise RuntimeError("injected replica loss")

    res = resilient_serve(bm, B, mesh_shape=(2, 2, 2), block_b=8,
                          ksp_type="richardson", rtol=1e-10, maxit=40,
                          fault_injector=inject,
                          on_failure=lambda c, e: (1,) + tuple(c[1:]))
    assert res.failures == 1
    assert res.meshes_used == [(2, 2, 2), (1, 2, 2)]
    rel = np.linalg.norm(res.X - U) / np.linalg.norm(U)
    assert rel < 1e-8, rel


def test_resilient_serve_2d_no_fault_pads_batch():
    """2-D (rhs, p) serving path: R not divisible by the rhs axis is padded
    with zero columns and trimmed; no-fault runs report a clean trail."""
    from spike_petsc_tpu.parallel import resilient_serve

    n, R = 512, 5
    a = problems.spd_banded(n, 3, seed=5)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    U = np.random.default_rng(1).standard_normal((R, n))
    res = resilient_serve(bm, (a @ U.T).T, mesh_shape=(2, 4), block_b=8,
                          ksp_type="preonly")
    assert res.failures == 0 and res.meshes_used == [(2, 4)]
    np.testing.assert_allclose(res.X, U, rtol=1e-8, atol=1e-9)


def test_resilient_serve_default_policy_transient_retry():
    """Default on_failure: when every device still answers the health probe
    the failure is treated as transient — one same-size retry, no replica
    dropped; a second consecutive failure drops a replica anyway."""
    from spike_petsc_tpu.parallel import resilient_serve

    n, R = 384, 4
    a = problems.spd_banded(n, 3, seed=6)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    U = np.random.default_rng(2).standard_normal((R, n))
    B = (a @ U.T).T

    def inject_once(i):
        if i == 0:
            raise RuntimeError("transient blip")

    res = resilient_serve(bm, B, mesh_shape=(2, 4), block_b=8,
                          ksp_type="preonly", fault_injector=inject_once)
    assert res.failures == 1
    assert res.meshes_used == [(2, 4)]          # same size retained
    np.testing.assert_allclose(res.X, U, rtol=1e-8, atol=1e-9)

    def inject_twice(i):
        if i <= 1:
            raise RuntimeError("persistent fault the probe cannot see")

    res2 = resilient_serve(bm, B, mesh_shape=(2, 4), block_b=8,
                           ksp_type="preonly", fault_injector=inject_twice,
                           max_failures=3)
    assert res2.failures == 2
    assert res2.meshes_used[-1] == (1, 4)       # forced replica drop
    np.testing.assert_allclose(res2.X, U, rtol=1e-8, atol=1e-9)


def test_resilient_serve_batched_krylov_engine():
    """Elastic serving with the batched bcgs engine (ksp_type='bcgs' now
    dispatches to bicgstab_many inside make_dist_solver_batched): replica
    loss still only costs throughput."""
    from spike_petsc_tpu.parallel.elastic import resilient_serve

    n = 384
    a = problems.nonsym_banded(n, 3, 3, seed=21)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    band = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    rng = np.random.default_rng(9)
    U = rng.standard_normal((4, n))
    B = np.stack([a @ U[i] for i in range(4)])
    res = resilient_serve(band, jnp.asarray(B), mesh_shape=(2, 4),
                          parts_per_device=2, block_b=8, ksp_type="bcgs",
                          rtol=1e-11, maxit=30)
    np.testing.assert_allclose(np.asarray(res.X), U, rtol=1e-7, atol=1e-8)
