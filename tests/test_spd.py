"""Symmetric (method='spd') block-LDL^H factorization path.

The SPD half of the solver surface: blocktri_factor(method='spd') stores
only F + Sinv (2/3 of 'inv' factor memory), is its own transpose, and
threads through spike_factor / the PC layer as ``-pc_type cholesky``
(PETSc PCCHOLESKY role — the reference reaches it through PETSc's options
database, /root/reference/src/makefile:17-18).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.linalg as sla

from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
from spike_petsc_tpu.ops.blocktri import (BlockTridiagonal, blocktri_factor,
                                          blocktri_solve,
                                          blocktri_solve_transpose,
                                          blocktri_to_dense, cast_factor)
from spike_petsc_tpu.ops.spike import (spike_factor, spike_solve,
                                       spike_solve_many, spike_transpose)


def banded_of(acsr):
    data, kl, ku = hsp.csr_to_banded_arrays(acsr)
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku), kl, ku


def _spd_blocktri(nb, b, seed=0, dtype=np.float64):
    """Random SPD block-tridiagonal: A = G G^T + diag boost, G banded."""
    rng = np.random.default_rng(seed)
    n = nb * b
    a = np.zeros((n, n), dtype)
    for i in range(nb):
        d = rng.standard_normal((b, b))
        a[i * b:(i + 1) * b, i * b:(i + 1) * b] = d + d.T
        if i + 1 < nb:
            l = 0.3 * rng.standard_normal((b, b))
            a[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = l
            a[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = l.T
    a += np.eye(n) * (np.abs(a).sum(axis=1).max() + 1.0)
    D = np.stack([a[i * b:(i + 1) * b, i * b:(i + 1) * b] for i in range(nb)])
    L = np.stack([a[i * b:(i + 1) * b, (i - 1) * b:i * b] if i else
                  np.zeros((b, b)) for i in range(nb)])
    U = np.stack([a[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b]
                  if i + 1 < nb else np.zeros((b, b)) for i in range(nb)])
    t = BlockTridiagonal(D=jnp.asarray(D), L=jnp.asarray(L),
                         U=jnp.asarray(U))
    return t, a


@pytest.mark.parametrize("inverter", ["lapack", "blocked"])
def test_blocktri_spd_matches_dense(inverter):
    t, a = _spd_blocktri(6, 8, seed=3)
    fact = blocktri_factor(t, method="spd", inverter=inverter)
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal((6, 8))
    x = np.asarray(blocktri_solve(fact, jnp.asarray(rhs)))
    xd = np.linalg.solve(a, rhs.reshape(-1))
    np.testing.assert_allclose(x.reshape(-1), xd, rtol=1e-10, atol=1e-10)


def test_spd_factor_stores_two_arrays():
    t, _ = _spd_blocktri(5, 8)
    fact = blocktri_factor(t, method="spd")
    assert fact.method == "spd"
    assert fact.U.size == 0 and fact.Slu.size == 0 and fact.piv.size == 0
    assert fact.F.shape == (5, 8, 8) and fact.Sinv.shape == (5, 8, 8)


def test_spd_solve_matches_inv_solve():
    t, a = _spd_blocktri(4, 8, seed=7)
    f_spd = blocktri_factor(t, method="spd")
    f_inv = blocktri_factor(t, method="inv")
    rhs = np.random.default_rng(1).standard_normal((4, 8))
    xs = np.asarray(blocktri_solve(f_spd, jnp.asarray(rhs)))
    xi = np.asarray(blocktri_solve(f_inv, jnp.asarray(rhs)))
    np.testing.assert_allclose(xs, xi, rtol=1e-11, atol=1e-12)


def test_spd_transpose_is_forward_solve():
    t, a = _spd_blocktri(4, 8, seed=9)
    fact = blocktri_factor(t, method="spd")
    rhs = np.random.default_rng(2).standard_normal((4, 8))
    xt = np.asarray(blocktri_solve_transpose(fact, jnp.asarray(rhs)))
    xd = np.linalg.solve(a.T, rhs.reshape(-1))
    np.testing.assert_allclose(xt.reshape(-1), xd, rtol=1e-10, atol=1e-10)


def test_spd_hermitian_complex():
    rng = np.random.default_rng(4)
    nb, b = 4, 6
    n = nb * b
    g = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    # Hermitian banded (block-tridiagonal) matrix
    a = g + g.conj().T
    for i in range(n):
        for j in range(n):
            if abs(i // b - j // b) > 1:
                a[i, j] = 0.0
    a += np.eye(n) * (np.abs(a).sum(axis=1).max() + 1.0)
    D = np.stack([a[i * b:(i + 1) * b, i * b:(i + 1) * b] for i in range(nb)])
    L = np.stack([a[i * b:(i + 1) * b, (i - 1) * b:i * b] if i else
                  np.zeros((b, b), complex) for i in range(nb)])
    U = np.stack([a[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b]
                  if i + 1 < nb else np.zeros((b, b), complex)
                  for i in range(nb)])
    t = BlockTridiagonal(D=jnp.asarray(D), L=jnp.asarray(L),
                         U=jnp.asarray(U))
    fact = blocktri_factor(t, method="spd", inverter="lapack")
    rhs = (rng.standard_normal((nb, b))
           + 1j * rng.standard_normal((nb, b)))
    x = np.asarray(blocktri_solve(fact, jnp.asarray(rhs)))
    np.testing.assert_allclose(x.reshape(-1),
                               np.linalg.solve(a, rhs.reshape(-1)),
                               rtol=1e-10, atol=1e-10)
    # pure-transpose solve: A^T x = r (A^T = conj(A) for Hermitian A)
    xt = np.asarray(blocktri_solve_transpose(fact, jnp.asarray(rhs)))
    np.testing.assert_allclose(xt.reshape(-1),
                               np.linalg.solve(a.T, rhs.reshape(-1)),
                               rtol=1e-10, atol=1e-10)


def scipy_solve(acsr, rhs):
    kl, ku = hsp.compute_half_bandwidths(acsr)
    n = acsr.shape[0]
    ab = np.zeros((kl + ku + 1, n))
    a = acsr.toarray()
    for d in range(-kl, ku + 1):
        ab[ku - d, max(0, d):n + min(0, d)] = np.diag(a, d)
    return sla.solve_banded((kl, ku), ab, rhs)


@pytest.mark.parametrize("K,block_b", [(1, None), (4, 8), (8, 16)])
def test_spike_spd_method(K, block_b):
    n, k = 512, 5
    a = problems.spd_banded(n, k, seed=11)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=K, block_b=block_b, method="spd")
    u = np.random.default_rng(0).standard_normal(n)
    x = np.asarray(spike_solve(sf, jnp.asarray(a @ u)))
    np.testing.assert_allclose(x, u, rtol=1e-8, atol=1e-9)


def test_spike_spd_stored_spikes_and_many():
    n, k = 384, 4
    a = problems.spd_banded(n, k, seed=13)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=4, block_b=8, method="spd", store_spikes=True)
    rng = np.random.default_rng(3)
    U = rng.standard_normal((n, 3))
    B = np.asarray(a @ U)
    X = np.asarray(spike_solve_many(sf, jnp.asarray(B)))
    np.testing.assert_allclose(X, U, rtol=1e-8, atol=1e-9)


def test_spike_spd_self_transpose():
    n, k = 256, 3
    a = problems.spd_banded(n, k, seed=17)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=4, block_b=8, method="spd")
    sft = spike_transpose(sf)
    assert sft is sf          # real symmetric: zero-cost transpose
    u = np.random.default_rng(5).standard_normal(n)
    x = np.asarray(spike_solve(sft, jnp.asarray(a @ u)))
    np.testing.assert_allclose(x, u, rtol=1e-8, atol=1e-9)


def test_spd_cast_factor_bf16():
    t, a = _spd_blocktri(4, 8, seed=21)
    fact = cast_factor(blocktri_factor(t, method="spd"), jnp.bfloat16)
    rhs = np.random.default_rng(6).standard_normal((4, 8))
    x = np.asarray(blocktri_solve(fact, jnp.asarray(rhs, dtype=np.float32)))
    xd = np.linalg.solve(a, rhs.reshape(-1))
    # bf16 factors: preconditioner-grade accuracy
    assert np.linalg.norm(x.reshape(-1) - xd) / np.linalg.norm(xd) < 5e-2


def test_pc_cholesky_through_solve():
    from spike_petsc_tpu.solvers.ksp import solve
    from spike_petsc_tpu.utils.options import Options

    n, k = 400, 4
    a = problems.spd_banded(n, k, seed=23)
    bm, _, _ = banded_of(a)
    u = np.ones(n)
    rhs = jnp.asarray(a @ u)
    res = solve(bm, rhs, options=Options(
        {"ksp_type": "cg", "pc_type": "cholesky", "ksp_rtol": 1e-10}))
    assert int(res.its) <= 2
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-8, atol=1e-8)


def test_pc_cholesky_partitioned_and_transpose_apply():
    from spike_petsc_tpu.solvers.pc import make_pc
    from spike_petsc_tpu.utils.options import Options

    n, k = 512, 5
    a = problems.spd_banded(n, k, seed=29)
    bm, _, _ = banded_of(a)
    pc = make_pc("cholesky", bm, Options({"pc_cholesky_partitions": "4",
                                          "pc_cholesky_block": "16"}))
    assert pc.info["method"] == "spd" and pc.info["partitions"] == 4
    rng = np.random.default_rng(7)
    r = rng.standard_normal(n)
    y = np.asarray(pc.apply(jnp.asarray(r)))
    np.testing.assert_allclose(a @ y, r, rtol=1e-8, atol=1e-8)
    yt = np.asarray(pc.transpose().apply(jnp.asarray(r)))
    np.testing.assert_allclose(yt, y, rtol=1e-12, atol=1e-12)


def test_spd_checkpoint_roundtrip(tmp_path):
    from spike_petsc_tpu.io import load_factorization, save_factorization

    n, k = 256, 3
    a = problems.spd_banded(n, k, seed=31)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=4, block_b=8, method="spd", store_spikes=True)
    path = str(tmp_path / "spd_factor.npz")
    save_factorization(path, sf)
    sf2 = load_factorization(path)
    assert sf2.fact.method == "spd"
    rhs = np.random.default_rng(8).standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(spike_solve(sf2, jnp.asarray(rhs))),
        np.asarray(spike_solve(sf, jnp.asarray(rhs))), rtol=1e-13,
        atol=1e-13)


def test_spd_shift_guard():
    # a symmetric matrix with a tiny leading pivot: shift='nonzero' boosts it
    t, _ = _spd_blocktri(3, 4, seed=37)
    D = t.D.at[0].set(jnp.zeros((4, 4)))
    t2 = BlockTridiagonal(D=D, L=t.L, U=t.U)
    fact = blocktri_factor(t2, method="spd", shift="nonzero",
                           inverter="lapack")
    assert int(fact.nshift) >= 1
    x = blocktri_solve(fact, jnp.ones((3, 4)))
    assert bool(jnp.all(jnp.isfinite(x)))


def _f32_banded_of(acsr):
    bm, kl, ku = banded_of(acsr)
    return BandedMatrix(data=bm.data.astype(jnp.float32), kl=kl, ku=ku)


def test_spd_fused_pallas_matches_xla():
    """The spd kernel variant (transposed-F backward sweep) matches the XLA
    scan to f32 rounding in interpret mode, single- and multi-RHS."""
    from spike_petsc_tpu.ops.pallas.fused_sweep import (
        blocktri_solve_fused_pallas, blocktri_solve_fused_many_pallas)

    n, k, K, b = 512, 3, 4, 16
    bm = _f32_banded_of(problems.spd_banded(n, k, seed=51))
    sf = spike_factor(bm, K=K, block_b=b, method="spd")
    rng = np.random.default_rng(9)
    rblk = jnp.asarray(rng.standard_normal((K, sf.nb, sf.b)), jnp.float32)
    x_ref = jax.vmap(blocktri_solve)(sf.fact, rblk)
    x_pl = blocktri_solve_fused_pallas(sf.fact, rblk, interpret=True)
    np.testing.assert_allclose(np.asarray(x_pl), np.asarray(x_ref),
                               rtol=1e-5, atol=1e-6)
    # multi-RHS
    R = jnp.asarray(rng.standard_normal((K, sf.nb, sf.b, 3)), jnp.float32)
    X_ref = jax.vmap(blocktri_solve)(sf.fact, R)
    X_pl = blocktri_solve_fused_many_pallas(sf.fact, R, interpret=True)
    np.testing.assert_allclose(np.asarray(X_pl), np.asarray(X_ref),
                               rtol=1e-5, atol=1e-6)


def test_spd_spike_solve_pallas_fused_impl():
    """spike_solve(impl='pallas_fused') end-to-end on spd factors."""
    n, k = 384, 4
    a = problems.spd_banded(n, k, seed=53)
    sf = spike_factor(_f32_banded_of(a), K=4, block_b=16, method="spd",
                      store_spikes=True)
    u = np.random.default_rng(10).standard_normal(n)
    x = np.asarray(spike_solve(sf, jnp.asarray(a @ u, jnp.float32),
                               impl="pallas_fused", interpret=True))
    np.testing.assert_allclose(x, u, rtol=1e-4, atol=1e-4)
    X = np.asarray(spike_solve_many(
        sf, jnp.asarray(a @ np.ones((n, 2)), jnp.float32),
        impl="pallas_fused", interpret=True))
    np.testing.assert_allclose(X, np.ones((n, 2)), rtol=1e-4, atol=1e-4)


def test_spike_spd_grouped_matches_monolithic():
    from spike_petsc_tpu.ops.spike import spike_factor_grouped

    n, k = 512, 4
    a = problems.spd_banded(n, k, seed=57)
    bm, _, _ = banded_of(a)
    sf_m = spike_factor(bm, K=8, block_b=8, method="spd")
    sf_g = spike_factor_grouped(bm, K=8, groups=4, block_b=8, method="spd")
    rhs = jnp.asarray(np.random.default_rng(12).standard_normal(n))
    np.testing.assert_allclose(np.asarray(spike_solve(sf_g, rhs)),
                               np.asarray(spike_solve(sf_m, rhs)),
                               rtol=1e-12, atol=1e-12)
