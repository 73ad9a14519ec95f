"""Batched-inverse engines (blocktri.batched_inverse / newton_inv) and the
Pallas sweep kernels (ops/pallas/fused_sweep.py).

These tests pin the Newton–Schulz convergence contract on CPU in f64.  The
sweep kernels run in Pallas interpret mode here and are cross-checked
against blocktri_solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spike_petsc_tpu.ops.blocktri import (
    BlockTridiagonal, batched_inverse, blocktri_factor, blocktri_solve,
    cast_factor, newton_inv)
from spike_petsc_tpu.ops.pallas.fused_sweep import blocktri_solve_fused_pallas


def _dd_blocks(key, nb, b, dtype=jnp.float64, margin=0.5):
    S = jax.random.uniform(key, (nb, b, b), dtype, minval=-1.0, maxval=1.0)
    rs = jnp.sum(jnp.abs(S), axis=-1)
    return S.at[:, jnp.arange(b), jnp.arange(b)].set(rs + margin)


def test_newton_jacobi_dd_converges():
    S = _dd_blocks(jax.random.PRNGKey(0), 5, 16)
    X = newton_inv(S, max_steps=30)
    err = float(jnp.max(jnp.abs(S @ X - jnp.eye(16))))
    assert err < 1e-12


def test_newton_fixed_schedule_matches_adaptive():
    """Fixed cheap+polish schedule (no while_loop on the scan critical
    path) reaches the same accuracy as the adaptive iteration on the
    diagonally-dominant operating regime; gradients flow via the shared
    implicit JVP."""
    from spike_petsc_tpu.ops.blocktri import newton_inv_fixed

    S = _dd_blocks(jax.random.PRNGKey(4), 6, 16)
    X = newton_inv_fixed(S)
    err = float(jnp.max(jnp.abs(S @ X - jnp.eye(16))))
    assert err < 1e-12
    # implicit-JVP: d(S^-1) = -X dS X
    dS = jax.random.normal(jax.random.PRNGKey(5), S.shape, S.dtype) * 1e-3
    _, dX = jax.jvp(newton_inv_fixed, (S,), (dS,))
    expected = -(X @ dS @ X)
    np.testing.assert_allclose(np.asarray(dX), np.asarray(expected),
                               rtol=1e-8, atol=1e-12)
    # dispatch by name
    X2 = batched_inverse(S, inverter="newton_fixed")
    np.testing.assert_allclose(np.asarray(X2), np.asarray(X), rtol=1e-12)


def test_newton_pan_general():
    S = jax.random.normal(jax.random.PRNGKey(1), (4, 12, 12), jnp.float64)
    X = newton_inv(S, init="pan", max_steps=80)
    err = float(jnp.max(jnp.abs(S @ X - jnp.eye(12))))
    assert err < 1e-10


def test_newton_complex():
    key = jax.random.PRNGKey(2)
    S = _dd_blocks(key, 3, 8).astype(jnp.complex128)
    S = S + 0.1j * jax.random.normal(jax.random.fold_in(key, 1), (3, 8, 8))
    X = newton_inv(S, max_steps=30)
    err = float(jnp.max(jnp.abs(S @ X - jnp.eye(8))))
    assert err < 1e-12


def test_newton_singular_exits_finite_time():
    # all-zero blocks: the divergence guard must exit, not hang; output is
    # garbage by contract (factor_health is the detection layer)
    X = newton_inv(jnp.zeros((2, 8, 8)), max_steps=30)
    assert X.shape == (2, 8, 8)


def test_batched_inverse_engines_agree():
    S = _dd_blocks(jax.random.PRNGKey(3), 4, 32)
    Xl = batched_inverse(S, "lapack")
    Xb = batched_inverse(S, "blocked")
    Xn = batched_inverse(S, "newton")
    np.testing.assert_allclose(np.asarray(Xb), np.asarray(Xl), atol=1e-10)
    np.testing.assert_allclose(np.asarray(Xn), np.asarray(Xl), atol=1e-10)


def _factored(key, K, nb, b, dtype):
    def mk(k):
        D = (jax.random.uniform(k, (nb, b, b), dtype)
             + jnp.eye(b, dtype=dtype) * (2.0 * b))
        L = jax.random.uniform(jax.random.fold_in(k, 1), (nb, b, b),
                               dtype).at[0].set(0)
        U = jax.random.uniform(jax.random.fold_in(k, 2), (nb, b, b),
                               dtype).at[nb - 1].set(0)
        return BlockTridiagonal(D=D, L=L, U=U)
    ts = [mk(jax.random.fold_in(key, i)) for i in range(K)]
    T = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *ts)
    return jax.vmap(lambda t: blocktri_factor(t, method="inv"))(T)


def _kernel_vs_scan(fact, rhs):
    """The Pallas sweep kernel (interpret mode) against the XLA scan, both
    on f32 data; returns the max relative deviation."""
    x_ref = jax.vmap(blocktri_solve)(fact, rhs)
    x = blocktri_solve_fused_pallas(fact, rhs, interpret=True)
    assert x.dtype == jnp.float32
    return float(jnp.max(jnp.abs(x - x_ref)) / jnp.max(jnp.abs(x_ref)))


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_fused_sweep_matches_scan(store):
    """f32 factors and bf16-stored factors (promoted to f32 in registers)
    give the scan's answer to f32 rounding."""
    key = jax.random.PRNGKey(0)
    K, nb, b = 4, 7, 16
    fact = _factored(key, K, nb, b, jnp.float32)
    if store == "bf16":
        fact = cast_factor(fact, jnp.bfloat16)
    rhs = jax.random.uniform(jax.random.fold_in(key, 9), (K, nb, b),
                             jnp.float32)
    assert _kernel_vs_scan(fact, rhs) < 1e-5


def test_fused_sweep_single_block():
    key = jax.random.PRNGKey(4)
    fact = _factored(key, 2, 1, 16, jnp.float32)
    rhs = jax.random.uniform(jax.random.fold_in(key, 9), (2, 1, 16),
                             jnp.float32)
    assert _kernel_vs_scan(fact, rhs) < 1e-5


def test_fused_sweep_nb_smaller_than_nbuf():
    """A two-block chain: the in-kernel loops run a single step each."""
    key = jax.random.PRNGKey(5)
    fact = _factored(key, 2, 2, 32, jnp.float32)
    rhs = jax.random.uniform(jax.random.fold_in(key, 9), (2, 2, 32),
                             jnp.float32)
    assert _kernel_vs_scan(fact, rhs) < 1e-5


def test_fused_sweep_rejects_lu_factors():
    key = jax.random.PRNGKey(6)
    K, nb, b = 2, 3, 16

    def mk(k):
        D = (jax.random.uniform(k, (nb, b, b), jnp.float32)
             + jnp.eye(b) * (2.0 * b))
        return BlockTridiagonal(D=D, L=jnp.zeros((nb, b, b)),
                                U=jnp.zeros((nb, b, b)))
    T = jax.tree_util.tree_map(
        lambda *x: jnp.stack(x),
        *[mk(jax.random.fold_in(key, i)) for i in range(K)])
    fact = jax.vmap(lambda t: blocktri_factor(t, method="lu"))(T)
    with pytest.raises(ValueError, match="inv"):
        blocktri_solve_fused_pallas(fact, jnp.zeros((K, nb, b), jnp.float32),
                                    interpret=True)


def test_spike_factor_inverter_newton_end_to_end():
    from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
    from spike_petsc_tpu.ops.spike import spike_factor, spike_solve

    n, hw = 600, 5
    key = jax.random.PRNGKey(7)
    w = 2 * hw + 1
    data = jax.random.uniform(key, (n, w), jnp.float64, minval=-1, maxval=1)
    data = data.at[:, hw].set(jnp.sum(jnp.abs(data), axis=1) + 1.0)
    band = BandedMatrix(data=data, kl=hw, ku=hw)
    x_true = jnp.ones((n,), jnp.float64)
    rhs = banded_matvec(band, x_true)
    for method in ("inv", "cr"):
        sf = spike_factor(band, K=4, block_b=8, method=method,
                          inverter="newton")
        x = spike_solve(sf, rhs)
        assert float(jnp.max(jnp.abs(x - x_true))) < 1e-9, method


def _f32_band(n, hw, seed):
    from spike_petsc_tpu.ops.band import BandedMatrix
    key = jax.random.PRNGKey(seed)
    data = jax.random.uniform(key, (n, 2 * hw + 1), jnp.float32, minval=-1,
                              maxval=1)
    data = data.at[:, hw].set(jnp.sum(jnp.abs(data), axis=1) + 1.0)
    return BandedMatrix(data=data, kl=hw, ku=hw)


def test_fused_many_matches_xla():
    from spike_petsc_tpu.ops.band import banded_matvec
    from spike_petsc_tpu.ops.spike import spike_factor, spike_solve_many

    n = 600
    band = _f32_band(n, 5, 11)
    X = jax.random.uniform(jax.random.PRNGKey(1), (n, 4), jnp.float32)
    B = jax.vmap(lambda x: banded_matvec(band, x), in_axes=1, out_axes=1)(X)
    sf = spike_factor(band, K=4, block_b=16)
    x_xla = spike_solve_many(sf, B, impl="xla")
    x_pal = spike_solve_many(sf, B, impl="pallas_fused", interpret=True)
    np.testing.assert_allclose(np.asarray(x_pal), np.asarray(x_xla),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(x_pal), np.asarray(X), atol=1e-4)


def test_fused_many_rhs_chunking():
    """Each program sweeps 16 columns: r=40 is zero-padded to 48 and split
    over three programs per partition, and r=5 fits one padded program;
    both give the scan's answer at the caller's width."""
    from spike_petsc_tpu.ops.pallas import fused_sweep

    key = jax.random.PRNGKey(13)
    K, nb, b = 2, 5, 16
    fact = _factored(key, K, nb, b, jnp.float32)
    for r in (40, 5):
        R = jax.random.uniform(jax.random.fold_in(key, r), (K, nb, b, r),
                               jnp.float32)
        x_ref = jax.vmap(blocktri_solve)(fact, R)
        x = fused_sweep.blocktri_solve_fused_many_pallas(fact, R,
                                                         interpret=True)
        assert x.shape == (K, nb, b, r)
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                                   rtol=1e-5, atol=1e-5)


def test_pallas_impl_rejects_cr_factors():
    from spike_petsc_tpu.ops.spike import (spike_factor, spike_solve,
                                           spike_solve_many)

    n = 256
    sf = spike_factor(_f32_band(n, 3, 12), K=4, block_b=16, method="cr")
    with pytest.raises(ValueError, match="method='inv'"):
        spike_solve(sf, jnp.ones((n,), jnp.float32), impl="pallas_fused",
                    interpret=True)
    with pytest.raises(ValueError, match="method='inv'"):
        spike_solve_many(sf, jnp.ones((n, 2), jnp.float32),
                         impl="pallas_fused", interpret=True)


def test_auto_impl_falls_back_when_vmem_infeasible(monkeypatch):
    """'auto' asks the platform seam: the XLA scan off the GPU; on a GPU
    the kernels for f32/bf16 inv factors with an f32 rhs, the scan for
    anything they do not cover (f64 right-hand sides, odd block sizes).
    An explicit 'pallas_fused' off the GPU raises instead of running the
    interpreter."""
    from spike_petsc_tpu.ops import spike as spk
    from spike_petsc_tpu.utils import platform

    sf = spk.spike_factor(_f32_band(512, 3, 2), K=4, block_b=16)
    assert spk._resolve_impl(sf, "auto") == "xla"
    with pytest.raises(ValueError, match="CUDA GPU kernel"):
        spk._resolve_impl(sf, "pallas_fused")
    with pytest.raises(ValueError, match="unknown solve impl"):
        spk._resolve_impl(sf, "pallas")
    assert spk._resolve_impl(sf, "pallas_fused", interpret=True) == \
        "pallas_fused"
    monkeypatch.setattr(platform, "gpu_kernels_available", lambda: True)
    assert spk._resolve_impl(sf, "auto") == "pallas_fused"
    assert spk._resolve_impl(sf, "auto", jnp.float64) == "xla"
    sf12 = spk.spike_factor(_f32_band(512, 3, 2), K=4, block_b=12)
    assert spk._resolve_impl(sf12, "auto") == "xla"


def test_newton_probe_covers_fixed_engine():
    """The PC safety-net probe must fire for every newton-family engine —
    especially 'newton_fixed', which has no internal convergence check."""
    from spike_petsc_tpu.solvers.pc import _newton_probe_active
    assert _newton_probe_active("newton")
    assert _newton_probe_active("newton_fixed")
    assert _newton_probe_active("newton_pan")
    assert not _newton_probe_active("blocked")
    assert not _newton_probe_active("lapack")
