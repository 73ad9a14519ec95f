"""Banded matvec on band storage (ops/band.py banded_matvec) — the operator
SpMV of every Krylov solve — against dense NumPy references, in f32, bf16
storage and native f64, plus the operator-route plumbing around it."""

import numpy as np
import pytest

import jax.numpy as jnp

from spike_petsc_tpu.ops.band import (BandedMatrix, banded_matvec,
                                      banded_matvec_t, banded_to_dense)
from spike_petsc_tpu.solvers.operator import as_matvec, as_matvec_split


def _band(n, kl, ku, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = kl + ku + 1
    data = rng.standard_normal((n, w)).astype(dtype)
    i = np.arange(n)[:, None]
    col = i + np.arange(w)[None, :] - kl
    data = np.where((col >= 0) & (col < n), data, 0).astype(dtype)
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)


def _dense(bm):
    return np.asarray(banded_to_dense(bm)).astype(np.float64)


@pytest.mark.parametrize("n,kl,ku", [
    (1024, 6, 6),        # narrow symmetric
    (2000, 0, 3),        # upper-only
    (3000, 5, 0),        # lower-only
    (1500, 150, 80),     # asymmetric wide
    (999, 1, 1),         # tridiagonal, odd n
    (4096, 100, 100),    # the flagship band shape (scaled down)
])
def test_matches_dense_reference(n, kl, ku):
    bm = _band(n, kl, ku)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    ref = _dense(bm) @ x
    got = np.asarray(banded_matvec(bm, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=2e-5,
                               atol=2e-5 * np.max(np.abs(ref)))


@pytest.mark.parametrize("n,kl,ku", [(1024, 6, 6), (1500, 150, 80),
                                     (4096, 100, 100)])
def test_native_f64_matches_numpy(n, kl, ku):
    """Native f64 (the refinement residual engine): agreement with a
    NumPy f64 product to rounding."""
    bm = _band(n, kl, ku, seed=7, dtype=np.float64)
    x = np.random.default_rng(8).standard_normal(n)
    ref = _dense(bm) @ x
    got = banded_matvec(bm, jnp.asarray(x))
    assert got.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(ref)))


def test_multi_rhs_columns():
    bm = _band(777, 9, 4, seed=2)
    X = np.random.default_rng(3).standard_normal((777, 5)).astype(np.float32)
    got = np.asarray(banded_matvec(bm, jnp.asarray(X)))
    np.testing.assert_allclose(got, _dense(bm) @ X, rtol=2e-5, atol=2e-4)


def test_bf16_storage_promotes_to_f32_accumulation():
    bm = _band(1024, 4, 4, seed=4)
    bm16 = BandedMatrix(data=bm.data.astype(jnp.bfloat16), kl=4, ku=4)
    x = jnp.asarray(np.random.default_rng(5).standard_normal(1024),
                    jnp.float32)
    got = banded_matvec(bm16, x)
    assert got.dtype == jnp.float32
    ref = _dense(BandedMatrix(data=bm16.data.astype(jnp.float32), kl=4,
                              ku=4)) @ np.asarray(x)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5)


def test_very_wide_band_loop_path():
    """w > 512 takes the fori_loop over diagonals (bounded program size)."""
    bm = _band(1200, 300, 260, seed=6)
    x = np.random.default_rng(6).standard_normal(1200).astype(np.float32)
    ref = _dense(bm) @ x
    np.testing.assert_allclose(np.asarray(banded_matvec(bm, jnp.asarray(x))),
                               ref, rtol=2e-5,
                               atol=2e-5 * np.max(np.abs(ref)))


def test_matvec_t_is_transpose():
    bm = _band(900, 7, 3, seed=9, dtype=np.float64)
    x = np.random.default_rng(10).standard_normal(900)
    np.testing.assert_allclose(np.asarray(banded_matvec_t(bm, jnp.asarray(x))),
                               _dense(bm).T @ x, rtol=1e-12, atol=1e-12)


def test_operator_routes_agree():
    """'auto' (no tuning record: the band form) and the explicit routes
    compute the same product; the closure-free split form matches."""
    bm = _band(2048, 20, 20, seed=11)
    x = jnp.asarray(np.random.default_rng(12).standard_normal(2048),
                    jnp.float32)
    ref = np.asarray(banded_matvec(bm, x))
    for impl, route in (("auto", "xla"), ("xla", "xla"),
                        ("blocktri", "blocktri")):
        mv, n, _ = as_matvec(bm, impl=impl)
        assert n == 2048 and mv._route == route
        np.testing.assert_allclose(np.asarray(mv(x)), ref, rtol=2e-5,
                                   atol=2e-4)
        apply, operand, _, _ = as_matvec_split(bm, impl=impl)
        np.testing.assert_allclose(np.asarray(apply(operand, x)), ref,
                                   rtol=2e-5, atol=2e-4)


def test_explicit_blocktri_raises_where_conversion_does_not_apply():
    """An explicit route runs what it names or raises: the 128-blocked
    conversion takes neither half-bandwidths above 128 nor f64 bands."""
    with pytest.raises(ValueError, match="blocktri"):
        as_matvec(_band(2048, 150, 10), impl="blocktri")
    with pytest.raises(ValueError, match="blocktri"):
        as_matvec(_band(2048, 5, 5, dtype=np.float64), impl="blocktri")
    with pytest.raises(ValueError, match="unknown matvec impl"):
        as_matvec(_band(2048, 5, 5), impl="banded_pallas")
