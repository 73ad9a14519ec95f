"""The compiled Pallas sweep kernels on the CUDA card (marker ``gpu``).

The kernels have CPU tests in interpret mode (test_inverters.py,
test_spd.py); these run the code Triton compiles for the card at the block
size the flagship uses (b=128) and compare it with the XLA scan.  They skip
on the CPU; ``SPIKE_TEST_PLATFORM=cuda python -m pytest tests/ -m gpu`` runs
them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spike_petsc_tpu.ops.band import BandedMatrix, banded_transpose
from spike_petsc_tpu.ops.blocktri import cast_factor
from spike_petsc_tpu.ops.pallas.fused_sweep import (
    blocktri_solve_fused_many_pallas, blocktri_solve_fused_pallas)
from spike_petsc_tpu.ops.spike import (_batched_tri_solve, _resolve_impl,
                                       spike_factor, spike_solve,
                                       spike_solve_many)

pytestmark = pytest.mark.gpu


def _factor(method, store, n=8192, k=20, K=4):
    key = jax.random.PRNGKey(0)
    data = jax.random.uniform(key, (n, 2 * k + 1), jnp.float32, -1.0, 1.0)
    data = data.at[:, k].set(jnp.sum(jnp.abs(data), axis=1) + 1.0)
    band = BandedMatrix(data=data, kl=k, ku=k)
    if method == "spd":
        band = BandedMatrix(data=0.5 * (data + banded_transpose(band).data),
                            kl=k, ku=k)
    sf = spike_factor(band, K=K, block_b=128, method=method, inverter="lapack")
    fact = sf.fact if store == "f32" else cast_factor(sf.fact, jnp.bfloat16)
    return band, sf, fact


def _rel(a, b):
    return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))


@pytest.mark.parametrize("method,store", [("inv", "f32"), ("inv", "bf16"),
                                          ("spd", "f32")])
def test_sweep_kernel_matches_scan_on_card(method, store):
    _, sf, fact = _factor(method, store)
    r = jax.random.normal(jax.random.PRNGKey(1), (sf.K, sf.nb, sf.b),
                          jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = _batched_tri_solve(fact, r)
    assert _rel(blocktri_solve_fused_pallas(fact, r), ref) < 1e-5


@pytest.mark.parametrize("method,store", [("inv", "f32"), ("inv", "bf16"),
                                          ("spd", "f32")])
def test_many_kernel_matches_scan_on_card(method, store):
    """r=32 columns; bf16 tiles run their products in one TF32 pass (as the
    XLA scan does at DEFAULT precision), f32 tiles in three (TF32x3)."""
    _, sf, fact = _factor(method, store)
    R = jax.random.normal(jax.random.PRNGKey(2), (sf.K, sf.nb, sf.b, 32),
                          jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = _batched_tri_solve(fact, R)
    tol = 1e-5 if store == "f32" else 1e-3
    assert _rel(blocktri_solve_fused_many_pallas(fact, R), ref) < tol


def test_spike_solve_auto_takes_kernel_on_card():
    band, sf, _ = _factor("inv", "f32")
    assert _resolve_impl(sf, "auto") == "pallas_fused"
    u = jnp.ones((band.n,), jnp.float32)
    from spike_petsc_tpu.ops.band import banded_matvec
    b = banded_matvec(band, u)
    x = spike_solve(sf, b)
    assert _rel(x, spike_solve(sf, b, impl="xla")) < 1e-5
    np.testing.assert_allclose(np.asarray(x), np.asarray(u), atol=1e-3)
    B = jnp.stack([b, 2 * b], axis=1)
    X = spike_solve_many(sf, B)
    assert _rel(X, spike_solve_many(sf, B, impl="xla")) < 1e-5
    np.testing.assert_allclose(np.asarray(X[:, 1]), 2 * np.asarray(u),
                               atol=2e-3)


def test_platform_key_names_the_card():
    from spike_petsc_tpu.utils.platform import platform_key
    key = platform_key()
    assert key.startswith("gpu:") and len(key) > 4 and " " not in key
