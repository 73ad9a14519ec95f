"""Measured-route tuning records (utils/tuning.py): tools/tune.py writes
winners per card, as_matvec('auto') follows them, the band form remains the
fallback."""

import json

import numpy as np
import jax.numpy as jnp

from spike_petsc_tpu import BandedMatrix
from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.solvers.operator import as_matvec
from spike_petsc_tpu.utils import tuning


def banded_of(acsr):
    data, kl, ku = hsp.csr_to_banded_arrays(acsr)
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)


H100 = "gpu:h100-80gb-hbm3"


def test_route_hint_nearest_bandwidth(tmp_path, monkeypatch):
    import numpy as np

    monkeypatch.setenv("SPIKE_TUNING_FILE", str(tmp_path / "t.json"))
    tuning.update(H100, "banded_matvec", tuning.matvec_key(201, np.float32),
                  {"winner": "blocktri", "xla_ms": 0.9, "blocktri_ms": 0.7,
                   "n": 1_000_000})
    tuning.update(H100, "banded_matvec", tuning.matvec_key(13, np.float32),
                  {"winner": "xla", "xla_ms": 0.1, "n": 1_000_000})
    f32 = np.float32
    hint = tuning.matvec_route_hint
    assert hint(H100, 201, f32, 1_000_000) == "blocktri"
    assert hint(H100, 150, f32, 1_000_000) == "blocktri"       # within 2x
    assert hint(H100, 17, f32, 1_000_000) == "xla"
    assert hint(H100, 50, f32, 1_000_000) is None      # >2x from both
    assert hint("cpu", 201, f32, 1_000_000) is None     # other platform
    # dtype and problem-size gates: a winner measured at f32/n=1e6 must not
    # route f64 operators or tiny systems
    assert hint(H100, 201, np.float64, 1_000_000) is None
    assert hint(H100, 201, f32, 300) is None


def test_generation_keyed_records_loud_fallback(tmp_path, monkeypatch):
    """Tuning records are keyed by the card (platform_key); another card's
    measurements never apply silently — one RuntimeWarning announces the
    default-route fallback."""
    import warnings

    import pytest

    monkeypatch.setenv("SPIKE_TUNING_FILE", str(tmp_path / "t.json"))
    f32 = np.float32
    tuning.update(H100, "banded_matvec", tuning.matvec_key(201, f32),
                  {"winner": "blocktri", "n": 1_000_000})
    assert tuning.matvec_route_hint(H100, 201, f32, 1_000_000) == "blocktri"
    # another card sees the H100 record but must not inherit it
    other = "gpu:h200"
    tuning._warned_platforms.discard(other)
    with pytest.warns(RuntimeWarning, match=other):
        assert tuning.matvec_route_hint(other, 201, f32, 1_000_000) is None
    # warn once per platform, not per lookup
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tuning.matvec_route_hint(other, 201, f32, 1_000_000) is None
    # a bare "gpu" record (no card named) likewise triggers the fallback
    tuning.update("gpu", "banded_matvec", tuning.matvec_key(13, f32),
                  {"winner": "xla", "n": 4096})
    tuning._warned_platforms.discard("gpu:a100-sxm4-80gb")
    with pytest.warns(RuntimeWarning):
        assert tuning.matvec_route_hint("gpu:a100-sxm4-80gb", 13, f32,
                                        4096) is None
    # the CPU backend stays silent (its absence is not a hardware gap)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tuning.matvec_route_hint("cpu", 201, f32, 1_000_000) is None


def test_platform_key_cpu_backend():
    assert tuning.platform_key() == "cpu"   # tests pin JAX_PLATFORMS=cpu


def test_dist_matvec_impl_auto_resolution(monkeypatch):
    """platform_key on a faked H100: the GPU key names the card, so a
    record measured on it never applies to another card."""
    import jax

    from spike_petsc_tpu.utils import platform

    class _Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(platform, "backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev()])
    assert platform.platform_key() == H100
    assert tuning.platform_key() == H100
    _Dev.device_kind = "NVIDIA H200"
    assert platform.platform_key() == "gpu:h200"


def test_auto_follows_recorded_winner(tmp_path, monkeypatch):
    """A recorded winner overrides the default: a band that 'auto' runs on
    band storage routes through the blocktri conversion when this card's
    record says it wins here."""
    monkeypatch.setenv("SPIKE_TUNING_FILE", str(tmp_path / "t.json"))
    a = problems.nonsym_banded(4096, 3, 3, seed=1)
    A = banded_of(a)
    A = BandedMatrix(data=A.data.astype(jnp.float32), kl=A.kl, ku=A.ku)
    mv, n, _ = as_matvec(A, impl="auto")
    assert getattr(mv, "_route", None) == "xla"      # default route
    tuning.update(tuning.platform_key(), "banded_matvec",
                  tuning.matvec_key(7, jnp.float32),
                  {"winner": "blocktri", "blocktri_ms": 0.1, "n": 4096})
    mv2, _, _ = as_matvec(A, impl="auto")
    assert getattr(mv2, "_route", None) == "blocktri"
    # both routes compute the same product
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n), jnp.float32)
    np.testing.assert_allclose(np.asarray(mv(x)), np.asarray(mv2(x)),
                               rtol=1e-5, atol=1e-5)


def test_auto_ignores_infeasible_recorded_winner(tmp_path, monkeypatch):
    """A record naming a route that is infeasible for this operator (the
    blocktri conversion takes no f64 band) falls back to the band form
    instead of crashing or mis-routing."""
    monkeypatch.setenv("SPIKE_TUNING_FILE", str(tmp_path / "t.json"))
    a = problems.nonsym_banded(1000, 2, 2, seed=2)
    A = banded_of(a)                                   # f64 under x64
    tuning.update(tuning.platform_key(), "banded_matvec",
                  tuning.matvec_key(5, jnp.float64),
                  {"winner": "blocktri", "n": 1000})
    mv, _, _ = as_matvec(A, impl="auto")
    assert getattr(mv, "_route", None) == "xla"


def test_update_merges_and_is_atomic(tmp_path, monkeypatch):
    monkeypatch.setenv("SPIKE_TUNING_FILE", str(tmp_path / "t.json"))
    tuning.update(H100, "banded_matvec", "201:float32",
                  {"winner": "blocktri"})
    tuning.update(H100, "banded_matvec", "13:float32", {"winner": "xla"})
    tuning.update("cpu", "banded_matvec", "201:float32", {"winner": "xla"})
    with open(tmp_path / "t.json") as f:
        data = json.load(f)
    assert set(data) == {H100, "cpu"}
    assert set(data[H100]["banded_matvec"]) == {"201:float32",
                                                "13:float32"}


def test_as_matvec_split_parity_and_operand_timing():
    """as_matvec_split returns the closure-free (apply, operand) pair with
    exact parity to as_matvec on every route, and measure_matvec_ms accepts
    the explicit-operand form (the operator is a jit argument, not a
    GB-sized program constant)."""
    import jax

    from spike_petsc_tpu.solvers.operator import as_matvec_split

    n, kk = 2048, 3
    a = problems.nonsym_banded(n, kk, kk, seed=4)
    A64 = banded_of(a)
    A32 = BandedMatrix(data=A64.data.astype(jnp.float32), kl=kk, ku=kk)
    x64 = jnp.asarray(np.random.default_rng(1).standard_normal(n))
    # f64 on the band form; the blocktri conversion takes f32 bands
    for impl, A, x, tol in (("auto", A64, x64, 1e-12),
                            ("xla", A64, x64, 1e-12),
                            ("blocktri", A32, x64.astype(jnp.float32), 1e-6)):
        mv, _, _ = as_matvec(A, impl=impl)
        apply, operand, n_out, dt = as_matvec_split(A, impl=impl)
        assert n_out == n
        assert apply._route == mv._route
        np.testing.assert_allclose(np.asarray(apply(operand, x)),
                                   np.asarray(mv(x)),
                                   rtol=tol, atol=tol)
        # operand is a pytree passable as an explicit jit argument
        y = jax.jit(apply)(operand, x)
        np.testing.assert_allclose(np.asarray(y), np.asarray(mv(x)),
                                   rtol=tol, atol=tol)
    apply, operand, _, _ = as_matvec_split(A64, impl="xla")
    ms = tuning.measure_matvec_ms(apply, x64, reps=4, operand=operand)
    assert ms > 0
