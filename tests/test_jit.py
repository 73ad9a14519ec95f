"""``utils.jit.jit_closure``: closed-over arrays enter the compiled program
as arguments, never as embedded constants (which at production sizes make
XLA compile for minutes and cannot be placed on a mesh)."""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spike_petsc_tpu.utils.jit import jit_closure


@pytest.fixture
def constants_are_errors():
    """Any program that captures more than 1 KiB of constants fails."""
    old = jax.config.jax_captured_constants_warn_bytes
    jax.config.update("jax_captured_constants_warn_bytes", 1024)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*constants were "
                                    "captured")
            yield
    finally:
        jax.config.update("jax_captured_constants_warn_bytes", old)


def test_plain_jit_of_a_closure_trips_the_guard(constants_are_errors):
    big = jnp.arange(4096, dtype=jnp.float32)
    with pytest.raises(UserWarning, match="constants were captured"):
        jax.jit(lambda v: big * v)(jnp.float32(2.0))


def test_closure_arrays_enter_as_arguments(constants_are_errors):
    big = jnp.arange(4096, dtype=jnp.float32)
    fn = jit_closure(lambda v, scale=1.0: {"y": big * v * scale})
    out = fn(jnp.float32(2.0), scale=3.0)
    np.testing.assert_allclose(np.asarray(out["y"]),
                               np.arange(4096) * 6.0)


def test_traces_once_per_signature():
    traces = []
    big = jnp.ones((64,), jnp.float32)

    def fn(v):
        traces.append(v.shape)
        return big[:v.shape[0]] + v
    jf = jit_closure(fn)
    jf(jnp.ones((8,), jnp.float32))
    jf(jnp.zeros((8,), jnp.float32))
    assert len(traces) == 1
    np.testing.assert_allclose(np.asarray(jf(jnp.ones((4,), jnp.float32))),
                               2.0)
    assert len(traces) == 2


def test_inside_an_enclosing_jit_runs_inline():
    @jax.jit
    def outer(w, v):
        return jit_closure(lambda u: w * u)(v)
    np.testing.assert_allclose(
        np.asarray(outer(jnp.arange(3.0), jnp.full((3,), 2.0))),
        [0.0, 2.0, 4.0])


def test_dist_solver_captures_no_factor_constants(constants_are_errors):
    """The mesh-sharded factor reaches the distributed GMRES program as
    arguments (a captured factor cannot be placed on the mesh)."""
    from spike_petsc_tpu.models import problems
    from spike_petsc_tpu import sparse as hsp
    from spike_petsc_tpu.ops.band import BandedMatrix
    from spike_petsc_tpu.parallel import (dist_spike_factor,
                                          make_dist_solver, make_mesh)
    n = 1024
    a = problems.spd_banded(n, 4, seed=2)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    mesh = make_mesh(4, axis="p")
    dsf = dist_spike_factor(BandedMatrix(data=jnp.asarray(data), kl=kl,
                                         ku=ku), mesh, block_b=8)
    u = np.random.default_rng(0).standard_normal(n)
    res = make_dist_solver(dsf, mesh, ksp_type="gmres", rtol=1e-10,
                           maxit=20)(jnp.asarray(a @ u))
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-7, atol=1e-8)
