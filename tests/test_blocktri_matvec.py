"""Block-tridiagonal matvec (ops.blocktri.blocktri_matvec) — the Krylov
SpMV of the blocktri operator route and of the distributed blocks route —
against dense references: padded and chunked layouts, bf16 blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spike_petsc_tpu.ops.blocktri import (BlockTridiagonal, blocktri_matvec,
                                          blocktri_to_dense)


def _rand_T(nb, b, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    D = jnp.asarray(rng.standard_normal((nb, b, b)), dtype)
    L = jnp.asarray(rng.standard_normal((nb, b, b)), dtype).at[0].set(0)
    U = jnp.asarray(rng.standard_normal((nb, b, b)), dtype).at[nb - 1].set(0)
    return BlockTridiagonal(D=D, L=L, U=U)


def _ref(T, x):
    A = np.asarray(blocktri_to_dense(T)).astype(np.float64)
    return (A @ np.asarray(x, np.float64).reshape(A.shape[0], -1)).reshape(
        np.shape(x))


@pytest.mark.parametrize("nb,b", [(5, 8), (130, 8), (64, 16)])
def test_blocktri_matvec_matches_dense(nb, b):
    T = _rand_T(nb, b, seed=nb)
    x = jnp.asarray(np.random.default_rng(1).standard_normal((nb, b)),
                    jnp.float32)
    np.testing.assert_allclose(np.asarray(blocktri_matvec(T, x)), _ref(T, x),
                               rtol=2e-5, atol=2e-5)


def test_zero_padded_blocks_are_a_noop():
    """Padding the block count with zero blocks (the operator route pads
    x to nb*b) leaves the leading rows unchanged."""
    nb, b, pad = 40, 8, 6
    T = _rand_T(nb, b, seed=3)
    x = jnp.asarray(np.random.default_rng(2).standard_normal((nb, b)),
                    jnp.float32)
    padb = lambda a: jnp.pad(a, ((0, pad), (0, 0), (0, 0)))
    Tp = BlockTridiagonal(D=padb(T.D), L=padb(T.L), U=padb(T.U))
    y = np.asarray(blocktri_matvec(Tp, jnp.pad(x, ((0, pad), (0, 0)))))
    np.testing.assert_allclose(y[:nb], np.asarray(blocktri_matvec(T, x)),
                               rtol=1e-6, atol=1e-6)
    assert not np.any(y[nb:])


@pytest.mark.parametrize("Kc,nbk,b", [(4, 7, 8), (8, 16, 8)])
def test_chunked_layout(Kc, nbk, b):
    """The distributed layout [Kc, nbk, b, b]: a vmap over chunks whose
    boundary couplings (L[0], U[nbk-1]) are zero equals the flat matvec of
    the block-diagonal-of-chunks system."""
    nb = Kc * nbk
    T = _rand_T(nb, b, seed=Kc)
    edge = (np.arange(nb) % nbk)
    L = T.L * jnp.asarray(edge != 0, T.L.dtype)[:, None, None]
    U = T.U * jnp.asarray(edge != nbk - 1, T.U.dtype)[:, None, None]
    Tflat = BlockTridiagonal(D=T.D, L=L, U=U)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((nb, b)),
                    jnp.float32)
    Tc = jax.tree_util.tree_map(lambda a: a.reshape(Kc, nbk, b, b), Tflat)
    y = jax.vmap(blocktri_matvec)(Tc, x.reshape(Kc, nbk, b))
    np.testing.assert_allclose(np.asarray(y).reshape(nb, b),
                               _ref(Tflat, x), rtol=2e-5, atol=2e-5)


def test_bf16_blocks():
    """bf16-stored blocks with an f32 vector: the product is f32."""
    nb, b = 16, 8
    T32 = _rand_T(nb, b, seed=9)
    T16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), T32)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((nb, b)),
                    jnp.float32)
    y = blocktri_matvec(T16, x)
    assert y.dtype == jnp.float32
    ref = _ref(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), T16),
               x)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-5, atol=1e-5)


def test_multi_rhs():
    nb, b, r = 12, 16, 5
    T = _rand_T(nb, b, seed=13)
    X = jnp.asarray(np.random.default_rng(6).standard_normal((nb, b, r)),
                    jnp.float32)
    np.testing.assert_allclose(np.asarray(blocktri_matvec(T, X)), _ref(T, X),
                               rtol=2e-5, atol=2e-5)
