"""SPIKE factorization/solve vs SciPy banded-solve oracle.

Covers BASELINE configs 1-2: tridiagonal Laplacian (single partition) and SPD
banded multi-partition, plus nonsymmetric bands, truncated SPIKE under
diagonal dominance, and stored-spike one-sweep solves."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.linalg as sla

from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
from spike_petsc_tpu.ops.spike import spike_factor, spike_solve, spike_solve_many
from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems


def banded_of(acsr):
    data, kl, ku = hsp.csr_to_banded_arrays(acsr)
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku), kl, ku


def scipy_solve(acsr, rhs):
    kl, ku = hsp.compute_half_bandwidths(acsr)
    n = acsr.shape[0]
    ab = np.zeros((kl + ku + 1, n))
    a = acsr.toarray()
    for d in range(-kl, ku + 1):
        ab[ku - d, max(0, d):n + min(0, d)] = np.diag(a, d)
    return sla.solve_banded((kl, ku), ab, rhs)


@pytest.mark.parametrize("K", [1, 2, 4, 7])
@pytest.mark.parametrize("method", ["inv", "lu"])
def test_spike_tridiagonal(K, method):
    n = 200
    a = problems.tridiag_laplacian(n)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=K, block_b=4, method=method)
    u = np.linspace(1, 2, n)
    rhs = a @ u
    x = np.asarray(spike_solve(sf, jnp.asarray(rhs)))
    np.testing.assert_allclose(x, u, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("K,block_b", [(1, None), (4, 8), (8, 8), (16, 8)])
def test_spike_spd_banded(K, block_b):
    n, k = 512, 5
    a = problems.spd_banded(n, k, seed=1)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=K, block_b=block_b)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(n)
    x = np.asarray(spike_solve(sf, jnp.asarray(a @ u)))
    np.testing.assert_allclose(x, u, rtol=1e-8, atol=1e-9)


def test_spike_nonsym_unequal_bandwidths():
    n, kl, ku = 300, 4, 2
    a = problems.nonsym_banded(n, kl, ku, seed=5)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=5, block_b=8)
    rng = np.random.default_rng(2)
    rhs = rng.standard_normal(n)
    x = np.asarray(spike_solve(sf, jnp.asarray(rhs)))
    np.testing.assert_allclose(x, scipy_solve(a, rhs), rtol=1e-8, atol=1e-9)


def test_spike_matches_scipy_many_rhs():
    n = 257  # deliberately not divisible by K*b -> exercises padding
    a = problems.nonsym_banded(n, 3, 3, seed=7)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=4, block_b=8)
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((n, 3))
    x = np.asarray(spike_solve_many(sf, jnp.asarray(rhs)))
    for j in range(3):
        np.testing.assert_allclose(x[:, j], scipy_solve(a, rhs[:, j]),
                                   rtol=1e-8, atol=1e-9)


def test_spike_store_spikes_one_sweep():
    n = 400
    a = problems.spd_banded(n, 4, seed=9)
    bm, _, _ = banded_of(a)
    sf2 = spike_factor(bm, K=8, block_b=8, store_spikes=True)
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal(n)
    x = np.asarray(spike_solve(sf2, jnp.asarray(rhs)))
    np.testing.assert_allclose(x, scipy_solve(a, rhs), rtol=1e-8, atol=1e-9)


def test_spike_truncated_diagonally_dominant():
    """Truncated SPIKE is exact only in the dominant limit; for a strongly
    dominant band it must agree to engineering accuracy (used as a
    preconditioner, not a direct solve)."""
    n, k = 600, 3
    a = problems.nonsym_banded(n, k, k, seed=11, dominance=50.0)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=6, block_b=8, truncated=True)
    rng = np.random.default_rng(6)
    rhs = rng.standard_normal(n)
    x = np.asarray(spike_solve(sf, jnp.asarray(rhs)))
    xs = scipy_solve(a, rhs)
    rel = np.linalg.norm(x - xs) / np.linalg.norm(xs)
    assert rel < 1e-6, rel


def test_spike_residual_via_matvec():
    """Closure check: residual of the SPIKE solve through our own matvec."""
    n = 333
    a = problems.nonsym_banded(n, 2, 5, seed=13)
    bm, _, _ = banded_of(a)
    sf = spike_factor(bm, K=3, block_b=8)
    rng = np.random.default_rng(8)
    rhs = rng.standard_normal(n)
    x = spike_solve(sf, jnp.asarray(rhs))
    res = np.asarray(banded_matvec(bm, x)) - rhs
    assert np.linalg.norm(res) / np.linalg.norm(rhs) < 1e-10


def test_spike_solve_many_blocked_matches_loop():
    """Blocked multi-RHS path (factors streamed once) vs per-RHS solves."""
    import jax
    n = 500
    a = problems.nonsym_banded(n, 4, 4, seed=21)
    bm, _, _ = banded_of(a)
    for kwargs in (dict(K=4, block_b=8), dict(K=1),
                   dict(K=4, block_b=8, truncated=True),
                   dict(K=4, block_b=8, store_spikes=True)):
        sf = spike_factor(bm, **kwargs)
        rng = np.random.default_rng(5)
        rhs = jnp.asarray(rng.standard_normal((n, 3)))
        blocked = np.asarray(spike_solve_many(sf, rhs))
        looped = np.stack(
            [np.asarray(spike_solve(sf, rhs[:, j])) for j in range(3)], axis=1)
        np.testing.assert_allclose(blocked, looped, rtol=1e-11, atol=1e-12)


def test_shift_nonzero_survives_zero_diagonal():
    """PETSc -pc_factor_shift_type nonzero parity: a zero-diagonal matrix
    (singular pivot blocks at odd block sizes) factors finite with
    shift="nonzero" and the shifted factorization preconditions GMRES to the
    exact solution (/root/reference/src/makefile:18, testbed.c:266-272)."""
    import jax.numpy as jnp
    import numpy as np
    from spike_petsc_tpu import sparse as hsp
    from spike_petsc_tpu.models import problems
    from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
    from spike_petsc_tpu.ops.spike import spike_factor, spike_solve
    from spike_petsc_tpu.solvers.krylov import gmres
    from spike_petsc_tpu.utils.debug import OK, factor_health

    n = 120
    a = problems.zero_diag_tridiag(n)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)

    # odd block size -> the [0,-1;-1,0;...] diagonal blocks are singular
    plain = spike_factor(bm, K=4, block_b=3)
    assert int(factor_health(plain.fact).status) != OK

    shifted = spike_factor(bm, K=4, block_b=3, shift="nonzero")
    assert int(factor_health(shifted.fact).status) == OK
    assert int(np.asarray(shifted.fact.nshift).sum()) > 0

    u = np.ones(n)
    b = jnp.asarray(a @ u)
    res = gmres(lambda v: banded_matvec(bm, v), b, None,
                lambda v: spike_solve(shifted, v), rtol=1e-10, maxit=200)
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), u, atol=1e-6)


def test_shift_nonzero_cr_method():
    """Same guard on the cyclic-reduction factorization path."""
    import jax.numpy as jnp
    import numpy as np
    from spike_petsc_tpu import sparse as hsp
    from spike_petsc_tpu.models import problems
    from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
    from spike_petsc_tpu.ops.spike import spike_factor, spike_solve
    from spike_petsc_tpu.solvers.krylov import gmres
    from spike_petsc_tpu.utils.debug import OK, factor_health

    n = 120
    a = problems.zero_diag_tridiag(n)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    shifted = spike_factor(bm, K=2, block_b=3, method="cr", shift="nonzero")
    assert int(factor_health(shifted.fact).status) == OK
    u = np.ones(n)
    b = jnp.asarray(a @ u)
    res = gmres(lambda v: banded_matvec(bm, v), b, None,
                lambda v: spike_solve(shifted, v), rtol=1e-10, maxit=300)
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), u, atol=1e-5)


def test_chunked_conversion_matches_unchunked(monkeypatch):
    """The memory-bounded lax.map conversion path (the bench-scale branch)
    must produce bit-identical factors to the unchunked vmap path."""
    import jax
    import jax.numpy as jnp
    from spike_petsc_tpu.ops import spike as spk
    from spike_petsc_tpu.models import problems
    from spike_petsc_tpu import sparse as hsp
    from spike_petsc_tpu.ops.band import BandedMatrix

    a = problems.nonsym_banded(640, 3, 3, seed=21, dominance=6.0)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    sf_plain = spk.spike_factor(bm, K=8, block_b=8, store_spikes=True)
    # force the chunked branch (tiny budget -> 8 chunks of 1 partition)
    monkeypatch.setattr(spk, "_CONV_CHUNK_BYTES", 1024)
    spk._spike_factor_impl.clear_cache()
    sf_chunk = spk.spike_factor(bm, K=8, block_b=8, store_spikes=True)
    spk._spike_factor_impl.clear_cache()
    import numpy as np
    for lp, lc in zip(jax.tree_util.tree_leaves(sf_plain),
                      jax.tree_util.tree_leaves(sf_chunk)):
        np.testing.assert_array_equal(np.asarray(lp), np.asarray(lc))


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(store_spikes=True),
    dict(store_spikes=True, spike_dtype=jnp.bfloat16),
    dict(method="cr"),
    dict(truncated=True),
    dict(shift="nonzero"),
    dict(store_lt=True),
])
def test_spike_factor_grouped_matches(kwargs):
    """Group-wise factorization (the large-N memory path) is equivalent to
    the monolithic path: per-partition math is identical, only device-
    program batching differs."""
    import jax
    from spike_petsc_tpu.ops.spike import spike_factor_grouped

    a = problems.nonsym_banded(768, 3, 3, seed=12, dominance=6.0)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    rng = np.random.default_rng(5)
    u = rng.standard_normal(768)
    rhs = jnp.asarray(a @ u)
    sf_m = spike_factor(bm, K=8, block_b=8, **kwargs)
    sf_g = spike_factor_grouped(bm, K=8, groups=4, block_b=8, **kwargs)
    x_m = np.asarray(spike_solve(sf_m, rhs))
    x_g = np.asarray(spike_solve(sf_g, rhs))
    np.testing.assert_allclose(x_g, x_m, rtol=1e-12, atol=1e-13)
    if kwargs.get("store_lt"):
        np.testing.assert_array_equal(np.asarray(sf_g.Lb),
                                      np.asarray(sf_m.Lb))
    # bf16 spikes are ~1e-4-grade at this small well-conditioned size
    tol = 1e-3 if kwargs.get("spike_dtype") is not None else 1e-5
    np.testing.assert_allclose(x_g, u, rtol=tol, atol=tol / 10)


@pytest.mark.parametrize("method", ["inv", "lu"])
def test_blocktri_solve_transpose_matches_dense(method):
    """T^T x = r on the FORWARD factorization (no refactorization): the
    block-Thomas factors T = L*U give T^T = U^T L^T, solved as two sweeps
    over the same stored blocks transposed."""
    from spike_petsc_tpu.ops.blocktri import (BlockTridiagonal,
                                              blocktri_factor,
                                              blocktri_solve_transpose,
                                              blocktri_to_dense)
    rng = np.random.default_rng(91)
    nb, b = 6, 4
    D = rng.standard_normal((nb, b, b)) + 4 * np.eye(b)
    L = 0.3 * rng.standard_normal((nb, b, b)); L[0] = 0
    U = 0.3 * rng.standard_normal((nb, b, b)); U[-1] = 0
    t = BlockTridiagonal(D=jnp.asarray(D), L=jnp.asarray(L), U=jnp.asarray(U))
    A = np.asarray(blocktri_to_dense(t))
    fact = blocktri_factor(t, method=method)
    r = rng.standard_normal((nb, b))
    x = np.asarray(blocktri_solve_transpose(fact, jnp.asarray(r)))
    np.testing.assert_allclose(x.reshape(-1),
                               np.linalg.solve(A.T, r.reshape(-1)),
                               rtol=1e-11, atol=1e-12)
    # multi-RHS
    R = rng.standard_normal((nb, b, 3))
    X = np.asarray(blocktri_solve_transpose(fact, jnp.asarray(R)))
    np.testing.assert_allclose(X.reshape(nb * b, 3),
                               np.linalg.solve(A.T, R.reshape(nb * b, 3)),
                               rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("K,store,method", [
    (1, False, "inv"), (4, False, "inv"), (4, True, "inv"), (4, False, "lu"),
])
def test_spike_transpose_solves_transposed_system(K, store, method):
    """spike_transpose reuses A's partition factors for A^T x = g (PETSc
    MatSolveTranspose role): transposed local sweeps, swapped+transposed
    coupling tips, transpose spikes, reassembled reduced system."""
    from spike_petsc_tpu.ops.spike import spike_transpose

    n = 333                       # not divisible by K*b: exercises padding
    a = problems.nonsym_banded(n, 3, 2, seed=7)
    bm, kl, ku = banded_of(a)
    sf = spike_factor(bm, K=K, block_b=8, store_spikes=store, method=method)
    sft = spike_transpose(sf)
    rng = np.random.default_rng(92)
    g = rng.standard_normal(n)
    lam = np.asarray(spike_solve(sft, jnp.asarray(g)))
    lam_e = np.linalg.solve(a.toarray().T, g)
    np.testing.assert_allclose(lam, lam_e, rtol=1e-9, atol=1e-10)
    # multi-RHS path shares the transpose dispatch
    G = rng.standard_normal((n, 3))
    Lam = np.asarray(spike_solve_many(sft, jnp.asarray(G)))
    np.testing.assert_allclose(Lam, np.linalg.solve(a.toarray().T, G),
                               rtol=1e-9, atol=1e-10)


def test_spike_transpose_truncated_and_complex():
    from spike_petsc_tpu.ops.spike import spike_transpose

    n = 320
    rng = np.random.default_rng(93)
    g = rng.standard_normal(n)
    # truncated reduced system (diagonally-dominant regime)
    aspd = problems.spd_banded(n, 3, seed=9)
    bm, _, _ = banded_of(aspd)
    sf = spike_factor(bm, K=4, block_b=8, truncated=True)
    lam = np.asarray(spike_solve(spike_transpose(sf), jnp.asarray(g)))
    np.testing.assert_allclose(lam, np.linalg.solve(aspd.toarray().T, g),
                               rtol=1e-4, atol=1e-5)
    # complex adjoint: A^H x = g via conj(solve_T(conj(g)))
    ar = problems.nonsym_banded(n, 3, 2, seed=11)
    ac = (ar + 1j * 0.3 * problems.nonsym_banded(n, 3, 2, seed=12)).tocsr()
    data, kl, ku = hsp.csr_to_banded_arrays(ac)
    sfc = spike_factor(BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku),
                       K=4, block_b=8)
    lam = np.conj(np.asarray(spike_solve(spike_transpose(sfc),
                                         jnp.asarray(np.conj(g + 0j)))))
    np.testing.assert_allclose(lam,
                               np.linalg.solve(ac.toarray().conj().T, g),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("K", [1, 4])
def test_spike_transpose_regular_form_with_band(K):
    """spike_transpose(band=...) builds the REGULAR-form transposed factor
    (F' = (Sinv U)^T, Sinv' = Sinv^T, U' = L^T shifted — the standard
    sweeps then compute the transpose solve, the Pallas sweep kernels
    included on the GPU) instead of the XLA-scan marker wrapper."""
    from spike_petsc_tpu.ops.blocktri import BlockTriFactor
    from spike_petsc_tpu.ops.spike import spike_transpose

    n = 333
    a = problems.nonsym_banded(n, 3, 2, seed=7)
    bm, kl, ku = banded_of(a)
    sf = spike_factor(bm, K=K, block_b=8)
    sft = spike_transpose(sf, band=bm)
    assert isinstance(sft.fact, BlockTriFactor)      # regular form, not marker
    g = np.random.default_rng(95).standard_normal(n)
    lam = np.asarray(spike_solve(sft, jnp.asarray(g)))
    np.testing.assert_allclose(lam, np.linalg.solve(a.toarray().T, g),
                               rtol=1e-9, atol=1e-10)
    # identical answers from the marker form
    lam_m = np.asarray(spike_solve(spike_transpose(sf), jnp.asarray(g)))
    np.testing.assert_allclose(lam, lam_m, rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("K,store_dtype", [(1, None), (4, None),
                                           (4, jnp.bfloat16)])
def test_spike_transpose_from_stored_lt(K, store_dtype):
    """spike_factor(store_lt=True) keeps the L blocks so spike_transpose
    builds the REGULAR-form transpose factor with NO band and NO
    band->blocktri reconversion (the blocks were computed at factor time
    anyway); fast=False still opts into the zero-memory marker form."""
    from spike_petsc_tpu.ops.blocktri import (BlockTriFactor,
                                              TransposedBlockTriFactor)
    from spike_petsc_tpu.ops.spike import spike_transpose

    n = 333
    a = problems.nonsym_banded(n, 3, 2, seed=7)
    bm, kl, ku = banded_of(a)
    sf = spike_factor(bm, K=K, block_b=8, store_lt=True,
                      store_dtype=store_dtype)
    assert sf.Lb is not None
    if store_dtype is not None:
        assert sf.Lb.dtype == store_dtype
    sft = spike_transpose(sf)                 # no band passed — uses sf.Lb
    assert isinstance(sft.fact, BlockTriFactor)   # regular form, not marker
    g = np.random.default_rng(96).standard_normal(n)
    lam = np.asarray(spike_solve(sft, jnp.asarray(g)))
    tol = 2e-2 if store_dtype is not None else 1e-9
    np.testing.assert_allclose(lam, np.linalg.solve(a.toarray().T, g),
                               rtol=tol, atol=tol / 10)
    if store_dtype is None:
        # bit-identical to the band-built regular form (same L blocks)
        sft_b = spike_transpose(
            spike_factor(bm, K=K, block_b=8), band=bm)
        np.testing.assert_array_equal(np.asarray(sft.fact.F),
                                      np.asarray(sft_b.fact.F))
        np.testing.assert_array_equal(np.asarray(sft.fact.U),
                                      np.asarray(sft_b.fact.U))
    # fast=False: marker form even though Lb is stored
    sft_m = spike_transpose(sf, fast=False)
    assert isinstance(sft_m.fact, TransposedBlockTriFactor)
    lam_m = np.asarray(spike_solve(sft_m, jnp.asarray(g)))
    np.testing.assert_allclose(lam_m, np.linalg.solve(a.toarray().T, g),
                               rtol=tol, atol=tol / 10)


def test_store_lt_rejects_non_inv():
    a = problems.nonsym_banded(128, 3, 2, seed=7)
    bm, _, _ = banded_of(a)
    with pytest.raises(ValueError, match="store_lt"):
        spike_factor(bm, K=4, block_b=8, method="lu", store_lt=True)
