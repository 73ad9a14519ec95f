"""SPIKE partitioned banded factorization and solve (single-chip, batched).

This is the solver kernel the reference repo *wraps but does not contain* —
spike-petsc preconditions for the external SPIKEGPU library
(/root/reference/src/HOWTO:2 ``-cublas 0``; SURVEY.md §0).  Here it is built
natively:

* The banded matrix is split into K row partitions.  Each partition is an
  independent banded system -> K block-Thomas factorizations batched over the
  partition axis (``vmap`` over ``blocktri_factor``), i.e. every scan step is
  a ``[K, b, b]`` batched matmul.
* The couplings between neighbouring partitions are k x k corner "tips"
  (B_p to the next partition, C_p to the previous one, k = max(kl, ku)).
* Spike columns V_p = A_p^{-1} E_bot B_p and W_p = A_p^{-1} E_top C_p are
  computed with the same batched solver (k right-hand sides).
* The reduced system coupling the partition interfaces is *itself* a
  block-tridiagonal system with 2k x 2k blocks and K-1 block rows — solved by
  recursing on the same block-Thomas machinery (or, for the truncated variant
  valid under diagonal dominance, by K-1 *independent* 2k x 2k solves).
* The multi-chip version (parallel/spike_dist.py) shards the partition axis
  over the device mesh and assembles the reduced system with an all-gather —
  replacing the reference's PETSc MPI exchange (/root/reference/src/wbm.c:270-273).

Solved in two sweeps per application (memory-light, "recompute" SPIKE) or one
sweep + spike matvec when ``store_spikes=True`` (faster per solve, stores
V, W of shape [K, m, k]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .band import BandedMatrix, pad_banded
from .blocktri import (BlockTridiagonal, BlockTriFactor, band_to_blocktri,
                       blocktri_factor, blocktri_solve, sweep_precision)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SpikeFactor:
    """Factorization state for SPIKE solves (a pytree)."""

    fact: BlockTriFactor          # per-partition factors, leading dim K
    Btip: jax.Array               # [K, k, k], coupling to next (row K-1 zero)
    Ctip: jax.Array               # [K, k, k], coupling to prev (row 0 zero)
    red_fact: Optional[BlockTriFactor]   # exact reduced-system factorization
    red_Dinv: Optional[jax.Array]        # [K-1, 2k, 2k] truncated variant
    V: Optional[jax.Array]        # [K, nb, b, k] right spikes (store_spikes)
    W: Optional[jax.Array]        # [K, nb, b, k] left spikes (store_spikes)
    n: int = field(metadata=dict(static=True))        # original size
    K: int = field(metadata=dict(static=True))        # partitions
    m: int = field(metadata=dict(static=True))        # padded rows/partition
    b: int = field(metadata=dict(static=True))        # block size
    k: int = field(metadata=dict(static=True))        # tip size = max(kl, ku)
    truncated: bool = field(metadata=dict(static=True))
    # [K, nb, b, b] original subdiagonal blocks (store_lt=True): lets
    # spike_transpose build the REGULAR-form transpose factor without
    # re-running the band->blocktri conversion (and without the band at all)
    Lb: Optional[jax.Array] = None

    @property
    def nb(self) -> int:
        return self.m // self.b


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------

# cap on the band->blocktri conversion's transient skew buffer; conversion
# is chunked over partition groups beyond this (bounds peak factor memory)
_CONV_CHUNK_BYTES = 512 * 1024 * 1024


def _partition_geometry(n: int, K: int, kl: int, ku: int,
                        block_b: Optional[int]) -> tuple:
    k = max(kl, ku, 1)
    b = block_b if block_b is not None else max(k, 1)
    if b < k:
        raise ValueError(f"block size {b} must be >= tip size {k}")
    rows = -(-n // K)                      # ceil(n / K)
    m = -(-rows // b) * b                  # rounded up to a multiple of b
    if m < 2 * k and K > 1:
        raise ValueError(
            f"partition rows {m} must be >= 2*k={2*k}; reduce K or bandwidth")
    return k, b, m


def _skew_tip(rows: jax.Array, off: int, k: int) -> jax.Array:
    """``out[..., r, c] = rows[..., r, off - r + c]`` for ``c in [0, k)`` —
    the per-row -r shift done as ONE flatten + re-view at width-1 (the same
    pad-and-reshape skew as band_to_blocktri), instead of k per-row static
    slices (each tiny slice would be a separate device op).

    Requires ``0 <= off - r + c < rows.shape[-1]`` for the used index range
    (callers pad ``rows`` so out-of-band reads land in zeros).
    """
    *lead, kk, Wp = rows.shape
    flat = rows.reshape(*lead, kk * Wp)
    flat = jnp.pad(flat, [(0, 0)] * len(lead) + [(0, off)])
    skew = jax.lax.slice_in_dim(flat, off, off + kk * (Wp - 1), axis=-1)
    return skew.reshape(*lead, kk, Wp - 1)[..., :k]


def _extract_tips(data: jax.Array, K: int, m: int, k: int, kl: int, ku: int,
                  zero_boundaries: bool = True):
    """Pull the k x k coupling corners out of global band storage.

    B_tip[p][r, c] = A[p*m + (m-k) + r, (p+1)*m + c]  (band offset c + k - r)
    C_tip[p][r, c] = A[p*m + r,        (p-1)*m + (m-k) + c]  (offset c - k - r)

    ``zero_boundaries=False`` keeps the first/last partitions' outward tips
    (for callers extracting a GROUP of partitions from the middle of the
    global matrix, which zero the true global boundaries themselves).
    """
    w = kl + ku + 1
    rowsB = data.reshape(K, m, w)[:, m - k:, :]            # [K, k, w]
    rowsC = data.reshape(K, m, w)[:, :k, :]
    # B_tip[p][r, c] at band offset c + k - r + kl (right-pad: reads up to
    # 2k + kl - 1); C_tip at c - k - r + kl (left-pad 2k: negative offsets
    # read zeros).  Both are off = k + kl in their padded coordinates.
    Btip = _skew_tip(jnp.pad(rowsB, ((0, 0), (0, 0), (0, 2 * k))),
                     k + kl, k)                            # [K, k, k]
    Ctip = _skew_tip(jnp.pad(rowsC, ((0, 0), (0, 0), (2 * k, 0))),
                     k + kl, k)
    if zero_boundaries:
        Btip = Btip.at[K - 1].set(0)
        Ctip = Ctip.at[0].set(0)
    return Btip, Ctip


def reduced_factor(red: BlockTridiagonal, method: str, reduced: str = "auto",
                   inverter: str = "auto", cr_threshold: int = 33):
    """Factor the SPIKE reduced interface system.

    Large partition counts make the block-Thomas scan over K-1 reduced
    blocks the solve's latency floor; cyclic reduction solves it in log2(K)
    levels of batched work instead (ops/cyclic.py), keeping solve
    latency flat in K — the same role recursion plays in recursive SPIKE.
    ``reduced``: "thomas", "cr", or "auto" (cr when the reduced system has
    >= ``cr_threshold`` block rows or the partition factorization itself is
    CR).  The default threshold suits the replicated distributed reduced
    solve; the single-device path passes a higher one (255).  The
    crossover on the H100 is not measured.
    """
    use_cr = reduced == "cr" or method == "cr" or (
        reduced == "auto" and red.nb >= cr_threshold)
    if use_cr:
        from .cyclic import cr_factor
        return cr_factor(red, inverter=inverter)
    return blocktri_factor(red, method=method if method in ("inv", "lu")
                           else "inv", inverter=inverter)


def _local_band_mask(m: int, kl: int, ku: int, dtype) -> jax.Array:
    """[m, w] mask zeroing entries whose column leaves the partition."""
    i = jnp.arange(m)[:, None]
    d = jnp.arange(kl + ku + 1)[None, :]
    col = i + d - kl
    return ((col >= 0) & (col < m)).astype(dtype)


@partial(jax.jit, static_argnames=("K", "block_b", "method", "truncated",
                                   "store_spikes", "kl", "ku", "n",
                                   "store_dtype", "reduced", "shift",
                                   "inverter", "spike_dtype", "store_lt"))
def _spike_factor_impl(data, *, n, kl, ku, K, block_b, method, truncated,
                       store_spikes, store_dtype=None, reduced="auto",
                       shift="none", shift_amount=0.0, inverter="auto",
                       spike_dtype=None, store_lt=False):
    k, b, m = _partition_geometry(n, K, kl, ku, block_b)
    npad = K * m
    band = pad_banded(BandedMatrix(data=data, kl=kl, ku=ku), npad)

    Btip, Ctip = _extract_tips(band.data, K, m, k, kl, ku)

    # Folded-conversion fast path: for the default method='inv' factor the
    # band->blocktri conversion rides the factor scan itself
    # (blocktri_factor_inv_waux_band skews each [b, w] row block inside the
    # step), so neither the global skew intermediate nor the materialized
    # L/D/U blocks reach device memory.  Falls back to the materialized
    # conversion when shifting (the shift scale heuristic needs
    # max|blocks|) or when the L blocks must be kept (store_lt).
    if method == "inv" and K > 1 and shift == "none" and not store_lt:
        from .blocktri import blocktri_factor_inv_waux_band
        local = band.data.reshape(K, m // b, b, band.width)
        Cb = jnp.zeros((K, b, k), band.dtype).at[:, :k, :].set(Ctip)
        fact, yw = jax.vmap(partial(blocktri_factor_inv_waux_band,
                                    kl=kl, ku=ku, b=b,
                                    inverter=inverter))(local, Cb)
        return _finish_factor(None, Btip, Ctip, n=n, K=K, m=m, b=b, k=k,
                              method=method, truncated=truncated,
                              store_spikes=store_spikes,
                              store_dtype=store_dtype, reduced=reduced,
                              shift=shift, shift_amount=shift_amount,
                              inverter=inverter, spike_dtype=spike_dtype,
                              store_lt=store_lt, fact_yw=(fact, yw))

    # out-of-partition couplings live only in the first/last k rows of each
    # partition (b >= k), i.e. exactly the L[0]/U[nb-1] blocks that
    # band_to_blocktri zeroes — no separate local-band mask pass needed
    blocks = _band_to_blocks_chunked(band, K, m, b, kl, ku)
    return _finish_factor(blocks, Btip, Ctip, n=n, K=K, m=m, b=b, k=k,
                          method=method, truncated=truncated,
                          store_spikes=store_spikes, store_dtype=store_dtype,
                          reduced=reduced, shift=shift,
                          shift_amount=shift_amount, inverter=inverter,
                          spike_dtype=spike_dtype, store_lt=store_lt)


def _band_to_blocks_chunked(band: BandedMatrix, K: int, m: int, b: int,
                            kl: int, ku: int) -> BlockTridiagonal:
    """Per-partition band -> blocktri conversion, chunked over partition
    groups so the skew intermediate ([m, w + ~3b] per partition) stays
    bounded: unchunked it peaks at ~3x the block storage.  ``band`` must
    already be padded to K*m rows."""
    local = band.data.reshape(K, m, band.width)
    to_blocks = jax.vmap(
        lambda d: band_to_blocktri(BandedMatrix(data=d, kl=kl, ku=ku), b))
    skew_bytes = K * m * (band.width + 3 * b) * jnp.dtype(band.dtype).itemsize
    need = min(K, -(-skew_bytes // _CONV_CHUNK_BYTES))
    nch = next((c for c in range(int(need), K + 1) if K % c == 0), 1) \
        if need > 1 else 1
    if nch > 1:
        blocks = jax.lax.map(to_blocks, local.reshape(nch, K // nch, m,
                                                      band.width))
        return jax.tree_util.tree_map(
            lambda x: x.reshape(K, *x.shape[2:]), blocks)
    return to_blocks(local)                                # [K, nb, b, b] x3


def _finish_factor(blocks, Btip, Ctip, *, n, K, m, b, k, method, truncated,
                   store_spikes, store_dtype, reduced, shift, shift_amount,
                   inverter, spike_dtype, store_lt=False,
                   fact_yw=None) -> SpikeFactor:
    """Shared factorization tail (partition factor -> spikes -> reduced
    system -> mixed-precision cast) for both the band-storage entry
    (spike_factor) and the blocktri-native entry (spike_factor_blocks).
    ``fact_yw``: a precomputed (fact, yw) pair from the folded-conversion
    scan (blocks is None then)."""
    nb = m // b
    if fact_yw is not None:
        fact, yw = fact_yw
        dtype = fact.Sinv.dtype
    else:
        dtype = blocks.dtype
        yw = None
    if fact_yw is not None:
        pass
    elif method == "cr":
        # cyclic reduction: log2(nb) levels, one large batched inversion
        # call per level (vs nb sequential calls in block-Thomas) — trades
        # ~2x stored blocks for factor latency
        from .cyclic import cr_factor
        fact = jax.vmap(partial(cr_factor, shift=shift,
                                shift_amount=shift_amount,
                                inverter=inverter))(blocks)
    elif method == "inv" and K > 1:
        # fused factor + W-spike forward sweep: the spike solve's fwd pass
        # rides the factor scan instead of re-reading the stacked F blocks
        from .blocktri import blocktri_factor_inv_waux
        Cb = jnp.zeros((K, b, k), dtype).at[:, :k, :].set(Ctip)
        fact, yw = jax.vmap(partial(blocktri_factor_inv_waux, shift=shift,
                                    shift_amount=shift_amount,
                                    inverter=inverter))(blocks, Cb)
    else:
        fact = jax.vmap(partial(blocktri_factor, method=method, shift=shift,
                                shift_amount=shift_amount,
                                inverter=inverter))(blocks)

    V = W = None
    red_fact = None
    red_Dinv = None
    if K > 1:
        if yw is not None:
            Vfull, Wfull = _spike_columns_from_waux(fact, Btip, yw, b, k,
                                                    dtype)
        else:
            Vfull, Wfull = _spike_columns(fact, Btip, Ctip, nb, b, k, dtype)
        V_top, V_bot = Vfull[:, 0, :k, :], Vfull[:, nb - 1, b - k:, :]
        W_top, W_bot = Wfull[:, 0, :k, :], Wfull[:, nb - 1, b - k:, :]
        if store_spikes:
            V, W = Vfull, Wfull
        red_fact, red_Dinv = _reduced_from_tips(
            V_top, V_bot, W_top, W_bot, truncated=truncated, method=method,
            reduced=reduced, inverter=inverter)

    if store_dtype is not None:
        if method == "cr":
            from .cyclic import cast_cr_factor
            fact = cast_cr_factor(fact, store_dtype)
        else:
            from .blocktri import cast_factor
            fact = cast_factor(fact, store_dtype)
        if V is not None:
            V = V.astype(store_dtype)
            W = W.astype(store_dtype)
    if spike_dtype is not None and V is not None:
        V = V.astype(spike_dtype)
        W = W.astype(spike_dtype)

    Lb = None
    if store_lt:
        # keep the subdiagonal blocks (at the factor's storage dtype): the
        # transpose factor's U' = L^T builds from these with no band and no
        # reconversion (blocktri.transposed_factor_from_L)
        Lb = blocks.L if store_dtype is None else blocks.L.astype(store_dtype)

    return SpikeFactor(fact=fact, Btip=Btip, Ctip=Ctip, red_fact=red_fact,
                       red_Dinv=red_Dinv, V=V, W=W, n=n, K=K, m=m, b=b, k=k,
                       truncated=truncated, Lb=Lb)


@partial(jax.jit, static_argnames=("n", "kl", "ku", "K", "method",
                                   "truncated", "store_spikes",
                                   "store_dtype", "reduced", "shift",
                                   "inverter", "spike_dtype", "store_lt"))
def _spike_factor_blocks_impl(D, L, U, *, n, kl, ku, K, method, truncated,
                              store_spikes, store_dtype, reduced, shift,
                              shift_amount, inverter, spike_dtype,
                              store_lt=False):
    NB, b = D.shape[0], D.shape[-1]
    k = max(kl, ku, 1)
    nb = NB // K
    m = nb * b
    Dr = D.reshape(K, nb, b, b)
    Lr = L.reshape(K, nb, b, b)
    Ur = U.reshape(K, nb, b, b)
    # coupling tips live in the corners of the cross-partition blocks
    # (the band structure confines U[p*nb+nb-1] to its bottom-left k x k
    # corner and L[p*nb] to its top-right corner)
    Btip = Ur[:, nb - 1, b - k:, :k].at[K - 1].set(0)
    Ctip = Lr[:, 0, :k, b - k:].at[0].set(0)
    blocks = BlockTridiagonal(D=Dr, L=Lr.at[:, 0].set(0),
                              U=Ur.at[:, nb - 1].set(0))
    return _finish_factor(blocks, Btip, Ctip, n=n, K=K, m=m, b=b, k=k,
                          method=method, truncated=truncated,
                          store_spikes=store_spikes, store_dtype=store_dtype,
                          reduced=reduced, shift=shift,
                          shift_amount=shift_amount, inverter=inverter,
                          spike_dtype=spike_dtype, store_lt=store_lt)


def spike_factor_blocks(T: BlockTridiagonal, n: int, K: int, kl: int,
                        ku: int, method: str = "inv",
                        truncated: bool = False, store_spikes: bool = False,
                        store_dtype=None, reduced: str = "auto",
                        shift: str = "none", shift_amount: float = 0.0,
                        inverter: str = "auto",
                        spike_dtype=None,
                        store_lt: bool = False) -> SpikeFactor:
    """Factor a banded matrix already assembled in GLOBAL block-tridiagonal
    (p-major) layout — the native-assembly path.

    The band-storage entry (``spike_factor``) first converts the band to
    block-tridiagonal layout (an access-pattern-bound strided skew).
    Problems assembled directly in blocktri layout (models.problems.
    blocktri_diagdom_device, or any stencil assembly emitting [NB, b, b]
    blocks) skip it entirely: partitioning is a reshape, cross-partition
    coupling tips are static corner slices of the boundary blocks, and the
    factorization proper starts immediately — the step the reference's
    PCSetUp_Banded performs with a host LU on extracted bands
    (/root/reference/src/matbanded.c:165-178).

    Args:
      T: global block-tridiagonal [NB, b, b]; NB must be divisible by K and
        rows beyond ``n`` must be unit-diagonal padding.  The banded
        structure (half-bandwidths kl, ku <= b) must be respected: coupling
        blocks carry entries only in their band corners.
      n: true (unpadded) system size — solves slice results to [n].
      K: partition count; kl/ku: half-bandwidths (set the tip size k).
      Remaining options as in ``spike_factor``.
    """
    NB, b = T.nb, T.b
    k = max(kl, ku, 1)
    if kl > b or ku > b:
        raise ValueError(f"block size {b} must cover half-bandwidths "
                         f"(kl={kl}, ku={ku})")
    if NB % K:
        raise ValueError(f"block count {NB} must be divisible by K={K}")
    if (NB // K) * b < 2 * k and K > 1:
        raise ValueError(
            f"partition rows {(NB // K) * b} must be >= 2*k={2 * k}; "
            f"reduce K or bandwidth")
    _check_store_lt(store_lt, method)
    return _spike_factor_blocks_impl(
        T.D, T.L, T.U, n=n, kl=kl, ku=ku, K=K, method=method,
        truncated=truncated, store_spikes=store_spikes,
        store_dtype=store_dtype, reduced=reduced, shift=shift,
        shift_amount=shift_amount, inverter=inverter,
        spike_dtype=spike_dtype, store_lt=store_lt)


@partial(jax.jit, static_argnames=("kl", "ku", "b", "k", "method", "shift",
                                   "inverter", "store_spikes", "store_dtype",
                                   "spike_dtype", "store_lt"))
def _group_factor_impl(local, Btip_g, Ctip_g, *, kl, ku, b, k, method,
                       shift, shift_amount, inverter, store_spikes,
                       store_dtype, spike_dtype, store_lt=False):
    """Factor one GROUP of partitions: [Kg, m, w] local band rows ->
    (cast factors, cast V/W or None, f32 spike tips for the reduced build).
    The working set is one group's f32 intermediates — the memory unit of
    spike_factor_grouped."""
    Kg, m, w = local.shape
    to_blocks = jax.vmap(
        lambda d: band_to_blocktri(BandedMatrix(data=d, kl=kl, ku=ku), b))
    blocks = to_blocks(local)
    nb = m // b
    dtype = local.dtype
    if method == "cr":
        from .cyclic import cr_factor
        fact = jax.vmap(partial(cr_factor, shift=shift,
                                shift_amount=shift_amount,
                                inverter=inverter))(blocks)
        Vfull, Wfull = _spike_columns(fact, Btip_g, Ctip_g, nb, b, k, dtype)
    elif method == "inv":
        # fused factor + W-spike forward sweep, as in _finish_factor
        from .blocktri import blocktri_factor_inv_waux
        Cb = jnp.zeros((Kg, b, k), dtype).at[:, :k, :].set(Ctip_g)
        fact, yw = jax.vmap(partial(blocktri_factor_inv_waux, shift=shift,
                                    shift_amount=shift_amount,
                                    inverter=inverter))(blocks, Cb)
        Vfull, Wfull = _spike_columns_from_waux(fact, Btip_g, yw, b, k,
                                                dtype)
    else:
        fact = jax.vmap(partial(blocktri_factor, method=method, shift=shift,
                                shift_amount=shift_amount,
                                inverter=inverter))(blocks)
        Vfull, Wfull = _spike_columns(fact, Btip_g, Ctip_g, nb, b, k, dtype)
    tips = (Vfull[:, 0, :k, :], Vfull[:, nb - 1, b - k:, :],
            Wfull[:, 0, :k, :], Wfull[:, nb - 1, b - k:, :])
    V = W = None
    if store_spikes:
        V, W = Vfull, Wfull
    if store_dtype is not None:
        if method == "cr":
            from .cyclic import cast_cr_factor
            fact = cast_cr_factor(fact, store_dtype)
        else:
            from .blocktri import cast_factor
            fact = cast_factor(fact, store_dtype)
        if V is not None:
            V, W = V.astype(store_dtype), W.astype(store_dtype)
    if spike_dtype is not None and V is not None:
        V, W = V.astype(spike_dtype), W.astype(spike_dtype)
    Lb = None
    if store_lt:
        Lb = blocks.L if store_dtype is None else blocks.L.astype(store_dtype)
    return fact, V, W, tips, Lb


@partial(jax.jit, static_argnames=("truncated", "method", "reduced",
                                   "inverter", "cr_threshold"))
def _reduced_from_tips(V_top, V_bot, W_top, W_bot, *, truncated, method,
                       reduced, inverter, cr_threshold: int = 255):
    K, k = V_top.shape[0], V_top.shape[1]
    dtype = V_top.dtype
    eye = jnp.eye(k, dtype=dtype)
    z = jnp.zeros((K - 1, k, k), dtype)
    D = jnp.concatenate([
        jnp.concatenate([jnp.broadcast_to(eye, (K - 1, k, k)),
                         V_bot[:-1]], axis=2),
        jnp.concatenate([W_top[1:],
                         jnp.broadcast_to(eye, (K - 1, k, k))], axis=2),
    ], axis=1)
    if truncated:
        return None, jnp.linalg.solve(D, jnp.broadcast_to(
            jnp.eye(2 * k, dtype=dtype), (K - 1, 2 * k, 2 * k)))
    L = jnp.concatenate([
        jnp.concatenate([W_bot[:-1], z], axis=2),
        jnp.concatenate([z, z], axis=2)], axis=1).at[0].set(0)
    U = jnp.concatenate([
        jnp.concatenate([z, z], axis=2),
        jnp.concatenate([z, V_top[1:]], axis=2)], axis=1)
    U = U.at[K - 2].set(0) if K > 2 else jnp.zeros_like(U)
    red = BlockTridiagonal(D=D, L=L, U=U)
    return reduced_factor(red, method, reduced, inverter=inverter,
                          cr_threshold=cr_threshold), None


def spike_factor_grouped(band: BandedMatrix, K: int, groups: int,
                         block_b: Optional[int] = None, method: str = "inv",
                         truncated: bool = False, store_spikes: bool = False,
                         store_dtype=None, reduced: str = "auto",
                         shift: str = "none", shift_amount: float = 0.0,
                         inverter: str = "auto",
                         spike_dtype=None,
                         store_lt: bool = False) -> SpikeFactor:
    """spike_factor with the partition axis processed in ``groups`` separate
    device programs (one compile, ``groups`` executions).

    Partitions are independent, so each group's full-precision
    intermediates (block conversion, factor scan, spike sweeps) are freed
    before the next group runs — peak memory is the FINAL factor storage
    plus one group's working set, instead of everything at once, which
    lets factorizations fit that a single program could not.  Same result
    as spike_factor up to f32 summation order (bit-identical in practice:
    per-partition math is unchanged, only batching differs).
    """
    if K % groups or groups < 1:
        raise ValueError(f"groups={groups} must divide K={K}")
    _check_store_lt(store_lt, method)
    if groups == 1 or K == 1:
        return spike_factor(band, K, block_b=block_b, method=method,
                            truncated=truncated, store_spikes=store_spikes,
                            store_dtype=store_dtype, reduced=reduced,
                            shift=shift, shift_amount=shift_amount,
                            inverter=inverter, spike_dtype=spike_dtype,
                            store_lt=store_lt)
    k, b, m = _partition_geometry(band.n, K, band.kl, band.ku, block_b)
    n, kl, ku = band.n, band.kl, band.ku
    Kg = K // groups

    # slice groups out of the ORIGINAL band (a full padded copy of the band
    # would double the band's footprint — the thing this path exists to
    # avoid); only the last group's slice needs row padding.
    # Group results are written into PREALLOCATED full-K buffers via a
    # donated dynamic_update_slice (in-place on device) — the end-of-loop
    # concatenate this replaces transiently doubled the factor footprint;
    # now the peak is the at-rest factor plus one group's working set.
    @partial(jax.jit, donate_argnums=0)
    def _acc(out_tree, piece_tree, g):
        return jax.tree_util.tree_map(
            lambda o, x: jax.lax.dynamic_update_slice_in_dim(
                o, x, g * Kg, axis=0), out_tree, piece_tree)

    out = None
    for g in range(groups):
        r0 = g * Kg * m
        seg = band.data[r0:min((g + 1) * Kg * m, n)]
        if seg.shape[0] < Kg * m:
            seg = pad_banded(BandedMatrix(data=seg, kl=kl, ku=ku),
                             Kg * m).data
        Btip_g, Ctip_g = _extract_tips(seg, Kg, m, k, kl, ku,
                                       zero_boundaries=False)
        local_g = seg.reshape(Kg, m, kl + ku + 1)
        if g == groups - 1:
            Btip_g = Btip_g.at[Kg - 1].set(0)
        if g == 0:
            Ctip_g = Ctip_g.at[0].set(0)
        piece = (*_group_factor_impl(
            local_g, Btip_g, Ctip_g, kl=kl, ku=ku, b=b, k=k,
            method=method, shift=shift, shift_amount=shift_amount,
            inverter=inverter, store_spikes=store_spikes,
            store_dtype=store_dtype, spike_dtype=spike_dtype,
            store_lt=store_lt),
            Btip_g, Ctip_g)
        if out is None:
            out = jax.tree_util.tree_map(
                lambda x: jnp.zeros((K,) + x.shape[1:], x.dtype), piece)
        out = _acc(out, piece, g)
    fact, V, W, (V_top, V_bot, W_top, W_bot), Lb, Btip, Ctip = out
    if not store_spikes:
        V = W = None
    if not store_lt:
        Lb = None

    red_fact = red_Dinv = None
    if K > 1:
        red_fact, red_Dinv = _reduced_from_tips(
            V_top, V_bot, W_top, W_bot, truncated=truncated, method=method,
            reduced=reduced, inverter=inverter)
    return SpikeFactor(fact=fact, Btip=Btip, Ctip=Ctip, red_fact=red_fact,
                       red_Dinv=red_Dinv, V=V, W=W, n=n, K=K, m=m, b=b,
                       k=k, truncated=truncated, Lb=Lb)


def _check_store_lt(store_lt: bool, method: str) -> None:
    if store_lt and method != "inv":
        raise ValueError(
            "store_lt builds the regular-form transpose factor, which "
            f"needs method='inv' block-Thomas factors (got {method!r})")


def spike_factor(band: BandedMatrix, K: int, block_b: Optional[int] = None,
                 method: str = "inv", truncated: bool = False,
                 store_spikes: bool = False, store_dtype=None,
                 reduced: str = "auto", shift: str = "none",
                 shift_amount: float = 0.0,
                 inverter: str = "auto", spike_dtype=None,
                 store_lt: bool = False) -> SpikeFactor:
    """Factor a banded matrix for SPIKE solves over K partitions.

    Args:
      band: banded matrix in diagonal-offset storage.
      K: number of partitions (1 = plain block-Thomas direct solve).
      block_b: block size (defaults to the tip size; the flagship uses 128,
        which the Pallas sweep kernels take).
      method: per-partition factorization — "inv" (block-Thomas with stored
        Schur inverses, matmul-only solves), "lu" (pivoted LU factors, f64
        parity), "cr" (cyclic reduction: log-depth factor latency,
        ~2x stored blocks), or "spd" (symmetric/Hermitian block-LDL^H for
        SPD matrices: stores only F + Sinv = 2/3 of "inv"'s factor memory,
        self-transpose; the band must be symmetric — U blocks are ignored).
      truncated: drop the reduced system's inter-interface coupling — exact
        only in the diagonally-dominant limit (the classic truncated SPIKE).
      store_spikes: keep full V, W spikes for 1-sweep solves (memory K*m*k*2).
      store_dtype: downcast stored factors (e.g. jnp.bfloat16): solve sweeps
        are factor-read-bound, so this ~halves solve time; pair with
        iterative refinement (richardson + this factorization as PC) to
        recover accuracy.
      reduced: interface-system solver — "thomas" (sequential scan),
        "cr" (cyclic reduction, log-depth), or "auto" (cr when K > 255;
        below that the short Thomas scan beats CR's level-dispatch
        overhead on the fused-sweep path — see reduced_factor).
      shift: "none" or "nonzero" — in-scan diagonal-pivot boosting (PETSc
        ``-pc_factor_shift_type nonzero`` parity; the boosted count lands in
        ``fact.nshift`` and in factor_health reports).
      shift_amount: absolute pivot floor for shift="nonzero" (0 = relative
        floor only: 1e-10 * max|block|).
      spike_dtype: downcast ONLY the stored V/W spikes (e.g. jnp.bfloat16)
        while factors stay full precision.  The spikes carry a rank-k
        boundary correction on top of an exact local solve, so bf16 spikes
        trade some residual for ~0.8 GB less per-solve streaming at the
        flagship size — a cheap preconditioner-grade mode.
      inverter: batched-inverse engine for the Schur/CR blocks — "newton"
        (Newton–Schulz, batched matmuls, needs the near-diagonally-dominant
        regime the scaling pipeline provides), "blocked", "lapack", or
        "auto" (newton on the GPU, lapack elsewhere: utils.platform).  If
        factor_health reports a bad newton factorization, re-factor with
        inverter="blocked".
      store_lt: keep the subdiagonal blocks L ([K, nb, b, b], at
        store_dtype) so ``spike_transpose`` can build the REGULAR-form
        (fused-kernel-capable) transpose factor with no band and no
        band->blocktri reconversion — the blocks were computed during this
        factorization anyway.  Costs one factor-component of storage; pick
        it when transposes are applied often (bicg, adjoint-heavy loops)
        and the original band won't be kept around.  method='inv' only.
    """
    _check_store_lt(store_lt, method)
    return _spike_factor_impl(
        band.data, n=band.n, kl=band.kl, ku=band.ku, K=K, block_b=block_b,
        method=method, truncated=truncated, store_spikes=store_spikes,
        store_dtype=store_dtype, reduced=reduced, shift=shift,
        shift_amount=shift_amount, inverter=inverter,
        spike_dtype=spike_dtype, store_lt=store_lt)


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------

def _solve_reduced_system(red_fact, rhs):
    """Dispatch on the stored reduced factorization type (Thomas vs CR)."""
    from .cyclic import CRFactor, cr_solve
    if isinstance(red_fact, CRFactor):
        return cr_solve(red_fact, rhs)
    return blocktri_solve(red_fact, rhs)


def _batched_tri_solve(fact, rhs):
    """Per-partition batched solve, dispatching on factorization type
    (block-Thomas BlockTriFactor, its transpose marker, or cyclic-reduction
    CRFactor)."""
    from .blocktri import TransposedBlockTriFactor, blocktri_solve_transpose
    from .cyclic import CRFactor, cr_solve
    if isinstance(fact, TransposedBlockTriFactor):
        return jax.vmap(blocktri_solve_transpose)(fact.base, rhs)
    if isinstance(fact, CRFactor):
        return jax.vmap(cr_solve)(fact, rhs)
    return jax.vmap(blocktri_solve)(fact, rhs)


def _spike_columns(fact, Btip, Ctip, nb: int, b: int, k: int, dtype):
    """Spike columns V = A_p^{-1} E_bot B_p and W = A_p^{-1} E_top C_p.

    For method='inv' block-Thomas factors this exploits the right-hand-side
    structure: V's forward sweep is free (its RHS is nonzero only in the last
    block, so y_V = e_{nb-1} x B-rows), and V and W share one combined
    backward sweep — factors stream once for the forward (F) and once for
    the backward (Sinv, U) instead of twice each.  Other factor types take the
    generic two-solve path.
    """
    from .blocktri import _sweep_matvec as mv

    generic = not (isinstance(fact, BlockTriFactor)
                   and fact.method in ("inv", "spd"))
    if generic:
        K = Btip.shape[0]
        rhsV = jnp.zeros((K, nb, b, k), dtype).at[:, nb - 1, b - k:, :].set(Btip)
        rhsW = jnp.zeros((K, nb, b, k), dtype).at[:, 0, :k, :].set(Ctip)
        return _batched_tri_solve(fact, rhsV), _batched_tri_solve(fact, rhsW)

    def per_partition(f, Bt, Ct):
        Cb = jnp.zeros((b, k), dtype).at[:k, :].set(Ct)

        def fwd(y_prev, fi):
            y = -mv(fi, y_prev)
            return y, y

        _, yw_rest = jax.lax.scan(fwd, Cb, f.F[1:])
        yw = jnp.concatenate([Cb[None], yw_rest], axis=0)    # [nb, b, k]
        return _spike_bwd_one(f, Bt, yw, b, k, dtype)

    return jax.vmap(per_partition)(fact, Btip, Ctip)


def _spike_bwd_one(f, Bt, yw, b: int, k: int, dtype):
    """Shared V/W backward sweep for one partition given the W forward
    sweep result ``yw`` (from ``_spike_columns``'s fwd scan, or fused into
    the factor scan by ``blocktri_factor_inv_waux``)."""
    from .blocktri import _sweep_matvec as mv

    Bb = jnp.zeros((b, k), dtype).at[b - k:, :].set(Bt)
    x_last = mv(f.Sinv[-1], jnp.concatenate([Bb, yw[-1]], axis=-1))

    if f.method == "spd":
        # symmetric factors store no U: the backward sweep reads F^H
        # (blocktri_solve's spd branch formula, multi-column form)
        tH = lambda a: jnp.swapaxes(a, -1, -2).conj()

        def bwd_spd(x_next, inputs):
            sinv, f_next, ywi = inputs
            y = jnp.concatenate([jnp.zeros((b, k), x_next.dtype), ywi],
                                axis=-1)                     # [b, 2k]
            x = mv(sinv, y) - mv(tH(f_next), x_next)
            return x, x

        _, x_rest = jax.lax.scan(
            bwd_spd, x_last, (f.Sinv[:-1], f.F[1:], yw[:-1]), reverse=True)
        x = jnp.concatenate([x_rest, x_last[None]], axis=0)
        return x[..., :k], x[..., k:]

    def bwd(x_next, inputs):
        sinv, u, ywi = inputs
        y = jnp.concatenate([jnp.zeros((b, k), x_next.dtype), ywi],
                            axis=-1)                         # [b, 2k]
        x = mv(sinv, y - mv(u, x_next))
        return x, x

    _, x_rest = jax.lax.scan(
        bwd, x_last, (f.Sinv[:-1], f.U[:-1], yw[:-1]), reverse=True)
    x = jnp.concatenate([x_rest, x_last[None]], axis=0)      # [nb, b, 2k]
    return x[..., :k], x[..., k:]


def _spike_columns_from_waux(fact, Btip, yw, b: int, k: int, dtype):
    """V/W spikes when the W forward sweep was fused into the factor scan."""
    return jax.vmap(
        lambda f, Bt, ywp: _spike_bwd_one(f, Bt, ywp, b, k, dtype)
    )(fact, Btip, yw)


def spike_transpose(sf: SpikeFactor, reduced: str = "auto",
                    inverter: str = "auto",
                    store_spikes: Optional[bool] = None,
                    band: Optional[BandedMatrix] = None,
                    fast: bool = True) -> SpikeFactor:
    """SPIKE factorization of A^T REUSING A's per-partition factors — no
    band transpose, no conversion, no new block inversions (the expensive
    setup stages all vanish).  The returned SpikeFactor solves A^T x = rhs
    through the ordinary ``spike_solve``/``spike_solve_many``.

    Construction: partition diagonal blocks transpose in place (the local
    solves dispatch to ``blocktri_solve_transpose`` via the
    ``TransposedBlockTriFactor`` marker); the coupling tips swap and
    transpose (A^T couples partition p forward through C_{p+1}^T and
    backward through B_{p-1}^T); the transpose spikes are two batched
    transpose tri-solves; the reduced interface system is reassembled from
    their tips (small).  Setup cost = one stored-spike computation, vs a
    full refactorization for ``spike_factor(banded_transpose(band))``.

    Pure transpose (no conjugation) — for a complex adjoint solve use
    conj(spike_solve(spike_transpose(sf), conj(g))).

    ``store_spikes``: None (default) stores V/W iff the forward factor did.
    This is the PETSc MatSolveTranspose/PCApplyTranspose capability
    (exercised by KSPs that need A^T and by the implicit-adjoint backward
    pass of ops.autodiff).

    REGULAR-form transpose (``fast=True``, the default when the inputs
    allow it): build a real BlockTriFactor for A^T — the standard sweeps,
    fused Pallas kernel included, compute the transpose solve at
    forward-solve speed; the marker form runs the XLA scan.  The L blocks
    it needs come from, in preference order:

    * ``sf.Lb`` — stored at factor time (``spike_factor(store_lt=True)``);
      zero extra setup work here.
    * ``band`` — the ORIGINAL banded matrix; costs one band->blocktri
      conversion at setup (only the L blocks are consumed).

    Either way it materializes a second factor-sized buffer; worth it when
    the transpose is applied many times (bicg serving, adjoint-heavy
    optimization loops).  method='inv' only; ``fast=False`` forces the
    zero-memory marker form.
    """
    from .blocktri import TransposedBlockTriFactor
    if not isinstance(sf.fact, BlockTriFactor):
        raise ValueError(
            "spike_transpose requires block-Thomas partition factors "
            f"(got {type(sf.fact).__name__}); refactor with method='inv' "
            "or 'lu'")
    K, nb, b, k = sf.K, sf.nb, sf.b, sf.k
    dtype = sf.Btip.dtype
    if (sf.fact.method == "spd"
            and not jnp.issubdtype(dtype, jnp.complexfloating)):
        # a real symmetric factorization is its own transpose — zero-cost
        # PCApplyTranspose/MatSolveTranspose (complex Hermitian factors fall
        # through to the marker path: A^T = conj(A) needs the conjugated
        # sweeps of blocktri_solve_transpose's spd branch)
        return sf
    if fast and sf.Lb is not None and sf.fact.method == "inv":
        from .blocktri import transposed_factor_from_L
        factT = transposed_factor_from_L(sf.fact, sf.Lb)
    elif fast and band is not None and sf.fact.method == "inv":
        from .blocktri import transposed_factor_from_blocks
        bpad = pad_banded(band, K * sf.m)
        # same chunked conversion as the forward factor (the unchunked skew
        # intermediate peaks at ~3x the block storage)
        blocks = _band_to_blocks_chunked(bpad, K, sf.m, b, band.kl, band.ku)
        factT = transposed_factor_from_blocks(sf.fact, blocks)
    else:
        factT = TransposedBlockTriFactor(sf.fact)
    tT = lambda a: jnp.swapaxes(a, -1, -2)
    zk = jnp.zeros((1, k, k), dtype)
    Btip_t = jnp.concatenate([tT(sf.Ctip[1:]), zk], axis=0)
    Ctip_t = jnp.concatenate([zk, tT(sf.Btip[:-1])], axis=0)
    if K == 1:
        return SpikeFactor(fact=factT, Btip=Btip_t, Ctip=Ctip_t,
                           red_fact=None, red_Dinv=None, V=None, W=None,
                           n=sf.n, K=K, m=sf.m, b=b, k=k,
                           truncated=sf.truncated)
    rhsV = jnp.zeros((K, nb, b, k), dtype).at[:, nb - 1, b - k:, :].set(
        Btip_t)
    rhsW = jnp.zeros((K, nb, b, k), dtype).at[:, 0, :k, :].set(Ctip_t)
    Vt = _batched_tri_solve(factT, rhsV)
    Wt = _batched_tri_solve(factT, rhsW)
    red_fact_t, red_Dinv_t = _reduced_from_tips(
        Vt[:, 0, :k, :], Vt[:, nb - 1, b - k:, :],
        Wt[:, 0, :k, :], Wt[:, nb - 1, b - k:, :],
        truncated=sf.truncated,
        method=sf.fact.method, reduced=reduced, inverter=inverter)
    keep = (sf.V is not None) if store_spikes is None else store_spikes
    if keep:
        sdt = sf.V.dtype if sf.V is not None else Vt.dtype
        V, W = Vt.astype(sdt), Wt.astype(sdt)
    else:
        V = W = None
    return SpikeFactor(fact=factT, Btip=Btip_t, Ctip=Ctip_t,
                       red_fact=red_fact_t, red_Dinv=red_Dinv_t, V=V, W=W,
                       n=sf.n, K=K, m=sf.m, b=b, k=k, truncated=sf.truncated)


def _reduced_solve(sf: SpikeFactor, g_bot: jax.Array, g_top: jax.Array):
    """Solve for interface unknowns. Returns (xbot_prev, xtop_next):
    xtop_next[p] = x_{p+1}^top (zero for p = K-1),
    xbot_prev[p] = x_{p-1}^bot (zero for p = 0)."""
    K, k = sf.K, sf.k
    rhs = jnp.concatenate([g_bot[:-1], g_top[1:]], axis=1)   # [K-1, 2k]
    if sf.truncated:
        z = jnp.einsum("jpq,jq->jp", sf.red_Dinv, rhs,
                       precision=sweep_precision(sf.red_Dinv, rhs))
    else:
        z = _solve_reduced_system(sf.red_fact, rhs)
    x_bot = z[:, :k]        # x_p^bot for p = 0..K-2
    x_top = z[:, k:]        # x_{p+1}^top for p = 0..K-2
    zk = jnp.zeros((1, k), z.dtype)
    xtop_next = jnp.concatenate([x_top, zk], axis=0)         # [K, k]
    xbot_prev = jnp.concatenate([zk, x_bot], axis=0)         # [K, k]
    return xbot_prev, xtop_next


def _resolve_impl(sf: SpikeFactor, impl: str, rhs_dtype=jnp.float32,
                  interpret: bool = False) -> str:
    """'auto' picks the Pallas sweep kernels when the backend runs them
    (utils.platform) and the factors suit them (ops/pallas/fused_sweep.py:
    method='inv'/'spd', f32/bf16 storage, f32 rhs); otherwise the XLA
    scan.  An explicit 'pallas_fused' raises where it cannot run."""
    from ..utils import platform
    from .pallas.fused_sweep import fused_sweep_feasible
    if impl == "auto":
        if platform.gpu_kernels_available() and fused_sweep_feasible(
                sf.fact, sf.b, rhs_dtype):
            return "pallas_fused"
        return "xla"
    if impl == "xla":
        return impl
    if impl != "pallas_fused":
        raise ValueError(f"unknown solve impl {impl!r}: expected 'auto', "
                         f"'xla' or 'pallas_fused'")
    platform.require_gpu_kernels("impl='pallas_fused'", interpret)
    return impl


def _make_batched_solve(sf: SpikeFactor, impl: str, many: bool = False,
                        interpret: bool = False):
    if impl == "pallas_fused":
        from .pallas.fused_sweep import (blocktri_solve_fused_many_pallas,
                                         blocktri_solve_fused_pallas)
        kern = (blocktri_solve_fused_many_pallas if many
                else blocktri_solve_fused_pallas)
        return partial(kern, sf.fact, interpret=interpret)
    return partial(_batched_tri_solve, sf.fact)


@partial(jax.jit, static_argnames=("impl", "interpret"))
def spike_solve(sf: SpikeFactor, rhs: jax.Array, impl: str = "auto",
                interpret: bool = False) -> jax.Array:
    """Solve A x = rhs with a SPIKE factorization.  rhs: [n] (original size).

    impl: "auto" (the Pallas sweep kernels where the backend and factors
    allow, else XLA), "xla" (lax.scan sweeps), or "pallas_fused" (one
    program per partition walking its block chain in-kernel,
    ops/pallas/fused_sweep.py; CUDA GPUs only).  ``interpret`` runs the
    kernels in the Pallas interpreter (tests).
    """
    K, m, b, k, nb = sf.K, sf.m, sf.b, sf.k, sf.nb
    rp = jnp.zeros((K * m,), rhs.dtype).at[:sf.n].set(rhs)
    rblk = rp.reshape(K, nb, b)

    impl = _resolve_impl(sf, impl, rhs.dtype, interpret)
    batched_solve = _make_batched_solve(sf, impl, interpret=interpret)

    g = batched_solve(rblk)                                  # [K, nb, b]
    if K == 1:
        return g.reshape(-1)[:sf.n]

    g_bot = g[:, nb - 1, b - k:]
    g_top = g[:, 0, :k]
    xbot_prev, xtop_next = _reduced_solve(sf, g_bot, g_top)

    if sf.V is not None:
        # one-sweep: x = g - V x_{p+1}^top - W x_{p-1}^bot
        prec = sweep_precision(sf.V, g)
        x = (g - jnp.einsum("pnbk,pk->pnb", sf.V, xtop_next, precision=prec)
               - jnp.einsum("pnbk,pk->pnb", sf.W, xbot_prev, precision=prec))
    else:
        # recompute sweep: solve with boundary-corrected RHS
        prec = sweep_precision(sf.Btip, g)
        corrB = jnp.einsum("prc,pc->pr", sf.Btip, xtop_next,
                           precision=prec)                     # [K, k]
        corrC = jnp.einsum("prc,pc->pr", sf.Ctip, xbot_prev,
                           precision=prec)
        r2 = rblk.at[:, nb - 1, b - k:].add(-corrB)
        r2 = r2.at[:, 0, :k].add(-corrC)
        x = batched_solve(r2)
    return x.reshape(-1)[:sf.n]


@partial(jax.jit, static_argnames=("impl", "interpret"))
def spike_solve_many(sf: SpikeFactor, rhs: jax.Array, impl: str = "auto",
                     interpret: bool = False) -> jax.Array:
    """Blocked multi-RHS solve; rhs [n, r] -> x [n, r].

    Streams the factorization ONCE for all right-hand sides (the sweeps are
    factor-read-bound, so r solves cost barely more than one) — the batched
    solve mode of BASELINE config 2 and the serving path.

    impl / interpret: as for ``spike_solve`` (the multi-RHS kernel runs
    16 columns per program).
    """
    K, m, b, k, nb = sf.K, sf.m, sf.b, sf.k, sf.nb
    r = rhs.shape[1]
    rp = jnp.zeros((K * m, r), rhs.dtype).at[:sf.n].set(rhs)
    rblk = rp.reshape(K, nb, b, r)

    impl = _resolve_impl(sf, impl, rhs.dtype, interpret)
    batched_solve = _make_batched_solve(sf, impl, many=True,
                                        interpret=interpret)

    g = batched_solve(rblk)                                  # [K, nb, b, r]
    if K == 1:
        return g.reshape(K * m, r)[:sf.n]

    g_bot = g[:, nb - 1, b - k:, :]                          # [K, k, r]
    g_top = g[:, 0, :k, :]
    red_rhs = jnp.concatenate([g_bot[:-1], g_top[1:]], axis=1)  # [K-1,2k,r]
    if sf.truncated:
        z = jnp.einsum("jpq,jqr->jpr", sf.red_Dinv, red_rhs,
                       precision=sweep_precision(sf.red_Dinv, red_rhs))
    else:
        z = _solve_reduced_system(sf.red_fact, red_rhs)
    zk = jnp.zeros((1, k, r), z.dtype)
    xtop_next = jnp.concatenate([z[:, k:, :], zk], axis=0)   # [K, k, r]
    xbot_prev = jnp.concatenate([zk, z[:, :k, :]], axis=0)

    if sf.V is not None:
        prec = sweep_precision(sf.V, g)
        x = (g - jnp.einsum("pnbk,pkr->pnbr", sf.V, xtop_next,
                            precision=prec)
               - jnp.einsum("pnbk,pkr->pnbr", sf.W, xbot_prev,
                            precision=prec))
    else:
        prec = sweep_precision(sf.Btip, g)
        corrB = jnp.einsum("pcd,pdr->pcr", sf.Btip, xtop_next,
                           precision=prec)
        corrC = jnp.einsum("pcd,pdr->pcr", sf.Ctip, xbot_prev,
                           precision=prec)
        r2 = rblk.at[:, nb - 1, b - k:, :].add(-corrB)
        r2 = r2.at[:, 0, :k, :].add(-corrC)
        x = batched_solve(r2)
    return x.reshape(K * m, r)[:sf.n]
