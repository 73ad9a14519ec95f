"""Multi-chip SPIKE: partitions-per-device factorization, solves, and matvec.

This is the replacement for the reference's MPI layer: where
spike-petsc exchanges duals and assembles global quantities through
``VecScatter`` and ``MPI_Allreduce`` (/root/reference/src/wbm.c:270-273, 546),
here K = n_devices * parts_per_device band partitions live across a mesh
axis and

* each device factors its ``ppd`` partitions as one batched block-Thomas
  sweep (the same batching as the single-chip path),
* tip/interface exchange is a ``jax.lax.all_gather`` over the "p" axis
  (O(K * k^2) bytes — tiny),
* the reduced block-tridiagonal system is factored/solved *replicated* on
  every device (redundant flops instead of a scatter round-trip),
* the Krylov-side banded SpMV resolves intra-device partition coupling with
  local slices and exchanges only the k-wide device-boundary strips with
  ``jax.lax.ppermute`` (nearest-neighbour traffic only),
* dot products psum over "p" (solvers pass ``axis_name`` to the KSP).

Feature parity with the single-chip path (ops.spike): stored V/W spikes for
1-sweep PCApplies, bf16 factor/spike storage, diagonal-shift pivot boosting,
inverter selection with the Newton-probe safety net, and true multi-RHS
serving (``local_spike_solve_many`` / ``dist_spike_solve_many``) where the
factors stream ONCE for all right-hand sides.

Everything is expressed with ``jax.shard_map`` so the communication pattern
is explicit and XLA compiles one fused multi-chip program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.band import BandedMatrix, pad_banded
from ..ops.blocktri import (BlockTridiagonal, BlockTriFactor, band_to_blocktri,
                            blocktri_factor, blocktri_matvec, blocktri_solve,
                            sweep_precision,
                            transposed_factor_from_blocks as
                            _fast_transposed_factor)
from ..ops.spike import _batched_tri_solve, _partition_geometry
from ..solvers import krylov
from ..solvers.krylov_many import MANY_SOLVERS
from ..utils.jit import jit_closure
from ..utils.registry import SOLVERS


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DistSpikeFactor:
    """Device-sharded SPIKE factorization (leading dim = K global
    partitions, sharded over the mesh axis in contiguous groups of ppd)."""

    blocks: BlockTridiagonal        # [K, nb, b, b] x3, sharded on K
    fact: BlockTriFactor            # [K, ...], sharded on K
    Btip: jax.Array                 # [K, k, k], sharded
    Ctip: jax.Array                 # [K, k, k], sharded
    red_fact: Optional[BlockTriFactor]  # replicated reduced factorization
    red_Dinv: Optional[jax.Array]       # replicated truncated inverses
    V: Optional[jax.Array]          # [K, nb, b, k] right spikes (store_spikes)
    W: Optional[jax.Array]          # [K, nb, b, k] left spikes (store_spikes)
    n: int = field(metadata=dict(static=True))
    K: int = field(metadata=dict(static=True))
    m: int = field(metadata=dict(static=True))
    b: int = field(metadata=dict(static=True))
    k: int = field(metadata=dict(static=True))
    ppd: int = field(metadata=dict(static=True))     # partitions per device
    truncated: bool = field(metadata=dict(static=True))

    @property
    def nb(self) -> int:
        return self.m // self.b


def _local_tips_one(data_one: jax.Array, gidx, m: int, k: int, kl: int,
                    ku: int, K: int):
    """k x k coupling corners of ONE partition; zeroed at the global edges
    (same flatten-and-reskew form as ops.spike._extract_tips)."""
    from ..ops.spike import _skew_tip
    Btip = _skew_tip(jnp.pad(data_one[m - k:, :], ((0, 0), (0, 2 * k))),
                     k + kl, k)
    Ctip = _skew_tip(jnp.pad(data_one[:k, :], ((0, 0), (2 * k, 0))),
                     k + kl, k)
    Btip = jnp.where(gidx == K - 1, jnp.zeros_like(Btip), Btip)
    Ctip = jnp.where(gidx == 0, jnp.zeros_like(Ctip), Ctip)
    return Btip, Ctip


def _build_reduced(Vt, Vb, Wt, Wb, K: int, k: int, truncated: bool,
                   method: str, reduced: str = "auto",
                   inverter: str = "auto"):
    """Assemble + factor the reduced interface system from gathered tips.
    Identical math to the single-chip path (ops.spike), executed replicated
    on every device.  ``reduced`` selects thomas/cr/auto: cyclic reduction
    keeps the replicated interface solve log-depth at large K (the
    recursive-SPIKE role; VERDICT r1 item 5).  Delegates to the shared
    assembly (ops.spike._reduced_from_tips) with the distributed default
    CR threshold (K-1 >= 33)."""
    from ..ops.spike import _reduced_from_tips
    return _reduced_from_tips(Vt, Vb, Wt, Wb, truncated=truncated,
                              method=method, reduced=reduced,
                              inverter=inverter, cr_threshold=33)


def _local_factor_fn(method: str, shift: str, shift_amount, inverter: str):
    """Per-device batched factorization closure [ppd, nb, b, b] -> fact."""
    if method == "cr":
        from ..ops.cyclic import cr_factor
        return jax.vmap(partial(cr_factor, shift=shift,
                                shift_amount=shift_amount,
                                inverter=inverter))
    return jax.vmap(partial(blocktri_factor, method=method, shift=shift,
                            shift_amount=shift_amount, inverter=inverter))


def _factor_and_spikes(blocks, Btip, Ctip, factor_fn, method: str, shift,
                       shift_amount, inverter, nb: int, b: int, k: int):
    """Per-device batched factor + V/W spikes.  For method='inv' the
    W-spike forward sweep is fused into the factor scan
    (ops.blocktri.blocktri_factor_inv_waux — one pass over F instead of
    two), matching the single-chip _finish_factor path; other methods take
    the generic factor + _spike_columns pair."""
    dtype = blocks.dtype
    if method == "inv":
        from ..ops.blocktri import blocktri_factor_inv_waux
        from ..ops.spike import _spike_columns_from_waux
        Cb = jnp.zeros((Ctip.shape[0], b, k), dtype).at[:, :k, :].set(Ctip)
        fact, yw = jax.vmap(partial(blocktri_factor_inv_waux, shift=shift,
                                    shift_amount=shift_amount,
                                    inverter=inverter))(blocks, Cb)
        Vfull, Wfull = _spike_columns_from_waux(fact, Btip, yw, b, k, dtype)
    else:
        from ..ops.spike import _spike_columns
        fact = factor_fn(blocks)
        Vfull, Wfull = _spike_columns(fact, Btip, Ctip, nb, b, k, dtype)
    return fact, Vfull, Wfull


def _cast_local(fact, V, W, method: str, store_dtype, spike_dtype):
    """Mixed-precision storage, identical to the single-chip path: factors
    (and V/W) downcast to ``store_dtype``; ``spike_dtype`` downcasts ONLY
    the stored spikes (accuracy-free — they decay away from interfaces)."""
    if store_dtype is not None:
        if method == "cr":
            from ..ops.cyclic import cast_cr_factor
            fact = cast_cr_factor(fact, store_dtype)
        else:
            from ..ops.blocktri import cast_factor
            fact = cast_factor(fact, store_dtype)
        if V is not None:
            V, W = V.astype(store_dtype), W.astype(store_dtype)
    if spike_dtype is not None and V is not None:
        V, W = V.astype(spike_dtype), W.astype(spike_dtype)
    return fact, V, W


def _shard_or_rep(tree, axis):
    """PartitionSpec pytree: P(axis) for leaves with all-positive dims,
    P() for zero-size placeholder fields (see blocktri_factor — XLA
    canonicalizes them replicated) and scalars."""
    def spec(leaf):
        shape = getattr(leaf, "shape", ())
        return P(axis) if (len(shape) and all(d > 0 for d in shape)) else P()
    return jax.tree_util.tree_map(spec, tree)


def dist_spike_factor(band: BandedMatrix, mesh: Mesh, axis: str = "p",
                      method: str = "inv", truncated: bool = False,
                      block_b: Optional[int] = None,
                      parts_per_device: int = 1,
                      reduced: str = "auto",
                      store_spikes: bool = False,
                      store_dtype=None, spike_dtype=None,
                      shift: str = "none", shift_amount: float = 0.0,
                      inverter: str = "auto",
                      safety_net: bool = True) -> DistSpikeFactor:
    """Factor a global banded matrix over the mesh with
    K = n_devices * parts_per_device partitions.

    Accepts the full single-chip option set (see ops.spike.spike_factor):
    ``store_spikes`` keeps V/W so distributed PCApplies stream the factors
    ONCE (one sweep + spike-correction matvec instead of two sweeps);
    ``store_dtype``/``spike_dtype`` are the bf16 mixed-precision modes;
    ``shift`` boosts small Schur pivots in-scan; ``inverter`` selects the
    batched-inverse engine, guarded by the Newton-probe ``safety_net``
    (a distributed probe solve; junk factorizations are silently re-factored
    with inverter='blocked' — the PC layer's host-level retry contract).

    ``reduced``: interface-system factorization — "thomas" (sequential
    scan), "cr" (cyclic reduction, log-depth), "auto" (cr when K-1 >= 33,
    keeping distributed solve latency flat in K).

    The Krylov matvec runs on the stored block-tridiagonal operator
    (``local_matvec``): per-partition block products plus k-wide
    device-edge strips over ppermute."""
    def build(inv):
        return _dist_spike_factor_impl(
            band, mesh, axis, method=method, truncated=truncated,
            block_b=block_b, parts_per_device=parts_per_device,
            reduced=reduced, store_spikes=store_spikes,
            store_dtype=store_dtype, spike_dtype=spike_dtype, shift=shift,
            shift_amount=shift_amount, inverter=inv)

    dsf = build(inverter)
    if safety_net:
        dsf, _ = _dist_safety_net(
            band, dsf, mesh, axis, inverter, store_dtype, spike_dtype,
            lambda: build("blocked"), exact=not truncated)
    return dsf


def _dist_safety_net(band, dsf, mesh, axis, inverter, store_dtype,
                     spike_dtype, refactor, exact: bool = True):
    """The PC layer's Newton-probe retry contract, applied to a distributed
    factorization (ADVICE r2 medium: without this, a non-diagonally-dominant
    matrix factored on a mesh silently yields a garbage preconditioner).
    Runs a distributed probe solve; re-factors with inverter='blocked' when
    the probe residual is junk.  Returns (dsf, fell_back)."""
    from ..solvers.pc import _newton_probe_active, _probe_tolerance
    if not _newton_probe_active(inverter):
        return dsf, False
    import numpy as _np
    # every product runs sharded (dist_matvec): the global band never
    # gathers on one device
    probe = dist_matvec(dsf, jnp.ones((dsf.n,), dsf.Btip.dtype), mesh, axis)
    xs = dist_spike_solve(dsf, probe, mesh, axis)
    err = float(_np.asarray(jnp.linalg.norm(
        dist_matvec(dsf, xs, mesh, axis) - probe) / jnp.linalg.norm(probe)))
    tol = _probe_tolerance(store_dtype, spike_dtype)
    bad = not _np.isfinite(err) or (exact and err > tol) or err > 1e6
    if bad:
        return refactor(), True
    return dsf, False


def _shard_band(band: BandedMatrix, K: int, m: int, sharding) -> jax.Array:
    """The band padded to K*m rows (unit diagonal) as [K, m, w] partitions
    laid out by ``sharding``.  A host (NumPy) band is padded on the host
    and each device receives only its own shard; a device band is padded
    by a program whose output is already sharded — either way no device
    holds the whole band beyond what the caller put there."""
    import numpy as _np
    w = band.width
    if isinstance(band.data, _np.ndarray):
        data = band.data
        if data.shape[0] < K * m:
            pad = _np.zeros((K * m - data.shape[0], w), data.dtype)
            pad[:, band.kl] = 1
            data = _np.concatenate([data, pad], axis=0)
        return jax.device_put(data.reshape(K, m, w), sharding)
    return jax.jit(lambda d: pad_banded(
        BandedMatrix(data=d, kl=band.kl, ku=band.ku), K * m).data.reshape(
            K, m, w), out_shardings=sharding)(band.data)


def _dist_spike_factor_impl(band: BandedMatrix, mesh: Mesh, axis: str,
                            *, method, truncated, block_b, parts_per_device,
                            reduced, store_spikes, store_dtype, spike_dtype,
                            shift, shift_amount,
                            inverter) -> DistSpikeFactor:
    ndev = mesh.shape[axis]
    ppd = parts_per_device
    K = ndev * ppd
    kl, ku = band.kl, band.ku
    n = band.n
    k, b, m = _partition_geometry(n, K, kl, ku, block_b)
    w = band.width
    data = _shard_band(band, K, m, NamedSharding(mesh, P(axis)))

    nb = m // b
    factor_fn = _local_factor_fn(method, shift, shift_amount, inverter)

    def local_setup(data_shard):                    # [ppd, m, w]
        gidx = jax.lax.axis_index(axis) * ppd + jnp.arange(ppd)
        Btip, Ctip = jax.vmap(
            lambda d, g: _local_tips_one(d, g, m, k, kl, ku, K))(
                data_shard, gidx)                   # [ppd, k, k] x2
        # out-of-partition couplings live only in the L[0]/U[nb-1] blocks
        # that band_to_blocktri zeroes (b >= k) — no mask pass needed
        blocks = jax.vmap(
            lambda d: band_to_blocktri(BandedMatrix(data=d, kl=kl, ku=ku),
                                       b))(data_shard)
        fact, Vfull, Wfull = _factor_and_spikes(
            blocks, Btip, Ctip, factor_fn, method, shift, shift_amount,
            inverter, nb, b, k)
        tips = jnp.stack([Vfull[:, 0, :k, :], Vfull[:, nb - 1, b - k:, :],
                          Wfull[:, 0, :k, :], Wfull[:, nb - 1, b - k:, :]],
                         axis=1)                     # [ppd, 4, k, k]
        all_tips = jax.lax.all_gather(tips, axis)    # [ndev, ppd, 4, k, k]
        all_tips = all_tips.reshape(K, 4, k, k)
        red_fact, red_Dinv = _build_reduced(
            all_tips[:, 0], all_tips[:, 1], all_tips[:, 2], all_tips[:, 3],
            K, k, truncated, method, reduced, inverter)
        V, W = (Vfull, Wfull) if store_spikes else (None, None)
        fact, V, W = _cast_local(fact, V, W, method, store_dtype,
                                 spike_dtype)
        return blocks, fact, Btip, Ctip, red_fact, red_Dinv, V, W

    # derive spec pytrees from eval_shape of the actual builders (the
    # factorization structure varies with method/shift/cast; zero-size
    # placeholder fields must stay replicated)
    sds = jax.ShapeDtypeStruct
    blocks_struct = BlockTridiagonal(
        D=sds((ppd, nb, b, b), band.data.dtype),
        L=sds((ppd, nb, b, b), band.data.dtype),
        U=sds((ppd, nb, b, b), band.data.dtype))
    fact_struct = jax.eval_shape(factor_fn, blocks_struct)
    if store_dtype is not None:
        fact_struct = jax.eval_shape(
            lambda f: _cast_local(f, None, None, method, store_dtype,
                                  None)[0], fact_struct)
    fact_specs = _shard_or_rep(fact_struct, axis)
    # reduced-factor structure depends on thomas-vs-cr choice: derive the
    # spec pytree from an eval_shape of the actual builder
    tip_struct = sds((K, k, k), band.data.dtype)
    red_struct, _ = jax.eval_shape(
        partial(_build_reduced, K=K, k=k, truncated=truncated,
                method=method, reduced=reduced, inverter=inverter),
        tip_struct, tip_struct, tip_struct, tip_struct)
    out_specs = (
        jax.tree_util.tree_map(lambda _: P(axis), _blocktri_struct()),
        fact_specs,
        P(axis), P(axis),
        jax.tree_util.tree_map(lambda _: P(), red_struct),
        P() if truncated else None,
        P(axis) if store_spikes else None,
        P(axis) if store_spikes else None,
    )
    blocks, fact, Btip, Ctip, red_fact, red_Dinv, V, W = \
        jax.shard_map(
            local_setup, mesh=mesh, in_specs=(P(axis),),
            out_specs=out_specs, check_vma=False)(data)
    return DistSpikeFactor(blocks=blocks, fact=fact, Btip=Btip, Ctip=Ctip,
                           red_fact=red_fact, red_Dinv=red_Dinv, V=V, W=W,
                           n=n, K=K, m=m, b=b, k=k, ppd=ppd,
                           truncated=truncated)


def _blocktri_struct():
    return BlockTridiagonal(D=0, L=0, U=0)


# ---------------------------------------------------------------------------
# Local (per-device) building blocks, usable inside shard_map.
# Local arrays carry the [ppd, ...] partition batch of this device.
# ---------------------------------------------------------------------------

def local_interface_solve(dsf_local, g_top, g_bot, axis: str):
    """All-gather interface values, replicated reduced solve, slice mine.
    g_top/g_bot: [ppd, k] or [ppd, k, r].
    Returns (xbot_prev, xtop_next) of the same shape."""
    K, k, ppd = dsf_local.K, dsf_local.k, dsf_local.ppd
    gp = jax.lax.axis_index(axis) * ppd + jnp.arange(ppd)   # global ids
    trail = g_top.shape[2:]
    gt = jax.lax.all_gather(g_top, axis).reshape(K, k, *trail)
    gb = jax.lax.all_gather(g_bot, axis).reshape(K, k, *trail)
    rhs = jnp.concatenate([gb[:-1], gt[1:]], axis=1)        # [K-1, 2k, *r]
    if dsf_local.truncated:
        z = jnp.einsum("jpq,jq...->jp...", dsf_local.red_Dinv, rhs,
                       precision=sweep_precision(dsf_local.red_Dinv, rhs))
    else:
        from ..ops.spike import _solve_reduced_system
        z = _solve_reduced_system(dsf_local.red_fact, rhs)
    zpad = jnp.concatenate([z, jnp.zeros((1, 2 * k, *trail), z.dtype)],
                           axis=0)
    # xtop_next[p] = z[p, k:] (p < K-1), xbot_prev[p] = z[p-1, :k] (p > 0)
    mask_next = (gp < K - 1).reshape(ppd, *([1] * (1 + len(trail))))
    mask_prev = (gp > 0).reshape(ppd, *([1] * (1 + len(trail))))
    xtop_next = zpad[jnp.minimum(gp, K - 1), k:] * mask_next
    xbot_prev = zpad[jnp.maximum(gp - 1, 0), :k] * mask_prev
    return xbot_prev, xtop_next


def _local_tri_solve(dsf_local, rblk: jax.Array, impl: str) -> jax.Array:
    """Per-device batched partition solve, rblk [ppd, nb, b] or
    [ppd, nb, b, r]: the Pallas sweep kernels or the XLA scan, chosen
    exactly like ops.spike.spike_solve (the platform seam for 'auto')."""
    from ..ops.spike import _make_batched_solve, _resolve_impl
    impl = _resolve_impl(dsf_local, impl, rblk.dtype)
    return _make_batched_solve(dsf_local, impl, many=rblk.ndim == 4)(rblk)


def _spike_correct(dsf_local, g, rblk, xbot_prev, xtop_next, solve_fn):
    """Shared final SPIKE step: stored-spike 1-sweep correction when V/W
    exist (x = g - V x_next^top - W x_prev^bot — factors streamed ONCE per
    PCApply, as ops.spike.spike_solve:594-598), else the recompute second
    sweep with boundary-corrected RHS.  Shapes: [ppd, nb, b] or
    [ppd, nb, b, r] with interface vectors [ppd, k(, r)]."""
    nb, b, k = dsf_local.nb, dsf_local.b, dsf_local.k
    many = g.ndim == 4
    if dsf_local.V is not None:
        prec = sweep_precision(dsf_local.V, g)
        eq = "pnbk,pkr->pnbr" if many else "pnbk,pk->pnb"
        return (g - jnp.einsum(eq, dsf_local.V, xtop_next, precision=prec)
                  - jnp.einsum(eq, dsf_local.W, xbot_prev, precision=prec))
    prec = sweep_precision(dsf_local.Btip, g)
    eq = "pcd,pdr->pcr" if many else "pcd,pd->pc"
    corrB = jnp.einsum(eq, dsf_local.Btip, xtop_next, precision=prec)
    corrC = jnp.einsum(eq, dsf_local.Ctip, xbot_prev, precision=prec)
    if many:
        r2 = rblk.at[:, nb - 1, b - k:, :].add(-corrB)
        r2 = r2.at[:, 0, :k, :].add(-corrC)
    else:
        r2 = rblk.at[:, nb - 1, b - k:].add(-corrB)
        r2 = r2.at[:, 0, :k].add(-corrC)
    return solve_fn(r2)


def local_spike_solve(dsf_local, rhs_local: jax.Array, axis: str,
                      impl: str = "auto") -> jax.Array:
    """Per-device SPIKE solve of the global system; rhs_local: [ppd * m]."""
    nb, b, k, ppd = dsf_local.nb, dsf_local.b, dsf_local.k, dsf_local.ppd
    rblk = rhs_local.reshape(ppd, nb, b)
    g = _local_tri_solve(dsf_local, rblk, impl)
    if dsf_local.K == 1:
        return g.reshape(-1)
    xbot_prev, xtop_next = local_interface_solve(
        dsf_local, g[:, 0, :k], g[:, nb - 1, b - k:], axis)
    x = _spike_correct(dsf_local, g, rblk, xbot_prev, xtop_next,
                       lambda r2: _local_tri_solve(dsf_local, r2, impl))
    return x.reshape(-1)


def local_spike_solve_many(dsf_local, rblk: jax.Array, axis: str,
                           impl: str = "auto") -> jax.Array:
    """Per-device multi-RHS SPIKE solve; rblk: [ppd, nb, b, r] -> same.

    The distributed serving path (BASELINE config 2's batched mode on a
    mesh): the factor blocks stream once for ALL r right-hand sides, the
    interface all_gather carries [K, k, r] strips, and the reduced system
    is solved for all columns in one replicated call."""
    nb, b, k = dsf_local.nb, dsf_local.b, dsf_local.k
    g = _local_tri_solve(dsf_local, rblk, impl)
    if dsf_local.K == 1:
        return g
    xbot_prev, xtop_next = local_interface_solve(
        dsf_local, g[:, 0, :k, :], g[:, nb - 1, b - k:, :], axis)
    return _spike_correct(
        dsf_local, g, rblk, xbot_prev, xtop_next,
        lambda r2: _local_tri_solve(dsf_local, r2, impl))


def _local_blocks_matvec(dsf_local, xblk: jax.Array) -> jax.Array:
    """Per-device block-tridiagonal matvec (no halo): [ppd, nb, b(, r)].
    band_to_blocktri zeroes each partition's L[0]/U[nb-1], so the
    cross-partition coupling is added by the callers from the tips."""
    return jax.vmap(blocktri_matvec)(dsf_local.blocks, xblk)


def _halo_corrections(x_top, x_bot, axis, ndev):
    """ppermute the k-wide device-boundary strips and form the neighbour
    vectors for the matvec coupling terms.  x_top/x_bot: [ppd, k(, r)] —
    each partition's first/last k rows of x."""
    top_from_next_dev = jax.lax.ppermute(
        x_top[0], axis, [(i, (i - 1) % ndev) for i in range(ndev)])
    bot_from_prev_dev = jax.lax.ppermute(
        x_bot[-1], axis, [(i, (i + 1) % ndev) for i in range(ndev)])
    next_tops = jnp.concatenate([x_top[1:], top_from_next_dev[None]], axis=0)
    prev_bots = jnp.concatenate([bot_from_prev_dev[None], x_bot[:-1]], axis=0)
    return next_tops, prev_bots


def local_matvec(dsf_local, x_local: jax.Array, axis: str) -> jax.Array:
    """Per-device banded SpMV: intra-device partition coupling via local
    slices; only the k-wide device-boundary strips ride ppermute (replacing
    VecScatter halo traffic, /root/reference/src/wbm.c:270-273)."""
    nb, b, k, K = dsf_local.nb, dsf_local.b, dsf_local.k, dsf_local.K
    ppd, m = dsf_local.ppd, dsf_local.m
    xp = x_local.reshape(ppd, m)
    y = _local_blocks_matvec(dsf_local, xp.reshape(ppd, nb, b)).reshape(
        ppd, m)
    if K == 1:
        return y.reshape(-1)
    next_tops, prev_bots = _halo_corrections(
        xp[:, :k], xp[:, -k:], axis, K // ppd)
    prec = sweep_precision(dsf_local.Btip, next_tops)
    y = y.at[:, -k:].add(jnp.einsum("pcd,pd->pc", dsf_local.Btip, next_tops,
                                    precision=prec))
    y = y.at[:, :k].add(jnp.einsum("pcd,pd->pc", dsf_local.Ctip, prev_bots,
                                   precision=prec))
    return y.reshape(-1)


def local_matvec_many(dsf_local, xblk: jax.Array, axis: str) -> jax.Array:
    """Multi-RHS per-device banded SpMV; xblk: [ppd, nb, b, r] -> same.
    Halo strips are [k, r] — still tiny nearest-neighbour traffic."""
    nb, b, k, K = dsf_local.nb, dsf_local.b, dsf_local.k, dsf_local.K
    ppd = dsf_local.ppd
    y = _local_blocks_matvec(dsf_local, xblk)
    if K == 1:
        return y
    next_tops, prev_bots = _halo_corrections(
        xblk[:, 0, :k, :], xblk[:, nb - 1, b - k:, :], axis, K // ppd)
    prec = sweep_precision(dsf_local.Btip, next_tops)
    y = y.at[:, nb - 1, b - k:, :].add(
        jnp.einsum("pcd,pdr->pcr", dsf_local.Btip, next_tops, precision=prec))
    y = y.at[:, 0, :k, :].add(
        jnp.einsum("pcd,pdr->pcr", dsf_local.Ctip, prev_bots, precision=prec))
    return y


# ---------------------------------------------------------------------------
# Global entry points
# ---------------------------------------------------------------------------

def _pad_rows(v: jax.Array, rows: int) -> jax.Array:
    """Zero-pad the leading axis to ``rows`` (a pad, not a scatter: a
    scatter's index constant becomes a hoisted jit constant that JAX cannot
    place on a mesh)."""
    return jnp.pad(v, [(0, rows - v.shape[0])] + [(0, 0)] * (v.ndim - 1))


def _pad_shard_rhs(dsf: DistSpikeFactor, mesh: Mesh, axis: str, rhs):
    rp = _pad_rows(rhs, dsf.K * dsf.m)
    return jax.device_put(rp.reshape(dsf.K, dsf.m),
                          NamedSharding(mesh, P(axis)))


def dist_matvec(dsf: DistSpikeFactor, x, mesh: Mesh,
                axis: str = "p") -> jax.Array:
    """y = A x with the factor's sharded operator (``local_matvec`` on
    every device); x/result [n]."""
    x_sh = _pad_shard_rhs(dsf, mesh, axis, jnp.asarray(x))
    ppd, m = dsf.ppd, dsf.m

    def local_fn(dsf_in, x_local):
        return local_matvec(dsf_in, x_local.reshape(-1), axis).reshape(ppd, m)

    y = jax.shard_map(local_fn, mesh=mesh,
                      in_specs=(_dsf_specs(dsf, axis), P(axis)),
                      out_specs=P(axis), check_vma=False)(dsf, x_sh)
    return y.reshape(-1)[:dsf.n]


def dist_spike_solve(dsf: DistSpikeFactor, rhs, mesh: Mesh,
                     axis: str = "p") -> jax.Array:
    """Direct SPIKE solve of A x = rhs across the mesh; rhs/result [n]."""
    rhs_sh = _pad_shard_rhs(dsf, mesh, axis, jnp.asarray(rhs))
    ppd, m = dsf.ppd, dsf.m

    def local_fn(dsf_in, r_local):
        x = local_spike_solve(dsf_in, r_local.reshape(-1), axis)
        return x.reshape(ppd, m)

    x = jax.shard_map(local_fn, mesh=mesh,
                      in_specs=(_dsf_specs(dsf, axis), P(axis)),
                      out_specs=P(axis), check_vma=False)(dsf, rhs_sh)
    return x.reshape(-1)[:dsf.n]


def dist_spike_solve_many(dsf: DistSpikeFactor, rhs, mesh: Mesh,
                          axis: str = "p") -> jax.Array:
    """Direct multi-RHS SPIKE solve across the mesh; rhs [n, r] -> x [n, r].

    The distributed analogue of ops.spike.spike_solve_many: factors stream
    once for all right-hand sides (the serving economics of BASELINE
    config 2, on a mesh)."""
    rhs = jnp.asarray(rhs)
    r = rhs.shape[1]
    ppd, m, nb, b = dsf.ppd, dsf.m, dsf.nb, dsf.b
    rp = _pad_rows(rhs, dsf.K * m)
    rhs_sh = jax.device_put(rp.reshape(dsf.K, m, r),
                            NamedSharding(mesh, P(axis)))

    def local_fn(dsf_in, r_local):                 # [ppd, m, r]
        rblk = r_local.reshape(ppd, nb, b, r)
        return local_spike_solve_many(dsf_in, rblk, axis).reshape(ppd, m, r)

    x = jax.shard_map(local_fn, mesh=mesh,
                      in_specs=(_dsf_specs(dsf, axis), P(axis)),
                      out_specs=P(axis), check_vma=False)(dsf, rhs_sh)
    return x.reshape(dsf.K * m, r)[:dsf.n]


def _pad_shard_nullspace(ns, dsf: DistSpikeFactor, mesh: Mesh, spec):
    """Shard a NullSpace basis row-block over the mesh exactly like the
    rhs (zero rows in the padding leave every inner product unchanged).
    Returns [K, m, dim]."""
    q = ns.vecs
    qp = _pad_rows(q, dsf.K * dsf.m)
    return jax.device_put(qp.reshape(dsf.K, dsf.m, q.shape[1]),
                          NamedSharding(mesh, spec))


def _remove_local(q_loc, v, axes):
    """MatNullSpaceRemove inside shard_map: project the null-space
    components out of a row-sharded vector.  ``q_loc`` [rows_loc, dim] is
    this device's shard of the orthonormal basis; the dim-sized
    coefficient is the only cross-device traffic (one psum)."""
    q = q_loc.astype(v.dtype)
    hi = jax.lax.Precision.HIGHEST
    coeff = jax.lax.psum(jnp.matmul(jnp.conj(q).T, v, precision=hi), axes)
    return v - jnp.matmul(q, coeff, precision=hi)


def _dsf_specs(dsf: DistSpikeFactor, axis):
    """PartitionSpec pytree matching DistSpikeFactor: partition-sharded
    local fields (zero-size placeholders replicated), replicated
    reduced-system fields."""
    def rep_like(tree):
        return jax.tree_util.tree_map(lambda _: P(), tree)
    return DistSpikeFactor(
        blocks=_shard_or_rep(dsf.blocks, axis),
        fact=_shard_or_rep(dsf.fact, axis),
        Btip=P(axis), Ctip=P(axis),
        red_fact=rep_like(dsf.red_fact),
        red_Dinv=None if dsf.red_Dinv is None else P(),
        V=None if dsf.V is None else P(axis),
        W=None if dsf.W is None else P(axis),
        n=dsf.n, K=dsf.K, m=dsf.m, b=dsf.b, k=dsf.k, ppd=dsf.ppd,
        truncated=dsf.truncated)


def _transpose_local_parts(fact, blocks, Btip, Ctip, *, perm_axes, ndev,
                           ppd, nb, b, k, spike_mask=None, fast=True):
    """Shared per-device construction for the distributed transposes
    (1-D mesh and multislice): tip swap+transpose via one k-wide ppermute
    each way over ``perm_axes`` (stored global-edge zeros wrap around and
    zero the new edges for free), partition-local block transpose
    (cross-partition coupling lives in the tips), and the transpose spikes
    from (optionally ``spike_mask``-ed) tips via batched transpose
    tri-solves on the SAME stored factors.

    Returns (blocks_t, Btip_t, Ctip_t, Vt, Wt, tips[ppd, 4, k, k], factT)
    where ``factT`` is the fast regular-form transposed factor for
    method='inv' (fused-kernel-capable) or None (marker path)."""
    from ..ops.blocktri import TransposedBlockTriFactor
    tT = lambda a: jnp.swapaxes(a, -1, -2)
    ct_next = jax.lax.ppermute(
        Ctip[0], perm_axes, [(i, (i - 1) % ndev) for i in range(ndev)])
    Btip_t = tT(jnp.concatenate([Ctip[1:], ct_next[None]], axis=0))
    bt_prev = jax.lax.ppermute(
        Btip[-1], perm_axes, [(i, (i + 1) % ndev) for i in range(ndev)])
    Ctip_t = tT(jnp.concatenate([bt_prev[None], Btip[:-1]], axis=0))
    zb = jnp.zeros_like(blocks.D[:, :1])
    blocks_t = BlockTridiagonal(
        D=tT(blocks.D),
        L=jnp.concatenate([zb, tT(blocks.U[:, :-1])], axis=1),
        U=jnp.concatenate([tT(blocks.L[:, 1:]), zb], axis=1))
    Bs, Cs = (Btip_t, Ctip_t) if spike_mask is None else \
        spike_mask(Btip_t, Ctip_t)
    if fast and isinstance(fact, BlockTriFactor) and fact.method == "inv":
        factT = _fast_transposed_factor(fact, blocks)
        out_factT = factT
    else:
        factT = TransposedBlockTriFactor(fact)
        out_factT = None
    dtype = Btip.dtype
    rhsV = jnp.zeros((ppd, nb, b, k), dtype).at[
        :, nb - 1, b - k:, :].set(Bs.astype(dtype))
    rhsW = jnp.zeros((ppd, nb, b, k), dtype).at[
        :, 0, :k, :].set(Cs.astype(dtype))
    Vt = _batched_tri_solve(factT, rhsV).astype(dtype)
    Wt = _batched_tri_solve(factT, rhsW).astype(dtype)
    tips = jnp.stack([Vt[:, 0, :k, :], Vt[:, nb - 1, b - k:, :],
                      Wt[:, 0, :k, :], Wt[:, nb - 1, b - k:, :]], axis=1)
    return blocks_t, Btip_t, Ctip_t, Vt, Wt, tips, out_factT


def _keep_spikes(Vt, Wt, keep: bool, sdt):
    if not keep:
        return None, None
    return (Vt, Wt) if sdt is None else (Vt.astype(sdt), Wt.astype(sdt))


def dist_spike_transpose(dsf: DistSpikeFactor, mesh: Mesh, axis: str = "p",
                         reduced: str = "auto", inverter: str = "auto",
                         store_spikes: Optional[bool] = None,
                         fast: bool = True) -> DistSpikeFactor:
    """DistSpikeFactor for A^T REUSING the mesh factorization — the
    distributed form of ops.spike.spike_transpose (no transpose
    refactorization: no conversion, no new block inversions).

    Per device: the block-tridiagonal blocks transpose partition-locally
    (D'=D^T, L'_i=U_{i-1}^T, U'_i=L_{i+1}^T — cross-partition coupling
    lives in the tips); coupling tips swap and transpose with one k-wide
    ppermute each (A^T couples partition p forward through C_{p+1}^T,
    backward through B_{p-1}^T; the stored global-edge zeros propagate so
    no masking is needed); transpose spikes are two batched transpose
    tri-solves; the replicated reduced system is reassembled from their
    all-gathered tips.

    ``fast=True`` (default, method='inv') materializes the REGULAR-form
    transposed factor (blocktri.transposed_factor_from_blocks — transpose
    solves take the standard sweeps, fused Pallas kernel included) at the
    cost of ~a second factor-sized buffer per device; ``fast=False`` (and
    method='lu') shares storage through the ``TransposedBlockTriFactor``
    marker instead (XLA-scan transpose sweeps, zero extra memory).

    The result is a full DistSpikeFactor: ``dist_spike_solve``,
    ``dist_spike_solve_many`` and ``make_dist_solver`` (Krylov on A^T with
    the SPIKE PC) work unchanged.  Pure transpose, no conjugation."""
    if not isinstance(dsf.fact, BlockTriFactor):
        raise ValueError(
            "dist_spike_transpose requires block-Thomas partition factors "
            f"(got {type(dsf.fact).__name__})")
    K, k, ppd, nb, b = dsf.K, dsf.k, dsf.ppd, dsf.nb, dsf.b
    ndev = K // ppd
    method = dsf.fact.method
    keep = (dsf.V is not None) if store_spikes is None else store_spikes
    sdt = dsf.V.dtype if dsf.V is not None else None

    def local_fn(fact, blocks, Btip, Ctip):
        blocks_t, Btip_t, Ctip_t, Vt, Wt, tips, factT = \
            _transpose_local_parts(fact, blocks, Btip, Ctip,
                                   perm_axes=axis, ndev=ndev, ppd=ppd,
                                   nb=nb, b=b, k=k, fast=fast)
        all_tips = jax.lax.all_gather(tips, axis).reshape(K, 4, k, k)
        red_fact, red_Dinv = _build_reduced(
            all_tips[:, 0], all_tips[:, 1], all_tips[:, 2], all_tips[:, 3],
            K, k, dsf.truncated, method, reduced, inverter)
        V, W = _keep_spikes(Vt, Wt, keep, sdt)
        return blocks_t, Btip_t, Ctip_t, red_fact, red_Dinv, V, W, factT

    in_specs = (_shard_or_rep(dsf.fact, axis),
                jax.tree_util.tree_map(lambda _: P(axis), _blocktri_struct()),
                P(axis), P(axis))
    tip_struct = jax.ShapeDtypeStruct((K, k, k), dsf.Btip.dtype)
    red_struct, _ = jax.eval_shape(
        partial(_build_reduced, K=K, k=k, truncated=dsf.truncated,
                method=method, reduced=reduced, inverter=inverter),
        tip_struct, tip_struct, tip_struct, tip_struct)
    factT_spec = _shard_or_rep(
        jax.eval_shape(_fast_transposed_factor, dsf.fact, dsf.blocks),
        axis) if (fast and method == "inv") else None
    out_specs = (
        jax.tree_util.tree_map(lambda _: P(axis), _blocktri_struct()),
        P(axis), P(axis),
        jax.tree_util.tree_map(lambda _: P(), red_struct),
        P() if dsf.truncated else None,
        P(axis) if keep else None,
        P(axis) if keep else None,
        factT_spec,
    )
    blocks_t, Btip_t, Ctip_t, red_fact, red_Dinv, V, W, factT = \
        jax.shard_map(local_fn, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=False)(
            dsf.fact, dsf.blocks, dsf.Btip, dsf.Ctip)
    if factT is None:
        from ..ops.blocktri import TransposedBlockTriFactor as _T
        factT = _T(dsf.fact)
    return DistSpikeFactor(blocks=blocks_t, fact=factT,
                           Btip=Btip_t, Ctip=Ctip_t, red_fact=red_fact,
                           red_Dinv=red_Dinv, V=V, W=W, n=dsf.n, K=K,
                           m=dsf.m, b=b, k=k, ppd=ppd,
                           truncated=dsf.truncated)


def make_dist_solver_batched(dsf: DistSpikeFactor, mesh: Mesh,
                             axis_p: str = "p", axis_rhs: str = "rhs",
                             ksp_type: str = "gmres", use_pc: bool = True,
                             **params):
    """Multi-RHS serving over a 2-D mesh (axis_rhs x axis_p): each rhs-row
    of the mesh holds a replica of the factorization and solves its own
    batch of right-hand sides on its partition sub-axis — the data-parallel
    x model-parallel composition of this framework.

    Returns solve(rhs[R, n]) -> x[R, n] with R divisible by the rhs axis.

    ``ksp_type`` selects the local engine:
      * "preonly"    — one TRUE multi-RHS SPIKE solve (factors stream once
                       for the whole local batch; direct-solve accuracy);
      * "richardson" — multi-RHS iterative refinement X += M^-1 (B - A X)
                       until every column meets rtol (multi-RHS matvec +
                       PCApply; the serving mode for reduced-precision
                       factor storage);
      * "gmres"/"bcgs"/"cg" — BATCHED Krylov (solvers/krylov_many.py):
                       one iteration loop for the whole local batch,
                       multi-RHS matvec/PCApply, per-column convergence
                       (gmres carries a [restart+1, n_local, r] basis —
                       size restart to the batch);
      * other Krylov names — per-RHS solves under lax.map (factors
                       re-streamed per RHS).
    """
    ppd, m, nb, b = dsf.ppd, dsf.m, dsf.nb, dsf.b

    if ksp_type == "preonly":
        def local_fn(dsf_in, r_local):
            # r_local: [Rloc, ppd, m] -> rblk [ppd, nb, b, Rloc]
            rloc = r_local.shape[0]
            rblk = jnp.moveaxis(r_local, 0, -1).reshape(ppd, nb, b, rloc)
            x = local_spike_solve_many(dsf_in, rblk, axis_p)
            return jnp.moveaxis(x.reshape(ppd, m, rloc), -1, 0)
    elif ksp_type == "richardson":
        rtol = params.get("rtol", 1e-8)
        maxit = params.get("maxit", 50)

        def local_fn(dsf_in, r_local):
            rloc = r_local.shape[0]
            rblk = jnp.moveaxis(r_local, 0, -1).reshape(ppd, nb, b, rloc)
            bnorm2 = jax.lax.psum(jnp.sum(
                jnp.square(rblk), axis=(0, 1, 2)), axis_p)     # [Rloc]
            bnorm2 = jnp.maximum(bnorm2, jnp.finfo(rblk.dtype).tiny)

            def resid_rel(X):
                R = rblk - local_matvec_many(dsf_in, X, axis_p)
                rn2 = jax.lax.psum(jnp.sum(jnp.square(R), axis=(0, 1, 2)),
                                   axis_p)
                # pmax over the replica axis: every replica takes the SAME
                # trip count, so the per-trip collectives stay aligned
                # across independent replica groups (see _keep_iterating)
                return R, jax.lax.pmax(
                    jnp.max(jnp.sqrt(rn2 / bnorm2)), axis_rhs)

            # the carry holds the CURRENT iterate's residual so convergence
            # is tested before spending the next correction — checking the
            # pre-update residual costs one wasted matvec + PCApply per
            # solve (code-review r3)
            def body(carry):
                X, R, _, it = carry
                X = X + local_spike_solve_many(dsf_in, R, axis_p)
                R, rel = resid_rel(X)
                return X, R, rel, it + 1

            def cond(carry):
                _, _, rel, it = carry
                return (rel > rtol) & (it < maxit)

            X0 = local_spike_solve_many(dsf_in, rblk, axis_p)
            R0, rel0 = resid_rel(X0)
            X, _, _, _ = jax.lax.while_loop(
                cond, body, (X0, R0, rel0, jnp.int32(1)))
            return jnp.moveaxis(X.reshape(ppd, m, rloc), -1, 0)
    elif ksp_type in MANY_SOLVERS:
        # TRUE batched Krylov: one iteration loop for the whole local RHS
        # batch — multi-RHS matvec + PCApply (factor blocks stream once per
        # iteration for ALL columns), per-column convergence, stacked
        # per-column reductions in one psum (solvers/krylov_many.py)
        method_many = MANY_SOLVERS[ksp_type]

        def local_fn(dsf_in, r_local):                # [Rloc, ppd, m]
            rloc = r_local.shape[0]
            rblk = jnp.moveaxis(r_local, 0, -1).reshape(ppd, nb, b, rloc)
            mvm = lambda X: local_matvec_many(
                dsf_in, X.reshape(ppd, nb, b, rloc), axis_p).reshape(
                    ppd * m, rloc)
            pcm = (lambda X: local_spike_solve_many(
                dsf_in, X.reshape(ppd, nb, b, rloc), axis_p).reshape(
                    ppd * m, rloc)) if use_pc else None
            res = method_many(mvm, rblk.reshape(ppd * m, rloc), None, pcm,
                              axis_name=axis_p, conv_sync_axis=axis_rhs,
                              **params)
            return jnp.moveaxis(res.x.reshape(ppd, m, rloc), -1, 0)
    else:
        method = SOLVERS.get(ksp_type)

        def local_fn(dsf_in, r_local):
            # r_local: [R/n_rhs_dev, ppd, m]
            matvec = lambda v: local_matvec(dsf_in, v, axis_p)
            pc_apply = (lambda v: local_spike_solve(dsf_in, v, axis_p)) \
                if use_pc else None

            def one(rl):
                # conv_sync_axis=axis_rhs: replicas must take identical
                # trip counts or their per-trip collectives misalign
                return method(matvec, rl.reshape(-1), None, pc_apply,
                              axis_name=axis_p, conv_sync_axis=axis_rhs,
                              **params).x.reshape(ppd, m)
            return jax.lax.map(one, r_local)

    # factor fields are sharded over axis_p only (replicated across axis_rhs)
    fact_specs = _dsf_specs(dsf, axis_p)
    rhs_spec = P(axis_rhs, axis_p)
    shmapped = jax.shard_map(local_fn, mesh=mesh,
                             in_specs=(fact_specs, rhs_spec),
                             out_specs=rhs_spec, check_vma=False)

    def solve_fn(rhs):
        R = rhs.shape[0]
        rp = _pad_rows(rhs.T, dsf.K * dsf.m).T
        rhs_sh = jax.device_put(
            rp.reshape(R, dsf.K, dsf.m),
            NamedSharding(mesh, P(axis_rhs, axis_p)))
        x = shmapped(dsf, rhs_sh)
        return x.reshape(R, dsf.K * dsf.m)[:, :dsf.n]

    return jit_closure(solve_fn)


# ---------------------------------------------------------------------------
# Multi-slice layer: slices x intra-slice partitions
# ---------------------------------------------------------------------------
#
# A deployment that spans several groups of devices ("slices" — e.g. hosts)
# joined by a link much slower than the one inside a group keeps ALL
# preconditioner communication intra-slice:
#
#   * rows are split over (slice, p): each slice owns a contiguous row block,
#     SPIKE-factored exactly within the slice (spike-tip all_gather over the
#     "p" axis only);
#   * across slices the preconditioner is block-Jacobi (the slice boundary is
#     treated as a global edge in the reduced system) -- no cross-slice
#     traffic in PCApply;
#   * the matvec keeps the TRUE cross-slice coupling: k-wide boundary strips
#     ride a ppermute over the flattened (slice, p) order, so only the two
#     slice-edge strips per slice cross the slow link;
#   * Krylov dot products psum over both axes (the only other cross-slice
#     traffic).
#
# This replaces the reference's single-level MPI communicator
# (/root/reference/src/wbm.c:270-273) with a hierarchy-aware layout.


def _per_slice_specs(red_tree, axis_slice: str):
    """Specs for a per-slice-varying reduced factorization: leading dim
    sliced over the slice axis; zero-size placeholder leaves (see
    blocktri_factor) stay replicated (XLA canonicalizes them that way)."""
    return _shard_or_rep(red_tree, axis_slice)


def _slice_grouped_grid(n_slices: int, per_slice: int):
    """[n_slices, per_slice] device grid grouped by ``slice_index``, or
    None when the populations cannot supply it (then callers fall back to
    a contiguous reshape of the flat device order).  Validates the SAME
    slices the grid is built from (sorted order): after a partial slice
    failure, populations can be heterogeneous."""
    devs = jax.devices()
    by_slice = {}
    for d in devs:
        by_slice.setdefault(getattr(d, "slice_index", 0), []).append(d)
    chosen = sorted(by_slice)[:n_slices]
    if len(by_slice) >= n_slices and all(
            len(by_slice[s]) >= per_slice for s in chosen):
        return [sorted(by_slice[s], key=lambda d: d.id)[:per_slice]
                for s in chosen]
    return None


def make_mesh_multislice(shape, axes=("slice", "p")) -> Mesh:
    """2-D (slices, chips-per-slice) mesh.  On real multi-slice deployments
    devices are grouped by their ``slice_index`` attribute; on single-slice
    or virtual platforms the flat device order is reshaped contiguously."""
    import numpy as _np
    n_slices, per_slice = shape
    devs = jax.devices()
    need = n_slices * per_slice
    if need > len(devs):
        raise ValueError(f"requested {need} devices, have {len(devs)}")
    grid = _slice_grouped_grid(n_slices, per_slice)
    if grid is not None:
        return Mesh(_np.asarray(grid), tuple(axes))
    return Mesh(_np.asarray(devs[:need]).reshape(n_slices, per_slice),
                tuple(axes))


def dist_spike_factor_multislice(
        band: BandedMatrix, mesh: Mesh, axis_slice: str = "slice",
        axis_p: str = "p", method: str = "inv",
        block_b: Optional[int] = None, parts_per_device: int = 1,
        reduced: str = "auto", store_spikes: bool = False,
        store_dtype=None, spike_dtype=None,
        shift: str = "none", shift_amount: float = 0.0,
        inverter: str = "auto", safety_net: bool = True) -> DistSpikeFactor:
    """Factor over a (slice, p) mesh: exact SPIKE within each slice,
    block-Jacobi coupling across slices (PC-grade; the matvec retains the
    exact cross-slice coupling).  K = n_slices * per_slice * ppd partitions
    total; the returned factor's reduced system is PER-SLICE (replicated
    within a slice, different across slices).

    Accepts the same storage/shift/inverter options as dist_spike_factor;
    stored V/W spikes are computed from the PC tips (slice boundaries
    zeroed), so the 1-sweep PCApply stays within the slice.  The safety
    net's probe tolerance treats the factorization as inexact (block-Jacobi
    across slices drops coupling on purpose), so it only rejects junk."""
    def build(inv):
        return _dist_spike_factor_multislice_impl(
            band, mesh, axis_slice, axis_p, method=method, block_b=block_b,
            parts_per_device=parts_per_device, reduced=reduced,
            store_spikes=store_spikes, store_dtype=store_dtype,
            spike_dtype=spike_dtype, shift=shift,
            shift_amount=shift_amount, inverter=inv)

    dsf = build(inverter)
    if safety_net:
        from ..solvers.pc import _newton_probe_active
        if _newton_probe_active(inverter):
            import numpy as _np
            from ..ops.band import banded_matvec as _bmv
            # block-Jacobi across slices is inexact by design: the probe is
            # a PCApply (not a solve) — reject only non-finite/garbage
            probe = _bmv(band, jnp.ones((band.n,), band.data.dtype))
            res = make_dist_solver_multislice(
                dsf, mesh, axis_slice, axis_p, ksp_type="richardson",
                rtol=1e-30, maxit=1)(probe)
            rel = float(_np.asarray(res.rnorm / jnp.linalg.norm(probe)))
            if not _np.isfinite(rel) or rel > 1e6:
                dsf = build("blocked")
    return dsf


def _dist_spike_factor_multislice_impl(
        band: BandedMatrix, mesh: Mesh, axis_slice: str, axis_p: str,
        *, method, block_b, parts_per_device, reduced, store_spikes,
        store_dtype, spike_dtype, shift, shift_amount,
        inverter) -> DistSpikeFactor:
    n_slices = mesh.shape[axis_slice]
    ndev_p = mesh.shape[axis_p]
    ppd = parts_per_device
    Ks = ndev_p * ppd                     # partitions per slice
    K = n_slices * Ks
    kl, ku = band.kl, band.ku
    n = band.n
    k, b, m = _partition_geometry(n, K, kl, ku, block_b)
    w = band.width
    data = _shard_band(band, K, m,
                       NamedSharding(mesh, P((axis_slice, axis_p))))
    nb = m // b
    factor_fn = _local_factor_fn(method, shift, shift_amount, inverter)

    def local_setup(data_shard):                    # [ppd, m, w]
        sidx = jax.lax.axis_index(axis_slice)
        pidx = jax.lax.axis_index(axis_p)
        gidx = (sidx * ndev_p + pidx) * ppd + jnp.arange(ppd)
        # true matrix tips (global edges zeroed) — used by the matvec
        Btip, Ctip = jax.vmap(
            lambda d, g: _local_tips_one(d, g, m, k, kl, ku, K))(
                data_shard, gidx)
        # locality is enforced by band_to_blocktri's L[0]/U[nb-1] zeroing
        blocks = jax.vmap(
            lambda d: band_to_blocktri(BandedMatrix(data=d, kl=kl, ku=ku),
                                       b))(data_shard)
        # PC tips: slice boundaries are PC-global edges (block-Jacobi
        # across slices -> no cross-slice traffic in PCApply)
        lidx = gidx % Ks                            # index within slice
        Btip_pc = jnp.where((lidx == Ks - 1)[:, None, None],
                            jnp.zeros_like(Btip), Btip)
        Ctip_pc = jnp.where((lidx == 0)[:, None, None],
                            jnp.zeros_like(Ctip), Ctip)
        fact, Vfull, Wfull = _factor_and_spikes(
            blocks, Btip_pc, Ctip_pc, factor_fn, method, shift,
            shift_amount, inverter, nb, b, k)
        tips = jnp.stack([Vfull[:, 0, :k, :], Vfull[:, nb - 1, b - k:, :],
                          Wfull[:, 0, :k, :], Wfull[:, nb - 1, b - k:, :]],
                         axis=1)                     # [ppd, 4, k, k]
        # intra-slice gather ONLY
        slice_tips = jax.lax.all_gather(tips, axis_p).reshape(Ks, 4, k, k)
        red_fact, red_Dinv = _build_reduced(
            slice_tips[:, 0], slice_tips[:, 1], slice_tips[:, 2],
            slice_tips[:, 3], Ks, k, False, method, reduced, inverter)
        V, W = (Vfull, Wfull) if store_spikes else (None, None)
        fact, V, W = _cast_local(fact, V, W, method, store_dtype,
                                 spike_dtype)
        return blocks, fact, Btip, Ctip, red_fact, red_Dinv, V, W

    sds = jax.ShapeDtypeStruct
    pax = P((axis_slice, axis_p))
    blocks_struct = BlockTridiagonal(
        D=sds((ppd, nb, b, b), band.data.dtype),
        L=sds((ppd, nb, b, b), band.data.dtype),
        U=sds((ppd, nb, b, b), band.data.dtype))
    fact_struct = jax.eval_shape(factor_fn, blocks_struct)
    if store_dtype is not None:
        fact_struct = jax.eval_shape(
            lambda f: _cast_local(f, None, None, method, store_dtype,
                                  None)[0], fact_struct)
    fact_specs = _shard_or_rep(fact_struct, (axis_slice, axis_p))
    tip_struct = sds((Ks, k, k), band.data.dtype)
    red_struct, _ = jax.eval_shape(
        partial(_build_reduced, K=Ks, k=k, truncated=False,
                method=method, reduced=reduced, inverter=inverter),
        tip_struct, tip_struct, tip_struct, tip_struct)
    out_specs = (
        jax.tree_util.tree_map(lambda _: pax, _blocktri_struct()),
        fact_specs,
        pax, pax,
        _per_slice_specs(red_struct, axis_slice),
        None,
        pax if store_spikes else None,
        pax if store_spikes else None,
    )
    blocks, fact, Btip, Ctip, red_fact, red_Dinv, V, W = \
        jax.shard_map(
            local_setup, mesh=mesh, in_specs=(pax,), out_specs=out_specs,
            check_vma=False)(data)
    return DistSpikeFactor(blocks=blocks, fact=fact, Btip=Btip, Ctip=Ctip,
                           red_fact=red_fact, red_Dinv=red_Dinv, V=V, W=W,
                           n=n, K=K, m=m, b=b, k=k, ppd=ppd,
                           truncated=False)


def dist_spike_transpose_multislice(
        dsf: DistSpikeFactor, mesh: Mesh, axis_slice: str = "slice",
        axis_p: str = "p", reduced: str = "auto", inverter: str = "auto",
        store_spikes: Optional[bool] = None,
        fast: bool = True) -> DistSpikeFactor:
    """Multislice DistSpikeFactor for A^T reusing the (slice, p) mesh
    factorization — the multislice form of ``dist_spike_transpose``
    (see there for the ``fast`` regular-form-vs-marker memory tradeoff).

    Same construction, with the multislice PC contract preserved: the TRUE
    tips transpose with a ppermute over the flattened (slice, p) order (the
    matvec keeps exact cross-slice coupling), while the transpose spikes
    and per-slice reduced system are built from SLICE-MASKED tips (slice
    boundaries are PC-global edges — block-Jacobi across slices, so
    PCApply stays within the slice, matching the forward factor)."""
    from ..ops.blocktri import TransposedBlockTriFactor
    if not isinstance(dsf.fact, BlockTriFactor):
        raise ValueError(
            "dist_spike_transpose_multislice requires block-Thomas "
            f"partition factors (got {type(dsf.fact).__name__})")
    K, k, ppd, nb, b = dsf.K, dsf.k, dsf.ppd, dsf.nb, dsf.b
    n_slices = mesh.shape[axis_slice]
    ndev_p = mesh.shape[axis_p]
    Ks = ndev_p * ppd
    ndev = n_slices * ndev_p
    axes = (axis_slice, axis_p)
    method = dsf.fact.method
    keep = (dsf.V is not None) if store_spikes is None else store_spikes
    sdt = dsf.V.dtype if dsf.V is not None else None

    def pc_mask(Btip_t, Ctip_t):
        # PC tips: slice boundaries are PC-global edges for the transpose
        # factor too (the forward PC-tip zeros live only in the spikes /
        # reduced system, so re-mask the transposed true tips here)
        lidx = jax.lax.axis_index(axis_p) * ppd + jnp.arange(ppd)
        Btip_pc = jnp.where((lidx == Ks - 1)[:, None, None],
                            jnp.zeros_like(Btip_t), Btip_t)
        Ctip_pc = jnp.where((lidx == 0)[:, None, None],
                            jnp.zeros_like(Ctip_t), Ctip_t)
        return Btip_pc, Ctip_pc

    def local_fn(fact, blocks, Btip, Ctip):
        # true tips ppermute over the flattened (slice, p) device order
        # (exact cross-slice matvec coupling); spikes from slice-masked tips
        blocks_t, Btip_t, Ctip_t, Vt, Wt, tips, factT = \
            _transpose_local_parts(fact, blocks, Btip, Ctip,
                                   perm_axes=axes, ndev=ndev, ppd=ppd,
                                   nb=nb, b=b, k=k, spike_mask=pc_mask,
                                   fast=fast)
        # intra-slice gather ONLY
        slice_tips = jax.lax.all_gather(tips, axis_p).reshape(Ks, 4, k, k)
        red_fact, red_Dinv = _build_reduced(
            slice_tips[:, 0], slice_tips[:, 1], slice_tips[:, 2],
            slice_tips[:, 3], Ks, k, False, method, reduced, inverter)
        V, W = _keep_spikes(Vt, Wt, keep, sdt)
        return blocks_t, Btip_t, Ctip_t, red_fact, red_Dinv, V, W, factT

    pax = P(axes)
    in_specs = (_shard_or_rep(dsf.fact, axes),
                jax.tree_util.tree_map(lambda _: pax, _blocktri_struct()),
                pax, pax)
    tip_struct = jax.ShapeDtypeStruct((Ks, k, k), dsf.Btip.dtype)
    red_struct, _ = jax.eval_shape(
        partial(_build_reduced, K=Ks, k=k, truncated=False,
                method=method, reduced=reduced, inverter=inverter),
        tip_struct, tip_struct, tip_struct, tip_struct)
    factT_spec = _shard_or_rep(
        jax.eval_shape(_fast_transposed_factor, dsf.fact, dsf.blocks),
        axes) if (fast and method == "inv") else None
    out_specs = (
        jax.tree_util.tree_map(lambda _: pax, _blocktri_struct()),
        pax, pax,
        _per_slice_specs(red_struct, axis_slice),
        None,
        pax if keep else None,
        pax if keep else None,
        factT_spec,
    )
    blocks_t, Btip_t, Ctip_t, red_fact, red_Dinv, V, W, factT = \
        jax.shard_map(local_fn, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=False)(
            dsf.fact, dsf.blocks, dsf.Btip, dsf.Ctip)
    if factT is None:
        factT = TransposedBlockTriFactor(dsf.fact)
    return DistSpikeFactor(blocks=blocks_t, fact=factT,
                           Btip=Btip_t, Ctip=Ctip_t, red_fact=red_fact,
                           red_Dinv=red_Dinv, V=V, W=W, n=dsf.n, K=K,
                           m=dsf.m, b=b, k=k, ppd=ppd, truncated=False)


def _interface_solve_in_slice(dsf_local, g_top, g_bot, axis_p: str, Ks: int):
    """Per-slice interface solve: all-gather the tips over axis_p ONLY,
    solve this slice's replicated reduced system, slice mine.
    g_top/g_bot: [ppd, k] or [ppd, k, r]; returns (xbot_prev, xtop_next)
    of the same shape (indices within the slice — slice edges masked to
    zero, which is exactly the block-Jacobi PC-tip contract)."""
    k, ppd = dsf_local.k, dsf_local.ppd
    lp = jax.lax.axis_index(axis_p) * ppd + jnp.arange(ppd)
    trail = g_top.shape[2:]
    gt = jax.lax.all_gather(g_top, axis_p).reshape(Ks, k, *trail)
    gb = jax.lax.all_gather(g_bot, axis_p).reshape(Ks, k, *trail)
    rhs_red = jnp.concatenate([gb[:-1], gt[1:]], axis=1)    # [Ks-1, 2k, *r]
    from ..ops.spike import _solve_reduced_system
    z = _solve_reduced_system(dsf_local.red_fact, rhs_red)
    zpad = jnp.concatenate([z, jnp.zeros((1, 2 * k, *trail), z.dtype)],
                           axis=0)
    mshape = (ppd,) + (1,) * (1 + len(trail))
    xtop_next = zpad[jnp.minimum(lp, Ks - 1), k:] * \
        (lp < Ks - 1).reshape(mshape)
    xbot_prev = zpad[jnp.maximum(lp - 1, 0), :k] * (lp > 0).reshape(mshape)
    return xbot_prev, xtop_next


def local_spike_solve_multislice(dsf_local, rhs_local, axis_slice: str,
                                 axis_p: str, ndev_p: int,
                                 impl: str = "auto") -> jax.Array:
    """Per-device PCApply on a (slice, p) mesh: exact SPIKE within the
    slice (all_gather over axis_p only), block-Jacobi across slices.
    Stored V/W spikes (computed from the PC tips at factor time) give the
    1-sweep form here too."""
    nb, b, k, ppd = dsf_local.nb, dsf_local.b, dsf_local.k, dsf_local.ppd
    Ks = ndev_p * ppd                           # partitions per slice
    rblk = rhs_local.reshape(ppd, nb, b)
    g = _local_tri_solve(dsf_local, rblk, impl)
    if Ks == 1:
        return g.reshape(-1)
    xbot_prev, xtop_next = _interface_solve_in_slice(
        dsf_local, g[:, 0, :k], g[:, nb - 1, b - k:], axis_p, Ks)
    # shared correction dispatch (stored V/W 1-sweep vs tip recompute) —
    # the PC-tip masking is carried by the interface vectors themselves:
    # xtop_next/xbot_prev are zero exactly where the PC tips differ from
    # the true tips (slice edges), so dsf.Btip/Ctip give identical
    # corrections and _spike_correct applies unchanged (code-review r3)
    x = _spike_correct(dsf_local, g, rblk, xbot_prev, xtop_next,
                       lambda r2: _local_tri_solve(dsf_local, r2, impl))
    return x.reshape(-1)


def local_spike_solve_multislice_many(dsf_local, rblk: jax.Array,
                                      axis_slice: str, axis_p: str,
                                      ndev_p: int,
                                      impl: str = "auto") -> jax.Array:
    """Multi-RHS per-device PCApply on a (slice, p) mesh;
    rblk: [ppd, nb, b, r] -> same.  The huge-N serving form: factor blocks
    stream once for ALL r right-hand sides, interface strips gather [Ks, k, r]
    over the intra-slice axis only — still no cross-slice traffic in
    PCApply."""
    nb, b, k, ppd = dsf_local.nb, dsf_local.b, dsf_local.k, dsf_local.ppd
    Ks = ndev_p * ppd
    g = _local_tri_solve(dsf_local, rblk, impl)
    if Ks == 1:
        return g
    xbot_prev, xtop_next = _interface_solve_in_slice(
        dsf_local, g[:, 0, :k, :], g[:, nb - 1, b - k:, :], axis_p, Ks)
    return _spike_correct(
        dsf_local, g, rblk, xbot_prev, xtop_next,
        lambda r2: _local_tri_solve(dsf_local, r2, impl))


def local_matvec_multislice(dsf_local, x_local, axis_slice: str,
                            axis_p: str, n_slices: int,
                            ndev_p: int) -> jax.Array:
    """Exact banded SpMV on a (slice, p) mesh: boundary strips ride a
    ppermute over the flattened (slice, p) device order — only slice-edge
    strips cross between slices."""
    nb, b, k, K = dsf_local.nb, dsf_local.b, dsf_local.k, dsf_local.K
    ppd, m = dsf_local.ppd, dsf_local.m
    xp = x_local.reshape(ppd, m)
    y = _local_blocks_matvec(dsf_local, xp.reshape(ppd, nb, b)).reshape(
        ppd, m)
    if K == 1:
        return y.reshape(-1)
    ndev = n_slices * ndev_p
    axes = (axis_slice, axis_p)
    next_tops, prev_bots = _halo_corrections(
        xp[:, :k], xp[:, -k:], axes, ndev)
    prec = sweep_precision(dsf_local.Btip, next_tops)
    y = y.at[:, -k:].add(jnp.einsum("pcd,pd->pc", dsf_local.Btip, next_tops,
                                    precision=prec))
    y = y.at[:, :k].add(jnp.einsum("pcd,pd->pc", dsf_local.Ctip, prev_bots,
                                   precision=prec))
    return y.reshape(-1)


def _multislice_specs(dsf: DistSpikeFactor, axis_slice: str, axis_p: str):
    """PartitionSpec pytree for a multislice DistSpikeFactor: local fields
    sharded over (slice, p), reduced factorization PER-SLICE (sliced over
    the slice axis, replicated within a slice)."""
    axes = (axis_slice, axis_p)
    pax = P(axes)
    specs = _dsf_specs(dsf, axes)
    return DistSpikeFactor(
        blocks=specs.blocks, fact=specs.fact, Btip=pax, Ctip=pax,
        red_fact=_per_slice_specs(dsf.red_fact, axis_slice),
        red_Dinv=None,
        V=None if dsf.V is None else pax,
        W=None if dsf.W is None else pax,
        n=dsf.n, K=dsf.K, m=dsf.m, b=dsf.b, k=dsf.k,
        ppd=dsf.ppd, truncated=dsf.truncated)



# KSP types whose recurrences iterate on A^T / M^{-T} and therefore need the
# transposed distributed factorization threaded in (bicg's shadow
# recurrence; the normal-equations family cgne/cgnr/cgls/lsqr)
TRANSPOSE_KSP_TYPES = ("bicg", "cgne", "cgnr", "cgls", "lsqr")

def make_dist_solver_multislice(dsf: DistSpikeFactor, mesh: Mesh,
                                axis_slice: str = "slice", axis_p: str = "p",
                                ksp_type: str = "gmres", use_pc: bool = True,
                                dsf_transpose: Optional[DistSpikeFactor]
                                = None, nullspace=None,
                                transpose_nullspace=None, **params):
    """Multi-slice Krylov solver: per-slice SPIKE preconditioner (no
    cross-slice traffic), exact cross-slice matvec (k-wide strips), dots
    psum'd over both axes.

    ``ksp_type="bicg"`` runs the shadow recurrence on A^T in-mesh: pass
    ``dsf_transpose=dist_spike_transpose_multislice(dsf, mesh, ...)``.

    ``nullspace`` / ``transpose_nullspace``: as in make_dist_solver; the
    projection coefficients psum over BOTH axes (rows span every chip).

    Returns solve(rhs[n]) -> KSPResult."""
    method = SOLVERS.get(ksp_type)
    ppd, m = dsf.ppd, dsf.m
    n_slices = mesh.shape[axis_slice]
    ndev_p = mesh.shape[axis_p]
    if ksp_type in TRANSPOSE_KSP_TYPES and dsf_transpose is None:
        raise ValueError(
            f"distributed {ksp_type} needs the A^T factorization: pass "
            "dsf_transpose=dist_spike_transpose_multislice(dsf, mesh, ...)")
    axes = (axis_slice, axis_p)
    pax = P((axis_slice, axis_p))
    ns, tns = nullspace, (transpose_nullspace if transpose_nullspace
                          is not None else nullspace)
    q_ns = None if ns is None else _pad_shard_nullspace(ns, dsf, mesh, pax)
    q_tns = None if tns is None else _pad_shard_nullspace(
        tns, dsf, mesh, pax)

    def local_fn(dsf_in, dsft_in, r_local, x0_local, qn_l, qt_l):
        qn = None if qn_l is None else qn_l.reshape(ppd * m, -1)
        qt = None if qt_l is None else qt_l.reshape(ppd * m, -1)
        base_mv = lambda v: local_matvec_multislice(
            dsf_in, v, axis_slice, axis_p, n_slices, ndev_p)
        if qt is not None:
            r_local = _remove_local(qt, r_local.reshape(-1), axes)
            matvec = lambda v: _remove_local(qt, base_mv(v), axes)
        else:
            matvec = base_mv
        base_pc = (lambda v: local_spike_solve_multislice(
            dsf_in, v, axis_slice, axis_p, ndev_p)) if use_pc else None
        # project EVERY PC output (PETSc KSP_PCApply + MatNullSpaceRemove):
        # M^{-1} of a shifted factor re-introduces a null component that
        # short-recurrence methods accumulate in x unboundedly
        pc_apply = base_pc if (base_pc is None or qn is None) else \
            (lambda v: _remove_local(qn, base_pc(v), axes))
        kw = dict(params)
        if ksp_type in TRANSPOSE_KSP_TYPES:
            base_mvt = lambda v: local_matvec_multislice(
                dsft_in, v, axis_slice, axis_p, n_slices, ndev_p)
            kw["matvec_transpose"] = base_mvt if qn is None else \
                (lambda v: _remove_local(qn, base_mvt(v), axes))
            if use_pc:
                base_pct = lambda v: local_spike_solve_multislice(
                    dsft_in, v, axis_slice, axis_p, ndev_p)
                kw["pc_apply_transpose"] = base_pct if qt is None else \
                    (lambda v: _remove_local(qt, base_pct(v), axes))
        res = method(matvec, r_local.reshape(-1), x0_local.reshape(-1),
                     pc_apply, axis_name=axes, **kw)
        x = res.x if qn is None else _remove_local(qn, res.x, axes)
        return (x.reshape(ppd, m), res.its, res.reason, res.rnorm,
                res.history)

    specs = _multislice_specs(dsf, axis_slice, axis_p)
    t_specs = None if dsf_transpose is None else \
        _multislice_specs(dsf_transpose, axis_slice, axis_p)
    shmapped = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(specs, t_specs, pax, pax,
                  None if q_ns is None else pax,
                  None if q_tns is None else pax),
        out_specs=(pax, P(), P(), P(), P()),
        check_vma=False)

    from ..solvers.types import KSPResult

    def _shard(v):
        vp = _pad_rows(v, dsf.K * dsf.m)
        return jax.device_put(vp.reshape(dsf.K, dsf.m),
                              NamedSharding(mesh, pax))

    def solve_fn(rhs, x0=None):
        rhs_sh = _shard(rhs)
        x0_sh = _shard(jnp.zeros_like(rhs) if x0 is None else x0)
        x, its, reason, rnorm, hist = shmapped(dsf, dsf_transpose, rhs_sh,
                                               x0_sh, q_ns, q_tns)
        return KSPResult(x=x.reshape(-1)[:dsf.n], its=its, reason=reason,
                         rnorm=rnorm, history=hist)

    return jit_closure(solve_fn)


def _multislice_many_local_fn(dsf: DistSpikeFactor, ksp_type: str,
                              axis_slice: str, axis_p: str, n_slices: int,
                              ndev_p: int, params: dict,
                              sync_axis: Optional[str] = None):
    """Per-device multi-RHS engine on a (slice, p) submesh:
    local_fn(dsf_local, r_local[ppd, m, r]) -> x[ppd, m, r].

    The engine bodies behind both multislice serving surfaces
    (make_dist_solver_multislice_batched and the 3-D replica mesh of
    make_dist_solver_3d); collectives touch ONLY axis_slice/axis_p, so an
    outer replica axis stays communication-free — but on a REPLICA mesh
    the iteration-count decisions must still be synchronized over
    ``sync_axis``: otherwise replicas take different while_loop trip
    counts and their per-trip collectives misalign across the independent
    groups (deadlock on XLA:CPU; see solvers.krylov._keep_iterating)."""
    ppd, m, nb, b = dsf.ppd, dsf.m, dsf.nb, dsf.b
    axes = (axis_slice, axis_p)

    if ksp_type == "preonly":
        def local_fn(dsf_in, r_local):                # [ppd, m, r]
            rblk = r_local.reshape(ppd, nb, b, r_local.shape[-1])
            x = local_spike_solve_multislice_many(
                dsf_in, rblk, axis_slice, axis_p, ndev_p)
            return x.reshape(ppd, m, -1)
    elif ksp_type == "richardson":
        rtol = params.get("rtol", 1e-8)
        maxit = params.get("maxit", 50)

        def local_fn(dsf_in, r_local):
            rblk = r_local.reshape(ppd, nb, b, r_local.shape[-1])
            bnorm2 = jax.lax.psum(jnp.sum(
                jnp.square(rblk), axis=(0, 1, 2)), axes)       # [r]
            bnorm2 = jnp.maximum(bnorm2, jnp.finfo(rblk.dtype).tiny)

            def pc(R):
                return local_spike_solve_multislice_many(
                    dsf_in, R, axis_slice, axis_p, ndev_p)

            def resid_rel(X):
                R = rblk - local_matvec_many(dsf_in, X, axes)
                rn2 = jax.lax.psum(jnp.sum(jnp.square(R), axis=(0, 1, 2)),
                                   axes)
                rel = jnp.max(jnp.sqrt(rn2 / bnorm2))
                if sync_axis is not None:
                    rel = jax.lax.pmax(rel, sync_axis)
                return R, rel

            def body(carry):
                X, R, _, it = carry
                X = X + pc(R)
                R, rel = resid_rel(X)
                return X, R, rel, it + 1

            def cond(carry):
                _, _, rel, it = carry
                return (rel > rtol) & (it < maxit)

            X0 = pc(rblk)
            R0, rel0 = resid_rel(X0)
            X, _, _, _ = jax.lax.while_loop(
                cond, body, (X0, R0, rel0, jnp.int32(1)))
            return X.reshape(ppd, m, -1)
    elif ksp_type in MANY_SOLVERS:
        # batched Krylov over the whole RHS block: per-slice SPIKE PC many-
        # apply (intra-slice) + exact cross-slice multi-RHS matvec; per-column
        # convergence, ONE stacked psum per reduction family
        method_many = MANY_SOLVERS[ksp_type]

        def local_fn(dsf_in, r_local):                # [ppd, m, r]
            r = r_local.shape[-1]
            mvm = lambda X: local_matvec_many(
                dsf_in, X.reshape(ppd, nb, b, r), axes).reshape(ppd * m, r)
            pcm = lambda X: local_spike_solve_multislice_many(
                dsf_in, X.reshape(ppd, nb, b, r), axis_slice, axis_p,
                ndev_p).reshape(ppd * m, r)
            res = method_many(mvm, r_local.reshape(ppd * m, r), None, pcm,
                              axis_name=axes, conv_sync_axis=sync_axis,
                              **params)
            return res.x.reshape(ppd, m, r)
    else:
        method = SOLVERS.get(ksp_type)

        def local_fn(dsf_in, r_local):
            matvec = lambda v: local_matvec_multislice(
                dsf_in, v, axis_slice, axis_p, n_slices, ndev_p)
            pc_apply = lambda v: local_spike_solve_multislice(
                dsf_in, v, axis_slice, axis_p, ndev_p)

            def one(rl):
                return method(matvec, rl.reshape(-1), None, pc_apply,
                              axis_name=axes, conv_sync_axis=sync_axis,
                              **params).x.reshape(ppd, m)
            x = jax.lax.map(one, jnp.moveaxis(r_local, -1, 0))
            return jnp.moveaxis(x, 0, -1)
    return local_fn


def make_dist_solver_multislice_batched(
        dsf: DistSpikeFactor, mesh: Mesh, axis_slice: str = "slice",
        axis_p: str = "p", ksp_type: str = "richardson", **params):
    """Multi-RHS serving over the (slice, p) mesh itself — the huge-N
    serving layout: rows span every device (all slices), and each device
    solves ALL r right-hand sides on its row shard, so no rhs mesh axis is
    spent on replicas (make_dist_solver_batched covers that regime).

    Returns solve(rhs[n, r]) -> x[n, r].  ``ksp_type``:
      * "richardson" (default) — multi-RHS refinement X += M^-1 (B - A X):
        the PC is per-slice exact SPIKE (intra-slice, factors streamed once
        for all r), the residual matvec carries the TRUE cross-slice
        coupling (k-wide strips), so the iteration converges to the
        exact solution;
      * "preonly"    — ONE multislice PCApply: block-Jacobi across slices,
        i.e. PC-grade accuracy (exact only when cross-slice coupling is
        zero); the cheapest mode when slices are weakly coupled;
      * "gmres"/"bcgs"/"cg" — BATCHED Krylov: one iteration loop for the
        whole RHS block (multi-RHS per-slice PCApply + exact cross-slice
        multi-RHS matvec, per-column convergence);
      * other Krylov names — per-RHS solves under lax.map.
    """
    local_fn = _multislice_many_local_fn(dsf, ksp_type, axis_slice, axis_p,
                                         mesh.shape[axis_slice],
                                         mesh.shape[axis_p], params)
    axes = (axis_slice, axis_p)
    pax = P(axes)
    specs = _multislice_specs(dsf, axis_slice, axis_p)
    shmapped = jax.shard_map(local_fn, mesh=mesh,
                             in_specs=(specs, P(axes)),
                             out_specs=P(axes), check_vma=False)

    def solve_fn(rhs):
        r = rhs.shape[1]
        rp = _pad_rows(rhs, dsf.K * dsf.m)
        rhs_sh = jax.device_put(rp.reshape(dsf.K, dsf.m, r),
                                NamedSharding(mesh, P(axes)))
        x = shmapped(dsf, rhs_sh)
        return x.reshape(dsf.K * dsf.m, r)[:dsf.n]

    return jit_closure(solve_fn)


# ---------------------------------------------------------------------------
# 3-D serving mesh: replicas x slices x intra-slice partitions
# ---------------------------------------------------------------------------


def make_mesh_3d(shape, axes=("rhs", "slice", "p")) -> Mesh:
    """3-D (replicas, slices, chips-per-slice) mesh for replicated
    multislice serving.  On real deployments whole slices are assigned to
    (replica, slice) coordinates via their ``slice_index`` attribute —
    the replica axis carries NO solver communication, so replicas may
    span slices freely; on virtual platforms the flat device order is
    reshaped contiguously (innermost axis = intra-slice)."""
    import numpy as _np
    n_rep, n_slices, per_slice = shape
    devs = jax.devices()
    need = n_rep * n_slices * per_slice
    if need > len(devs):
        raise ValueError(f"requested {need} devices, have {len(devs)}")
    grid = _slice_grouped_grid(n_rep * n_slices, per_slice)
    if grid is not None:
        return Mesh(_np.asarray(grid).reshape(n_rep, n_slices, per_slice),
                    tuple(axes))
    return Mesh(_np.asarray(devs[:need]).reshape(shape), tuple(axes))


def make_dist_solver_3d(dsf: DistSpikeFactor, mesh: Mesh,
                        axis_rhs: str = "rhs", axis_slice: str = "slice",
                        axis_p: str = "p", ksp_type: str = "richardson",
                        **params):
    """Replicated multislice serving over a 3-D (rhs, slice, p) mesh: each
    rhs-row of the mesh holds a full replica of the multislice factorization
    (exact per-slice SPIKE, cross-slice coupling through the matvec) and
    solves its own batch of right-hand sides — the composition of
    make_dist_solver_batched's replica axis with the huge-N multislice
    layout, for deployments that want replica- AND huge-N serving at once.

    The factor is replicated across ``axis_rhs`` (zero communication on
    that axis — pure throughput scaling) and sharded over
    (axis_slice, axis_p) within each replica.

    Returns solve(rhs[R, n]) -> x[R, n] with R divisible by the rhs-axis
    size.  ``ksp_type`` selects the per-replica engine (same contract as
    make_dist_solver_multislice_batched): "richardson" (multi-RHS
    refinement with the exact cross-slice residual matvec — converges to
    the true solution), "preonly" (one block-Jacobi PCApply), or any
    Krylov name (per-RHS convergence control under lax.map)."""
    local_engine = _multislice_many_local_fn(
        dsf, ksp_type, axis_slice, axis_p, mesh.shape[axis_slice],
        mesh.shape[axis_p], params, sync_axis=axis_rhs)

    def local_fn(dsf_in, r_local):                 # [Rloc, ppd, m]
        x = local_engine(dsf_in, jnp.moveaxis(r_local, 0, -1))
        return jnp.moveaxis(x, -1, 0)

    specs = _multislice_specs(dsf, axis_slice, axis_p)
    rhs_spec = P(axis_rhs, (axis_slice, axis_p))
    shmapped = jax.shard_map(local_fn, mesh=mesh,
                             in_specs=(specs, rhs_spec),
                             out_specs=rhs_spec, check_vma=False)

    def solve_fn(rhs):                             # [R, n]
        R = rhs.shape[0]
        rp = _pad_rows(rhs.T, dsf.K * dsf.m).T
        rhs_sh = jax.device_put(rp.reshape(R, dsf.K, dsf.m),
                                NamedSharding(mesh, rhs_spec))
        x = shmapped(dsf, rhs_sh)
        return x.reshape(R, dsf.K * dsf.m)[:, :dsf.n]

    return jit_closure(solve_fn)


def make_dist_solver(dsf: DistSpikeFactor, mesh: Mesh, axis: str = "p",
                     ksp_type: str = "gmres", use_pc: bool = True,
                     dsf_transpose: Optional[DistSpikeFactor] = None,
                     nullspace=None, transpose_nullspace=None,
                     **params):
    """Build a jitted multi-chip Krylov solver: SPIKE-preconditioned
    iterations entirely inside one shard_map program (matvec halo exchange
    via ppermute, reductions via psum, preconditioner = per-device SPIKE).

    ``ksp_type="bicg"`` runs the shadow recurrence on A^T in-mesh: pass
    ``dsf_transpose=dist_spike_transpose(dsf, mesh, axis)`` — its halo
    matvec and SPIKE solve supply the transpose operator/PC (no transpose
    refactorization; same factor blocks, transposed).

    ``nullspace`` / ``transpose_nullspace`` (solvers.nullspace.NullSpace):
    singular consistent systems (the reference's graph Laplacians,
    /root/reference/src/spectralPartition.c:264) — same semantics as
    make_solver, executed mesh-natively: the basis is row-sharded like the
    rhs and each projection costs one dim-sized psum.  Factor the operator
    with a ``shift`` so the SPIKE PC itself stays nonsingular.

    Returns solve(rhs[n]) -> KSPResult with x a global [n] array.
    """
    method = SOLVERS.get(ksp_type)
    ppd, m = dsf.ppd, dsf.m
    if ksp_type in TRANSPOSE_KSP_TYPES and dsf_transpose is None:
        raise ValueError(
            f"distributed {ksp_type} needs the A^T factorization: pass "
            "dsf_transpose=dist_spike_transpose(dsf, mesh, axis)")
    ns, tns = nullspace, (transpose_nullspace if transpose_nullspace
                          is not None else nullspace)
    q_ns = None if ns is None else _pad_shard_nullspace(
        ns, dsf, mesh, P(axis))
    q_tns = None if tns is None else _pad_shard_nullspace(
        tns, dsf, mesh, P(axis))

    def local_fn(dsf_in, dsft_in, r_local, x0_local, qn_l, qt_l):
        qn = None if qn_l is None else qn_l.reshape(ppd * m, -1)
        qt = None if qt_l is None else qt_l.reshape(ppd * m, -1)
        if qt is not None:
            # consistency + residual-space drift control by the LEFT null
            # space (see solvers.ksp for why the left one)
            r_local = _remove_local(qt, r_local.reshape(-1), axis)
            matvec = lambda v: _remove_local(
                qt, local_matvec(dsf_in, v, axis), axis)
        else:
            matvec = lambda v: local_matvec(dsf_in, v, axis)
        base_pc = (lambda v: local_spike_solve(dsf_in, v, axis)) \
            if use_pc else None
        # project EVERY PC output (PETSc KSP_PCApply + MatNullSpaceRemove):
        # M^{-1} of a shifted factor re-introduces a null component that
        # short-recurrence methods accumulate in x unboundedly
        pc_apply = base_pc if (base_pc is None or qn is None) else \
            (lambda v: _remove_local(qn, base_pc(v), axis))
        kw = dict(params)
        if ksp_type in TRANSPOSE_KSP_TYPES:
            if qn is not None:
                kw["matvec_transpose"] = lambda v: _remove_local(
                    qn, local_matvec(dsft_in, v, axis), axis)
            else:
                kw["matvec_transpose"] = \
                    lambda v: local_matvec(dsft_in, v, axis)
            if use_pc:
                base_pct = lambda v: local_spike_solve(dsft_in, v, axis)
                kw["pc_apply_transpose"] = base_pct if qt is None else \
                    (lambda v: _remove_local(qt, base_pct(v), axis))
        res = method(matvec, r_local.reshape(-1), x0_local.reshape(-1),
                     pc_apply, axis_name=axis, **kw)
        x = res.x if qn is None else _remove_local(qn, res.x, axis)
        return (x.reshape(ppd, m), res.its, res.reason, res.rnorm,
                res.history)

    t_specs = None if dsf_transpose is None else \
        _dsf_specs(dsf_transpose, axis)
    shmapped = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(_dsf_specs(dsf, axis), t_specs, P(axis), P(axis),
                  None if q_ns is None else P(axis),
                  None if q_tns is None else P(axis)),
        out_specs=(P(axis), P(), P(), P(), P()),
        check_vma=False)

    from ..solvers.types import KSPResult

    def solve_fn(rhs, x0=None):
        rhs_sh = _pad_shard_rhs(dsf, mesh, axis, rhs)
        x0_sh = _pad_shard_rhs(dsf, mesh, axis,
                               jnp.zeros_like(rhs) if x0 is None else x0)
        x, its, reason, rnorm, hist = shmapped(dsf, dsf_transpose, rhs_sh,
                                               x0_sh, q_ns, q_tns)
        return KSPResult(x=x.reshape(-1)[:dsf.n], its=its, reason=reason,
                         rnorm=rnorm, history=hist)

    return jit_closure(solve_fn)
