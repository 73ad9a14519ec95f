"""Device-parallel weighted bipartite matching (auction algorithm).

Device counterpart of the reference's two accelerated matchings:
the hand-written AWBM (/root/reference/src/petsc_mat_awbm.c:42-225) and the
MPI-distributed MatComputeMatching (/root/reference/src/wbm.c:201-456).  The
reference's own notes (ParallelMC64.tex:6-19) point to auction algorithms as
the way to parallelize MC64 — that is exactly what this module implements:

* matrix as padded ELL arrays [n, dmax] (static shapes for jit),
* duals/prices updated by *rounds* of all-column parallel bidding
  (vectorized argmax + segment reductions — no sequential DFS),
* row acceptance by segment-max with deterministic tie-breaking,
* a fixed round budget inside ``lax.while_loop``; unmatched leftovers are
  completed deterministically like HSLmc64XD.

The epsilon-scaled auction converges to an assignment within n*eps of the
optimal log-product weight — the same objective as MC64 job 5 — and every
round is O(nnz) fully parallel work.  The distributed version shards columns
over the mesh and reduces row prices/acceptances with psum-style collectives
(replacing the VecScatter fwd/rev dual reduction,
/root/reference/src/wbm.c:270-273).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..ordering.base import OrderingResult


def csc_to_ell(a) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad CSC columns to uniform depth: rows[n, dmax] (n = invalid),
    logw[n, dmax] (+inf = invalid), where logw = log(colmax/|a|) >= 0."""
    csc = sp.csc_matrix(a)
    csc.eliminate_zeros()
    n = csc.shape[0]
    counts = np.diff(csc.indptr)
    dmax = max(int(counts.max()), 1) if n else 1
    rows = np.full((n, dmax), n, dtype=np.int32)
    logw = np.full((n, dmax), np.inf)
    absval = np.abs(csc.data.astype(np.float64))
    for j in range(n):
        s, e = csc.indptr[j], csc.indptr[j + 1]
        nz = absval[s:e] > 0
        idx = np.flatnonzero(nz)
        cnt = len(idx)
        if cnt == 0:
            continue
        vals = absval[s:e][idx]
        rows[j, :cnt] = csc.indices[s:e][idx]
        logw[j, :cnt] = np.log(vals.max() / vals)
    return rows, logw, n


@partial(jax.jit, static_argnames=("n", "max_rounds"))
def _auction_rounds(rows, benefit, n: int, eps, max_rounds: int):
    """Parallel auction: returns (match[n], matchR[n], prices[n], rounds).

    rows: [n, dmax] int32 row ids (n = padding)
    benefit: [n, dmax] float benefit of edge (higher = better; -inf padding)
    """
    dmax = rows.shape[1]
    NEG = jnp.array(-jnp.inf, benefit.dtype)

    def cond(state):
        match, matchR, p, r = state
        return (r < max_rounds) & jnp.any(match < 0)

    def body(state):
        match, matchR, p, r = state
        # bidding: every unmatched column evaluates value = benefit - price
        pr = jnp.concatenate([p, jnp.zeros((1,), p.dtype)])   # pad row n
        vals = benefit - pr[rows]                              # [n, dmax]
        unmatched = match < 0
        vals = jnp.where(unmatched[:, None], vals, NEG)
        best_e = jnp.argmax(vals, axis=1)
        best = jnp.take_along_axis(vals, best_e[:, None], 1)[:, 0]
        vals2 = vals.at[jnp.arange(n), best_e].set(NEG)
        second = jnp.max(vals2, axis=1)
        has_bid = unmatched & jnp.isfinite(best)
        target = jnp.where(has_bid,
                           rows[jnp.arange(n), best_e].astype(jnp.int32), n)
        raise_amt = jnp.where(jnp.isfinite(second), best - second, 0.0) + eps

        # acceptance: per target row, the highest raise wins (ties -> lowest
        # column index) — one segment-max + one masked segment-min
        bid_key = jnp.where(has_bid, raise_amt, -jnp.inf)
        row_best = jax.ops.segment_max(bid_key, target, num_segments=n + 1)
        is_top = has_bid & (bid_key >= row_best[target] - 0.0)
        col_ids = jnp.where(is_top, jnp.arange(n), n)
        row_winner = jax.ops.segment_min(col_ids, target,
                                         num_segments=n + 1)[:n]
        accepted = has_bid & (row_winner[jnp.clip(target, 0, n - 1)]
                              == jnp.arange(n)) & (target < n)

        # evict previous owners of rows that changed hands; no-op writes are
        # routed to a dummy slot so they never race with real evictions
        tgt_c = jnp.clip(target, 0, n - 1)
        old_owner = jnp.where(accepted, matchR[tgt_c], n)
        evict_idx = jnp.where((old_owner >= 0) & (old_owner < n),
                              old_owner, n).astype(jnp.int32)
        match_pad = jnp.concatenate([match, jnp.full((1,), -1, match.dtype)])
        match_pad = match_pad.at[evict_idx].set(-1)
        match = match_pad[:n]
        # assign: accepted columns take their rows
        match = jnp.where(accepted, tgt_c.astype(match.dtype), match)
        write_row = jnp.where(accepted, tgt_c, n).astype(jnp.int32)
        matchR_pad = jnp.concatenate([matchR,
                                      jnp.full((1,), -1, matchR.dtype)])
        matchR_pad = matchR_pad.at[write_row].set(
            jnp.arange(n, dtype=matchR.dtype))
        matchR = matchR_pad[:n]
        p_pad = jnp.concatenate([p, jnp.zeros((1,), p.dtype)])
        p_pad = p_pad.at[write_row].add(jnp.where(accepted, raise_amt, 0.0))
        p = p_pad[:n]
        return match, matchR, p, r + 1

    match0 = jnp.full((n,), -1, jnp.int32)
    matchR0 = jnp.full((n,), -1, jnp.int32)
    p0 = jnp.zeros((n,), benefit.dtype)
    match, matchR, p, r = jax.lax.while_loop(
        cond, body, (match0, matchR0, p0, jnp.int32(0)))
    return match, matchR, p, r


def _auction_rounds_dist(rows_sh, benefit_sh, n: int, eps, max_rounds: int,
                         mesh, axis: str):
    """Mesh-distributed auction: columns sharded over ``axis``; row state
    (owners, prices) replicated and updated identically on every device from
    globally-reduced acceptances.

    This is the mesh-native redesign of the reference's MPI matching
    (`MatComputeMatching_MPIAIJ`, /root/reference/src/wbm.c:201-296): where
    it reduces row duals with a VecScatter forward/reverse pair (:270-273),
    here each bidding round does two O(n) collective reductions (pmax of the
    best raise per row, pmin of the winning column id) and every device
    replays the same row-state update — no scatter round-trip.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    ndev = mesh.shape[axis]
    nl = rows_sh.shape[0] // ndev

    def local_fn(rows_l, ben_l):
        rows_l = rows_l.reshape(nl, -1)
        ben_l = ben_l.reshape(nl, -1)
        my = jax.lax.axis_index(axis)
        gcol = my * nl + jnp.arange(nl)                    # global col ids
        NEG = jnp.array(-jnp.inf, ben_l.dtype)

        def cond(state):
            match_l, matchR, p, r = state
            local_un = jnp.sum(match_l < 0)
            total_un = jax.lax.psum(local_un, axis)
            return (r < max_rounds) & (total_un > 0)

        def body(state):
            match_l, matchR, p, r = state
            pr = jnp.concatenate([p, jnp.zeros((1,), p.dtype)])
            vals = ben_l - pr[rows_l]
            unmatched = match_l < 0
            vals = jnp.where(unmatched[:, None], vals, NEG)
            best_e = jnp.argmax(vals, axis=1)
            best = jnp.take_along_axis(vals, best_e[:, None], 1)[:, 0]
            vals2 = vals.at[jnp.arange(nl), best_e].set(NEG)
            second = jnp.max(vals2, axis=1)
            has_bid = unmatched & jnp.isfinite(best)
            target = jnp.where(
                has_bid, rows_l[jnp.arange(nl), best_e].astype(jnp.int32), n)
            raise_amt = jnp.where(jnp.isfinite(second), best - second,
                                  0.0) + eps

            # global acceptance: per-row max raise (pmax), tie -> min col id
            bid_key = jnp.where(has_bid, raise_amt, -jnp.inf)
            row_best = jax.ops.segment_max(bid_key, target,
                                           num_segments=n + 1)
            row_best = jax.lax.pmax(row_best, axis)
            is_top = has_bid & (bid_key >= row_best[target])
            cand = jnp.where(is_top, gcol, n).astype(jnp.int32)
            winner = jax.ops.segment_min(cand, target, num_segments=n + 1)
            winner = jax.lax.pmin(winner, axis)[:n]

            # replicated row-state update (identical on every device)
            accepted_row = (winner < n) & jnp.isfinite(row_best[:n])
            matchR = jnp.where(accepted_row, winner, matchR)
            p = p + jnp.where(accepted_row, row_best[:n], 0.0)

            # local column state: win where I am the winner of my target;
            # evictions fall out of re-checking matchR consistency
            tgt_c = jnp.clip(target, 0, n - 1)
            i_won = has_bid & (target < n) & (winner[tgt_c] == gcol)
            match_l = jnp.where(i_won, tgt_c.astype(match_l.dtype), match_l)
            owned = match_l >= 0
            still_mine = owned & (matchR[jnp.clip(match_l, 0, n - 1)] == gcol)
            match_l = jnp.where(owned & ~still_mine, -1, match_l)
            return match_l, matchR, p, r + 1

        init = (jnp.full((nl,), -1, jnp.int32),
                jnp.full((n,), -1, jnp.int32),
                jnp.zeros((n,), ben_l.dtype), jnp.int32(0))
        match_l, matchR, p, r = jax.lax.while_loop(cond, body, init)
        return match_l, matchR, p, r

    rows_dev = jax.device_put(rows_sh, NamedSharding(mesh, P(axis)))
    ben_dev = jax.device_put(benefit_sh, NamedSharding(mesh, P(axis)))
    shmapped = jax.shard_map(
        local_fn, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(), P(), P()), check_vma=False)
    return shmapped(rows_dev, ben_dev)


def auction_match_dist(a, mesh, axis: str = "p", eps: Optional[float] = None,
                       max_rounds: Optional[int] = None) -> OrderingResult:
    """Distributed MC64-job-5-objective matching across a device mesh."""
    rows_np, logw_np, n = csc_to_ell(a)
    ndev = mesh.shape[axis]
    eps = eps if eps is not None else 1e-3 / max(n, 1)
    max_rounds = max_rounds or 50 * n
    n_pad = -(-max(n, 1) // ndev) * ndev
    dmax = rows_np.shape[1] if n else 1
    rows_pad = np.full((n_pad, dmax), n, dtype=np.int32)
    ben_pad = np.full((n_pad, dmax), -np.inf)
    if n:
        rows_pad[:n] = rows_np
        ben_pad[:n] = np.where(np.isfinite(logw_np), -logw_np, -np.inf)

    match_l, matchR, prices, rounds = _auction_rounds_dist(
        jnp.asarray(rows_pad), jnp.asarray(ben_pad), n=n, eps=eps,
        max_rounds=max_rounds, mesh=mesh, axis=axis)
    match = np.asarray(match_l, dtype=np.int64)[:n]
    info = dict(type="auction_dist", rounds=int(rounds), eps=float(eps),
                devices=ndev)
    unmatched = np.flatnonzero(match < 0)
    if unmatched.size:
        used = np.zeros(n, dtype=bool)
        used[match[match >= 0]] = True
        free = np.flatnonzero(~used)
        match[unmatched] = free[: unmatched.size]
        info["completed"] = int(unmatched.size)
    res = _scalings_from_prices(a, rows_np, logw_np, np.asarray(prices), n)
    return OrderingResult(rperm=match, cperm=np.arange(n),
                          row_scale=res[0], col_scale=res[1], info=info)


def _scalings_from_prices(a, rows_np, logw_np, p, n):
    """Shared dual->scaling derivation (see auction_match)."""
    logw_flat = logw_np.ravel()
    rows_flat = rows_np.ravel()
    finite = np.isfinite(logw_flat) & (rows_flat < n)
    q = np.full(n, -np.inf)
    col_flat = np.repeat(np.arange(n), rows_np.shape[1])
    np.maximum.at(q, col_flat[finite],
                  -logw_flat[finite] - p[rows_flat[finite]])
    q[~np.isfinite(q)] = 0.0
    coo = sp.csc_matrix(a).tocoo()
    colmax = np.zeros(n)
    np.maximum.at(colmax, coo.col, np.abs(coo.data))
    logmax = np.zeros(n)
    np.log(colmax, out=logmax, where=colmax > 0)
    row_scale = np.exp(np.clip(-p, -700, 700))
    col_scale = np.exp(np.clip(-q - logmax, -700, 700))
    return row_scale, col_scale


def auction_match(a, eps: Optional[float] = None,
                  max_rounds: Optional[int] = None) -> OrderingResult:
    """MC64-job-5-objective matching computed entirely on device.

    eps trades optimality for rounds (result within n*eps of the optimal
    log-product).  Scalings are derived from the final prices: the auction's
    price vector plays the role of the column duals.
    """
    rows_np, logw_np, n = csc_to_ell(a)
    if n == 0:
        return OrderingResult(rperm=np.arange(0), cperm=np.arange(0))
    eps = eps if eps is not None else 1e-3 / max(n, 1)
    max_rounds = max_rounds or 50 * n

    rows = jnp.asarray(rows_np)
    benefit = jnp.asarray(-np.where(np.isfinite(logw_np), logw_np, np.inf))
    benefit = jnp.where(jnp.isfinite(benefit), benefit, -jnp.inf)

    match, matchR, prices, rounds = _auction_rounds(
        rows, benefit, n=n, eps=eps, max_rounds=max_rounds)
    match = np.asarray(match, dtype=np.int64)
    info = dict(type="auction", rounds=int(rounds), eps=float(eps))

    # deterministic completion (structurally singular / round budget)
    unmatched = np.flatnonzero(match < 0)
    if unmatched.size:
        used = np.zeros(n, dtype=bool)
        used[match[match >= 0]] = True
        free = np.flatnonzero(~used)
        match[unmatched] = free[: unmatched.size]
        info["completed"] = int(unmatched.size)

    # duals from prices (eps-complementary slackness of the auction):
    # rows carry prices p_i; column values q_j = max_e (-w_je - p_{row(je)}).
    # Then u_i = -p_i, v_j = -q_j satisfy u + v <= w (equality on matched,
    # within eps) — the same tightness MC64 job 5 uses for its scalings.
    row_scale, col_scale = _scalings_from_prices(
        a, rows_np, logw_np, np.asarray(prices, dtype=np.float64), n)

    return OrderingResult(rperm=match, cperm=np.arange(n),
                          row_scale=row_scale, col_scale=col_scale,
                          info=info)
