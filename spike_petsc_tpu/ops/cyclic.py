"""Block cyclic reduction (CR) for block-tridiagonal systems.

Block-Thomas (blocktri.py) is a sequential scan of ``nb`` steps, each with
one small batched inversion — the factor's latency is nb sequential LU
lowerings.  Cyclic reduction restructures the elimination into log2(nb)
*levels*: each level eliminates every even-indexed block unknown at once, so
the level's inversions happen in ONE large batched call ([ne, b, b]) and the
matmuls are big batches.  Same no-pivot stability regime as block-Thomas
(within-block pivoting via the batched LU inside jnp.linalg.solve), ~2x the
flops and stored blocks — the classic latency-for-throughput trade.

Used for (a) the SPIKE reduced interface system at large partition counts,
where the Thomas scan over K-1 blocks dominates solve latency, and (b) as an
alternative full factorization (``spike_factor(..., method="cr")`` territory
in later rounds).

Elimination (0-based; n padded to 2^L - 1 with decoupled identity blocks):
even unknowns x_i = Dinv_i (b_i - L_i x_{i-1} - U_i x_{i+1}) substitute into
odd rows j:
    P_j = L_j Dinv_{j-1}        Q_j = U_j Dinv_{j+1}
    D'_j = D_j - P_j U_{j-1} - Q_j L_{j+1}
    L'_j = -P_j L_{j-1}         U'_j = -Q_j U_{j+1}
    b'_j = b_j - P_j b_{j-1} - Q_j b_{j+1}
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .blocktri import BlockTridiagonal, _mm, batched_inverse, boost_diag


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CRLevel:
    Dinv_e: jax.Array   # [ne, b, b] inverses of even diagonal blocks
    P: jax.Array        # [no, b, b] L_odd @ Dinv_left
    Q: jax.Array        # [no, b, b] U_odd @ Dinv_right
    L_e: jax.Array      # [ne, b, b] original even sub-blocks (back-subst)
    U_e: jax.Array      # [ne, b, b] original even super-blocks


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CRFactor:
    levels: Tuple[CRLevel, ...]
    root_Dinv: jax.Array          # [b, b]
    nb: int = field(metadata=dict(static=True))       # original block count
    n_pad: int = field(metadata=dict(static=True))    # 2^L - 1
    # boosted-pivot count when factored with shift="nonzero"; None otherwise
    nshift: Optional[jax.Array] = None

    @property
    def b(self) -> int:
        return self.root_Dinv.shape[-1]


def _pad_pow2m1(t: BlockTridiagonal) -> Tuple[BlockTridiagonal, int]:
    nb, b = t.nb, t.b
    n_pad = 1
    while n_pad < nb:
        n_pad = 2 * n_pad + 1
    if n_pad == nb:
        return t, n_pad
    extra = n_pad - nb
    eye = jnp.broadcast_to(jnp.eye(b, dtype=t.dtype), (extra, b, b))
    zero = jnp.zeros((extra, b, b), t.dtype)
    return BlockTridiagonal(
        D=jnp.concatenate([t.D, eye], axis=0),
        L=jnp.concatenate([t.L, zero], axis=0),
        U=jnp.concatenate([t.U.at[nb - 1].set(0) if extra else t.U, zero],
                          axis=0)), n_pad


def cr_factor(t: BlockTridiagonal, shift: str = "none",
              shift_amount: float = 0.0,
              inverter: str = "auto") -> CRFactor:
    """Cyclic-reduction factorization: log2(nb) levels, each with ONE
    batched inversion call.  ``shift="nonzero"`` boosts small diagonal
    pivots before each level's inversion (see blocktri.boost_diag).
    ``inverter`` selects the batched-inverse engine (blocktri.batched_inverse:
    newton / blocked / lapack / auto)."""
    nb = t.nb
    b = t.b
    tp, n_pad = _pad_pow2m1(t)
    D, L, U = tp.D, tp.L, tp.U
    eye = jnp.eye(b, dtype=t.dtype)
    shifting = shift != "none"
    if shifting:
        gscale = jnp.maximum(jnp.max(jnp.abs(tp.D)),
                             jnp.maximum(jnp.max(jnp.abs(tp.L)),
                                         jnp.max(jnp.abs(tp.U))))
        shift_amount = jnp.where(shift_amount > 0, shift_amount,
                                 1e-8 * gscale)
    nsh = jnp.zeros((), jnp.int32)
    levels = []
    while D.shape[0] > 1:
        De, Do = D[0::2], D[1::2]
        Le, Lo = L[0::2], L[1::2]
        Ue, Uo = U[0::2], U[1::2]
        if shifting:
            De, nbad = boost_diag(De, shift_amount)
            nsh = nsh + nbad
        Dinv_e = batched_inverse(De, inverter)
        # odd row j = 2t+1: left even t, right even t+1
        P = _mm(Lo, Dinv_e[:-1])
        Q = _mm(Uo, Dinv_e[1:])
        D_new = Do - _mm(P, Ue[:-1]) - _mm(Q, Le[1:])
        L_new = -_mm(P, Le[:-1])
        U_new = -_mm(Q, Ue[1:])
        levels.append(CRLevel(Dinv_e=Dinv_e, P=P, Q=Q, L_e=Le, U_e=Ue))
        D, L, U = D_new, L_new, U_new
    Droot = D[0]
    if shifting:
        Droot, nbad = boost_diag(Droot, shift_amount)
        nsh = nsh + nbad
    root_Dinv = batched_inverse(Droot[None], inverter)[0]
    return CRFactor(levels=tuple(levels), root_Dinv=root_Dinv, nb=nb,
                    n_pad=n_pad, nshift=nsh if shifting else None)


def cast_cr_factor(fact: CRFactor, dtype) -> CRFactor:
    """Downcast stored CR blocks (e.g. bfloat16): the solve sweeps promote
    in-register while carries stay f32 — same trade as blocktri.cast_factor."""
    def cast(lv: CRLevel) -> CRLevel:
        return CRLevel(Dinv_e=lv.Dinv_e.astype(dtype), P=lv.P.astype(dtype),
                       Q=lv.Q.astype(dtype), L_e=lv.L_e.astype(dtype),
                       U_e=lv.U_e.astype(dtype))
    return CRFactor(levels=tuple(cast(lv) for lv in fact.levels),
                    root_Dinv=fact.root_Dinv.astype(dtype), nb=fact.nb,
                    n_pad=fact.n_pad, nshift=fact.nshift)


def cr_solve(fact: CRFactor, rhs: jax.Array) -> jax.Array:
    """Solve T x = rhs; rhs [nb, b] or [nb, b, r]."""
    squeeze = rhs.ndim == 2
    if squeeze:
        rhs = rhs[..., None]
    r = rhs.shape[-1]
    b = fact.b
    pad = fact.n_pad - fact.nb
    if pad:
        rhs = jnp.concatenate(
            [rhs, jnp.zeros((pad, b, r), rhs.dtype)], axis=0)

    from .blocktri import sweep_precision
    mm = partial(jnp.matmul,
                 precision=sweep_precision(fact.root_Dinv, rhs))

    # down sweep: fold even rhs into odd rhs at each level
    stack = []
    cur = rhs
    for lv in fact.levels:
        be, bo = cur[0::2], cur[1::2]
        stack.append(be)
        cur = bo - mm(lv.P, be[:-1]) - mm(lv.Q, be[1:])

    # root
    x = mm(fact.root_Dinv, cur[0])[None]       # [1, b, r]

    # up sweep: recover even unknowns from odd neighbours
    for lv, be in zip(reversed(fact.levels), reversed(stack)):
        ne = be.shape[0]
        zero = jnp.zeros((1, b, r), x.dtype)
        x_left = jnp.concatenate([zero, x], axis=0)       # x_{2t-1}
        x_right = jnp.concatenate([x, zero], axis=0)      # x_{2t+1}
        xe = mm(lv.Dinv_e, be - mm(lv.L_e, x_left) - mm(lv.U_e, x_right))
        merged = jnp.zeros((ne + x.shape[0], b, r), x.dtype)
        merged = merged.at[0::2].set(xe).at[1::2].set(x)
        x = merged

    x = x[:fact.nb]
    return x[..., 0] if squeeze else x
