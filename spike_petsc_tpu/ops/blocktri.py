"""Block-tridiagonal representation and factorization — the compute core.

Design note: a banded matrix with half-bandwidths kl, ku <= b is
*exactly* a block-tridiagonal matrix with dense ``b x b`` blocks.  Classic
banded LU (what PETSc's LU does on the extracted band the reference builds in
/root/reference/src/matbanded.c:165-192) is a scalar recurrence over rows —
hostile to matrix units.  Block-Thomas factorization instead does, per block row,

    F_i = L_i @ inv(S_{i-1}),     S_i = D_i - F_i @ U_{i-1},

i.e. two ``b x b`` matmuls and one small factorization, and the whole sweep is
a ``lax.scan`` of batched matmuls.  Within-block partial pivoting (inside
``inv``/``lu_factor``) gives *better* stability than strict no-pivot banded
LU, while the block structure keeps zero fill outside the band blocks.

With ``b`` padded to 128 these are full-width batched products; SPIKE
(``spike.py``) then batches K independent such sweeps over the partition axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from .band import BandedMatrix, pad_banded


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockTridiagonal:
    """Blocks of a block-tridiagonal matrix.

    D[i] is the diagonal block, L[i] couples block-row i to block i-1
    (L[0] == 0), U[i] couples block-row i to block i+1 (U[nb-1] == 0).
    """

    D: jax.Array  # [nb, b, b]
    L: jax.Array  # [nb, b, b]
    U: jax.Array  # [nb, b, b]

    @property
    def nb(self) -> int:
        return self.D.shape[0]

    @property
    def b(self) -> int:
        return self.D.shape[-1]

    @property
    def dtype(self):
        return self.D.dtype


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockTriFactor:
    """Block-Thomas factorization state (a pytree; safe to jit through).

    method == "inv": Sinv holds explicit Schur-complement inverses; solves are
    pure batched matmuls.
    method == "lu":  Slu/piv hold LAPACK-style LU factors of each S_i; solves
    use pivoted triangular solves (preferred for ill-conditioned f64 runs).
    method == "spd": symmetric (Hermitian) block-LDL^H — only F and Sinv are
    stored (U is a zero-size placeholder reconstructed as F^H in the sweeps),
    so the factorization holds 2 block arrays instead of 3: 2/3 the factor
    memory of "inv" for SPD/Hermitian matrices (PETSc PCCHOLESKY's storage
    advantage).  The input's U blocks are IGNORED (assumed L^H).
    """

    F: jax.Array            # [nb, b, b], F[0] == 0
    U: jax.Array            # [nb, b, b] (copy of superdiagonal blocks)
    Sinv: jax.Array         # [nb, b, b] or zeros if method == "lu"
    Slu: jax.Array          # [nb, b, b] or zeros if method == "inv"
    piv: jax.Array          # [nb, b] int32
    method: str = field(metadata=dict(static=True))
    # number of Schur pivots boosted by the diagonal shift (int32 scalar);
    # None when factoring with shift="none" — PETSc -pc_factor_shift_type
    # diagnostics surface (/root/reference/src/makefile:18)
    nshift: Optional[jax.Array] = None

    @property
    def nb(self) -> int:
        return self.F.shape[0]

    @property
    def b(self) -> int:
        return self.F.shape[-1]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TransposedBlockTriFactor:
    """Marker pytree: solve with the TRANSPOSE of the wrapped factorization.

    Carries no data of its own — ``ops.spike._batched_tri_solve`` dispatches
    it to ``blocktri_solve_transpose``, which reuses ``base``'s stored
    blocks.  Built by ``ops.spike.spike_transpose`` so a forward SPIKE
    factorization serves A^T solves too (PETSc MatSolveTranspose role)."""

    base: BlockTriFactor

    @property
    def nb(self) -> int:
        return self.base.nb

    @property
    def b(self) -> int:
        return self.base.b


# ---------------------------------------------------------------------------
# Conversion: band -> block-tridiagonal
# ---------------------------------------------------------------------------

def band_to_blocktri(band: BandedMatrix, b: int) -> BlockTridiagonal:
    """Reshape diagonal-offset band storage into block-tridiagonal blocks.

    Requires kl, ku <= b; rows are padded (unit diagonal) to a multiple of b.

    Implementation: a pad-and-reshape "skew" — row p of each block is shifted
    right by p via flattening a width-``Wp`` row buffer and re-viewing it at
    width ``Wp - 1`` — after which the D/L/U blocks are *static contiguous
    slices*.  Pure layout ops, no gather.
    """
    if band.kl > b or band.ku > b:
        raise ValueError(f"block size {b} must cover half-bandwidths "
                         f"(kl={band.kl}, ku={band.ku})")
    nb = -(-band.n // b)
    band = pad_banded(band, nb * b)
    w, kl, ku = band.width, band.kl, band.ku
    data = band.data.reshape(nb, b, w)

    # skew[i, p, c] = data[i, p, c - p - pl]  (zero out of band range).
    # pl >= 2b - kl - 1 keeps every read at c >= p (no wrap into the previous
    # row); pr >= 2b - ku - 1 covers the U block's rightmost reads.
    pl = max(2 * b - kl - 1, 0)
    pr = max(2 * b - ku, 1)
    wp = pl + w + pr
    padded = jnp.pad(data, ((0, 0), (0, 0), (pl, pr)))
    skew = padded.reshape(nb, b * wp)[:, :b * (wp - 1)].reshape(
        nb, b, wp - 1)
    # block at column offset o holds entry (p, q) = A[i*b+p, (i+o)*b+q],
    # which sits at skew column c = pl + kl + o*b + q
    base = pl + kl
    L = skew[:, :, base - b:base].at[0].set(0)
    D = skew[:, :, base:base + b]
    U = skew[:, :, base + b:base + 2 * b].at[nb - 1].set(0)
    return BlockTridiagonal(D=D, L=L, U=U)


def blocktri_to_band(t: BlockTridiagonal, kl: int, ku: int) -> BandedMatrix:
    """Inverse of band_to_blocktri: global block-tridiagonal blocks (banded
    structure, kl/ku <= b) -> diagonal-offset band storage [nb*b, w].

    The same pad-and-reshape skew as the forward conversion, run backwards:
    concatenate [L|D|U] per block row, widen the row view by one so row p
    reads at a +p offset, and the band columns become one static slice.
    Interop path for blocktri-native assemblies (spike_factor_blocks) that
    need band-form consumers (CPU baselines, banded matvec, I/O)."""
    nb, b = t.nb, t.b
    if kl > b or ku > b:
        raise ValueError(f"half-bandwidths (kl={kl}, ku={ku}) must be <= "
                         f"block size {b}")
    w = kl + ku + 1
    cat = jnp.concatenate([t.L, t.D, t.U], axis=-1)          # [nb, b, 3b]
    W0 = 3 * b
    # widen to W0 + 1: viewed row p starts at flat p*(W0+1) = (p, col p) —
    # band[p, d] = cat[p, p + (b - kl) + d], and p + b + ku <= 3b - 1 keeps
    # every read inside the original row
    flat = jnp.concatenate(
        [cat.reshape(nb, b * W0), jnp.zeros((nb, b), t.dtype)], axis=1)
    sk = flat.reshape(nb, b, W0 + 1)
    band = sk[:, :, b - kl:b - kl + w]
    return BandedMatrix(data=band.reshape(nb * b, w), kl=kl, ku=ku)


def blocktri_to_dense(t: BlockTridiagonal) -> jax.Array:
    nb, b = t.nb, t.b
    n = nb * b
    a = jnp.zeros((n, n), t.dtype)
    for i in range(nb):
        a = a.at[i * b:(i + 1) * b, i * b:(i + 1) * b].set(t.D[i])
        if i + 1 < nb:
            a = a.at[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b].set(t.U[i])
            a = a.at[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b].set(t.L[i + 1])
    return a


def blocktri_matvec(t: BlockTridiagonal, x: jax.Array) -> jax.Array:
    """y_i = L_i x_{i-1} + D_i x_i + U_i x_{i+1}.

    x: [nb, b] or [nb, b, r].  Three batched matmuls — this is the SpMV
    used inside Krylov loops (replacing PETSc AIJ MatMult,
    /root/reference/src/testbed.c:310).
    """
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    xm = jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], axis=0)
    xp = jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], axis=0)
    prec = sweep_precision(t.D, x)
    y = (jnp.einsum("ipq,iqr->ipr", t.D, x, precision=prec)
         + jnp.einsum("ipq,iqr->ipr", t.L, xm, precision=prec)
         + jnp.einsum("ipq,iqr->ipr", t.U, xp, precision=prec))
    return y[..., 0] if squeeze else y


# ---------------------------------------------------------------------------
# Factorization
# ---------------------------------------------------------------------------

# factor and LU-sweep block products in full working precision: DEFAULT
# lets the GPU run f32 products in TF32 (about three decimal digits), which
# would make an "f32" factor preconditioner-grade
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def boost_diag(s: jax.Array, shift_amount, zeropivot: float = 1e-10):
    """Diagonal-shift guard for a batch of blocks [..., b, b]: pivots whose
    magnitude falls below max(shift_amount, zeropivot * max|block|) are
    raised to that floor (keeping their sign/phase) — the blocked analogue of
    PETSc's ``-pc_factor_shift_type nonzero`` pivot repair used by the
    reference's canned recipe (/root/reference/src/makefile:18).

    Returns (boosted_blocks, n_boosted).
    """
    d = jnp.diagonal(s, axis1=-2, axis2=-1)                  # [..., b]
    ad = jnp.abs(d)
    smax = jnp.max(jnp.abs(s), axis=(-2, -1))[..., None]     # [..., 1]
    floor = jnp.maximum(shift_amount, zeropivot * smax)
    floor = jnp.maximum(floor, jnp.finfo(ad.dtype).tiny)
    bad = ad < floor
    unit = jnp.where(ad > 0, d / jnp.where(ad > 0, ad, 1.0).astype(d.dtype),
                     jnp.ones_like(d))
    dnew = jnp.where(bad, unit * floor.astype(d.dtype), d)
    eye = jnp.eye(s.shape[-1], dtype=s.dtype)
    s2 = s + (dnew - d)[..., :, None] * eye
    return s2, jnp.sum(bad).astype(jnp.int32)


@partial(jax.jit, static_argnames=("method", "shift", "inverter"))
def blocktri_factor(t: BlockTridiagonal, method: str = "inv",
                    shift: str = "none",
                    shift_amount: float = 0.0,
                    inverter: str = "auto") -> BlockTriFactor:
    """Block-Thomas factorization via lax.scan.

    Scan carry is the previous Schur complement (or its inverse); each step is
    batched matmuls plus one b x b inversion/LU.  No outer pivoting — the
    reordering/scaling pipeline (MC64/AWBM, §ordering) is responsible for
    diagonal dominance, exactly as in the reference solve pipeline.

    ``shift="nonzero"`` enables in-scan pivot-magnitude monitoring with
    inline diagonal boosting (see ``boost_diag``); the boosted-pivot count is
    returned in ``.nshift`` and surfaced by ``utils.debug.factor_health``.
    """
    nb, b = t.nb, t.b
    dtype = t.dtype
    eye = jnp.eye(b, dtype=dtype)
    shifting = shift != "none"
    if shifting:
        # default absolute floor is relative to the global matrix scale, so
        # even an all-zero pivot block gets a usable O(scale) boost
        gscale = jnp.maximum(jnp.max(jnp.abs(t.D)),
                             jnp.maximum(jnp.max(jnp.abs(t.L)),
                                         jnp.max(jnp.abs(t.U))))
        shift_amount = jnp.where(shift_amount > 0, shift_amount,
                                 1e-8 * gscale)

    def guard(s):
        if shifting:
            s1, nbad = boost_diag(s, shift_amount)
            return s1, nbad
        return s, jnp.zeros((), jnp.int32)

    if method == "inv":
        def step(carry, blocks):
            s_prev_inv, nsh = carry
            d, l, u_prev = blocks
            f = _mm(l, s_prev_inv)
            s = d - _mm(f, u_prev)
            s, nbad = guard(s)
            s_inv = batched_inverse(s[None], inverter)[0]
            return (s_inv, nsh + nbad), (f, s_inv)

        s0, nsh0 = guard(t.D[0])
        s0_inv = batched_inverse(s0[None], inverter)[0]
        u_shift = jnp.concatenate([jnp.zeros_like(t.U[:1]), t.U[:-1]], axis=0)
        (_, nsh), (f_rest, sinv_rest) = jax.lax.scan(
            step, (s0_inv, nsh0), (t.D[1:], t.L[1:], u_shift[1:]))
        F = jnp.concatenate([jnp.zeros((1, b, b), dtype), f_rest], axis=0)
        Sinv = jnp.concatenate([s0_inv[None], sinv_rest], axis=0)
        # zero-size placeholders: carrying full-size unused fields would
        # waste GBs of device memory at production sizes
        z = jnp.zeros((nb, 0, 0), dtype)
        zp = jnp.zeros((nb, 0), jnp.int32)
        return BlockTriFactor(F=F, U=t.U, Sinv=Sinv, Slu=z, piv=zp,
                              method="inv", nshift=nsh if shifting else None)

    elif method == "spd":
        # symmetric/Hermitian block-LDL^H: T = (I+E) S (I+E)^H with E the
        # block-subdiagonal of F_i = L_i Sinv_{i-1} and S_i Hermitian:
        #   S_i = D_i - F_i L_i^H   (== D_i - L_i Sinv_{i-1} L_i^H).
        # Only F and Sinv are stored; the input U blocks are ignored (they
        # must equal L^H shifted — a symmetric band guarantees it).
        tH = lambda a: jnp.swapaxes(a, -1, -2).conj()

        def step(carry, blocks):
            s_prev_inv, nsh = carry
            d, l = blocks
            f = _mm(l, s_prev_inv)
            s = d - _mm(f, tH(l))
            # re-symmetrize: inexact inverters (Newton) leave O(eps)
            # asymmetry that would otherwise compound down the recursion
            s = 0.5 * (s + tH(s))
            s, nbad = guard(s)
            s_inv = batched_inverse(s[None], inverter)[0]
            return (s_inv, nsh + nbad), (f, s_inv)

        s0, nsh0 = guard(0.5 * (t.D[0] + tH(t.D[0])))
        s0_inv = batched_inverse(s0[None], inverter)[0]
        (_, nsh), (f_rest, sinv_rest) = jax.lax.scan(
            step, (s0_inv, nsh0), (t.D[1:], t.L[1:]))
        F = jnp.concatenate([jnp.zeros((1, b, b), dtype), f_rest], axis=0)
        Sinv = jnp.concatenate([s0_inv[None], sinv_rest], axis=0)
        z = jnp.zeros((nb, 0, 0), dtype)
        zp = jnp.zeros((nb, 0), jnp.int32)
        return BlockTriFactor(F=F, U=z, Sinv=Sinv, Slu=z, piv=zp,
                              method="spd", nshift=nsh if shifting else None)

    elif method == "lu":
        def step(carry, blocks):
            s_prev_lu, s_prev_piv, nsh = carry
            d, l, u_prev = blocks
            # F_i = L_i @ inv(S_{i-1})  ==  solve(S_{i-1}^T, L_i^T)^T
            f = jsl.lu_solve((s_prev_lu, s_prev_piv), l.T, trans=1).T
            s = d - _mm(f, u_prev)
            s, nbad = guard(s)
            s_lu, s_piv = jsl.lu_factor(s)
            return (s_lu, s_piv, nsh + nbad), (f, s_lu, s_piv)

        s0, nsh0 = guard(t.D[0])
        s0_lu, s0_piv = jsl.lu_factor(s0)
        u_shift = jnp.concatenate([jnp.zeros_like(t.U[:1]), t.U[:-1]], axis=0)
        (_, _, nsh), (f_rest, slu_rest, piv_rest) = jax.lax.scan(
            step, (s0_lu, s0_piv, nsh0), (t.D[1:], t.L[1:], u_shift[1:]))
        F = jnp.concatenate([jnp.zeros((1, b, b), dtype), f_rest], axis=0)
        Slu = jnp.concatenate([s0_lu[None], slu_rest], axis=0)
        piv = jnp.concatenate([s0_piv[None].astype(jnp.int32),
                               piv_rest.astype(jnp.int32)], axis=0)
        z = jnp.zeros((nb, 0, 0), dtype)
        return BlockTriFactor(F=F, U=t.U, Sinv=z, Slu=Slu, piv=piv,
                              method="lu", nshift=nsh if shifting else None)

    raise ValueError(
        f"unknown method {method!r} (use 'inv', 'lu', or 'spd')")


def blocktri_factor_inv_waux(t: BlockTridiagonal, y0: jax.Array,
                             shift: str = "none", shift_amount: float = 0.0,
                             inverter: str = "auto"):
    """``blocktri_factor(method='inv')`` with a fused auxiliary forward
    sweep: alongside the Schur recursion the scan carries
    ``y_i = -F_i @ y_{i-1}`` (``y_0`` given) — the W-spike forward sweep of
    ``ops.spike._spike_columns`` computed while ``F_i`` is still in
    registers, instead of a second 0.5 GB re-read pass over the stacked F
    blocks at the flagship size.  Returns ``(fact, y)`` with ``y``
    stacked ``[nb, *y0.shape]``.

    Numerically identical to the unfused pair (same ops, same order); the
    shift/guard logic mirrors ``blocktri_factor`` exactly.
    """
    nb, b = t.nb, t.b
    dtype = t.dtype
    shifting = shift != "none"
    if shifting:
        gscale = jnp.maximum(jnp.max(jnp.abs(t.D)),
                             jnp.maximum(jnp.max(jnp.abs(t.L)),
                                         jnp.max(jnp.abs(t.U))))
        shift_amount = jnp.where(shift_amount > 0, shift_amount,
                                 1e-8 * gscale)

    def guard(s):
        if shifting:
            s1, nbad = boost_diag(s, shift_amount)
            return s1, nbad
        return s, jnp.zeros((), jnp.int32)

    def step(carry, blocks):
        s_prev_inv, y_prev, nsh = carry
        d, l, u_prev = blocks
        f = _mm(l, s_prev_inv)
        s = d - _mm(f, u_prev)
        s, nbad = guard(s)
        s_inv = batched_inverse(s[None], inverter)[0]
        y = -_sweep_matvec(f, y_prev)
        return (s_inv, y, nsh + nbad), (f, s_inv, y)

    s0, nsh0 = guard(t.D[0])
    s0_inv = batched_inverse(s0[None], inverter)[0]
    u_shift = jnp.concatenate([jnp.zeros_like(t.U[:1]), t.U[:-1]], axis=0)
    (_, _, nsh), (f_rest, sinv_rest, y_rest) = jax.lax.scan(
        step, (s0_inv, y0, nsh0), (t.D[1:], t.L[1:], u_shift[1:]))
    F = jnp.concatenate([jnp.zeros((1, b, b), dtype), f_rest], axis=0)
    Sinv = jnp.concatenate([s0_inv[None], sinv_rest], axis=0)
    y = jnp.concatenate([y0[None], y_rest], axis=0)
    z = jnp.zeros((nb, 0, 0), dtype)
    zp = jnp.zeros((nb, 0), jnp.int32)
    fact = BlockTriFactor(F=F, U=t.U, Sinv=Sinv, Slu=z, piv=zp,
                          method="inv", nshift=nsh if shifting else None)
    return fact, y


def _skew_block_rows(X: jax.Array, b: int, kl: int, ku: int):
    """One block's band rows ``X [b, w]`` -> dense ``(l, d, u)`` blocks.

    The same pad-and-reshape skew as ``band_to_blocktri`` at single-block
    granularity (``Y[r, j] = X[r, j - r - b + kl]``; leaked reads land in
    the zero padding because ``b >= ku``): run INSIDE the factor scan it
    converts while the rows are on-chip, so neither the global skew
    intermediate nor the [nb, b, b] L/D/U blocks ever reach device memory."""
    W2 = 3 * b + 1
    Z = jnp.pad(X, ((0, 0), (b - kl, W2 - (b - kl) - X.shape[-1])))
    Y = Z.reshape(-1)[: 3 * b * b].reshape(b, 3 * b)
    return Y[:, :b], Y[:, b:2 * b], Y[:, 2 * b:]


def blocktri_factor_inv_waux_band(local_band: jax.Array, y0: jax.Array,
                                  kl: int, ku: int, b: int,
                                  inverter: str = "auto"):
    """``blocktri_factor_inv_waux`` consuming RAW band rows — the
    band->blocktri conversion folded into the factor scan.

    ``local_band``: one partition's band rows ``[nb, b, w]`` (a free
    reshape of diagonal-offset storage).  Each scan step skews its
    ``[b, w]`` row block to dense ``(l, d, u)`` blocks inside the step and
    feeds the Schur recursion directly, so the only memory traffic the
    conversion adds is the band read itself (~0.8 GB at the flagship size)
    instead of the materialized skew + block writes of
    ``band_to_blocktri``.  The boundary
    semantics match ``band_to_blocktri`` exactly: block 0's L is never
    read, the last block's U is zeroed in the emitted factor.

    Shift support is intentionally absent (the caller falls back to the
    materialized path when shifting — the global scale heuristic needs
    max|blocks|, which the folded form never materializes).

    Returns ``(fact, y)`` exactly like ``blocktri_factor_inv_waux``.
    """
    nb = local_band.shape[0]
    dtype = local_band.dtype

    def step(carry, X):
        s_prev_inv, y_prev, u_prev = carry
        l, d, u = _skew_block_rows(X, b, kl, ku)
        f = _mm(l, s_prev_inv)
        s = d - _mm(f, u_prev)
        s_inv = batched_inverse(s[None], inverter)[0]
        y = -_sweep_matvec(f, y_prev)
        return (s_inv, y, u), (f, s_inv, y, u_prev)

    _, d0, u0 = _skew_block_rows(local_band[0], b, kl, ku)
    s0_inv = batched_inverse(d0[None], inverter)[0]
    (_, _, u_last), (f_rest, sinv_rest, y_rest, u_head) = jax.lax.scan(
        step, (s0_inv, y0, u0), local_band[1:])
    F = jnp.concatenate([jnp.zeros((1, b, b), dtype), f_rest], axis=0)
    Sinv = jnp.concatenate([s0_inv[None], sinv_rest], axis=0)
    y = jnp.concatenate([y0[None], y_rest], axis=0)
    # U[i] emitted as step i+1's u_prev; U[nb-1] is a partition edge -> 0
    U = jnp.concatenate([u_head, jnp.zeros((1, b, b), dtype)], axis=0) \
        if nb > 1 else jnp.zeros((1, b, b), dtype)
    z = jnp.zeros((nb, 0, 0), dtype)
    zp = jnp.zeros((nb, 0), jnp.int32)
    fact = BlockTriFactor(F=F, U=U, Sinv=Sinv, Slu=z, piv=zp,
                          method="inv", nshift=None)
    return fact, y


def blocked_inv(S: jax.Array, base: int = 32) -> jax.Array:
    """Batched matrix inverse via recursive 2x2 blocked Schur complements.

    XLA's batched ``jnp.linalg.solve`` lowers to a pivoted-LU loop of n
    steps of narrow vector work; this recursion replaces most of it with
    batched matmuls (base-case LUs only at ``base`` size).

    No pivoting ACROSS the 2x2 block split — valid in this framework's
    operating regime (post-MC64-scaling diagonal dominance, preserved by
    Schur complements); the LAPACK path remains the CPU/f64 default.
    """
    n = S.shape[-1]
    if n <= base:
        return jnp.linalg.solve(
            S, jnp.broadcast_to(jnp.eye(n, dtype=S.dtype), S.shape))
    h = n // 2
    A = S[..., :h, :h]
    B = S[..., :h, h:]
    C = S[..., h:, :h]
    D = S[..., h:, h:]
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    Ai = blocked_inv(A, base)
    CAi = mm(C, Ai)
    Sci = blocked_inv(D - mm(CAi, B), base)
    AiB = mm(Ai, B)
    TL = Ai + mm(mm(AiB, Sci), CAi)
    top = jnp.concatenate([TL, -mm(AiB, Sci)], axis=-1)
    bot = jnp.concatenate([-mm(Sci, CAi), Sci], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


@partial(jax.custom_jvp, nondiff_argnums=(1, 2, 3))
def newton_inv(S: jax.Array, tol: Optional[float] = None,
               max_steps: int = 16, init: str = "jacobi") -> jax.Array:
    """Batched inverse via Newton–Schulz iteration X <- X (2I - S X).

    Pure batched matmuls; on the H100 the flagship factor is faster with it
    than with the pivoted-LU inverse (measured in PERF.md).  The error contracts
    quadratically: E_{k+1} = E_k^2 with E = I - S X.

    init="jacobi" (X0 = inv(diag S)) converges iff the Jacobi iteration
    matrix has spectral radius < 1 — the diagonally-dominant operating regime
    this framework's MC64/AWBM scaling pipeline establishes (SURVEY.md §7
    hard-part 2).  init="pan" (X0 = S^T / (||S||_1 ||S||_inf)) converges for
    any nonsingular S but needs ~log2(cond^2) extra steps.  Divergence (or
    NaN) exits the loop early; callers detect garbage via
    utils.debug.factor_health and re-factor with inverter="blocked".
    """
    b = S.shape[-1]
    eye = jnp.eye(b, dtype=S.dtype)
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    rdtype = jnp.zeros((), S.dtype).real.dtype
    if tol is None:
        tol = 50 * float(jnp.finfo(rdtype).eps)
    if init == "pan":
        n1 = jnp.max(jnp.sum(jnp.abs(S), axis=-2), axis=-1)
        ninf = jnp.max(jnp.sum(jnp.abs(S), axis=-1), axis=-1)
        scale = jnp.maximum(n1 * ninf, jnp.finfo(rdtype).tiny)
        X0 = jnp.swapaxes(S, -1, -2).conj() / scale[..., None, None]
    else:
        d = jnp.diagonal(S, axis1=-2, axis2=-1)
        safe = jnp.where(d != 0, d, jnp.ones_like(d))
        X0 = eye * (1.0 / safe)[..., None, :]

    def body(c):
        X, _, it = c
        R = 2.0 * eye - mm(S, X)
        err = jnp.max(jnp.abs(R - eye))
        return mm(X, R), err.astype(rdtype), it + 1

    def cond(c):
        _, err, it = c
        # err > 1e8 or NaN -> stop wasting matmuls on a diverged iteration
        return (err > tol) & (it < max_steps) & (err < 1e8)

    # initial "error" only needs to pass the loop gates (> tol, < 1e8);
    # the true residual is computed inside the first iteration
    X, _, _ = jax.lax.while_loop(
        cond, body, (X0, jnp.array(1e6, rdtype), jnp.zeros((), jnp.int32)))
    return X


@newton_inv.defjvp
def _newton_inv_jvp(tol, max_steps, init, primals, tangents):
    # implicit differential of X = S^{-1}: dX = -X dS X.  Linear in dS, so
    # JAX transposes it for reverse mode too — exact regardless of the
    # adaptive iteration count (the while_loop itself is not reverse-
    # differentiable, and doesn't need to be).
    (S,) = primals
    (dS,) = tangents
    X = newton_inv(S, tol, max_steps, init)
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return X, -mm(X, mm(dS, X))


@partial(jax.custom_jvp, nondiff_argnums=(1, 2))
def newton_inv_fixed(S: jax.Array, cheap_steps: int = 10,
                     polish_steps: int = 2) -> jax.Array:
    """Newton–Schulz with a FIXED precision schedule: ``cheap_steps`` at
    DEFAULT precision (TF32 products for f32 on the GPU — the iteration is
    self-correcting, E_{k+1} = E_k^2 contracts any low-precision noise)
    then ``polish_steps`` at HIGHEST to set the final accuracy.  No
    convergence check: removes the while_loop's serialized max-reduce +
    branch from the factor scan's critical path.
    Use only in the diagonally-dominant regime; `newton_inv` remains the
    adaptive/guarded default."""
    b = S.shape[-1]
    eye = jnp.eye(b, dtype=S.dtype)
    d = jnp.diagonal(S, axis1=-2, axis2=-1)
    X = eye * (1.0 / jnp.where(d != 0, d, jnp.ones_like(d)))[..., None, :]
    mmc = partial(jnp.matmul, precision=jax.lax.Precision.DEFAULT)
    mmh = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    for _ in range(cheap_steps):
        X = mmc(X, 2.0 * eye - mmc(S, X))
    for _ in range(polish_steps):
        X = mmh(X, 2.0 * eye - mmh(S, X))
    return X


@newton_inv_fixed.defjvp
def _newton_inv_fixed_jvp(cheap_steps, polish_steps, primals, tangents):
    (S,) = primals
    (dS,) = tangents
    X = newton_inv_fixed(S, cheap_steps, polish_steps)
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return X, -mm(X, mm(dS, X))


def resolve_inverter(inverter: str) -> str:
    """'auto' -> the engine the platform seam picks for this backend
    (utils.platform.default_inverter); other names pass through."""
    if inverter == "auto":
        from ..utils.platform import default_inverter
        return default_inverter()
    return inverter


def batched_inverse(S: jax.Array, inverter: str = "auto") -> jax.Array:
    """Dispatch: 'newton' Newton–Schulz iteration (batched products; needs
    the near-diagonally-dominant regime the scaling pipeline provides),
    'newton_fixed' fixed-schedule Newton (no convergence check, cheap
    steps at DEFAULT precision + HIGHEST polish), 'blocked' Schur
    recursion, 'lapack' pivoted LU, 'auto' = :func:`resolve_inverter`."""
    inverter = resolve_inverter(inverter)
    if inverter == "newton":
        return newton_inv(S)
    if inverter == "newton_fixed":
        return newton_inv_fixed(S)
    if inverter == "newton_pan":
        return newton_inv(S, init="pan", max_steps=48)
    if inverter == "blocked":
        return blocked_inv(S)
    return jnp.linalg.solve(
        S, jnp.broadcast_to(jnp.eye(S.shape[-1], dtype=S.dtype), S.shape))


def sweep_precision(*operands):
    """Matmul precision for solve-sweep math: HIGHEST when every operand is
    a >= 32-bit float (the sweeps are memory-bound, so full-precision
    products cost little — and DEFAULT may run f32 products in TF32, which
    keeps about three decimal digits); DEFAULT when any operand is stored
    bf16 (already a reduced-precision operand)."""
    if all(jnp.dtype(o.dtype).itemsize >= 4 for o in operands):
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def _sweep_matvec(m, v):
    """y[a, r] = sum_b m[a, b] v[b, r] (plus leading batch dims via vmap)."""
    return jnp.matmul(m, v, precision=sweep_precision(m, v))


def cast_factor(fact: BlockTriFactor, dtype) -> BlockTriFactor:
    """Store factors in a lower precision (e.g. bfloat16) while solves keep
    f32 carries: F/Sinv/U are read-bandwidth-bound in the sweeps, so halving
    their bytes nearly halves solve time; accuracy is recovered by iterative
    refinement (solvers.krylov.richardson with the factorization as PC)."""
    if fact.method not in ("inv", "spd"):
        raise ValueError("cast_factor supports method='inv'/'spd' factors")
    return BlockTriFactor(F=fact.F.astype(dtype), U=fact.U.astype(dtype),
                          Sinv=fact.Sinv.astype(dtype), Slu=fact.Slu,
                          piv=fact.piv, method=fact.method,
                          nshift=fact.nshift)


def blocktri_solve(fact: BlockTriFactor, rhs: jax.Array,
                   unroll: int = 1) -> jax.Array:
    """Solve T x = rhs given a block-Thomas factorization.

    rhs: [nb, b] or [nb, b, r].  Forward scan eliminates with F, reverse scan
    back-substitutes with S^{-1} and U — all batched matmuls for method "inv".
    ``unroll`` is exposed for experimentation.
    """
    squeeze = rhs.ndim == 2
    if squeeze:
        rhs = rhs[..., None]

    mv = _sweep_matvec

    # forward: y_0 = rhs_0, y_i = rhs_i - F_i y_{i-1}
    def fwd(y_prev, inputs):
        f, bi = inputs
        y = bi - mv(f, y_prev)
        return y, y

    y0 = rhs[0]
    _, y_rest = jax.lax.scan(fwd, y0, (fact.F[1:], rhs[1:]), unroll=unroll)
    y = jnp.concatenate([y0[None], y_rest], axis=0)

    if fact.method == "inv":
        def bwd(x_next, inputs):
            sinv, u, yi = inputs
            x = mv(sinv, yi - mv(u, x_next))
            return x, x
        x_last = mv(fact.Sinv[-1], y[-1])
        _, x_rest = jax.lax.scan(
            bwd, x_last,
            (fact.Sinv[:-1], fact.U[:-1], y[:-1]),
            reverse=True, unroll=unroll)
    elif fact.method == "spd":
        # U_i = L_{i+1}^H and F_{i+1} = L_{i+1} Sinv_i with Sinv Hermitian
        # give Sinv_i U_i = F_{i+1}^H: the backward sweep reads F (again)
        # and Sinv instead of a stored U —
        #   x_i = Sinv_i y_i - F_{i+1}^H x_{i+1}
        tH = lambda a: jnp.swapaxes(a, -1, -2).conj()

        def bwd(x_next, inputs):
            sinv, f_next, yi = inputs
            x = mv(sinv, yi) - mv(tH(f_next), x_next)
            return x, x
        x_last = mv(fact.Sinv[-1], y[-1])
        _, x_rest = jax.lax.scan(
            bwd, x_last,
            (fact.Sinv[:-1], fact.F[1:], y[:-1]),
            reverse=True, unroll=unroll)
    else:
        def bwd(x_next, inputs):
            slu, piv, u, yi = inputs
            x = jsl.lu_solve((slu, piv), yi - _mm(u, x_next))
            return x, x
        x_last = jsl.lu_solve((fact.Slu[-1], fact.piv[-1]), y[-1])
        _, x_rest = jax.lax.scan(
            bwd, x_last,
            (fact.Slu[:-1], fact.piv[:-1], fact.U[:-1], y[:-1]),
            reverse=True, unroll=unroll)

    x = jnp.concatenate([x_rest, x_last[None]], axis=0)
    return x[..., 0] if squeeze else x


def transposed_factor_from_blocks(fact: BlockTriFactor,
                                  blocks: BlockTridiagonal
                                  ) -> BlockTriFactor:
    """REGULAR-form factor for T^T from a method='inv' forward factor plus
    the original blocks: with

        F'_i = (Sinv_{i-1} U_{i-1})^T,  Sinv'_i = Sinv_i^T,
        U'_i = L_{i+1}^T

    the STANDARD block-Thomas sweeps compute the transpose solve (derive by
    substituting z_i = Sinv_i^T w_i into the U^T L^T sweeps of
    blocktri_solve_transpose).  Unlike the TransposedBlockTriFactor marker
    (which forces the XLA scan), the result is an ordinary 'inv' factor —
    the Pallas sweep kernels apply on the GPU, so transpose solves run at
    forward-solve speed.  Works batched over leading dims.

    Needs the original L blocks (only L is read from ``blocks``), and
    materializes a full second factor (~the forward factor's footprint) —
    the marker wrapper shares storage instead; pick by whether the
    transpose is applied often enough to amortize."""
    return transposed_factor_from_L(fact, blocks.L)


def transposed_factor_from_L(fact: BlockTriFactor,
                             L: jax.Array) -> BlockTriFactor:
    """``transposed_factor_from_blocks`` from the bare subdiagonal blocks
    ``L`` ([..., nb, b, b]; row 0 is ignored) — the entry used when the
    factorization stored them at factor time (``spike_factor(store_lt=True)``
    keeps ``SpikeFactor.Lb``), so no band->blocktri reconversion is needed
    to build the regular-form transpose."""
    tT = lambda a: jnp.swapaxes(a, -1, -2)
    prec = sweep_precision(fact.U, fact.Sinv)
    FU = jnp.matmul(fact.Sinv[..., :-1, :, :], fact.U[..., :-1, :, :],
                    precision=prec)
    zbb = jnp.zeros_like(fact.F[..., :1, :, :])
    Fh = jnp.concatenate([zbb, tT(FU)], axis=-3)
    Uh = jnp.concatenate([tT(L[..., 1:, :, :].astype(fact.U.dtype)),
                          zbb], axis=-3)
    return BlockTriFactor(F=Fh, U=Uh, Sinv=tT(fact.Sinv), Slu=fact.Slu,
                          piv=fact.piv, method="inv", nshift=fact.nshift)


def blocktri_solve_transpose(fact: BlockTriFactor, rhs: jax.Array,
                             unroll: int = 1) -> jax.Array:
    """Solve T^T x = rhs reusing the FORWARD factorization — no transpose
    refactorization (PETSc MatSolveTranspose analogue).

    The block-Thomas factorization is T = L*U with L unit-lower-bidiagonal
    (subdiagonal F) and U upper-bidiagonal (diagonal S, superdiagonal U), so
    T^T = U^T L^T solves in two sweeps over the SAME stored blocks,
    transposed:

        forward:  z_0 = S_0^{-T} r_0,
                  z_i = S_i^{-T} (r_i - U_{i-1}^T z_{i-1})
        backward: x_{nb-1} = z_{nb-1},
                  x_i = z_i - F_{i+1}^T x_{i+1}

    Pure transpose (no conjugation): for a complex adjoint solve A^H x = g
    use conj(solve_transpose(fact, conj(g))).  rhs: [nb, b] or [nb, b, r].
    """
    if fact.method == "spd":
        # Hermitian T factored as (I+E) S (I+E)^H satisfies T^T = conj(T),
        # so the transpose solve is the conjugated forward solve (for real
        # dtypes the conj is elided and this IS the forward solve)
        return jnp.conj(blocktri_solve(fact, jnp.conj(rhs), unroll=unroll))

    squeeze = rhs.ndim == 2
    if squeeze:
        rhs = rhs[..., None]
    mv = _sweep_matvec
    tT = lambda a: jnp.swapaxes(a, -1, -2)

    if fact.method == "inv":
        def fwd(z_prev, inputs):
            sinv_t, u_prev_t, ri = inputs
            z = mv(sinv_t, ri - mv(u_prev_t, z_prev))
            return z, z

        z0 = mv(tT(fact.Sinv[0]), rhs[0])
        _, z_rest = jax.lax.scan(
            fwd, z0, (tT(fact.Sinv[1:]), tT(fact.U[:-1]), rhs[1:]),
            unroll=unroll)
    elif fact.method == "lu":
        def fwd(z_prev, inputs):
            slu, piv, u_prev_t, ri = inputs
            z = jsl.lu_solve((slu, piv), ri - mv(u_prev_t, z_prev), trans=1)
            return z, z

        z0 = jsl.lu_solve((fact.Slu[0], fact.piv[0]), rhs[0], trans=1)
        _, z_rest = jax.lax.scan(
            fwd, z0, (fact.Slu[1:], fact.piv[1:], tT(fact.U[:-1]), rhs[1:]),
            unroll=unroll)
    else:
        raise ValueError(f"unsupported method {fact.method!r}")
    z = jnp.concatenate([z0[None], z_rest], axis=0)

    def bwd(x_next, inputs):
        f_next_t, zi = inputs
        x = zi - mv(f_next_t, x_next)
        return x, x

    x_last = z[-1]
    _, x_rest = jax.lax.scan(bwd, x_last, (tT(fact.F[1:]), z[:-1]),
                             reverse=True, unroll=unroll)
    x = jnp.concatenate([x_rest, x_last[None]], axis=0)
    return x[..., 0] if squeeze else x
