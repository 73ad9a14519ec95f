"""Preconditioners (the PC layer).

Composability mirrors the reference: PCBANDED extracts a banded approximation
of the preconditioning matrix and delegates to an *embedded* PC configured
under the ``banded_`` options prefix (/root/reference/src/matbanded.c:165-192,
251-283).  Here a PC is a small object with a jittable ``apply`` closure over
device factorization state; factories are registered by name and read their
parameters from a prefix-scoped options database.

Built-ins:
  none     identity
  jacobi   diagonal scaling
  lu       direct banded solve (block-Thomas, single partition)
  spike    SPIKE partitioned banded solve (exact or truncated reduced system)
  bjacobi  per-partition local solves, no interface coupling
  asm      (restricted) additive Schwarz with overlap          [PCASM]
  banded   norm-fraction band extraction + embedded inner PC   [PCBANDED]
  ksp      inner Krylov solve as the preconditioner            [PCKSP]
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp


from .. import sparse as hsp
from ..ops.band import BandedMatrix, banded_diagonal
from ..ops.blocktri import blocktri_solve
from ..ops.spike import spike_factor, spike_solve, spike_solve_many
from ..utils.options import Options
from ..utils.registry import PRECONDITIONERS, register_pc


@dataclass
class PC:
    """A configured preconditioner: ``apply`` maps residual -> correction."""

    name: str
    apply: Callable
    info: dict = dfield(default_factory=dict)
    inner: Optional["PC"] = None
    # native multi-RHS apply ([n, r] -> [n, r]) when the PC type has one
    # (factorization PCs via spike_solve_many: factors stream ONCE for all
    # r columns); None = callers vmap ``apply`` (correct, not bandwidth-
    # optimal).  Consumed by ksp.make_solver_many / the batched Krylov
    # engines.
    apply_many: Optional[Callable] = dfield(default=None, repr=False)
    # host-side builder for the M^{-T} apply (PCApplyTranspose analogue);
    # None = this PC type has no transpose (composite/fieldsplit)
    make_transpose: Optional[Callable] = dfield(default=None, repr=False)
    _transposed: Optional["PC"] = dfield(default=None, repr=False)

    def describe(self, indent: int = 0) -> str:
        """PCView-style description (/root/reference/src/matbanded.c:196-211)."""
        pad = "  " * indent
        s = f"{pad}PC {self.name}: " + ", ".join(
            f"{k}={v}" for k, v in self.info.items())
        if self.inner is not None:
            s += "\n" + self.inner.describe(indent + 1)
        return s

    def transpose(self) -> "PC":
        """A PC applying M^{-T} (PETSc PCApplyTranspose role), built ONCE on
        the host and cached — factorization-backed PCs reuse their stored
        factors via ops.spike.spike_transpose (no refactorization).  Used by
        KSPs that iterate on A^T (`-ksp_type bicg`)."""
        if self._transposed is None:
            if self.make_transpose is None:
                raise ValueError(
                    f"pc '{self.name}' has no transpose apply "
                    "(PCApplyTranspose unsupported for this type)")
            self._transposed = self.make_transpose()
            # transpose() is an involution: (M^T)^{-T} = M^{-1}, so the
            # transposed PC's transpose is this PC itself (KSPSolveTranspose
            # + bicg composes: the shadow recurrence gets the forward apply)
            if self._transposed._transposed is None:
                self._transposed._transposed = self
        return self._transposed


def _as_banded(pmat, opts: Options) -> BandedMatrix:
    if isinstance(pmat, BandedMatrix):
        return pmat
    # host sparse/dense -> band storage (full bandwidth)
    data, kl, ku = hsp.csr_to_banded_arrays(hsp.as_csr(pmat))
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)


def make_pc(name: str, pmat, options: Optional[Options] = None,
            prefix: str = "") -> PC:
    """Build a preconditioner by registry name, PETSc ``PCSetType`` style."""
    opts = (options or Options()).scoped(prefix)
    return PRECONDITIONERS.get(name)(pmat, opts)


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------

@register_pc("none")
def pc_none(pmat, opts: Options) -> PC:
    pc = PC(name="none", apply=lambda x: x)
    pc.make_transpose = lambda: pc                  # identity is symmetric
    return pc


@register_pc("jacobi")
def pc_jacobi(pmat, opts: Options) -> PC:
    """Diagonal scaling (PCJACOBI).

    ``-pc_jacobi_type diagonal|rowmax|rowsum`` (PCJacobiSetType): scale by
    the inverse diagonal (default), the row's max |a_ij|, or the row's
    sum of |a_ij| (the L1-smoother diagonal).  ``-pc_jacobi_abs``
    (PCJacobiSetUseAbs): use |diagonal| — for indefinite matrices where a
    signed diagonal would flip residual components.  The PC matrix is
    diagonal, hence self-transpose for every variant."""
    jtype = opts.get_string("pc_jacobi_type", "diagonal")
    if jtype not in ("diagonal", "rowmax", "rowsum"):
        raise ValueError(f"unknown -pc_jacobi_type {jtype!r}: expected "
                         "diagonal, rowmax, or rowsum")
    if isinstance(pmat, BandedMatrix):
        if jtype == "rowmax":
            d = jnp.max(jnp.abs(pmat.data), axis=1)
        elif jtype == "rowsum":
            d = jnp.sum(jnp.abs(pmat.data), axis=1)
        else:
            d = banded_diagonal(pmat)
    else:
        acsr = hsp.as_csr(pmat)
        if jtype == "rowmax":
            d = jnp.asarray(abs(acsr).max(axis=1).toarray().ravel())
        elif jtype == "rowsum":
            import numpy as _np
            d = jnp.asarray(_np.asarray(abs(acsr).sum(axis=1)).ravel())
        else:
            d = jnp.asarray(acsr.diagonal())
    if jtype == "diagonal" and opts.get_bool("pc_jacobi_abs", False):
        d = jnp.abs(d)
    dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 1.0)
    pc = PC(name="jacobi", apply=lambda x: dinv * x,
            apply_many=lambda X: dinv[:, None] * X)
    pc.make_transpose = lambda: pc                  # diagonal is symmetric
    return pc


@register_pc("sor")
def pc_sor(pmat, opts: Options) -> PC:
    """Block-SSOR preconditioner (PETSc ``-pc_type sor`` role).

    Design note: PETSc's PCSOR is a POINTWISE Gauss-Seidel relaxation — a
    scalar recurrence over rows, hostile to batched matrix units.  Here
    the splitting is at block granularity: the band is viewed as
    block-tridiagonal (``-pc_sor_block``, default = the bandwidth) and one
    symmetric sweep applies

        M⁻¹ = ((2-ω)/ω) · (D/ω + U)⁻¹ D (D/ω + L)⁻¹

    via two block-triangular scans + stored batched D⁻¹ blocks (setup =
    one batched inversion; no Schur recursion, so setup is far cheaper
    than a factorization PC — the classic SOR trade).  Pointwise SOR is
    the b=1 special case.  Options: ``-pc_sor_omega`` (1.0),
    ``-pc_sor_its`` (1; extra sweeps iterate x += M⁻¹(r - A x)),
    ``-pc_sor_type symmetric|forward|backward``, ``-pc_sor_block``,
    ``-pc_sor_inverter``.  Symmetric sweeps on a symmetric matrix give a
    symmetric M — valid for cg/minres.
    """
    from ..ops.blocktri import (band_to_blocktri, batched_inverse,
                                blocktri_matvec, _sweep_matvec)

    band = _as_banded(pmat, opts)
    omega = float(opts.get_real("pc_sor_omega", 1.0))
    if not 0.0 < omega < 2.0:
        raise ValueError(f"-pc_sor_omega must be in (0, 2), got {omega}")
    its = opts.get_int("pc_sor_its", 1)
    stype = opts.get_string("pc_sor_type", "symmetric")
    if stype not in ("symmetric", "forward", "backward"):
        raise ValueError(f"unknown -pc_sor_type {stype!r}")
    block = opts.get_int("pc_sor_block", None)
    inverter = opts.get_string("pc_sor_inverter", "auto")
    b = block or max(band.kl, band.ku, 1)
    n = band.n
    T = band_to_blocktri(band, b)
    Dinv = batched_inverse(T.D, inverter)
    info = dict(omega=omega, its=its, type=stype, block=b)

    def _mk_apply(T, Dinv):
        nb = T.nb
        mv = _sweep_matvec

        def fwd(r):
            # (D/ω + L)⁻¹ r: y_i = ω·Dinv_i (r_i - L_i y_{i-1})
            def step(y_prev, inp):
                dinv, l, ri = inp
                y = omega * mv(dinv, ri - mv(l, y_prev))
                return y, y
            y0 = omega * mv(Dinv[0], r[0])
            _, ys = jax.lax.scan(step, y0, (Dinv[1:], T.L[1:], r[1:]))
            return jnp.concatenate([y0[None], ys], axis=0)

        def bwd(r):
            # (D/ω + U)⁻¹ r: z_i = ω·Dinv_i (r_i - U_i z_{i+1})
            def step(z_next, inp):
                dinv, u, ri = inp
                z = omega * mv(dinv, ri - mv(u, z_next))
                return z, z
            zl = omega * mv(Dinv[-1], r[-1])
            _, zs = jax.lax.scan(step, zl, (Dinv[:-1], T.U[:-1], r[:-1]),
                                 reverse=True)
            return jnp.concatenate([zs, zl[None]], axis=0)

        def sweep(r):
            if stype == "forward":
                return fwd(r)
            if stype == "backward":
                return bwd(r)
            t = fwd(r)
            s = jax.vmap(mv)(T.D, t) / omega
            return ((2.0 - omega) / omega) * bwd(s)

        def apply_blocked(rblk):
            z = sweep(rblk)
            if its > 1:
                def body(i, zc):
                    resid = rblk - blocktri_matvec(T, zc)
                    return zc + sweep(resid)
                z = jax.lax.fori_loop(0, its - 1, body, z)
            return z

        def apply(r):
            rp = jnp.zeros((nb * b,), r.dtype).at[:n].set(r)
            z = apply_blocked(rp.reshape(nb, b))
            return z.reshape(-1)[:n]

        def apply_many(R):
            r = R.shape[1]
            rp = jnp.zeros((nb * b, r), R.dtype).at[:n].set(R)
            z = apply_blocked(rp.reshape(nb, b, r))
            return z.reshape(nb * b, r)[:n]

        return apply, apply_many

    apply, apply_many = _mk_apply(T, Dinv)

    def _mk_transpose(_T=T, _Dinv=Dinv, _info=info):
        # M(A)^T == M(A^T) for this splitting: build the same sweeps on the
        # transposed blocks (D'_i = D_i^T, L'_i = U_{i-1}^T, U'_i = L_{i+1}^T)
        tT = lambda a: jnp.swapaxes(a, -1, -2)
        zbb = jnp.zeros_like(_T.D[:1])
        from ..ops.blocktri import BlockTridiagonal
        Tt = BlockTridiagonal(
            D=tT(_T.D),
            L=jnp.concatenate([zbb, tT(_T.U[:-1])], axis=0),
            U=jnp.concatenate([tT(_T.L[1:]), zbb], axis=0))
        at, amt = _mk_apply(Tt, tT(_Dinv))
        return PC(name="sor_transpose", apply=at, apply_many=amt,
                  info=_info)

    return PC(name="sor", apply=apply, apply_many=apply_many, info=info,
              make_transpose=_mk_transpose)


def _newton_probe_active(inverter: str) -> bool:
    from ..ops.blocktri import resolve_inverter
    return resolve_inverter(inverter) in ("newton", "newton_fixed",
                                          "newton_pan")


def _probe_tolerance(store_dtype, spike_dtype) -> float:
    """Probe-residual acceptance threshold: reduced-precision storage
    legitimately floors the probe residual — only errors well beyond each
    mode's floor indicate inverter failure."""
    if store_dtype is not None:
        return 5e-2
    if spike_dtype is not None:
        return 5e-3
    return 1e-3


def _newton_safety_net(band, sf, inverter, store_dtype, spike_dtype,
                       refactor, exact: bool = True):
    """Newton-family safety net: the fast inverters assume the near-
    diagonally-dominant regime the scaling pipeline provides (and
    'newton_fixed' has no internal convergence check at all).  Verify the
    factorization on a probe solve and silently re-factor with the pivoted
    blocked recursion if the result is junk — the host-level retry contract
    documented in spike_factor.

    ``exact=False`` (truncated/block-Jacobi factorizations, which drop
    coupling ON PURPOSE) only rejects non-finite probes.

    Returns (sf, fell_back).
    """
    if not _newton_probe_active(inverter):
        return sf, False
    import numpy as _np
    from ..ops.band import banded_matvec as _bmv
    from ..ops.spike import spike_solve as _ssolve
    probe = _bmv(band, jnp.ones((band.n,), band.data.dtype))
    xs = _ssolve(sf, probe)
    err = float(_np.asarray(jnp.linalg.norm(
        _bmv(band, xs) - probe) / jnp.linalg.norm(probe)))
    tol = _probe_tolerance(store_dtype, spike_dtype)
    bad = not _np.isfinite(err) or (exact and err > tol) or err > 1e6
    if bad:
        return refactor(), True
    return sf, False


def _spike_pc(pmat, opts: Options, *, name: str, default_K: int,
              truncated_default: bool, default_method: str = "inv") -> PC:
    band = _as_banded(pmat, opts)
    k = max(band.kl, band.ku, 1)
    K = opts.get_int(f"pc_{name}_partitions", default_K)
    K = max(1, min(K, band.n // (2 * k)))   # partitions must cover 2k rows
    block = opts.get_int(f"pc_{name}_block", None)
    method = opts.get_string(f"pc_{name}_method", default_method)
    truncated = opts.get_bool(f"pc_{name}_truncated", truncated_default)
    store = opts.get_bool(f"pc_{name}_store_spikes", False)
    # -pc_<name>_store_lt: keep the L blocks at factor time so the
    # regular-form transpose builds with NO band->blocktri reconversion
    # (spike_factor(store_lt=True) -> spike_transpose uses sf.Lb)
    store_lt = opts.get_bool(f"pc_{name}_store_lt", False)
    shift = opts.get_string("pc_factor_shift_type", "none")
    shift_amount = opts.get_real("pc_factor_shift_amount", 0.0)
    inverter = opts.get_string(f"pc_{name}_inverter", "auto")
    # mixed-precision storage: -pc_spike_store_dtype bf16 halves the bytes
    # the solve sweeps stream (PC-grade accuracy; pair with refinement);
    # -pc_spike_spike_dtype bf16 downcasts only V/W (accuracy-free — the
    # spikes decay away from the interfaces; bench default configuration)
    _dt = {"": None, "none": None, "bf16": jnp.bfloat16,
           "f32": jnp.float32, "f64": jnp.float64}
    store_dtype = _dt[opts.get_string(f"pc_{name}_store_dtype", "")]
    spike_dtype = _dt[opts.get_string(f"pc_{name}_spike_dtype", "")]
    # -pc_<name>_factor_dtype casts the BAND before factoring (vs
    # store_dtype, which casts the finished factor): the mixed-precision
    # recipe keeps the operator f64 (matvec-only) while the whole
    # factorization runs in f32 — PCApply casts at the boundary, so
    # any f64 KSP (richardson refinement, gmres) composes untouched
    orig_dtype = band.dtype
    factor_dtype = _dt[opts.get_string(f"pc_{name}_factor_dtype", "")]
    if factor_dtype is not None and orig_dtype != factor_dtype:
        from ..ops.band import BandedMatrix
        band = BandedMatrix(data=band.data.astype(factor_dtype),
                            kl=band.kl, ku=band.ku)
    sf = spike_factor(band, K=K, block_b=block, method=method,
                      truncated=truncated, store_spikes=store,
                      shift=shift, shift_amount=shift_amount,
                      inverter=inverter, store_dtype=store_dtype,
                      spike_dtype=spike_dtype, store_lt=store_lt)
    info = dict(partitions=K, block=sf.b, tip=sf.k, method=method,
                truncated=truncated)
    if factor_dtype is not None and orig_dtype != factor_dtype:
        info["factor_dtype"] = jnp.dtype(factor_dtype).name
    if store_dtype is not None:
        info["store_dtype"] = jnp.dtype(store_dtype).name
    if spike_dtype is not None and store:
        info["spike_dtype"] = jnp.dtype(spike_dtype).name
    if store_lt:
        info["store_lt"] = True
    sf, fb = _newton_safety_net(
        band, sf, inverter, store_dtype, spike_dtype,
        lambda: spike_factor(band, K=K, block_b=block, method=method,
                             truncated=truncated, store_spikes=store,
                             shift=shift, shift_amount=shift_amount,
                             inverter="blocked", store_dtype=store_dtype,
                             spike_dtype=spike_dtype, store_lt=store_lt),
        exact=not truncated)
    if fb:
        info["inverter_fallback"] = "blocked"
    if shift != "none":
        import numpy as _np
        info["shifted_pivots"] = int(_np.asarray(sf.fact.nshift).sum())
    if opts.get_bool(f"pc_{name}_check", False):
        # typed factorization status (MC64 INFO(1)-style; SURVEY.md §5):
        # fail fast on singular pivots instead of silently producing NaNs
        from ..utils.debug import OK, factor_health, SINGULAR
        h = factor_health(sf.fact)
        status = int(h.status)
        info["health"] = status
        if status == SINGULAR:
            raise FloatingPointError(
                f"pc '{name}': factorization has singular Schur pivots "
                f"(reorder/scale the matrix first)")
    # the transpose reduced system must use the RESOLVED inverter: if the
    # forward factorization needed the 'blocked' fallback, an 'auto' here
    # would hand the transpose back to the unguarded Newton engine on
    # exactly the matrices that broke it (code-review r3)
    inv_eff = "blocked" if fb else inverter
    # -pc_<name>_transpose_fast 0: storage-sharing marker form (XLA-scan
    # transpose sweeps, zero extra memory) instead of the default
    # regular-form transpose (fused-kernel speed, ~a second factor-sized
    # buffer; the band conversion at build vanishes under store_lt)
    tr_fast = opts.get_bool(f"pc_{name}_transpose_fast", True)
    tr_band = band if tr_fast else None

    def _mk_transpose(_sf=sf, _band=tr_band, _name=name, _info=info,
                      _inv=inv_eff, _fast=tr_fast):
        # PCApplyTranspose: reuse the stored factors (spike_transpose — no
        # refactorization); built once on the host, cached by PC.transpose.
        # The band (or stored Lb) builds the REGULAR-form transpose
        # (fused-kernel sweeps — transpose applies at forward-solve speed)
        from ..ops.spike import spike_transpose
        sft = spike_transpose(_sf, inverter=_inv, band=_band, fast=_fast)
        return PC(name=_name + "_transpose",
                  apply=partial(spike_solve, sft), info=_info)

    if factor_dtype is not None and orig_dtype != factor_dtype:
        def _cast_apply(_sf, _fd=factor_dtype, _od=orig_dtype):
            def apply(r):
                r_lo = r.astype(_fd)
                if jnp.dtype(_od).itemsize > 4 >= jnp.dtype(_fd).itemsize:
                    # f64 caller, f32 factors: trace the inner solve with
                    # x64 promotion OFF — Pallas Mosaic lowering recurses
                    # forever on i64-typed index converts (JAX bug), and
                    # the kernel only ever sees f32/i32 anyway
                    with jax.enable_x64(False):
                        y = spike_solve(_sf, r_lo)
                else:
                    y = spike_solve(_sf, r_lo)
                return y.astype(_od)
            return apply

        def _mk_transpose_cast(_sf=sf, _band=tr_band, _name=name, _info=info,
                               _inv=inv_eff, _fast=tr_fast):
            from ..ops.spike import spike_transpose
            sft = spike_transpose(_sf, inverter=_inv, band=_band, fast=_fast)
            return PC(name=_name + "_transpose",
                      apply=_cast_apply(sft), info=_info)

        def _cast_apply_many(_sf, _fd=factor_dtype, _od=orig_dtype):
            def apply_many(R):
                r_lo = R.astype(_fd)
                if jnp.dtype(_od).itemsize > 4 >= jnp.dtype(_fd).itemsize:
                    with jax.enable_x64(False):
                        y = spike_solve_many(_sf, r_lo)
                else:
                    y = spike_solve_many(_sf, r_lo)
                return y.astype(_od)
            return apply_many

        return PC(name=name, apply=_cast_apply(sf), info=info,
                  apply_many=_cast_apply_many(sf),
                  make_transpose=_mk_transpose_cast)
    return PC(name=name, apply=partial(spike_solve, sf), info=info,
              apply_many=partial(spike_solve_many, sf),
              make_transpose=_mk_transpose)


@register_pc("lu")
def pc_lu(pmat, opts: Options) -> PC:
    """Direct banded factorization (single-partition block-Thomas) — the
    role PETSc's -pc_type lu plays in the reference's canned recipe
    (/root/reference/src/makefile:18)."""
    band = _as_banded(pmat, opts)
    method = opts.get_string("pc_lu_method", "inv")
    block = opts.get_int("pc_lu_block", None)
    shift = opts.get_string("pc_factor_shift_type", "none")
    shift_amount = opts.get_real("pc_factor_shift_amount", 0.0)
    inverter = opts.get_string("pc_lu_inverter", "auto")
    store_lt = opts.get_bool("pc_lu_store_lt", False)
    sf = spike_factor(band, K=1, block_b=block, method=method,
                      shift=shift, shift_amount=shift_amount,
                      inverter=inverter, store_lt=store_lt)
    info = dict(block=sf.b, method=method)
    if store_lt:
        info["store_lt"] = True
    sf, fb = _newton_safety_net(
        band, sf, inverter, None, None,
        lambda: spike_factor(band, K=1, block_b=block, method=method,
                             shift=shift, shift_amount=shift_amount,
                             inverter="blocked", store_lt=store_lt))
    if fb:
        info["inverter_fallback"] = "blocked"
    if shift != "none":
        import numpy as _np
        info["shifted_pivots"] = int(_np.asarray(sf.fact.nshift).sum())
    _lu_tr_fast = opts.get_bool("pc_lu_transpose_fast", True)

    def _mk_transpose(_sf=sf, _band=(band if _lu_tr_fast else None),
                      _info=info, _inv="blocked" if fb else inverter,
                      _fast=_lu_tr_fast):
        from ..ops.spike import spike_transpose
        sft = spike_transpose(_sf, inverter=_inv, band=_band, fast=_fast)
        return PC(name="lu_transpose",
                  apply=partial(spike_solve, sft), info=_info)

    return PC(name="lu", apply=partial(spike_solve, sf), info=info,
              apply_many=partial(spike_solve_many, sf),
              make_transpose=_mk_transpose)


@register_pc("spike")
def pc_spike(pmat, opts: Options) -> PC:
    return _spike_pc(pmat, opts, name="spike", default_K=16,
                     truncated_default=False)


@register_pc("cholesky")
def pc_cholesky(pmat, opts: Options) -> PC:
    """Symmetric/Hermitian direct factorization — PETSc's ``-pc_type
    cholesky`` role (the SPD half of the reference's canned LU recipe,
    /root/reference/src/makefile:17-18).

    Uses method='spd' block-LDL^H factors: only F and Sinv are stored (U is
    reconstructed as F^H in the sweeps), so the factorization holds 2/3 of
    LU's block arrays — and it is its own transpose (PCApplyTranspose is
    free).  The matrix must be symmetric (Hermitian): the factorization
    reads only the diagonal and subdiagonal blocks.  All ``pc_cholesky_*``
    options of the spike family apply (partitions for a symmetric SPIKE
    split, inverter, store_dtype, shift, ...); ``-pc_cholesky_method``
    can override back to 'inv'/'lu' for experiments.
    """
    return _spike_pc(pmat, opts, name="cholesky", default_K=1,
                     truncated_default=False, default_method="spd")


@register_pc("bjacobi")
def pc_bjacobi(pmat, opts: Options) -> PC:
    """Per-partition solves with interface coupling dropped entirely — the
    cheapest member of the spike family (useful as a smoother/baseline)."""
    band = _as_banded(pmat, opts)
    K = opts.get_int("pc_bjacobi_blocks", 16)
    K = max(1, min(K, band.n // (2 * max(band.kl, band.ku, 1))))
    block = opts.get_int("pc_bjacobi_block", None)
    method = opts.get_string("pc_bjacobi_method", "inv")
    inverter = opts.get_string("pc_bjacobi_inverter", "auto")
    sf = spike_factor(band, K=K, block_b=block, method=method,
                      truncated=True, inverter=inverter)
    sf, _fb = _newton_safety_net(
        band, sf, inverter, None, None,
        lambda: spike_factor(band, K=K, block_b=block, method=method,
                             truncated=True, inverter="blocked"),
        exact=False)

    def _block_apply(fact):
        def apply(x):
            from ..ops.spike import _batched_tri_solve
            rp = jnp.zeros((sf.K * sf.m,), x.dtype).at[:sf.n].set(x)
            y = _batched_tri_solve(fact, rp.reshape(sf.K, sf.nb, sf.b))
            return y.reshape(-1)[:sf.n]
        return apply

    info = dict(blocks=K, block=sf.b, method=method)

    def _mk_transpose(_info=info):
        # coupling is dropped, so the transpose PC is just the per-block
        # transpose solves on the same stored factors
        from ..ops.blocktri import TransposedBlockTriFactor
        return PC(name="bjacobi_transpose",
                  apply=_block_apply(TransposedBlockTriFactor(sf.fact)),
                  info=_info)

    return PC(name="bjacobi", apply=_block_apply(sf.fact), info=info,
              make_transpose=_mk_transpose)


@register_pc("banded")
def pc_banded(pmat, opts: Options) -> PC:
    """PCBANDED: extract the norm-fraction band of pmat, precondition with an
    embedded PC on the band (/root/reference/src/matbanded.c:165-192).

    Options: -pc_banded_kmax (default 50), -pc_banded_frac (default 0.95)
    (/root/reference/src/matbanded.c:156-157, 261-262); the embedded PC is
    configured under the ``banded_`` prefix (default: spike), mirroring
    PCCreate_Banded's prefix plumbing (/root/reference/src/matbanded.c:278-281).
    """
    kmax = opts.get_int("pc_banded_kmax", 50)
    frac = opts.get_real("pc_banded_frac", 0.95)
    if isinstance(pmat, BandedMatrix):
        raise TypeError("pc 'banded' extracts a band from a general sparse "
                        "pmat; the operator is already banded")
    ext = hsp.extract_banded(hsp.as_csr(pmat), kmax=kmax, frac=frac)
    data, kl, ku = hsp.csr_to_banded_arrays(ext.matrix, kl=ext.k, ku=ext.k)
    band = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    inner_opts = opts.scoped("banded_")
    inner_name = inner_opts.get_string("pc_type", "spike")
    inner = PRECONDITIONERS.get(inner_name)(band, inner_opts)
    info = dict(k=ext.k, frac=round(ext.frac, 6), kmax=kmax)

    def _mk_transpose(_info=info):
        it = inner.transpose()
        return PC(name="banded_transpose", apply=it.apply, info=_info,
                  inner=it)

    return PC(name="banded", apply=inner.apply, info=info, inner=inner,
              apply_many=inner.apply_many, make_transpose=_mk_transpose)


@register_pc("ksp")
def pc_ksp(pmat, opts: Options) -> PC:
    """PCKSP: a full inner Krylov solve as the preconditioner apply.

    PETSc's PCKSP — the composition that turns ANY registered KSP+PC pair
    into a preconditioner for an outer iteration (e.g. a loosely-converged
    inner GMRES+bjacobi accelerating an outer solve on the full operator).
    The inner solver is configured under the ``ksp_`` options prefix, PETSc's
    exact convention: ``-ksp_ksp_type``, ``-ksp_pc_type``, ``-ksp_ksp_rtol``,
    ``-ksp_ksp_max_it``, ... (nested prefixes compose:
    ``-ksp_banded_pc_type`` configures a PCBANDED inside the inner KSP).

    The apply runs the inner ``lax.while_loop`` to its own tolerances on
    every outer iteration, so the preconditioner VARIES between applies —
    use ``-ksp_type fgmres`` (or richardson) for the outer method, as PETSc
    advises for PCKSP.  Inner defaults are deliberately PC-shaped: rtol 1e-2,
    maxit 50 (override via ``-ksp_ksp_rtol`` / ``-ksp_ksp_max_it``; PETSc
    leaves the inner KSP at solver defaults, which as a PC wastes work).

    PCApplyTranspose solves A^T z = r with the same inner configuration
    (operator transposed host-side, inner PC reusing stored factors via
    PC.transpose) — exact adjoint when the inner solve is run to
    convergence, the standard PCKSP approximation otherwise.
    """
    from . import ksp as _ksp
    inner_opts = opts.scoped("ksp_")
    inner_ksp = inner_opts.get_string("ksp_type", "gmres")
    inner_pc_name = inner_opts.get_string("pc_type", "none")
    rtol = inner_opts.get_real("ksp_rtol", 1e-2)
    maxit = inner_opts.get_int("ksp_max_it", 50)
    inner_pc = PRECONDITIONERS.get(inner_pc_name)(pmat, inner_opts)
    solver = _ksp.make_solver(pmat, options=inner_opts, ksp_type=inner_ksp,
                              pc=inner_pc, jit=False, rtol=rtol, maxit=maxit)
    info = dict(ksp=inner_ksp, rtol=rtol, maxit=maxit)

    def _apply(r):
        return solver(r).x

    def _mk_transpose(_info=info):
        solver_t = _ksp.make_solver(pmat, options=inner_opts,
                                    ksp_type=inner_ksp, pc=inner_pc,
                                    jit=False, transpose=True,
                                    rtol=rtol, maxit=maxit)
        return PC(name="ksp_transpose", apply=lambda r: solver_t(r).x,
                  info=_info,
                  inner=(inner_pc.transpose()
                         if inner_pc.name != "none" else inner_pc))

    return PC(name="ksp", apply=_apply, info=info,
              inner=inner_pc if inner_pc.name != "none" else None,
              make_transpose=_mk_transpose)


@register_pc("asm")
def pc_asm(pmat, opts: Options) -> PC:
    """PCASM: (restricted) additive Schwarz with overlap.

    The overlap generalization of ``bjacobi`` (PETSc PCASM with PCASMType
    RESTRICT/BASIC): each of K row blocks is EXTENDED by ``overlap`` rows on
    both sides, the overlapped local problems are batch-factored with
    Dirichlet truncation, and the apply solves all K local systems in one
    batched sweep.  "restrict" (default, PETSc's default too) takes each
    block's interior rows from its local solution — cheaper and usually
    faster-converging (Cai–Sarkis RAS); "basic" scatter-adds the full
    overlapped solutions.

    Shape: the overlapped windows concatenate into ONE banded operator
    factored by ``spike_factor(K partitions, truncated=True)`` — partition
    boundaries fall exactly on window boundaries, so the truncation drops
    precisely the couplings ASM's local Dirichlet problems drop, and the
    apply is a single batched block-tridiagonal solve (no per-block loop).

    Options: -pc_asm_blocks (16), -pc_asm_overlap (default max(kl, ku)),
    -pc_asm_type restrict|basic, -pc_asm_method, -pc_asm_inverter,
    -pc_asm_block.  Overlap 0 reproduces bjacobi.

    PCApplyTranspose is the exact adjoint of the apply (interior-embed ->
    transposed local solves -> window scatter-add for "restrict"; same
    windows with transposed solves for "basic").
    """
    from ..ops.spike import _batched_tri_solve

    band = _as_banded(pmat, opts)
    k = max(band.kl, band.ku, 1)
    n, w = band.n, band.width
    K = opts.get_int("pc_asm_blocks", 16)
    K = max(1, min(K, n // (2 * k) if n >= 2 * k else 1))
    overlap = opts.get_int("pc_asm_overlap", k)
    if overlap < 0:
        raise ValueError(f"pc_asm_overlap must be >= 0, got {overlap}")
    asm_type = opts.get_string("pc_asm_type", "restrict")
    if asm_type not in ("restrict", "basic"):
        raise ValueError(f"-pc_asm_type must be restrict or basic, "
                         f"got {asm_type!r}")
    method = opts.get_string("pc_asm_method", "inv")
    inverter = opts.get_string("pc_asm_inverter", "auto")
    # -pc_asm_store_dtype bf16: reduced-precision local factors (the apply
    # is factor-read-bound like every spike-family PC; pair with richardson
    # refinement or an outer Krylov to recover accuracy)
    _dt = {"": None, "none": None, "bf16": jnp.bfloat16,
           "f32": jnp.float32, "f64": jnp.float64}
    store_dtype = _dt[opts.get_string("pc_asm_store_dtype", "")]
    bb = opts.get_int("pc_asm_block", None) or k
    m_int = -(-n // K)                       # owned rows per block
    mloc = -(-(m_int + 2 * overlap) // bb) * bb   # window rows (block-mult)
    total = (K - 1) * m_int + mloc
    pad_top = overlap

    # windowed band rows; rows outside [0, n) get a unit diagonal so the
    # padded local operators stay nonsingular (identity on the padding)
    dpad = jnp.zeros((pad_top + total, w),
                     band.data.dtype).at[:, band.kl].set(1.0)
    dpad = dpad.at[pad_top:pad_top + n].set(band.data)
    windows = jnp.stack([dpad[kk * m_int: kk * m_int + mloc]
                         for kk in range(K)])
    concat = BandedMatrix(data=windows.reshape(K * mloc, w),
                          kl=band.kl, ku=band.ku)
    sf = spike_factor(concat, K=K, block_b=bb, method=method,
                      truncated=True, inverter=inverter,
                      store_dtype=store_dtype)
    sf, _fb = _newton_safety_net(
        concat, sf, inverter, store_dtype, None,
        lambda: spike_factor(concat, K=K, block_b=bb, method=method,
                             truncated=True, inverter="blocked",
                             store_dtype=store_dtype),
        exact=False)
    nb_, b_ = sf.nb, sf.b                    # nb_*b_ == mloc
    assert nb_ * b_ == mloc, (nb_, b_, mloc)

    def _scatter(y, dtype):
        acc = jnp.zeros((pad_top + total,), dtype)
        for kk in range(K):
            acc = acc.at[kk * m_int: kk * m_int + mloc].add(y[kk])
        return acc[pad_top:pad_top + n]

    def _apply_with(fact, transposed: bool):
        def apply(x):
            if not transposed or asm_type == "basic":
                rp = jnp.zeros((pad_top + total,),
                               x.dtype).at[pad_top:pad_top + n].set(x)
                rw = jnp.stack([rp[kk * m_int: kk * m_int + mloc]
                                for kk in range(K)])
            else:
                # adjoint of the interior restriction: embed each block's
                # owned rows at window position [overlap, overlap + m_int)
                xe = jnp.zeros((K * m_int,), x.dtype).at[:n].set(x)
                rw = jnp.zeros((K, mloc), x.dtype).at[
                    :, overlap:overlap + m_int].set(xe.reshape(K, m_int))
            y = _batched_tri_solve(fact, rw.reshape(K, nb_, b_))
            y = y.reshape(K, mloc)
            if transposed or asm_type == "basic":
                return _scatter(y, x.dtype)
            return y[:, overlap:overlap + m_int].reshape(-1)[:n]
        return apply

    info = dict(blocks=K, overlap=overlap, type=asm_type, block=b_,
                window=mloc)
    if store_dtype is not None:
        info["store_dtype"] = jnp.dtype(store_dtype).name
    if _fb:
        info["inverter_fallback"] = "blocked"

    def _mk_transpose(_info=info):
        from ..ops.blocktri import TransposedBlockTriFactor
        return PC(name="asm_transpose",
                  apply=_apply_with(TransposedBlockTriFactor(sf.fact),
                                    transposed=True),
                  info=_info)

    return PC(name="asm", apply=_apply_with(sf.fact, transposed=False),
              info=info, make_transpose=_mk_transpose)
