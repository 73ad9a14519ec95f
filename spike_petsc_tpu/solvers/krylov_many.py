"""Batched multi-RHS Krylov engines: one iteration loop for ALL columns.

The serving-economics completion of the multi-RHS story (BASELINE config 2's
"batched solves"): ``spike_solve_many`` already streams the factorization
once for r right-hand sides inside a direct solve, but a *Krylov* solve over
r right-hand sides previously ran ``lax.map`` of one-RHS solves — factors
and operator re-streamed r times per iteration sweep.  These engines carry
X as an [n, r] block instead:

  * every matvec / PCApply is a TRUE multi-RHS call (factor blocks and band
    entries stream once per iteration for all columns — the dominant cost of
    the factor-read-bound SPIKE apply);
  * all per-column inner products of one algorithmic step stack into ONE
    reduction (a single [k, r] psum on a mesh instead of r separate scalar
    rounds — the latency shape PETSc reaches for with batched VecMDot);
  * convergence is PER COLUMN: a converged column's state freezes (the
    column-wise analogue of ``_freeze_when_done``) while the loop runs until
    every column is terminal, so columns with different difficulty don't
    perturb each other's iterates.

Results are column-batched ``KSPResult`` pytrees: x [n, r], its/reason/rnorm
[r], history [maxit+1, r] with entries beyond a column's ``its`` left NaN
(the single-RHS contract: a frozen column stops writing its history).

The role mirrors PETSc's MatMatSolve / KSPMatSolve batched interfaces
(the reference reaches multi-RHS solves through PETSc's Mat-level API; cf.
/root/reference/src/matbanded.c:184-192 PCApply forwarding, which PETSc
calls once per rhs).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .types import (CONVERGED_ITERATING, DIVERGED_BREAKDOWN, KSPResult,
                    default_convergence_check)

# Krylov-basis products in full working precision (see solvers/krylov.py)
_HI = jax.lax.Precision.HIGHEST


def _cdot(a, b, axis_name=None):
    """Per-column inner products <a_j, b_j>: [n, r] x [n, r] -> [r]."""
    d = jnp.sum(jnp.conj(a) * b, axis=0)
    if axis_name is not None:
        d = jax.lax.psum(d, axis_name)
    return d


def _cdots(pairs, axis_name=None):
    """Fused per-column inner products: one stacked [k, r] psum for several
    column-wise <a_j, b_j> families (one collective instead of k)."""
    d = jnp.stack([jnp.sum(jnp.conj(a) * b, axis=0) for a, b in pairs])
    if axis_name is not None:
        d = jax.lax.psum(d, axis_name)
    return tuple(d[i] for i in range(len(pairs)))


def _cnorm(x, axis_name=None):
    return jnp.sqrt(jnp.real(_cdot(x, x, axis_name)))


def _any_iterating(reason, conv_sync_axis=None):
    it = jnp.any(reason == CONVERGED_ITERATING)
    if conv_sync_axis is None:
        return it
    return jax.lax.pmax(it.astype(jnp.int32), conv_sync_axis) == 1


def _freeze_cols(body):
    """Wrap a loop body so columns whose reason is terminal keep executing
    the body's collectives (alignment across the batch) but discard every
    per-column state update."""

    def wrapped(s):
        new_s = body(s)
        active = s["reason"] == CONVERGED_ITERATING          # [r]

        def merge(n, o):
            if o.ndim == 0:                                   # loop-global
                return n
            # per-column state carries the column axis LAST ([r], [*, r],
            # [*, *, r], ...) — broadcast the mask there
            return jnp.where(
                active.reshape((1,) * (n.ndim - 1) + (-1,)), n, o)

        return {k: merge(new_s[k], s[k]) for k in s}
    return wrapped


def bicgstab_many(matvec: Callable, B: jax.Array,
                  X0: Optional[jax.Array] = None,
                  pc_apply: Optional[Callable] = None, *,
                  rtol: float = 1e-5, atol: float = 1e-50,
                  divtol: float = 1e4, maxit: int = 10000,
                  axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Column-batched preconditioned BiCGStab; B: [n, r].

    ``matvec`` / ``pc_apply`` must accept [n, r] blocks (multi-RHS
    operators: ``spike_solve_many``, ``local_matvec_many``, or a vmapped
    single-RHS closure).  Each column runs exactly the one-RHS ``bicgstab``
    recurrence (same shadow vector = its own initial residual); per-column
    breakdown/convergence freezes that column only.
    """
    psolve = pc_apply or (lambda x: x)
    x0_zero = X0 is None                 # R0 = B exactly; skip matvec(0)
    X0 = jnp.zeros_like(B) if X0 is None else X0
    dtype = B.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    tiny = jnp.finfo(dtype).tiny
    r = B.shape[1]
    norm = partial(_cnorm, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    bnorm = norm(B)
    R0 = B if x0_zero else B - matvec(X0)
    Rt = R0
    rnorm0 = norm(R0)
    hist = jnp.full((maxit + 1, r), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _any_iterating(s["reason"], conv_sync_axis)

    def body(s):
        rho_new = _cdot(Rt, s["R"], axis_name)
        breakdown = jnp.abs(rho_new) < tiny
        beta = (rho_new / jnp.where(s["rho"] != 0, s["rho"], 1.0)) \
            * (s["alpha"] / jnp.where(s["omega"] != 0, s["omega"], 1.0))
        P = s["R"] + beta[None, :] * (s["P"] - s["omega"][None, :] * s["V"])
        Phat = psolve(P)
        V = matvec(Phat)
        denom = _cdot(Rt, V, axis_name)
        alpha = rho_new / jnp.where(denom != 0, denom, 1.0)
        Sr = s["R"] - alpha[None, :] * V
        # classic BiCGStab half-step ("s-norm") convergence test: with a
        # strong PC every column converges right here, and skipping the
        # second psolve+matvec halves the per-iteration serving cost
        # (krylov_serve dissect, VERDICT r4 #6).  Work is saved only when
        # EVERY active column passes (one lax.cond around the second half);
        # otherwise the full step runs and per-column freezing applies as
        # before.  PETSc's KSPSolve_BCGS performs the same s-norm exit.
        snorm = norm(Sr)
        half_reason = check(snorm, bnorm, s["trip"] + 1)
        active = s["reason"] == CONVERGED_ITERATING
        all_half = jnp.all(jnp.logical_or(~active, half_reason > 0))
        if conv_sync_axis is not None:
            all_half = jax.lax.pmin(
                all_half.astype(jnp.int32), conv_sync_axis) == 1

        def half_step(_):
            X = s["X"] + alpha[None, :] * Phat
            hist = s["hist"].at[s["trip"] + 1].set(snorm)
            return dict(X=X, R=Sr, P=P, V=V, rho=rho_new, alpha=alpha,
                        omega=s["omega"], its=s["its"] + 1,
                        reason=half_reason, hist=hist, trip=s["trip"] + 1)

        def full_step(_):
            Shat = psolve(Sr)
            T = matvec(Shat)
            # <t,t>, <t,s> for every column in ONE stacked psum
            tt, ts = _cdots(((T, T), (T, Sr)), axis_name)
            omega = ts / jnp.where(tt != 0, tt, 1.0)
            X = s["X"] + alpha[None, :] * Phat + omega[None, :] * Shat
            R = Sr - omega[None, :] * T
            rn = norm(R)
            hist = s["hist"].at[s["trip"] + 1].set(rn)
            reason = check(rn, bnorm, s["trip"] + 1)
            reason = jnp.where(breakdown & (reason == CONVERGED_ITERATING),
                               DIVERGED_BREAKDOWN, reason)
            return dict(X=X, R=R, P=P, V=V, rho=rho_new, alpha=alpha,
                        omega=omega, its=s["its"] + 1, reason=reason,
                        hist=hist, trip=s["trip"] + 1)

        return jax.lax.cond(all_half, half_step, full_step, None)

    ones = jnp.ones((r,), dtype)
    init = dict(X=X0, R=R0, P=jnp.zeros_like(B), V=jnp.zeros_like(B),
                rho=ones, alpha=ones, omega=ones,
                its=jnp.zeros((r,), jnp.int32), reason=reason0, hist=hist,
                trip=jnp.int32(0))

    out = jax.lax.while_loop(cond, _freeze_cols(body), init)
    rn = norm(B - matvec(out["X"]))
    return KSPResult(x=out["X"], its=out["its"], reason=out["reason"],
                     rnorm=rn, history=out["hist"])


def cg_many(matvec: Callable, B: jax.Array, X0: Optional[jax.Array] = None,
            pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
            atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
            axis_name=None, conv_sync_axis=None, **_) -> KSPResult:
    """Column-batched preconditioned CG (SPD operator/PC); B: [n, r]."""
    psolve = pc_apply or (lambda x: x)
    x0_zero = X0 is None                 # R0 = B exactly; skip matvec(0)
    X0 = jnp.zeros_like(B) if X0 is None else X0
    dtype = B.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    r = B.shape[1]
    norm = partial(_cnorm, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    bnorm = norm(B)
    R0 = B if x0_zero else B - matvec(X0)
    Z0 = psolve(R0)
    rnorm0 = norm(R0)
    hist = jnp.full((maxit + 1, r), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _any_iterating(s["reason"], conv_sync_axis)

    def body(s):
        W = matvec(s["P"])
        pw = _cdot(s["P"], W, axis_name)
        alpha = s["rz"] / jnp.where(pw != 0, pw, 1.0)
        X = s["X"] + alpha[None, :] * s["P"]
        R = s["R"] - alpha[None, :] * W
        Z = psolve(R)
        rz_new, rr = _cdots(((R, Z), (R, R)), axis_name)
        beta = rz_new / jnp.where(s["rz"] != 0, s["rz"], 1.0)
        P = Z + beta[None, :] * s["P"]
        rn = jnp.sqrt(jnp.real(rr))
        its = s["its"] + 1
        hist = s["hist"].at[s["trip"] + 1].set(rn)
        reason = check(rn, bnorm, s["trip"] + 1)
        return dict(X=X, R=R, P=P, rz=rz_new, its=its, reason=reason,
                    hist=hist, trip=s["trip"] + 1)

    init = dict(X=X0, R=R0, P=Z0, rz=_cdot(R0, Z0, axis_name),
                its=jnp.zeros((r,), jnp.int32), reason=reason0, hist=hist,
                trip=jnp.int32(0))

    out = jax.lax.while_loop(cond, _freeze_cols(body), init)
    return KSPResult(x=out["X"], its=out["its"], reason=out["reason"],
                     rnorm=norm(B - matvec(out["X"])), history=out["hist"])


def gmres_many(matvec: Callable, B: jax.Array,
               X0: Optional[jax.Array] = None,
               pc_apply: Optional[Callable] = None, *, restart: int = 30,
               rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
               maxit: int = 10000, side: str = "left",
               cgs_refinement: str = "always", axis_name=None,
               conv_sync_axis=None, **_) -> KSPResult:
    """Column-batched restarted GMRES; B: [n, r].

    Every column runs the one-RHS ``gmres`` recurrence (classical GS with
    one reorthogonalization pass, Givens least squares, PETSc defaults) but
    all columns share each iteration's multi-RHS matvec/PCApply and ONE
    fused [restart+1, r] Gram reduction.  Memory: the basis is
    [restart+1, n, r] — size the restart to the serving batch (bcgs_many
    carries 4 vectors per column where GMRES carries ``restart``).

    Per-column convergence freezes a finished column's basis/Hessenberg in
    place; its solution update uses exactly the columns it built.

    ``cgs_refinement`` follows the single-RHS option (never/ifneeded/
    always).  ``"ifneeded"`` note: the DGKS test is per column but the
    refinement pass is one batched program — it fires when ANY column
    needs it (a refinement on an already-orthogonal column is a no-op up
    to roundoff; per-column gating would save no bandwidth since the
    second pass streams the whole [m+1, n, r] basis either way).
    """
    psolve = pc_apply or (lambda x: x)
    right = side == "right"
    X0 = jnp.zeros_like(B) if X0 is None else X0
    n, nc = B.shape
    dtype = B.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    m = max(1, int(restart))
    norm = partial(_cnorm, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    def gram(V, w):
        h = jnp.einsum("anr,nr->ar", jnp.conj(V), w, precision=_HI)
        if axis_name is not None:
            h = jax.lax.psum(h, axis_name)
        return h

    def residual(X):
        R = B - matvec(X)
        return R if right else psolve(R)

    bnorm = norm(B) if right else norm(psolve(B))
    R0 = residual(X0)
    rnorm0 = norm(R0)
    hist0 = jnp.full((maxit + 1, nc), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    idx = jnp.arange(m)

    def back_sub(Hm, gm, used):
        """Per-column upper-triangular solve of the rotated Hessenberg,
        masked to each column's own basis size."""
        Hm = jnp.where(used[:, None, :] & used[None, :, :], Hm[:m],
                       jnp.eye(m, dtype=dtype)[:, :, None])
        gm = jnp.where(used, gm[:m], 0.0)

        def step(t, y):
            i = m - 1 - t
            s = jnp.einsum("kr,kr->r", Hm[i], y, precision=_HI)
            den = Hm[i, i]
            yi = (gm[i] - s) / jnp.where(den != 0, den, 1.0)
            return y.at[i].set(yi)

        y = jax.lax.fori_loop(0, m, step, jnp.zeros((m, nc), dtype))
        return jnp.where(used, y, 0.0)

    def cycle(s):
        X, R = s["X"], s["R"]
        beta = norm(R)                                        # [r]
        safe_beta = jnp.where(beta > 0, beta, 1.0)
        V = jnp.zeros((m + 1, n, nc), dtype).at[0].set(
            R / safe_beta.astype(dtype))
        H = jnp.zeros((m + 1, m, nc), dtype)
        g = jnp.zeros((m + 1, nc), dtype).at[0].set(beta.astype(dtype))
        cs = jnp.ones((m, nc), dtype)
        sn = jnp.zeros((m, nc), dtype)

        def inner_cond(c):
            return (c["j"] < m) & _any_iterating(c["reason"],
                                                 conv_sync_axis)

        def inner_body(c):
            V, H, g, cs, sn = c["V"], c["H"], c["g"], c["cs"], c["sn"]
            j = c["j"]
            vj = V[j]
            w = psolve(matvec(vj)) if not right else matvec(psolve(vj))
            mask = (jnp.arange(m + 1) <= j).astype(dtype)[:, None]
            if cgs_refinement == "always":
                h = gram(V, w) * mask
                w = w - jnp.einsum("ar,anr->nr", h, V, precision=_HI)
                # one reorthogonalization pass (as the single-RHS gmres)
                h2 = gram(V, w) * mask
                w = w - jnp.einsum("ar,anr->nr", h2, V, precision=_HI)
                h = h + h2
                hj1 = norm(w)                                 # [r]
            elif cgs_refinement == "never":
                h = gram(V, w) * mask
                w = w - jnp.einsum("ar,anr->nr", h, V, precision=_HI)
                hj1 = norm(w)
            elif cgs_refinement == "ifneeded":
                # pre-projection column norms ride the SAME psum as the
                # gram block (one [m+2, r] reduction, zero extra rounds)
                hw = jnp.concatenate(
                    [jnp.einsum("anr,nr->ar", jnp.conj(V), w, precision=_HI),
                     jnp.sum(jnp.conj(w) * w, axis=0)[None]], axis=0)
                if axis_name is not None:
                    hw = jax.lax.psum(hw, axis_name)
                h = hw[:-1] * mask
                wnorm0 = jnp.sqrt(jnp.abs(jnp.real(hw[-1])))  # [r]
                w = w - jnp.einsum("ar,anr->nr", h, V, precision=_HI)
                hj1 = norm(w)
                need = jnp.any(hj1 < 0.7071067811865476 * wnorm0)
                if conv_sync_axis is not None:
                    need = jax.lax.pmax(need.astype(jnp.int32),
                                        conv_sync_axis) == 1

                def _refine(args):
                    w_, h_, _ = args
                    h2 = gram(V, w_) * mask
                    w2 = w_ - jnp.einsum("ar,anr->nr", h2, V, precision=_HI)
                    return w2, h_ + h2, norm(w2)

                w, h, hj1 = jax.lax.cond(need, _refine, lambda a: a,
                                         (w, h, hj1))
            else:
                raise ValueError(
                    f"unknown cgs_refinement {cgs_refinement!r}: expected "
                    "never, ifneeded, or always "
                    "(-ksp_gmres_cgs_refinement_type)")
            V = V.at[j + 1].set(
                w / jnp.where(hj1 > 0, hj1, 1.0).astype(dtype))
            col = h.at[j + 1].set(hj1.astype(dtype))          # [m+1, r]

            def rot(i, colc):
                t1 = cs[i] * colc[i] + sn[i] * colc[i + 1]
                t2 = (-jnp.conj(sn[i]) * colc[i]
                      + jnp.conj(cs[i]) * colc[i + 1])
                apply = i < j
                colc = colc.at[i].set(jnp.where(apply, t1, colc[i]))
                colc = colc.at[i + 1].set(jnp.where(apply, t2,
                                                    colc[i + 1]))
                return colc

            col = jax.lax.fori_loop(0, m, rot, col)
            denom = jnp.sqrt(jnp.abs(col[j]) ** 2
                             + jnp.abs(col[j + 1]) ** 2)      # [r]
            ok = denom > 0
            safe = jnp.where(ok, denom, 1.0)
            c_new = jnp.where(ok, jnp.conj(col[j]) / safe,
                              jnp.ones((nc,), dtype))
            s_new = jnp.where(ok, jnp.conj(col[j + 1]) / safe,
                              jnp.zeros((nc,), dtype))
            col = col.at[j].set(denom.astype(dtype)).at[j + 1].set(0.0)
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(
                -jnp.conj(s_new) * gj)
            H = H.at[:, j].set(col)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)

            rn = jnp.abs(g[j + 1]).astype(rdtype)             # [r]
            trip = c["trip"] + 1
            hist = c["hist"].at[trip].set(rn)
            its = c["its"] + 1
            reason = check(rn, bnorm, trip)
            return dict(V=V, H=H, g=g, cs=cs, sn=sn, j=j + 1, jcol=c["jcol"]
                        + 1, its=its, trip=trip, reason=reason, hist=hist)

        # j/trip are loop-global; jcol counts the steps EACH column was
        # active for (its lsq mask) via the per-column freeze
        inner0 = dict(V=V, H=H, g=g, cs=cs, sn=sn, j=jnp.int32(0),
                      jcol=jnp.zeros((nc,), jnp.int32), its=s["its"],
                      trip=s["trip"], reason=s["reason"], hist=s["hist"])
        ic = jax.lax.while_loop(inner_cond, _freeze_cols(inner_body),
                                inner0)

        used = idx[:, None] < ic["jcol"][None, :]             # [m, r]
        y = back_sub(ic["H"], ic["g"], used)
        dX = jnp.einsum("ar,anr->nr", y, ic["V"][:m], precision=_HI)
        if right:
            dX = psolve(dX)
        X = X + dX
        R = residual(X)
        return dict(X=X, R=R, its=ic["its"], trip=ic["trip"],
                    reason=ic["reason"], hist=ic["hist"])

    init = dict(X=X0, R=R0, its=jnp.zeros((nc,), jnp.int32),
                trip=jnp.int32(0), reason=reason0, hist=hist0)

    def cond(s):
        return _any_iterating(s["reason"], conv_sync_axis)

    out = jax.lax.while_loop(cond, _freeze_cols(cycle), init)
    return KSPResult(x=out["X"], its=out["its"], reason=out["reason"],
                     rnorm=_cnorm(B - matvec(out["X"]), axis_name),
                     history=out["hist"])


def richardson_many(matvec: Callable, B: jax.Array,
                    X0: Optional[jax.Array] = None,
                    pc_apply: Optional[Callable] = None, *,
                    rtol: float = 1e-5, atol: float = 1e-50,
                    divtol: float = 1e4, maxit: int = 10000,
                    scale: float = 1.0, axis_name=None,
                    conv_sync_axis=None, **_) -> KSPResult:
    """Column-batched preconditioned Richardson iteration
    X += scale * M^{-1}(B - A X); B: [n, r].

    With a factorization PC this is multi-RHS iterative refinement — the
    serving mode that recovers full accuracy from reduced-precision factor
    storage (one multi-RHS PCApply + one multi-RHS matvec per iteration,
    factor blocks streamed once for all columns)."""
    psolve = pc_apply or (lambda x: x)
    x0_zero = X0 is None                 # R0 = B exactly; skip matvec(0)
    X0 = jnp.zeros_like(B) if X0 is None else X0
    rdtype = jnp.zeros((), B.dtype).real.dtype
    r = B.shape[1]
    norm = partial(_cnorm, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    bnorm = norm(B)
    R0 = B if x0_zero else B - matvec(X0)
    rnorm0 = norm(R0)
    hist = jnp.full((maxit + 1, r), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _any_iterating(s["reason"], conv_sync_axis)

    def body(s):
        X = s["X"] + scale * psolve(s["R"])
        R = B - matvec(X)
        rn = norm(R)
        its = s["its"] + 1
        hist = s["hist"].at[s["trip"] + 1].set(rn)
        reason = check(rn, bnorm, s["trip"] + 1)
        return dict(X=X, R=R, its=its, reason=reason, hist=hist,
                    trip=s["trip"] + 1)

    init = dict(X=X0, R=R0, its=jnp.zeros((r,), jnp.int32), reason=reason0,
                hist=hist, trip=jnp.int32(0))
    out = jax.lax.while_loop(cond, _freeze_cols(body), init)
    return KSPResult(x=out["X"], its=out["its"], reason=out["reason"],
                     rnorm=norm(B - matvec(out["X"])), history=out["hist"])


def preonly_many(matvec: Callable, B: jax.Array,
                 X0: Optional[jax.Array] = None,
                 pc_apply: Optional[Callable] = None, *, maxit: int = 1,
                 axis_name=None, **_) -> KSPResult:
    """Single multi-RHS preconditioner application (KSPPREONLY batched):
    with a direct factorization PC this is ``spike_solve_many`` with the
    KSPResult bookkeeping."""
    from .types import CONVERGED_ITS, DIVERGED_NANORINF
    psolve = pc_apply or (lambda x: x)
    norm = partial(_cnorm, axis_name=axis_name)
    X = psolve(B) if X0 is None else X0 + psolve(B - matvec(X0))
    rn = norm(B - matvec(X))
    rdtype = jnp.zeros((), B.dtype).real.dtype
    # exactly one application happens: a [2, r] history, NOT [maxit+1, r] —
    # _params_from_options defaults maxit to 10000 and a [10001, r] dead
    # array per serving batch is real memory (code-review r3)
    hist = jnp.full((2, B.shape[1]), jnp.nan, rdtype)
    hist = hist.at[0].set(norm(B)).at[1].set(rn)
    reason = jnp.where(jnp.isfinite(rn), jnp.int32(CONVERGED_ITS),
                       jnp.int32(DIVERGED_NANORINF))
    return KSPResult(x=X, its=jnp.ones((B.shape[1],), jnp.int32),
                     reason=reason, rnorm=rn, history=hist)


#: batched engines by the single-RHS name they correspond to
MANY_SOLVERS = {
    "gmres": gmres_many,
    "bcgs": bicgstab_many,
    "bicgstab": bicgstab_many,
    "cg": cg_many,
    "richardson": richardson_many,
    "preonly": preonly_many,
}
