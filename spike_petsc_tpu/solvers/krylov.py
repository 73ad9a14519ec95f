"""Jittable Krylov solvers (the KSP layer).

Functional re-design of the capability the reference reaches through PETSc's
KSP (/root/reference/src/testbed.c:313-316; canned GMRES recipe
/root/reference/src/makefile:17-18): each method is a pure function

    method(matvec, b, x0, pc_apply, **params) -> KSPResult

built from ``lax.while_loop`` so the whole solve — matvecs, preconditioner
applications, reductions — stages into one XLA computation.  No Python-level
iteration: the GMRES inner loop is a single compiled program, and under
``shard_map`` the same code runs multi-device with ``psum`` reductions supplied
by the sharded matvec closures.

Reductions are mesh-aware: every solver takes ``axis_name``; under shard_map
each solver sees only its local shard of the vectors and ``axis_name`` turns
every inner product into a psum over the partition axis — the collective
replacement for the MPI_Allreduce dot products inside PETSc's KSP
(/root/reference/src/wbm.c:546; SURVEY.md §2).  The axis is an explicit
parameter (no module state), so two meshes/axes can trace concurrently.

Fixed-shape state everywhere (Krylov basis [restart+1, n], history buffer
[maxit+1]) — the XLA tracing contract.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..utils.registry import register_ksp
from .types import (CONVERGED_ITERATING, CONVERGED_ITS,
                    CONVERGED_RTOL_NORMAL, DIVERGED_BREAKDOWN,
                    DIVERGED_NANORINF, KSPResult, default_convergence_check)

# Krylov-basis products (Gram-Schmidt, solution updates, inner products) in
# full working precision: DEFAULT lets the GPU run f32 products in TF32
# (about three decimal digits), which stalls the true residual near 1e-4
# while the recurrence reports convergence.  These products are
# memory-bound, so the precision costs nothing measurable.
_HI = jax.lax.Precision.HIGHEST
_mm = partial(jnp.matmul, precision=_HI)


def _identity_pc(x):
    return x


def _dot(a, b, axis_name=None):
    d = jnp.vdot(a, b, precision=_HI)
    if axis_name is not None:
        d = jax.lax.psum(d, axis_name)
    return d


def _norm(x, axis_name=None):
    return jnp.sqrt(jnp.real(_dot(x, x, axis_name)))


def _gram(V, w, axis_name=None):
    """Basis-projection row of dot products <V_i, w> (psum'd when sharded;
    conjugated for complex scalars)."""
    h = _mm(V.conj(), w)
    if axis_name is not None:
        h = jax.lax.psum(h, axis_name)
    return h


def _gram_with_norm(V, w, axis_name=None):
    """(projection row, ||w||) fused into ONE collective — the extra scalar
    rides the same psum as the gram row, so the DGKS refinement test
    ('ifneeded') costs zero additional latency rounds on a mesh."""
    h = _mm(V.conj(), w)
    s = jnp.vdot(w, w, precision=_HI)
    hv = jnp.concatenate([h, jnp.reshape(s, (1,)).astype(h.dtype)])
    if axis_name is not None:
        hv = jax.lax.psum(hv, axis_name)
    return hv[:-1], jnp.sqrt(jnp.abs(jnp.real(hv[-1])))


def _dots(pairs, axis_name=None):
    """Fused inner products: one stacked psum for several <a_i, b_i>.

    On a mesh every ``_dot`` is a separate latency-bound collective;
    independent reductions that the algorithm consumes together should ride
    ONE collective (the analogue of PETSc's split/pipelined KSP variants
    batching MPI_Allreduce calls).  Returns a tuple of scalars in pair order.
    """
    d = jnp.stack([jnp.vdot(a, b, precision=_HI) for a, b in pairs])
    if axis_name is not None:
        d = jax.lax.psum(d, axis_name)
    return tuple(d[i] for i in range(len(pairs)))


def _orthogonalize(V, w, mask, cgs_refinement, axis_name=None,
                   conv_sync_axis=None):
    """Classical Gram-Schmidt orthogonalization of ``w`` against the masked
    rows of ``V`` with PETSc's CGS refinement policy
    (``KSPGMRESSetCGSRefinementType``):

    * ``"always"``  — one unconditional reorthogonalization pass (the
      historical default here; maximally robust, but streams the [m, n]
      basis TWICE per iteration);
    * ``"never"``   — single pass (halves per-iteration basis HBM traffic;
      safe for well-conditioned systems, PETSc's own default);
    * ``"ifneeded"``— single pass plus the DGKS cancellation test
      ``||w_after|| < ||w_before|| / sqrt(2)``; the pre-projection norm
      rides the SAME psum as the gram row (zero extra latency rounds) and
      the refinement executes under ``lax.cond`` (no bandwidth paid when
      skipped).  On replica meshes the predicate syncs over
      ``conv_sync_axis`` so every replica executes the same collective
      sequence (see _keep_iterating).

    Returns ``(w_orth, h, hj1)``.
    """
    if cgs_refinement == "never":
        h = _gram(V, w, axis_name) * mask
        w = w - _mm(h, V)
        return w, h, _norm(w, axis_name)
    if cgs_refinement == "always":
        h = _gram(V, w, axis_name) * mask
        w = w - _mm(h, V)
        h2 = _gram(V, w, axis_name) * mask
        w = w - _mm(h2, V)
        return w, h + h2, _norm(w, axis_name)
    if cgs_refinement != "ifneeded":
        raise ValueError(
            f"unknown cgs_refinement {cgs_refinement!r}: expected never, "
            "ifneeded, or always (-ksp_gmres_cgs_refinement_type)")
    hrow, wnorm0 = _gram_with_norm(V, w, axis_name)
    h = hrow * mask
    w = w - _mm(h, V)
    hj1 = _norm(w, axis_name)
    need = hj1 < 0.7071067811865476 * wnorm0
    if conv_sync_axis is not None:
        need = jax.lax.pmax(need.astype(jnp.int32), conv_sync_axis) == 1

    def _refine(args):
        w_, h_, _ = args
        h2 = _gram(V, w_, axis_name) * mask
        w2 = w_ - _mm(h2, V)
        return w2, h_ + h2, _norm(w2, axis_name)

    return jax.lax.cond(need, _refine, lambda a: a, (w, h, hj1))


def _keep_iterating(reason, conv_sync_axis=None):
    """Loop predicate, optionally SYNCHRONIZED over a mesh axis that the
    solver's reductions do NOT cover (e.g. the replica axis of a serving
    mesh).  Without the sync, independent replicas take data-dependent,
    DIFFERENT while_loop trip counts — and since each trip executes
    collectives (ppermute halos, psum dots) over the partition axes,
    devices in different replicas execute mismatched collective sequences:
    a deadlock on XLA:CPU's rendezvous and undefined behaviour generally.
    Synced, every participant iterates until ALL have stopped (extra
    iterations on converged replicas are harmless refinement; reported
    ``its`` counts executed iterations)."""
    it = reason == CONVERGED_ITERATING
    if conv_sync_axis is None:
        return it
    return jax.lax.pmax(it.astype(jnp.int32), conv_sync_axis) == 1


def _freeze_when_done(body, conv_sync_axis):
    """Wrap a while_loop body so a participant whose reason is already
    TERMINAL keeps executing the body's collectives (alignment!) but
    discards every state update — without this, conv_sync_axis-forced
    extra trips would (a) divide by the breakdown-zero scalars bicgstab
    just stopped on (NaN overwrites a valid solution) and (b) recompute
    ``reason = check(...)``, silently re-arming a loop that stopped on
    DIVERGED_BREAKDOWN.  No-op (unwrapped) without a sync axis, where the
    loop exits on any terminal reason before re-entering the body."""
    if conv_sync_axis is None:
        return body

    def wrapped(s):
        new_s = body(s)
        active = s["reason"] == CONVERGED_ITERATING
        return jax.tree_util.tree_map(
            lambda n, o: jnp.where(active, n, o), new_s, s)
    return wrapped


# ---------------------------------------------------------------------------
# Arnoldi spectrum estimation (KSPComputeEigenvalues / KSPChebyshevEstEig)
# ---------------------------------------------------------------------------

def arnoldi_hessenberg(matvec: Callable, v0: jax.Array, m: int,
                       pc_apply: Optional[Callable] = None,
                       axis_name: Optional[str] = None):
    """m-step Arnoldi factorization of the left-preconditioned operator
    M⁻¹A started from ``v0``; returns ``(H, k)`` with H the (m+1, m)
    Hessenberg and ``k`` the number of completed columns (< m on exact
    breakdown, where the Krylov space became invariant — the Ritz values of
    ``H[:k, :k]`` are then exact eigenvalues).

    Jittable (one device dispatch); the Ritz values of ``H[:k, :k]``
    estimate the extreme eigenvalues of M⁻¹A — the engine behind PETSc's
    ``KSPComputeEigenvalues`` diagnostics and ``KSPChebyshevEstEig``
    bound selection (the reference drives both through PETSc options,
    cf. /root/reference/src/makefile:17-18 option-driven KSP config).
    """
    psolve = pc_apply or _identity_pc
    dtype = v0.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    norm = partial(_norm, axis_name=axis_name)
    n0 = norm(v0)
    v = v0 / jnp.where(n0 != 0, n0, 1.0).astype(rdtype)
    V = jnp.zeros((m + 1,) + v0.shape, dtype).at[0].set(v)
    H = jnp.zeros((m + 1, m), dtype)
    tiny = jnp.finfo(rdtype).tiny

    def body(j, c):
        V, H, k, alive = c
        w = psolve(matvec(V[j]))
        # modified-GS projections against ALL stored vectors; rows > j are
        # zero vectors so their (exactly zero) coefficients are harmless,
        # masked anyway for clarity
        h = _gram(V, w, axis_name)
        h = jnp.where(jnp.arange(m + 1) <= j, h, 0)
        w = w - jnp.tensordot(h, V, axes=([0], [0]), precision=_HI)
        hj1 = norm(w)
        ok = hj1 > 1e3 * tiny
        H = H.at[:, j].set(h).at[j + 1, j].set(hj1.astype(dtype))
        V = V.at[j + 1].set(jnp.where(
            ok, w / jnp.where(hj1 != 0, hj1, 1.0).astype(rdtype), 0))
        k = k + jnp.where(alive, 1, 0)
        return V, H, k, alive & ok

    _, H, k, _ = jax.lax.fori_loop(
        0, m, body, (V, H, jnp.int32(0), jnp.bool_(True)))
    return H, k


def estimate_extreme_eigs(matvec: Callable, n: int, dtype=jnp.float32, *,
                          m: int = 10, pc_apply: Optional[Callable] = None,
                          seed: int = 0, v0=None):
    """Host-side Ritz-value estimation of M⁻¹A's spectrum: run ``m`` Arnoldi
    steps on device, eigendecompose the tiny Hessenberg on host.  Returns the
    complex Ritz values (length ≤ m).  This is setup-time work (PETSc runs
    its estimation once inside KSPSetUp), so eager dispatch is fine."""
    import numpy as np
    m = max(1, min(int(m), int(n)))
    if v0 is None:
        v0 = jnp.asarray(
            np.random.default_rng(seed).standard_normal(n), dtype)
    H, k = jax.jit(
        lambda v: arnoldi_hessenberg(matvec, v, m, pc_apply))(v0)
    k = int(k)
    if k == 0:
        return np.zeros(0, complex)
    Hk = np.asarray(H)[:k, :k]
    return np.linalg.eigvals(Hk)


def golub_kahan_bidiag(matvec: Callable, matvec_transpose: Callable,
                       v0: jax.Array, m: int,
                       pc_apply: Optional[Callable] = None,
                       pc_apply_transpose: Optional[Callable] = None,
                       axis_name: Optional[str] = None):
    """m-step Golub–Kahan bidiagonalization of the left-preconditioned
    operator B = M⁻¹A started from ``v0``; returns ``(alphas, betas, k)``
    with B_m = bidiag(alphas, betas) the (k+1, k) lower-bidiagonal factor
    and ``k`` the number of completed steps (< m on exact breakdown).

    Jittable.  The singular values of B_m estimate the extreme singular
    values of M⁻¹A — the engine behind PETSc's
    ``KSPComputeExtremeSingularValues`` / ``-ksp_compute_singularvalues``
    diagnostics (condition-number estimation of the preconditioned system).
    The transposes come from the framework's transpose stack
    (``banded_transpose`` matvecs, ``PC.transpose`` on stored factors).
    """
    psolve = pc_apply or _identity_pc
    psolve_t = pc_apply_transpose or _identity_pc
    mv_h = lambda v: jnp.conj(matvec_transpose(jnp.conj(v)))
    ps_h = lambda v: jnp.conj(psolve_t(jnp.conj(v)))
    bmv = lambda v: psolve(matvec(v))
    bmv_h = lambda v: mv_h(ps_h(v))
    dtype = v0.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    tiny = jnp.finfo(rdtype).tiny
    norm = partial(_norm, axis_name=axis_name)

    n0 = norm(v0)
    u = v0 / jnp.where(n0 != 0, n0, 1.0).astype(rdtype)
    v_un = bmv_h(u)
    alpha0 = norm(v_un)
    v = v_un / jnp.where(alpha0 != 0, alpha0, 1.0).astype(rdtype)
    alphas = jnp.zeros((m,), rdtype).at[0].set(alpha0)
    betas = jnp.zeros((m,), rdtype)   # betas[j] couples step j to j+1

    def body(j, c):
        alphas, betas, u, v, k, alive = c
        u_un = bmv(v) - alphas[j].astype(dtype) * u
        beta = norm(u_un)
        u = u_un / jnp.where(beta != 0, beta, 1.0).astype(rdtype)
        v_un = bmv_h(u) - beta.astype(dtype) * v
        alpha = norm(v_un)
        v = v_un / jnp.where(alpha != 0, alpha, 1.0).astype(rdtype)
        ok = (beta > 1e3 * tiny) & (alpha > 1e3 * tiny)
        betas = betas.at[j].set(jnp.where(alive, beta, 0))
        alphas = alphas.at[j + 1].set(jnp.where(alive & ok, alpha, 0))
        # k counts COMPLETED columns: a breakdown step (e.g. M^{-1}A = I
        # terminating immediately) must not append its zero column — that
        # would report smin = 0 / cond = inf for a perfectly conditioned
        # operator (code-review r3)
        k = k + jnp.where(alive & ok, 1, 0)
        return alphas, betas, u, v, k, alive & ok

    alphas, betas, _, _, k, _ = jax.lax.fori_loop(
        0, m - 1, body, (alphas, betas, u, v, jnp.int32(1),
                         alpha0 > 1e3 * tiny))
    return alphas, betas, k


def estimate_extreme_singular_values(matvec: Callable,
                                     matvec_transpose: Callable, n: int,
                                     dtype=jnp.float32, *, m: int = 30,
                                     pc_apply: Optional[Callable] = None,
                                     pc_apply_transpose: Optional[Callable]
                                     = None, seed: int = 0, v0=None):
    """Host-side extreme-singular-value estimation of M⁻¹A: ``m``
    Golub–Kahan steps on device, SVD of the tiny bidiagonal on host.
    Returns ``(smax, smin)`` — PETSc KSPComputeExtremeSingularValues's
    outputs (smax converges fast; smin is a Lanczos-style estimate that
    needs m near the spectrum's effective size to tighten)."""
    import numpy as np
    m = max(2, min(int(m), int(n)))
    if v0 is None:
        v0 = jnp.asarray(
            np.random.default_rng(seed).standard_normal(n), dtype)
    alphas, betas, k = jax.jit(lambda v: golub_kahan_bidiag(
        matvec, matvec_transpose, v, m, pc_apply, pc_apply_transpose))(v0)
    k = int(k)
    if k == 0:
        return 0.0, 0.0
    a = np.asarray(alphas)[:k]
    b = np.asarray(betas)[:k]
    B = np.zeros((k + 1, k))
    B[np.arange(k), np.arange(k)] = a
    B[np.arange(1, k + 1), np.arange(k)] = b
    s = np.linalg.svd(B, compute_uv=False)
    return float(s.max()), float(s.min())


#: PETSc's default -ksp_chebyshev_esteig transform: bounds from the Ritz
#: extremes as (a·λmin + b·λmax, c·λmin + d·λmax).  The 0.1 floor keeps the
#: smoother robust when the smallest eigenvalues are underestimated by a
#: short Arnoldi run; 1.1 adds headroom above the largest Ritz value.
ESTEIG_DEFAULT_TRANSFORM = (0.0, 0.1, 0.0, 1.1)


def chebyshev_esteig_bounds(eigs, transform=ESTEIG_DEFAULT_TRANSFORM):
    """Map Ritz values to chebyshev [emin, emax] via the 4-parameter PETSc
    transform (KSPChebyshevEstEigSet semantics)."""
    import numpy as np
    re = np.real(np.asarray(eigs))
    if re.size == 0:
        raise ValueError("no Ritz values: Arnoldi broke down at step 0 "
                         "(zero starting vector?)")
    lmin, lmax = float(re.min()), float(re.max())
    a, b, c, d = transform
    return a * lmin + b * lmax, c * lmin + d * lmax


# ---------------------------------------------------------------------------
# GMRES (restarted, modified Gram-Schmidt, Givens rotations)
# ---------------------------------------------------------------------------

def gmres(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
          pc_apply: Optional[Callable] = None, *, restart: int = 30,
          rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
          maxit: int = 10000, side: str = "left",
          monitor_true: bool = False, norm_type: str = "default",
          cgs_refinement: str = "always",
          axis_name: Optional[str] = None,
          conv_sync_axis: Optional[str] = None) -> KSPResult:
    """Restarted GMRES with left (default) or right preconditioning.

    Matches PETSc KSPGMRES defaults (restart 30, rtol 1e-5, classical Givens
    least-squares update, preconditioned residual monitoring for left pc) —
    the solver behind the reference's canned run recipe
    (/root/reference/src/makefile:18).

    ``monitor_true=True`` additionally records the UNPRECONDITIONED residual
    norm per iteration in ``result.true_history`` (PETSc
    ``-ksp_monitor_true_residual``, /root/reference/src/makefile:18) at the
    cost of one extra matvec (+pc apply for right pc) per iteration.

    ``cgs_refinement`` (PETSc KSPGMRESSetCGSRefinementType /
    ``-ksp_gmres_cgs_refinement_type``): the classical-Gram-Schmidt
    reorthogonalization policy — "always" (default; basis streamed twice
    per iteration), "never" (halves basis HBM traffic), "ifneeded" (DGKS
    cancellation test fused into the gram psum; refinement under lax.cond
    costs nothing when skipped).  See :func:`_orthogonalize`.
    """
    return _gmres_like(matvec, b, x0, pc_apply, restart=restart, rtol=rtol,
                       atol=atol, divtol=divtol, maxit=maxit,
                       flexible=False, right=(side == "right"),
                       monitor_true=monitor_true, norm_type=norm_type,
                       cgs_refinement=cgs_refinement,
                       axis_name=axis_name, conv_sync_axis=conv_sync_axis)


def fgmres(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
           pc_apply: Optional[Callable] = None, *, restart: int = 30,
           rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
           maxit: int = 10000, monitor_true: bool = False,
           norm_type: str = "default", cgs_refinement: str = "always",
           axis_name: Optional[str] = None,
           conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Flexible GMRES (right-preconditioned, stores the preconditioned basis;
    tolerates nonlinear/iterative preconditioners such as inner Krylov
    solves — the analogue of nesting KSPs under PETSc prefixes).

    ``norm_type``: validated for consistency — right preconditioning
    already monitors the true residual, so "unpreconditioned" is a no-op
    and "preconditioned" is an error (as in PETSc)."""
    return _gmres_like(matvec, b, x0, pc_apply, restart=restart, rtol=rtol,
                       atol=atol, divtol=divtol, maxit=maxit,
                       flexible=True, right=True,
                       monitor_true=monitor_true, norm_type=norm_type,
                       cgs_refinement=cgs_refinement,
                       axis_name=axis_name, conv_sync_axis=conv_sync_axis)


def _gmres_like(matvec, b, x0, pc_apply, *, restart, rtol, atol, divtol,
                maxit, flexible, right, monitor_true=False,
                norm_type="default", cgs_refinement="always",
                axis_name=None, conv_sync_axis=None):
    psolve = pc_apply or _identity_pc
    n = b.shape[0]
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype   # residual norms are real
    x0 = jnp.zeros_like(b) if x0 is None else x0

    dot = partial(_dot, axis_name=axis_name)
    norm = partial(_norm, axis_name=axis_name)

    # Convergence norm (PETSc KSPSetNormType): the default tests the
    # preconditioned residual for left pc (KSP_NORM_PRECONDITIONED) and the
    # true residual for right pc; norm_type="unpreconditioned" forces the
    # TRUE residual test under left pc too (one extra matvec per iteration
    # to build it — exactly PETSc's cost for KSP_NORM_UNPRECONDITIONED).
    if norm_type not in ("default", "preconditioned", "unpreconditioned"):
        raise ValueError(f"unknown norm_type {norm_type!r}")
    if norm_type == "preconditioned" and right:
        # right preconditioning monitors the true residual by construction
        # (PETSc errors on this combination too)
        raise ValueError("norm_type='preconditioned' is incompatible with "
                         "right preconditioning (fgmres / side='right')")
    unprec = norm_type == "unpreconditioned" and not right
    track_true = monitor_true or unprec
    bnorm = norm(b) if (right or unprec) else norm(psolve(b))
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    hist0 = jnp.full((maxit + 1,), jnp.nan, rdtype)
    thist0 = jnp.full((maxit + 1,), jnp.nan, rdtype) if track_true else None

    def residual(x):
        r = b - matvec(x)
        return r if right else psolve(r)

    def _lsq_update(H, g, j_end):
        """Solve the rotated-Hessenberg least-squares for the current basis
        size (masked to identity beyond j_end) -> coefficient vector y."""
        idx = jnp.arange(restart)
        used = idx < j_end
        Hm = jnp.where(used[:, None] & used[None, :], H[:restart, :],
                       jnp.eye(restart, dtype=dtype))
        gm = jnp.where(used, g[:restart], 0.0)
        y = jax.scipy.linalg.solve_triangular(Hm, gm, lower=False)
        return jnp.where(used, y, 0.0)

    def cycle(state):
        # the (preconditioned) residual rides the carry: computed once
        # before the loop and refreshed only when another cycle actually
        # follows — a converged 1-cycle solve does exactly its+1 matvecs
        # instead of its+3
        x, r, its, rnorm, reason, hist, thist = state
        beta = norm(r)
        safe_beta = jnp.where(beta > 0, beta, 1.0)

        V = jnp.zeros((restart + 1, n), dtype).at[0].set(r / safe_beta)
        Z = jnp.zeros((restart, n), dtype) if flexible else None
        H = jnp.zeros((restart + 1, restart), dtype)
        g = jnp.zeros((restart + 1,), dtype).at[0].set(beta)
        cs = jnp.ones((restart,), dtype)
        sn = jnp.zeros((restart,), dtype)

        def inner_cond(c):
            _, _, _, _, _, _, j, its_i, _, reason_i, _, _ = c
            return (j < restart) & _keep_iterating(reason_i, conv_sync_axis)

        def inner_body(c):
            V, Z, H, g, cs, sn, j, its_i, rn, reason_i, hist_i, thist_i = c
            vj = V[j]
            if flexible:
                z = psolve(vj)
                Z = Z.at[j].set(z)
                w = matvec(z)
            elif right:
                w = matvec(psolve(vj))
            else:
                w = psolve(matvec(vj))

            # classical Gram-Schmidt against V[0..j] (vectorized, masked)
            # with the configured refinement policy
            mask = (jnp.arange(restart + 1) <= j).astype(dtype)
            w, h, hj1 = _orthogonalize(V, w, mask, cgs_refinement,
                                       axis_name, conv_sync_axis)
            V = V.at[j + 1].set(w / jnp.where(hj1 > 0, hj1, 1.0))
            col = h.at[j + 1].set(hj1)

            # apply accumulated unitary Givens rotations to the new column:
            # G_i = [[c_i, s_i], [-conj(s_i), conj(c_i)]] (real case reduces
            # to the classical rotations)
            def rot(i, colc):
                t1 = cs[i] * colc[i] + sn[i] * colc[i + 1]
                t2 = -jnp.conj(sn[i]) * colc[i] + jnp.conj(cs[i]) * colc[i + 1]
                apply = i < j
                colc = colc.at[i].set(jnp.where(apply, t1, colc[i]))
                colc = colc.at[i + 1].set(jnp.where(apply, t2, colc[i + 1]))
                return colc
            col = jax.lax.fori_loop(0, restart, rot, col)

            # new rotation eliminating col[j+1]:
            # c = conj(a)/r, s = conj(b)/r with r = sqrt(|a|^2 + |b|^2)
            denom = jnp.sqrt(jnp.abs(col[j]) ** 2 + jnp.abs(col[j + 1]) ** 2)
            ok = denom > 0
            safe = jnp.where(ok, denom, 1.0)
            c_new = jnp.where(ok, jnp.conj(col[j]) / safe,
                              jnp.ones((), dtype))
            s_new = jnp.where(ok, jnp.conj(col[j + 1]) / safe,
                              jnp.zeros((), dtype))
            col = col.at[j].set(denom.astype(dtype)).at[j + 1].set(0.0)
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(-jnp.conj(s_new) * gj)
            H = H.at[:, j].set(col)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)

            rn = jnp.abs(g[j + 1])
            its_i = its_i + 1
            if track_true:
                # build the current solution estimate and its true residual
                # (what PETSc's -ksp_monitor_true_residual reports, and the
                # norm KSP_NORM_UNPRECONDITIONED converges on); one extra
                # matvec per iteration, opt-in
                y = _lsq_update(H, g, j + 1)
                if flexible:
                    dx = _mm(y, Z)
                else:
                    dx = _mm(y, V[:restart])
                    if right:
                        dx = psolve(dx)
                true_rn = norm(b - matvec(x + dx))
                thist_i = thist_i.at[its_i].set(true_rn)
                if unprec:
                    rn = true_rn.astype(rn.dtype)
            hist_i = hist_i.at[its_i].set(rn)
            reason_i = check(rn, bnorm, its_i)
            return (V, Z, H, g, cs, sn, j + 1, its_i, rn, reason_i, hist_i,
                    thist_i)

        init = (V, Z, H, g, cs, sn, jnp.int32(0), its, rnorm, reason, hist,
                thist)
        V, Z, H, g, cs, sn, j_end, its, rnorm, reason, hist, thist = \
            jax.lax.while_loop(inner_cond, inner_body, init)

        # least-squares solve on the rotated Hessenberg: H is upper
        # triangular in its leading j_end columns; mask the rest to identity
        y = _lsq_update(H, g, j_end)
        if flexible:
            dx = _mm(y, Z)
        else:
            dx = _mm(y, V[:restart])
            if right:
                dx = psolve(dx)
        x = x + dx
        # residual for the NEXT cycle; skipped (branch not executed)
        # when this cycle ended the solve — the SYNCED predicate, so a
        # replica forced into extra cycles refreshes r and keeps refining
        r = jax.lax.cond(_keep_iterating(reason, conv_sync_axis),
                         lambda op: residual(op[0]), lambda op: op[1],
                         (x, r))
        return (x, r, its, rnorm, reason, hist, thist)

    def outer_cond(state):
        return _keep_iterating(state[4], conv_sync_axis)

    r0 = residual(x0)
    rnorm0 = _norm(r0, axis_name)
    if track_true:
        true0 = norm(b - matvec(x0))
        thist0 = thist0.at[0].set(true0)
        if unprec:
            rnorm0 = true0
    hist0 = hist0.at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))
    state = (x0, r0, jnp.int32(0), rnorm0, reason0, hist0, thist0)
    x, _, its, rnorm, reason, hist, thist = jax.lax.while_loop(
        outer_cond, cycle, state)
    return KSPResult(x=x, its=its, reason=reason, rnorm=rnorm, history=hist,
                     true_history=thist)


def lgmres(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
           pc_apply: Optional[Callable] = None, *, restart: int = 30,
           aug: int = 2, rtol: float = 1e-5, atol: float = 1e-50,
           divtol: float = 1e4, maxit: int = 10000,
           cgs_refinement: str = "always",
           axis_name: Optional[str] = None,
           conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """LGMRES (Baker–Jessup–Manteuffel "loose" GMRES; PETSc KSPLGMRES).

    Restarted GMRES whose restart cycles alternate between sawtooth
    convergence phases: plain GMRES(m) discards the whole Krylov space at
    each restart and tends to re-generate the same directions.  LGMRES
    appends the ``aug`` most recent APPROXIMATE ERROR vectors z_i = dx of
    previous cycles to the search space — the cycle approximation space is
    K_{m-aug}(M⁻¹A, r) + span{z_1..z_aug} — which breaks the alternating
    pattern and typically converges in fewer total matvecs on problems
    where GMRES(m) stagnates.  Total directions per cycle stay ``restart``
    (PETSc counts the augmentation against the restart size too), so
    memory and per-cycle cost match gmres(restart) plus one extra stored
    basis ([restart, n] for the operator inputs, as fgmres).

    Left-preconditioned; the first cycle (no history yet) is plain
    GMRES(restart).  ``aug=0`` reduces exactly to gmres.
    """
    psolve = pc_apply or _identity_pc
    n = b.shape[0]
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    x0 = jnp.zeros_like(b) if x0 is None else x0
    aug = max(0, min(int(aug), restart - 1))

    norm = partial(_norm, axis_name=axis_name)
    bnorm = norm(psolve(b))
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)
    hist0 = jnp.full((maxit + 1,), jnp.nan, rdtype)

    def residual(x):
        return psolve(b - matvec(x))

    def _lsq_update(H, g, j_end):
        idx = jnp.arange(restart)
        used = idx < j_end
        Hm = jnp.where(used[:, None] & used[None, :], H[:restart, :],
                       jnp.eye(restart, dtype=dtype))
        gm = jnp.where(used, g[:restart], 0.0)
        y = jax.scipy.linalg.solve_triangular(Hm, gm, lower=False)
        return jnp.where(used, y, 0.0)

    def cycle(state):
        x, r, AUG, naug, its, rnorm, reason, hist = state
        beta = norm(r)
        safe_beta = jnp.where(beta > 0, beta, 1.0)
        mk = restart - naug          # Krylov directions this cycle

        V = jnp.zeros((restart + 1, n), dtype).at[0].set(r / safe_beta)
        Z = jnp.zeros((restart, n), dtype)   # operator inputs (as fgmres)
        H = jnp.zeros((restart + 1, restart), dtype)
        g = jnp.zeros((restart + 1,), dtype).at[0].set(beta)
        cs = jnp.ones((restart,), dtype)
        sn = jnp.zeros((restart,), dtype)

        def inner_cond(c):
            _, _, _, _, _, _, j, its_i, _, reason_i, _ = c
            return (j < restart) & _keep_iterating(reason_i, conv_sync_axis)

        def inner_body(c):
            V, Z, H, g, cs, sn, j, its_i, rn, reason_i, hist_i = c
            # direction source: Krylov basis vector for j < mk, stored
            # error-approximation vector beyond (the augmentation slots)
            zaug = AUG[jnp.clip(j - mk, 0, max(aug, 1) - 1)] if aug else V[j]
            z_in = jnp.where(j < mk, V[j], zaug)
            Z = Z.at[j].set(z_in)
            w = psolve(matvec(z_in))

            mask = (jnp.arange(restart + 1) <= j).astype(dtype)
            w, h, hj1 = _orthogonalize(V, w, mask, cgs_refinement,
                                       axis_name, conv_sync_axis)
            V = V.at[j + 1].set(w / jnp.where(hj1 > 0, hj1, 1.0))
            col = h.at[j + 1].set(hj1)

            def rot(i, colc):
                t1 = cs[i] * colc[i] + sn[i] * colc[i + 1]
                t2 = (-jnp.conj(sn[i]) * colc[i]
                      + jnp.conj(cs[i]) * colc[i + 1])
                apply = i < j
                colc = colc.at[i].set(jnp.where(apply, t1, colc[i]))
                colc = colc.at[i + 1].set(jnp.where(apply, t2, colc[i + 1]))
                return colc
            col = jax.lax.fori_loop(0, restart, rot, col)

            denom = jnp.sqrt(jnp.abs(col[j]) ** 2 + jnp.abs(col[j + 1]) ** 2)
            ok = denom > 0
            safe = jnp.where(ok, denom, 1.0)
            c_new = jnp.where(ok, jnp.conj(col[j]) / safe,
                              jnp.ones((), dtype))
            s_new = jnp.where(ok, jnp.conj(col[j + 1]) / safe,
                              jnp.zeros((), dtype))
            col = col.at[j].set(denom.astype(dtype)).at[j + 1].set(0.0)
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(-jnp.conj(s_new) * gj)
            H = H.at[:, j].set(col)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)

            rn = jnp.abs(g[j + 1])
            its_i = its_i + 1
            hist_i = hist_i.at[its_i].set(rn)
            reason_i = check(rn, bnorm, its_i)
            return (V, Z, H, g, cs, sn, j + 1, its_i, rn, reason_i, hist_i)

        init = (V, Z, H, g, cs, sn, jnp.int32(0), its, rnorm, reason, hist)
        V, Z, H, g, cs, sn, j_end, its, rnorm, reason, hist = \
            jax.lax.while_loop(inner_cond, inner_body, init)

        y = _lsq_update(H, g, j_end)
        dx = _mm(y, Z)
        x = x + dx
        if aug:
            # push this cycle's error approximation (normalized) into the
            # augmentation window, oldest out
            dxn = norm(dx)
            z_new = dx / jnp.where(dxn > 0, dxn, 1.0).astype(rdtype)
            AUG = jnp.where(dxn > 0,
                            jnp.concatenate([z_new[None], AUG[:-1]], axis=0),
                            AUG)
            naug = jnp.minimum(naug + jnp.where(dxn > 0, 1, 0), aug)
        r = jax.lax.cond(_keep_iterating(reason, conv_sync_axis),
                         lambda op: residual(op[0]), lambda op: op[1],
                         (x, r))
        return (x, r, AUG, naug, its, rnorm, reason, hist)

    def outer_cond(state):
        return _keep_iterating(state[6], conv_sync_axis)

    r0 = residual(x0)
    rnorm0 = norm(r0)
    hist0 = hist0.at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))
    AUG0 = jnp.zeros((max(aug, 1), n), dtype)
    state = (x0, r0, AUG0, jnp.int32(0), jnp.int32(0), rnorm0, reason0,
             hist0)
    x, _, _, _, its, rnorm, reason, hist = jax.lax.while_loop(
        outer_cond, cycle, state)
    return KSPResult(x=x, its=its, reason=reason, rnorm=rnorm, history=hist)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------

def bicgstab(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
             pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
             atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
             axis_name: Optional[str] = None,
             conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Preconditioned BiCGStab (van der Vorst), PETSc KSPBCGS equivalent —
    the solver BASELINE config 3 pairs with the MC64 pre-pass.  The monitored
    residual is already the true (unpreconditioned) residual.

    The preconditioner is applied FRESH to p and s each iteration and the
    solution is updated with the preconditioned vectors (phat/shat), i.e.
    this is the formulation PETSc ships as KSPFBCGS — it tolerates a
    preconditioner that varies between iterations (registered under both
    "bcgs" and "fbcgs")."""
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None      # r0 = b exactly; skip matvec(0)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    dot = partial(_dot, axis_name=axis_name)
    norm = partial(_norm, axis_name=axis_name)
    bnorm = norm(b)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    rdtype = jnp.zeros((), dtype).real.dtype
    r0 = b if x0_zero else b - matvec(x0)
    rtilde = r0
    rnorm0 = norm(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        rho_new = dot(rtilde, s["r"])
        breakdown = jnp.abs(rho_new) < jnp.finfo(dtype).tiny
        beta = (rho_new / s["rho"]) * (s["alpha"] / s["omega"])
        p = s["r"] + beta * (s["p"] - s["omega"] * s["v"])
        phat = psolve(p)
        v = matvec(phat)
        denom = dot(rtilde, v)
        alpha = rho_new / jnp.where(denom != 0, denom, 1.0)
        sr = s["r"] - alpha * v
        shat = psolve(sr)
        t = matvec(shat)
        # <t,t> and <t,sr> ride one fused psum (exact same scalars)
        tt, ts = _dots(((t, t), (t, sr)), axis_name)
        omega = ts / jnp.where(tt != 0, tt, 1.0)
        x = s["x"] + alpha * phat + omega * shat
        r = sr - omega * t
        rn = norm(r)
        its = s["its"] + 1
        hist = s["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        reason = jnp.where(breakdown & (reason == CONVERGED_ITERATING),
                           DIVERGED_BREAKDOWN, reason)
        return dict(x=x, r=r, p=p, v=v, rho=rho_new, alpha=alpha, omega=omega,
                    its=its, reason=reason, hist=hist)

    init = dict(x=x0, r=r0, p=jnp.zeros_like(b), v=jnp.zeros_like(b),
                rho=jnp.ones((), dtype), alpha=jnp.ones((), dtype),
                omega=jnp.ones((), dtype), its=jnp.int32(0), reason=reason0,
                hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis), init)
    rn = norm(b - matvec(out["x"]))
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=rn, history=out["hist"])


def bcgsl(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
          pc_apply: Optional[Callable] = None, *, ell: int = 2,
          rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
          maxit: int = 10000, axis_name: Optional[str] = None,
          conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """BiCGStab(ell) (Sleijpen–Fokkema 1993; PETSc KSPBCGSL, default ell=2).

    Generalizes BiCGStab's degree-1 minimal-residual polynomial to degree
    ``ell``: each cycle runs ell BiCG steps followed by an ell-dimensional
    residual minimization, which restores convergence on operators with
    large IMAGINARY spectral parts where plain bicgstab's real 1-step MR
    polynomial stagnates (the classic failure on convection-dominated /
    strongly nonsymmetric systems).  Cost per cycle: 2*ell matvecs+PCapplies
    (same per-matvec budget as bicgstab) plus an ell x ell Gram solve of
    axpys.

    Preconditioning is right-folded (B = A M^{-1}, x = x0 + M^{-1} y) so
    the monitored history is the TRUE residual, recorded once per cycle at
    index ``its`` (its advances by ell per cycle, PETSc's counting).
    ``ell`` is a static unroll parameter — keep it small (2..4).
    """
    if ell < 1:
        raise ValueError(f"bcgsl requires ell >= 1, got {ell}")
    L = int(ell)
    psolve = pc_apply or _identity_pc
    bmv = lambda v: matvec(psolve(v))
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    tiny = jnp.finfo(rdtype).tiny
    norm = partial(_norm, axis_name=axis_name)
    dot = partial(_dot, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    bnorm = norm(b)
    r0 = b if x0 is None else b - matvec(x0)
    rt = r0
    rnorm0 = norm(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        # R[i]/U[i] rows are the hat-vectors r̂_i / û_i; y accumulates the
        # solution of the folded system B y = r0.  Every sub-step is GATED
        # by ``live``: with a strong preconditioner the residual can hit
        # the tolerance in the middle of a cycle (exact PC: after the very
        # first BiCG step), after which rho/gamma are rounding noise and
        # the remaining steps would amplify it — the gate freezes the
        # converged state instead (the in-cycle analogue of PETSc's per-
        # iteration convergence test in KSPBCGSL).
        R, U, y = s["R"], s["U"], s["y"]
        rho0 = -s["omega"] * s["rho0"]
        alpha = s["alpha"]
        its = s["its"]
        reason = s["reason"]
        live = reason == CONVERGED_ITERATING

        def sel(new, old):
            return jnp.where(live, new, old)

        # ---- BiCG part: ell shadow steps, each gated ---------------------
        for j in range(L):
            rho1 = dot(rt, R[j])
            brk = jnp.abs(rho0) < tiny
            beta = alpha * rho1 / jnp.where(rho0 != 0, rho0, 1.0)
            Un = U
            for i in range(j + 1):
                Un = Un.at[i].set(R[i] - beta * Un[i])
            Un = Un.at[j + 1].set(bmv(Un[j]))
            gamma = dot(rt, Un[j + 1])
            brk |= jnp.abs(gamma) < tiny
            alpha_n = rho1 / jnp.where(gamma != 0, gamma, 1.0)
            Rn = R
            for i in range(j + 1):
                Rn = Rn.at[i].set(Rn[i] - alpha_n * Un[i + 1])
            Rn = Rn.at[j + 1].set(bmv(Rn[j]))
            yn = y + alpha_n * Un[0]
            rn_j = norm(Rn[0])
            reason_j = check(rn_j, bnorm, its + 1)
            reason_j = jnp.where(brk & (reason_j == CONVERGED_ITERATING),
                                 DIVERGED_BREAKDOWN, reason_j)
            U, R, y = sel(Un, U), sel(Rn, R), sel(yn, y)
            alpha = sel(alpha_n, alpha)
            rho0 = sel(rho1, rho0)
            its = jnp.where(live, its + 1, its)
            reason = jnp.where(live, reason_j, reason)
            live = live & (reason_j == CONVERGED_ITERATING)

        # ---- MR part: minimize ||r̂_0 - sum gamma_j r̂_j|| by modified
        # Gram-Schmidt on r̂_1..r̂_ell (all scalars; ell is tiny) ----------
        brk = jnp.zeros((), bool)
        Rm = R
        tau = [[None] * (L + 1) for _ in range(L + 1)]
        sigma = [None] * (L + 1)
        gp = [None] * (L + 1)       # gamma'
        for j in range(1, L + 1):
            for i in range(1, j):
                tij = dot(Rm[i], Rm[j]) / jnp.where(sigma[i] != 0, sigma[i],
                                                    1.0)
                tau[i][j] = tij
                Rm = Rm.at[j].set(Rm[j] - tij * Rm[i])
            sigma[j] = dot(Rm[j], Rm[j])
            brk |= jnp.abs(sigma[j]) < tiny
            gp[j] = dot(Rm[j], Rm[0]) / jnp.where(sigma[j] != 0, sigma[j],
                                                  1.0)
        g = [None] * (L + 1)
        g[L] = gp[L]
        omega_n = g[L]
        for j in range(L - 1, 0, -1):
            g[j] = gp[j] - sum((tau[j][i] * g[i] for i in range(j + 1,
                                                                L + 1)),
                               jnp.zeros((), dtype))
        gpp = [None] * L
        for j in range(1, L):
            gpp[j] = g[j + 1] + sum(
                (tau[j][i] * g[i + 1] for i in range(j + 1, L)),
                jnp.zeros((), dtype))

        # ---- polynomial update (gated like the BiCG steps) ---------------
        yn = y + g[1] * Rm[0]
        Rn = Rm.at[0].set(Rm[0] - gp[L] * Rm[L])
        Un = U.at[0].set(U[0] - g[L] * U[L])
        for j in range(1, L):
            Un = Un.at[0].set(Un[0] - g[j] * Un[j])
            yn = yn + gpp[j] * Rn[j]
            Rn = Rn.at[0].set(Rn[0] - gp[j] * Rn[j])
        rn_mr = norm(Rn[0])
        reason_mr = check(rn_mr, bnorm, its)
        reason_mr = jnp.where(brk & (reason_mr == CONVERGED_ITERATING),
                              DIVERGED_BREAKDOWN, reason_mr)
        U, R, y = sel(Un, U), sel(Rn, Rm), sel(yn, y)
        omega = sel(omega_n, s["omega"])
        reason = jnp.where(live, reason_mr, reason)

        rn = norm(R[0])
        hist = s["hist"].at[jnp.minimum(its, maxit)].set(rn)
        return dict(R=R, U=U, y=y, rho0=rho0, alpha=alpha, omega=omega,
                    its=its, reason=reason, hist=hist)

    zeros = jnp.zeros((L + 1,) + b.shape, dtype)
    init = dict(R=zeros.at[0].set(r0), U=zeros, y=jnp.zeros_like(b),
                rho0=jnp.ones((), dtype), alpha=jnp.zeros((), dtype),
                omega=jnp.ones((), dtype), its=jnp.int32(0),
                reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)
    x = psolve(out["y"]) if x0 is None else x0 + psolve(out["y"])
    return KSPResult(x=x, its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(x)), history=out["hist"])


def bicg(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
         pc_apply: Optional[Callable] = None, *,
         matvec_transpose: Optional[Callable] = None,
         pc_apply_transpose: Optional[Callable] = None,
         rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
         maxit: int = 10000, axis_name: Optional[str] = None,
         conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Preconditioned BiConjugate Gradients (PETSc KSPBICG equivalent).

    Runs the shadow recurrence on A^H / M^{-H} — the transpose operators
    the framework now provides for free (``banded_transpose`` matvecs,
    ``spike_transpose``/``PC.transpose`` preconditioner applies on stored
    factors), composed through ``ksp.make_solver`` for `-ksp_type bicg`.
    ``matvec_transpose``/``pc_apply_transpose`` take the PURE transpose;
    the Hermitian forms are derived by conjugation wrapping (free for real
    scalars).  The monitored residual is the true residual.
    """
    if matvec_transpose is None:
        raise ValueError("bicg requires matvec_transpose (an explicit "
                         "operator through ksp.solve provides it; bare "
                         "callables cannot be transposed)")
    psolve = pc_apply or _identity_pc
    psolve_t = pc_apply_transpose or _identity_pc
    mv_h = lambda v: jnp.conj(matvec_transpose(jnp.conj(v)))
    ps_h = lambda v: jnp.conj(psolve_t(jnp.conj(v)))
    x0_zero = x0 is None      # r0 = b exactly; skip matvec(0)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    dot = partial(_dot, axis_name=axis_name)
    norm = partial(_norm, axis_name=axis_name)
    bnorm = norm(b)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    rdtype = jnp.zeros((), dtype).real.dtype
    r0 = b if x0_zero else b - matvec(x0)
    rt0 = r0
    z0 = psolve(r0)
    zt0 = ps_h(rt0)
    rho0 = dot(rt0, z0)
    rnorm0 = norm(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        q = matvec(s["p"])
        qt = mv_h(s["pt"])
        denom = dot(s["pt"], q)
        breakdown = jnp.abs(denom) < jnp.finfo(rdtype).tiny
        alpha = s["rho"] / jnp.where(denom != 0, denom, 1.0)
        x = s["x"] + alpha * s["p"]
        r = s["r"] - alpha * q
        rt = s["rt"] - jnp.conj(alpha) * qt
        z = psolve(r)
        zt = ps_h(rt)
        # <rt,z> and ||r||^2 share one fused psum (exact same scalars)
        rho_new, rr = _dots(((rt, z), (r, r)), axis_name)
        breakdown |= jnp.abs(rho_new) < jnp.finfo(rdtype).tiny
        beta = rho_new / jnp.where(s["rho"] != 0, s["rho"], 1.0)
        p = z + beta * s["p"]
        pt = zt + jnp.conj(beta) * s["pt"]
        rn = jnp.sqrt(jnp.real(rr))
        its = s["its"] + 1
        hist = s["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        reason = jnp.where(breakdown & (reason == CONVERGED_ITERATING),
                           DIVERGED_BREAKDOWN, reason)
        return dict(x=x, r=r, rt=rt, p=p, pt=pt, rho=rho_new, its=its,
                    reason=reason, hist=hist)

    init = dict(x=x0, r=r0, rt=rt0, p=z0, pt=zt0, rho=rho0,
                its=jnp.int32(0), reason=reason0, hist=hist)
    init["reason"] = jnp.where(
        (jnp.abs(rho0) < jnp.finfo(rdtype).tiny)
        & (reason0 == CONVERGED_ITERATING), DIVERGED_BREAKDOWN, reason0)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis), init)
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(out["x"])), history=out["hist"])


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------

def cg(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
       pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
       atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
       axis_name: Optional[str] = None,
       conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Preconditioned conjugate gradients (SPD operators/preconditioners)."""
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None      # r0 = b exactly; skip matvec(0)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    dot = partial(_dot, axis_name=axis_name)
    norm = partial(_norm, axis_name=axis_name)
    bnorm = norm(b)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    rdtype = jnp.zeros((), dtype).real.dtype
    r0 = b if x0_zero else b - matvec(x0)
    z0 = psolve(r0)
    rnorm0 = norm(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        w = matvec(s["p"])
        pw = dot(s["p"], w)
        alpha = s["rz"] / jnp.where(pw != 0, pw, 1.0)
        x = s["x"] + alpha * s["p"]
        r = s["r"] - alpha * w
        z = psolve(r)
        # <r,z> and ||r||^2 ride one fused psum (identical values, one
        # fewer collective round trip per iteration on a mesh)
        rz_new, rr = _dots(((r, z), (r, r)), axis_name)
        beta = rz_new / jnp.where(s["rz"] != 0, s["rz"], 1.0)
        p = z + beta * s["p"]
        rn = jnp.sqrt(jnp.real(rr))
        its = s["its"] + 1
        hist = s["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        return dict(x=x, r=r, p=p, rz=rz_new, its=its, reason=reason,
                    hist=hist)

    init = dict(x=x0, r=r0, p=z0, rz=dot(r0, z0), its=jnp.int32(0),
                reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis), init)
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(out["x"])), history=out["hist"])


def pipecg(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
           pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
           atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
           axis_name: Optional[str] = None,
           conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Pipelined conjugate gradients (Ghysels & Vanroose; PETSc KSPPIPECG).

    Mathematically equivalent to ``cg`` in exact arithmetic, restructured for
    mesh latency: every iteration issues exactly ONE fused reduction
    (<r,u>, <w,u>, <r,r> stacked into a single psum) and the reduction has no
    data dependency on that iteration's preconditioner apply ``m = M⁻¹w`` or
    matvec ``n = A·m`` — XLA's scheduler can overlap the collective with
    the local compute, the pipelining that PETSc implements with
    MPI_Iallreduce.  Plain ``cg`` costs 2 sequential psums per iteration plus
    a matvec and PC apply on the critical path.

    The extra recurrences (s = A·p, q = M⁻¹·A·p, z = A·M⁻¹·A·p carried
    alongside p) trade 4 more axpys and ~2× vector state for the latency win;
    rounding drift vs textbook CG is well-studied and small for the
    well-conditioned preconditioned systems the SPIKE PC produces.  Use for
    SPD operators/preconditioners on meshes where psum latency, not
    bandwidth, dominates the iteration.
    """
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None      # r0 = b exactly; skip matvec(0)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    norm = partial(_norm, axis_name=axis_name)
    bnorm = norm(b)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    rdtype = jnp.zeros((), dtype).real.dtype
    r0 = b if x0_zero else b - matvec(x0)
    u0 = psolve(r0)
    w0 = matvec(u0)
    gamma0, delta0, rr0 = _dots(((r0, u0), (w0, u0), (r0, r0)), axis_name)
    rnorm0 = jnp.sqrt(jnp.real(rr0))
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))
    # next iteration's m/n are computed ahead of their consuming iteration —
    # the pipeline stage that hides the reduction latency
    m0 = psolve(w0)
    n0 = matvec(m0)

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        first = s["its"] == 0
        gamma, delta = s["gamma"], s["delta"]
        beta = jnp.where(first, 0.0, gamma / jnp.where(s["gamma_p"] != 0,
                                                       s["gamma_p"], 1.0))
        denom = jnp.where(
            first, delta,
            delta - beta * gamma / jnp.where(s["alpha_p"] != 0,
                                             s["alpha_p"], 1.0))
        breakdown = jnp.abs(denom) < jnp.finfo(rdtype).tiny
        alpha = gamma / jnp.where(denom != 0, denom, 1.0)
        z = s["n"] + beta * s["z"]
        q = s["m"] + beta * s["q"]
        sv = s["w"] + beta * s["s"]
        p = s["u"] + beta * s["p"]
        x = s["x"] + alpha * p
        r = s["r"] - alpha * sv
        u = s["u"] - alpha * q
        w = s["w"] - alpha * z
        # the fused reduction (one psum) and the next pipeline stage's
        # m = M⁻¹w, n = A m are mutually independent -> overlappable
        gamma_n, delta_n, rr = _dots(((r, u), (w, u), (r, r)), axis_name)
        m = psolve(w)
        n = matvec(m)
        rn = jnp.sqrt(jnp.real(rr))
        its = s["its"] + 1
        hist = s["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        reason = jnp.where(breakdown & (reason == CONVERGED_ITERATING),
                           DIVERGED_BREAKDOWN, reason)
        return dict(x=x, r=r, u=u, w=w, m=m, n=n, z=z, q=q, s=sv, p=p,
                    gamma=gamma_n, delta=delta_n, gamma_p=gamma,
                    alpha_p=alpha, its=its, reason=reason, hist=hist)

    zeros = jnp.zeros_like(b)
    init = dict(x=x0, r=r0, u=u0, w=w0, m=m0, n=n0, z=zeros, q=zeros,
                s=zeros, p=zeros, gamma=gamma0, delta=delta0,
                gamma_p=jnp.ones((), dtype), alpha_p=jnp.ones((), dtype),
                its=jnp.int32(0), reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(out["x"])), history=out["hist"])


def minres(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
           pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
           atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
           axis_name: Optional[str] = None,
           conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Preconditioned MINRES (Paige–Saunders; PETSc KSPMINRES) for SYMMETRIC
    (possibly indefinite) operators with an SPD preconditioner — the gap CG
    leaves for saddle-point / shifted systems (e.g. the fieldsplit Schur
    blocks, or interior shifts where the SPIKE band loses definiteness).

    Lanczos three-term recurrence + on-the-fly Givens QR of the tridiagonal;
    one matvec, one PC apply and two (sequentially dependent) reductions
    <v,Av> and β² = <r₂, M⁻¹r₂> per iteration.  The monitored norm is the
    preconditioned residual ‖r‖_{M⁻¹} (phibar recurrence), matching the
    left-preconditioned convergence convention of the other KSPs here;
    ``rnorm`` in the result is the true unpreconditioned final residual.
    Breakdown (β² ≤ 0, i.e. an indefinite preconditioner) reports
    DIVERGED_BREAKDOWN rather than silently producing NaNs.
    """
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None      # r0 = b exactly; skip matvec(0)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    norm = partial(_norm, axis_name=axis_name)
    dot = partial(_dot, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    r1 = b if x0_zero else b - matvec(x0)
    y0 = psolve(r1)
    beta1_sq = jnp.real(dot(r1, y0))
    pc_indef0 = beta1_sq < 0
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0))
    # convergence is tested on ‖r‖_{M⁻¹}; ‖b‖_{M⁻¹} is the matching scale
    yb = psolve(b)
    bnorm = jnp.sqrt(jnp.maximum(jnp.real(dot(b, yb)), 0))
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(beta1)
    reason0 = jnp.where(pc_indef0, DIVERGED_BREAKDOWN,
                        check(beta1, bnorm, jnp.int32(0)))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        beta, oldb = s["beta"], s["oldb"]
        ibeta = 1.0 / jnp.where(beta != 0, beta, 1.0)
        v = s["y"] * ibeta.astype(rdtype)
        y = matvec(v)
        y = jnp.where(s["its"] >= 1,
                      y - (beta / jnp.where(oldb != 0, oldb, 1.0)) * s["r1"],
                      y)
        alfa = jnp.real(dot(v, y))
        y = y - (alfa * ibeta) * s["r2"]
        r1n, r2n = s["r2"], y
        yn = psolve(r2n)
        beta_sq = jnp.real(dot(r2n, yn))
        pc_indef = beta_sq < 0
        beta_n = jnp.sqrt(jnp.maximum(beta_sq, 0))
        # Givens QR of the Lanczos tridiagonal, one column per iteration
        oldeps = s["epsln"]
        delta = s["cs"] * s["dbar"] + s["sn"] * alfa
        gbar = s["sn"] * s["dbar"] - s["cs"] * alfa
        epsln = s["sn"] * beta_n
        dbar = -s["cs"] * beta_n
        gamma = jnp.sqrt(gbar * gbar + beta_n * beta_n)
        lanczos_break = gamma < jnp.finfo(rdtype).tiny
        gamma = jnp.where(lanczos_break, 1.0, gamma)
        cs = gbar / gamma
        sn = beta_n / gamma
        phi = cs * s["phibar"]
        phibar = sn * s["phibar"]
        w1, w2 = s["w2"], s["w"]
        w = (v - oldeps.astype(dtype) * w1 - delta.astype(dtype) * w2) \
            / gamma.astype(rdtype)
        x = s["x"] + phi.astype(dtype) * w
        rn = phibar
        its = s["its"] + 1
        hist = s["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        # breakdown wins over the convergence check: β² < 0 zeroes sn and
        # collapses phibar to 0, which would otherwise read as CONVERGED_ATOL
        reason = jnp.where(pc_indef | lanczos_break,
                           DIVERGED_BREAKDOWN, reason)
        return dict(x=x, y=yn, r1=r1n, r2=r2n, w=w, w2=w2,
                    beta=beta_n, oldb=beta, dbar=dbar, epsln=epsln,
                    cs=cs, sn=sn, phibar=phibar, its=its, reason=reason,
                    hist=hist)

    zeros = jnp.zeros_like(b)
    rzero = jnp.zeros((), rdtype)
    init = dict(x=x0, y=y0, r1=r1, r2=r1, w=zeros, w2=zeros,
                beta=beta1, oldb=rzero, dbar=rzero, epsln=rzero,
                cs=-jnp.ones((), rdtype), sn=rzero, phibar=beta1,
                its=jnp.int32(0), reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(out["x"])), history=out["hist"])


def symmlq(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
           pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
           atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
           axis_name: Optional[str] = None,
           conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """SYMMLQ (Paige–Saunders; PETSc KSPSYMMLQ) for symmetric, possibly
    indefinite operators with an SPD preconditioner.

    Solves via an LQ factorization of the Lanczos tridiagonal: iterates
    minimize ``||x - x*||`` over the Krylov space (vs MINRES's residual
    minimization), keeping every iterate in range(A) — the conservative
    choice for compatible singular/indefinite systems.  Per iteration: one
    matvec, one PC apply, two (dependent) reductions ``<v, Av>`` and
    ``beta² = <r2, M⁻¹r2>``, same as MINRES.  Convergence is monitored on
    the residual of the TRANSFERRED CG point (symmlq.m's ``cgnorm``), and
    the final solution includes the CG-point transfer step.  A negative
    ``beta²`` (indefinite preconditioner) reports DIVERGED_BREAKDOWN.
    """
    psolve = pc_apply or _identity_pc
    x00 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    tiny = jnp.finfo(rdtype).tiny
    dot = partial(_dot, axis_name=axis_name)
    norm = partial(_norm, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    # shift to the x0 = 0 problem: A dx = r0 (SYMMLQ's natural form)
    r0 = b - matvec(x00)

    y0 = psolve(r0)
    beta1_sq = jnp.real(dot(r0, y0))
    pc_indef0 = beta1_sq < 0
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0))
    bnorm = beta1          # ||r0||_{M⁻¹}: left-preconditioned monitor scale
    sfe = jnp.where(beta1 > 0, beta1, 1.0)
    v1 = y0 / sfe.astype(rdtype)
    yA = matvec(v1)
    alfa0 = jnp.real(dot(v1, yA))
    yA = yA - (alfa0 / sfe).astype(dtype) * r0
    r2_0 = yA
    y1 = psolve(r2_0)
    beta_sq0 = jnp.real(dot(r2_0, y1))
    pc_indef0 = pc_indef0 | (beta_sq0 < 0)
    beta0 = jnp.sqrt(jnp.maximum(beta_sq0, 0))

    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(beta1)
    reason0 = jnp.where(pc_indef0, DIVERGED_BREAKDOWN,
                        check(beta1, bnorm, jnp.int32(0)))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        beta, oldb_prev = s["beta"], s["oldb"]
        ibeta = 1.0 / jnp.where(beta > 0, beta, 1.0)
        v = s["y"] * ibeta.astype(rdtype)
        y = matvec(v)
        y = y - (beta / jnp.where(oldb_prev != 0, oldb_prev, 1.0)
                 ).astype(dtype) * s["r1"]
        alfa = jnp.real(dot(v, y))
        y = y - (alfa * ibeta).astype(dtype) * s["r2"]
        r1n, r2n = s["r2"], y
        yn = psolve(r2n)
        oldb = beta
        beta_sq = jnp.real(dot(r2n, yn))
        pc_indef = beta_sq < 0
        beta_n = jnp.sqrt(jnp.maximum(beta_sq, 0))

        # LQ factorization: previous rotation folds into this column
        gamma = jnp.sqrt(s["gbar"] ** 2 + oldb ** 2)
        gamma = jnp.maximum(gamma, tiny)
        cs = s["gbar"] / gamma
        sn = oldb / gamma
        delta = cs * s["dbar"] + sn * alfa
        gbar = sn * s["dbar"] - cs * alfa
        epsln = sn * beta_n
        dbar = -cs * beta_n

        # LQ-point update
        z = s["rhs1"] / gamma
        x = s["x"] + (z * cs).astype(dtype) * s["w"] \
            + (z * sn).astype(dtype) * v
        w = sn.astype(dtype) * s["w"] - cs.astype(dtype) * v
        rhs1 = s["rhs2"] - delta * z
        rhs2 = -epsln * z

        # the solution component along M⁻¹r0 accumulates separately
        # (symmlq.m's bstep; added after the loop), and the CG-point
        # residual norm drives convergence
        bstep = s["snprod"] * cs * z + s["bstep"]
        snprod = s["snprod"] * sn
        diag = jnp.where(jnp.abs(gbar) > 0, jnp.abs(gbar), tiny)
        qrnorm = snprod * beta1
        cgnorm = qrnorm * beta_n / diag

        its = s["its"] + 1
        hist = s["hist"].at[its].set(cgnorm)
        reason = check(cgnorm, bnorm, its)
        reason = jnp.where(pc_indef, DIVERGED_BREAKDOWN, reason)
        return dict(x=x, w=w, y=yn, r1=r1n, r2=r2n, beta=beta_n, oldb=oldb,
                    gbar=gbar, dbar=dbar, rhs1=rhs1, rhs2=rhs2,
                    snprod=snprod, bstep=bstep, its=its, reason=reason,
                    hist=hist)

    init = dict(x=jnp.zeros_like(b), w=jnp.zeros_like(b), y=y1, r1=r0,
                r2=r2_0, beta=beta0, oldb=beta1, gbar=alfa0, dbar=beta0,
                rhs1=beta1, rhs2=jnp.zeros((), rdtype),
                snprod=jnp.ones((), rdtype), bstep=jnp.zeros((), rdtype),
                its=jnp.int32(0), reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)

    # transfer the LQ point to the CG point (symmlq.m's final move): a
    # last step along w plus the accumulated component along M⁻¹ r0.
    # Skipped if the loop never ran (its == 0, e.g. r0 == 0 or immediate
    # breakdown).
    ran = out["its"] > 0
    denom = jnp.where(jnp.abs(out["gbar"]) > tiny, out["gbar"], tiny)
    zbar = jnp.where(ran, out["rhs1"] / denom, 0.0)
    bstep = (out["snprod"] * zbar + out["bstep"]) / sfe
    xf = out["x"] + zbar.astype(dtype) * out["w"] \
        + jnp.where(ran, bstep, 0.0).astype(dtype) * y0
    x = x00 + xf
    rnorm_true = norm(b - matvec(x))
    return KSPResult(x=x, its=out["its"], reason=out["reason"],
                     rnorm=rnorm_true, history=out["hist"])


def cr(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
       pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
       atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
       axis_name: Optional[str] = None,
       conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Preconditioned Conjugate Residuals (PETSc KSPCR) for symmetric
    operators with an SPD preconditioner.

    Minimizes ``||b - A x||_{M⁻¹}`` over the Krylov space (vs CG's A-norm
    error minimization) with the same short recurrences: one matvec
    (``A z``), one PC apply (``M⁻¹ A p``) and two reduction rounds per
    iteration — ``<w, q>`` alone, then ``<z, Az>`` + ``||r||²`` fused in
    one psum.  Monotone TRUE-residual-norm decrease makes it the symmetric
    analogue of GCR (whose per-iteration storage it avoids); for symmetric
    indefinite systems prefer ``minres`` (CR's ``<z,Az>`` recurrence can
    break down at zero curvature, reported as DIVERGED_BREAKDOWN).
    """
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None      # r0 = b exactly; skip matvec(0)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    dot = partial(_dot, axis_name=axis_name)
    norm = partial(_norm, axis_name=axis_name)
    bnorm = norm(b)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    r0 = b if x0_zero else b - matvec(x0)
    z0 = psolve(r0)
    Az0 = matvec(z0)
    rho0 = dot(z0, Az0)
    rnorm0 = norm(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        q = psolve(s["w"])                     # M⁻¹ A p
        wq = dot(s["w"], q)
        breakdown = jnp.abs(wq) < jnp.finfo(rdtype).tiny
        alpha = s["rho"] / jnp.where(wq != 0, wq, 1.0)
        x = s["x"] + alpha * s["p"]
        r = s["r"] - alpha * s["w"]
        z = s["z"] - alpha * q
        Az = matvec(z)
        rho_new, rr = _dots(((z, Az), (r, r)), axis_name)
        beta = rho_new / jnp.where(s["rho"] != 0, s["rho"], 1.0)
        p = z + beta * s["p"]
        w = Az + beta * s["w"]                 # A p maintained by recurrence
        rn = jnp.sqrt(jnp.real(rr))
        its = s["its"] + 1
        hist = s["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        reason = jnp.where(breakdown & (reason == CONVERGED_ITERATING),
                           DIVERGED_BREAKDOWN, reason)
        return dict(x=x, r=r, z=z, p=p, w=w, rho=rho_new, its=its,
                    reason=reason, hist=hist)

    init = dict(x=x0, r=r0, z=z0, p=z0, w=Az0, rho=rho0, its=jnp.int32(0),
                reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(out["x"])), history=out["hist"])


# ---------------------------------------------------------------------------
# Richardson / preonly
# ---------------------------------------------------------------------------

def richardson(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
               pc_apply: Optional[Callable] = None, *, scale: float = 1.0,
               rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
               maxit: int = 10000, axis_name: Optional[str] = None,
               conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Preconditioned Richardson iteration x += scale * M^{-1} r — doubles as
    stationary iterative refinement when M is a (possibly lower-precision)
    direct factorization."""
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None      # r0 = b exactly; skip matvec(0)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    norm = partial(_norm, axis_name=axis_name)
    bnorm = norm(b)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)
    rdtype = jnp.zeros((), dtype).real.dtype
    r0 = b if x0_zero else b - matvec(x0)
    rnorm0 = norm(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        x = s["x"] + scale * psolve(s["r"])
        r = b - matvec(x)
        rn = norm(r)
        its = s["its"] + 1
        hist = s["hist"].at[its].set(rn)
        return dict(x=x, r=r, its=its, reason=check(rn, bnorm, its),
                    hist=hist)

    out = jax.lax.while_loop(
        cond, _freeze_when_done(body, conv_sync_axis),
        dict(x=x0, r=r0, its=jnp.int32(0), reason=reason0, hist=hist))
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(out["x"])), history=out["hist"])


def chebyshev(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
              pc_apply: Optional[Callable] = None, *, emin: float = 0.1,
              emax: float = 1.1, rtol: float = 1e-5, atol: float = 1e-50,
              divtol: float = 1e4, maxit: int = 10000,
              axis_name: Optional[str] = None,
              conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Chebyshev semi-iteration over the (preconditioned) spectrum interval
    [emin, emax] — PETSc KSPCHEBYSHEV equivalent; reduction-free iterations
    (no dot products -> no psum latency on the mesh), the classic smoother
    pairing for bjacobi/truncated-spike preconditioners."""
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None      # r0 = b exactly; skip matvec(0)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    norm = partial(_norm, axis_name=axis_name)
    bnorm = norm(b)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)
    sigma1 = theta / delta if delta != 0 else 0.0

    rdtype = jnp.zeros((), dtype).real.dtype
    r0 = b if x0_zero else b - matvec(x0)
    rnorm0 = norm(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        z = psolve(s["r"])
        first = s["its"] == 0
        rho_new = jnp.where(first, 1.0 / sigma1,
                            1.0 / (2.0 * sigma1 - s["rho"]))
        p = jnp.where(first, z / theta,
                      (rho_new * s["rho"]) * s["p"]
                      + (2.0 * rho_new / delta) * z)
        x = s["x"] + p
        r = s["r"] - matvec(p)
        rn = norm(r)
        its = s["its"] + 1
        hist = s["hist"].at[its].set(rn)
        return dict(x=x, r=r, p=p, rho=rho_new, its=its,
                    reason=check(rn, bnorm, its), hist=hist)

    init = dict(x=x0, r=r0, p=jnp.zeros_like(b), rho=jnp.zeros((), dtype),
                its=jnp.int32(0), reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis), init)
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(out["x"])), history=out["hist"])


def preonly(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
            pc_apply: Optional[Callable] = None, *, maxit: int = 1,
            axis_name: Optional[str] = None, **_) -> KSPResult:
    """Single preconditioner application (PETSc KSPPREONLY): with a direct
    factorization PC this is the direct-solve path.  Reason is CONVERGED_ITS
    (PETSc parity) unless the result is non-finite (DIVERGED_NANORINF)."""
    psolve = pc_apply or _identity_pc
    norm = partial(_norm, axis_name=axis_name)
    x = psolve(b) if x0 is None else x0 + psolve(b - matvec(x0))
    r = b - matvec(x)
    rn = norm(r)
    rdtype = jnp.zeros((), b.dtype).real.dtype
    # exactly one application: a [2] history regardless of the caller's
    # maxit (which _params_from_options defaults to 10000)
    hist = jnp.full((2,), jnp.nan, rdtype)
    hist = hist.at[0].set(norm(b)).at[1].set(rn)
    reason = jnp.where(jnp.isfinite(rn), jnp.int32(CONVERGED_ITS),
                       jnp.int32(DIVERGED_NANORINF))
    return KSPResult(x=x, its=jnp.int32(1), reason=reason, rnorm=rn,
                     history=hist)


def gcr(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
        pc_apply: Optional[Callable] = None, *, restart: int = 30,
        rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
        maxit: int = 10000, axis_name: Optional[str] = None,
        conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Generalized Conjugate Residuals with restarts (PETSc KSPGCR).

    Like fgmres it tolerates a preconditioner that CHANGES between
    iterations (an inner iterative solve via ``-pc_type ksp``, adaptive
    mixed-precision applies), but updates x and the TRUE residual every
    iteration — so unpreconditioned-norm monitoring and convergence tests
    are free where fgmres pays an extra matvec (PETSc recommends GCR over
    fgmres exactly for right-PC + true-residual workflows).  Cost: stores
    TWO direction buffers [restart, n] (p and A·p), one matvec + one
    PCApply per iteration, and exactly TWO reduction rounds: the [restart]
    Gram row, then (<Ap,Ap>, <Ap,r>, <r,r>) fused — the post-step residual
    norm comes from the minimization identity
    ||r'||² = ||r||² − |<Ap,r>|²/||Ap||² with ||r||² measured fresh each
    iteration (no third psum, no cumulative drift).

    At each restart boundary the direction buffers are cleared (PETSc
    KSPGCR's restart semantics, not a truncated sliding window).
    """
    psolve = pc_apply or _identity_pc
    x0_zero = x0 is None      # r0 = b exactly; skip matvec(0)
    x0 = jnp.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    tiny = jnp.finfo(rdtype).tiny
    norm = partial(_norm, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    bnorm = norm(b)
    r0 = b if x0_zero else b - matvec(x0)
    rnorm0 = norm(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))
    m = max(1, int(restart))

    def cond(s):
        return _keep_iterating(s["reason"], conv_sync_axis)

    def body(s):
        slot = jnp.mod(s["its"], m)
        # restart boundary: drop the stored directions
        P = jnp.where(slot == 0, 0.0, 1.0) * s["P"]
        AP = jnp.where(slot == 0, 0.0, 1.0) * s["AP"]
        p = psolve(s["r"])
        Ap = matvec(p)
        # classical-GS orthogonalization of A·p against the stored
        # (normalized) A·p_i: empty slots are zero rows -> coefficient 0.
        # One gram row; stacking <Ap,Ap-proj> into the same psum would need
        # the projection first, so GCR pays exactly 2 reduction rounds per
        # iteration (the residual norm below uses the minimization identity
        # instead of a third psum).
        beta = _gram(AP, Ap, axis_name)                     # [m]
        p = p - jnp.tensordot(beta, P, axes=([0], [0]), precision=_HI)
        Ap = Ap - jnp.tensordot(beta, AP, axes=([0], [0]), precision=_HI)
        # ||Ap||^2, <Ap, r>, and ||r||^2 ride one fused psum; the residual
        # norm after the minimizing step then needs NO third round:
        # r' ⊥ Ap  =>  ||r'||² = ||r||² − |<Ap,r>|²/||Ap||².  ||r||² is
        # measured FRESH each iteration (not carried), so the cancellation
        # error is single-step, never cumulative.
        nn, ar, rr = _dots(((Ap, Ap), (Ap, s["r"]), (s["r"], s["r"])),
                           axis_name)
        nrm = jnp.sqrt(jnp.real(nn))
        breakdown = nrm <= 1e3 * tiny
        safe = jnp.where(nrm != 0, nrm, 1.0).astype(rdtype)
        p = p / safe
        Ap = Ap / safe
        alpha = ar / jnp.where(nn != 0, nn, 1.0) * safe     # <Ap/||,r||>
        x = s["x"] + alpha * p
        r = s["r"] - alpha * Ap
        P = P.at[slot].set(p)
        AP = AP.at[slot].set(Ap)
        rn = jnp.sqrt(jnp.maximum(
            jnp.real(rr) - jnp.abs(ar) ** 2
            / jnp.real(jnp.where(nn != 0, nn, 1.0)), 0.0))
        its = s["its"] + 1
        hist = s["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        reason = jnp.where(breakdown & (reason == CONVERGED_ITERATING),
                           DIVERGED_BREAKDOWN, reason)
        return dict(x=x, r=r, P=P, AP=AP, its=its, reason=reason,
                    hist=hist)

    zeros = jnp.zeros((m,) + b.shape, dtype)
    init = dict(x=x0, r=r0, P=zeros, AP=zeros, its=jnp.int32(0),
                reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(out["x"])), history=out["hist"])


# ---------------------------------------------------------------------------
# Normal-equations family (PETSc KSPCGNE / KSPLSQR): nonsymmetric and
# RECTANGULAR least-squares solves riding the transpose stack
# (banded_transpose matvecs + PC.transpose on stored factors)
# ---------------------------------------------------------------------------

def cgnr(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
         pc_apply: Optional[Callable] = None, *,
         matvec_transpose: Optional[Callable] = None,
         pc_apply_transpose: Optional[Callable] = None,
         rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
         maxit: int = 10000, axis_name: Optional[str] = None,
         conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """CG on the normal equations in CGLS form (PETSc KSPCGNE role).

    Minimizes ``||M^{-1}(b - A x)||_2`` without ever forming A^H A: the CGLS
    recurrences carry the least-squares residual ``s = M^{-1}(b - A x)`` and
    the normal residual ``r = B^H s`` (B = M^{-1} A) separately — numerically
    superior to running ``cg`` on the squared operator (the squared condition
    number never touches the stored vectors).  Works for square nonsymmetric
    systems and for RECTANGULAR least-squares problems (x and b may have
    different lengths; pass matvec/matvec_transpose callables).

    ``matvec_transpose`` is the PURE transpose A^T; Hermitian forms are
    derived by conjugation wrapping (free for real scalars), exactly as
    ``bicg``.  The monitored history is ``||s||``; for inconsistent
    (rectangular) systems, where ``||s||`` stalls at the least-squares
    optimum, CONVERGED_RTOL_NORMAL is reported once the normal residual
    satisfies ``||B^H s|| <= rtol * ||B^H M^{-1} b||`` (PETSc KSPLSQR's
    normal-equations test).
    """
    if matvec_transpose is None:
        raise ValueError("cgnr/cgne requires matvec_transpose (an explicit "
                         "operator through ksp.solve provides it; bare "
                         "callables cannot be transposed)")
    psolve = pc_apply or _identity_pc
    psolve_t = pc_apply_transpose or _identity_pc
    mv_h = lambda v: jnp.conj(matvec_transpose(jnp.conj(v)))
    ps_h = lambda v: jnp.conj(psolve_t(jnp.conj(v)))
    bmv = lambda v: psolve(matvec(v))        # B = M^{-1} A
    bmv_h = lambda v: mv_h(ps_h(v))          # B^H = A^H M^{-H}
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    norm = partial(_norm, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    c = psolve(b)
    bt = bmv_h(c)                            # also fixes x's length (may != m)
    if x0 is None:
        x0 = jnp.zeros_like(bt)
        s0, r0 = c, bt
    else:
        s0 = psolve(b - matvec(x0))
        r0 = bmv_h(s0)
    bnorm = norm(c)
    ntnorm0 = norm(bt)
    gamma0 = jnp.real(_dot(r0, r0, axis_name))
    rnorm0 = norm(s0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))

    def cond(st):
        return _keep_iterating(st["reason"], conv_sync_axis)

    def body(st):
        q = bmv(st["p"])
        qq = jnp.real(_dot(q, q, axis_name))
        breakdown = qq < jnp.finfo(rdtype).tiny
        alpha = st["gamma"] / jnp.where(qq != 0, qq, 1.0)
        x = st["x"] + alpha.astype(dtype) * st["p"]
        s = st["s"] - alpha.astype(dtype) * q
        r = bmv_h(s)
        # ||r||^2 and ||s||^2 ride one fused psum
        gamma_new, ss = _dots(((r, r), (s, s)), axis_name)
        gamma_new, ss = jnp.real(gamma_new), jnp.real(ss)
        beta = gamma_new / jnp.where(st["gamma"] != 0, st["gamma"], 1.0)
        p = r + beta.astype(dtype) * st["p"]
        rn = jnp.sqrt(ss)
        its = st["its"] + 1
        hist = st["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        reason = jnp.where(
            (reason == CONVERGED_ITERATING)
            & (jnp.sqrt(gamma_new) <= rtol * ntnorm0),
            CONVERGED_RTOL_NORMAL, reason)
        reason = jnp.where(breakdown & (reason == CONVERGED_ITERATING),
                           DIVERGED_BREAKDOWN, reason)
        return dict(x=x, s=s, p=p, gamma=gamma_new, its=its, reason=reason,
                    hist=hist)

    init = dict(x=x0, s=s0, p=r0, gamma=gamma0, its=jnp.int32(0),
                reason=reason0, hist=hist)
    # already at the normal-equations optimum (e.g. x0 exact for an
    # inconsistent system)
    init["reason"] = jnp.where(
        (reason0 == CONVERGED_ITERATING) & (jnp.sqrt(gamma0) <= rtol * ntnorm0),
        CONVERGED_RTOL_NORMAL, reason0)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)
    return KSPResult(x=out["x"], its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(out["x"])), history=out["hist"])


def lsqr(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
         pc_apply: Optional[Callable] = None, *,
         matvec_transpose: Optional[Callable] = None,
         pc_apply_transpose: Optional[Callable] = None,
         rtol: float = 1e-5, atol: float = 1e-50, divtol: float = 1e4,
         maxit: int = 10000, axis_name: Optional[str] = None,
         conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """LSQR (Paige–Saunders Golub–Kahan bidiagonalization; PETSc KSPLSQR).

    Solves ``min_x ||b - A x||_2`` for square or RECTANGULAR A; analytically
    equivalent to ``cgnr`` but propagates the bidiagonalization directly, so
    the residual-norm recurrence (phibar) is monotone and cheap.  Right
    preconditioning: with M ~ A it solves ``min ||r0 - (A M^{-1}) y||``,
    x = x0 + M^{-1} y — a nonzero x0 enters through the residual correction
    (no M apply is ever needed, only M^{-1}/M^{-H} via PC.transpose()).

    Monitored history is the LSQR residual-norm estimate phibar (equals
    ``||b - A x_k||`` in exact arithmetic); CONVERGED_RTOL_NORMAL fires on
    the Paige–Saunders normal-equations test
    ``||B^H r|| <= rtol * ||B||_F-est * ||r||`` — the least-squares optimum
    for inconsistent systems.
    """
    if matvec_transpose is None:
        raise ValueError("lsqr requires matvec_transpose (an explicit "
                         "operator through ksp.solve provides it; bare "
                         "callables cannot be transposed)")
    psolve = pc_apply or _identity_pc
    psolve_t = pc_apply_transpose or _identity_pc
    mv_h = lambda v: jnp.conj(matvec_transpose(jnp.conj(v)))
    ps_h = lambda v: jnp.conj(psolve_t(jnp.conj(v)))
    bmv = lambda v: matvec(psolve(v))        # B = A M^{-1}
    bmv_h = lambda u: ps_h(mv_h(u))          # B^H = M^{-H} A^H
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    tiny = jnp.finfo(rdtype).tiny
    norm = partial(_norm, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    bnorm = norm(b)
    r0 = b if x0 is None else b - matvec(x0)
    beta0 = norm(r0)
    u0 = r0 / jnp.where(beta0 != 0, beta0, 1.0).astype(dtype)
    v_un = bmv_h(u0)
    alpha0 = norm(v_un)
    v0 = v_un / jnp.where(alpha0 != 0, alpha0, 1.0).astype(dtype)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(beta0)
    reason0 = check(beta0, bnorm, jnp.int32(0))
    reason0 = jnp.where((reason0 == CONVERGED_ITERATING) & (alpha0 <= tiny),
                        CONVERGED_RTOL_NORMAL, reason0)

    def cond(st):
        return _keep_iterating(st["reason"], conv_sync_axis)

    def body(st):
        u_un = bmv(st["v"]) - st["alpha"].astype(dtype) * st["u"]
        beta = norm(u_un)
        u = u_un / jnp.where(beta != 0, beta, 1.0).astype(dtype)
        v_un = bmv_h(u) - beta.astype(dtype) * st["v"]
        alpha = norm(v_un)
        v = v_un / jnp.where(alpha != 0, alpha, 1.0).astype(dtype)
        rho = jnp.sqrt(st["rhobar"] ** 2 + beta ** 2)
        cs = st["rhobar"] / jnp.where(rho != 0, rho, 1.0)
        sn = beta / jnp.where(rho != 0, rho, 1.0)
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * st["phibar"]
        phibar = sn * st["phibar"]
        y = st["y"] + (phi / jnp.where(rho != 0, rho, 1.0)).astype(dtype) \
            * st["w"]
        w = v - (theta / jnp.where(rho != 0, rho, 1.0)).astype(dtype) \
            * st["w"]
        anorm2 = st["anorm2"] + alpha ** 2 + beta ** 2
        rn = phibar
        its = st["its"] + 1
        hist = st["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        # Paige–Saunders stopping rule 2: ||B^H r_k|| = phibar*alpha*|cs|
        # small relative to ||B||*||r_k|| — the normal-equations optimum
        normal_rn = phibar * alpha * jnp.abs(cs)
        reason = jnp.where(
            (reason == CONVERGED_ITERATING)
            & (normal_rn <= rtol * jnp.sqrt(anorm2) * jnp.maximum(phibar,
                                                                  tiny)),
            CONVERGED_RTOL_NORMAL, reason)
        # alpha == 0 / beta == 0: bidiagonalization terminated — the exact
        # (least-squares) solution of the Krylov subspace is reached
        reason = jnp.where(
            (reason == CONVERGED_ITERATING)
            & ((alpha <= tiny) | (beta <= tiny)),
            CONVERGED_RTOL_NORMAL, reason)
        return dict(y=y, w=w, u=u, v=v, alpha=alpha, rhobar=rhobar,
                    phibar=phibar, anorm2=anorm2, its=its, reason=reason,
                    hist=hist)

    init = dict(y=jnp.zeros_like(v0), w=v0, u=u0, v=v0, alpha=alpha0,
                rhobar=alpha0, phibar=beta0, anorm2=alpha0 ** 2,
                its=jnp.int32(0), reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)
    x = psolve(out["y"]) if x0 is None else x0 + psolve(out["y"])
    return KSPResult(x=x, its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(x)), history=out["hist"])


# ---------------------------------------------------------------------------
# Transpose-free nonsymmetric family (PETSc KSPCGS / KSPTFQMR)
# ---------------------------------------------------------------------------

def cgs(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
        pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
        atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
        axis_name: Optional[str] = None,
        conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Conjugate Gradients Squared (Sonneveld; PETSc KSPCGS).

    Transpose-free BiCG variant: squares the BiCG polynomial, so it needs
    two matvecs but NO A^T — the option when only a forward operator exists
    (bare-callable operators, where ``bicg`` raises).  Preconditioning is
    right-folded (B = A M^{-1}, solved for y with x = x0 + M^{-1} y), so the
    monitored history is the TRUE residual of the original system.
    Convergence is irregular (squared polynomial → amplified peaks); prefer
    bicgstab unless CGS's faster smooth-phase convergence is measured to win.
    """
    psolve = pc_apply or _identity_pc
    bmv = lambda v: matvec(psolve(v))
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    tiny = jnp.finfo(rdtype).tiny
    norm = partial(_norm, axis_name=axis_name)
    dot = partial(_dot, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    bnorm = norm(b)
    r0 = b if x0 is None else b - matvec(x0)
    rt0 = r0
    rho0 = dot(rt0, r0)
    rnorm0 = norm(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(rnorm0)
    reason0 = check(rnorm0, bnorm, jnp.int32(0))
    reason0 = jnp.where(
        (jnp.abs(rho0) < tiny) & (reason0 == CONVERGED_ITERATING),
        DIVERGED_BREAKDOWN, reason0)

    def cond(st):
        return _keep_iterating(st["reason"], conv_sync_axis)

    def body(st):
        v = bmv(st["p"])
        sigma = dot(rt0, v)
        breakdown = jnp.abs(sigma) < tiny
        alpha = st["rho"] / jnp.where(sigma != 0, sigma, 1.0)
        q = st["u"] - alpha * v
        uq = st["u"] + q
        y = st["y"] + alpha * uq
        r = st["r"] - alpha * bmv(uq)
        # <rt,r> and ||r||^2 share one fused psum
        rho_new, rr = _dots(((rt0, r), (r, r)), axis_name)
        breakdown |= jnp.abs(rho_new) < tiny
        beta = rho_new / jnp.where(st["rho"] != 0, st["rho"], 1.0)
        u = r + beta * q
        p = u + beta * (q + beta * st["p"])
        rn = jnp.sqrt(jnp.real(rr))
        its = st["its"] + 1
        hist = st["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        reason = jnp.where(breakdown & (reason == CONVERGED_ITERATING),
                           DIVERGED_BREAKDOWN, reason)
        return dict(y=y, r=r, u=u, p=p, rho=rho_new, its=its, reason=reason,
                    hist=hist)

    init = dict(y=jnp.zeros_like(b), r=r0, u=r0, p=r0, rho=rho0,
                its=jnp.int32(0), reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)
    x = psolve(out["y"]) if x0 is None else x0 + psolve(out["y"])
    return KSPResult(x=x, its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(x)), history=out["hist"])


def tfqmr(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None,
          pc_apply: Optional[Callable] = None, *, rtol: float = 1e-5,
          atol: float = 1e-50, divtol: float = 1e4, maxit: int = 10000,
          axis_name: Optional[str] = None,
          conv_sync_axis: Optional[str] = None, **_) -> KSPResult:
    """Transpose-Free QMR (Freund 1993; PETSc KSPTFQMR).

    CGS's search space with a quasi-minimal-residual smoothing — the
    transpose-free method of choice when CGS/BiCGStab stagnate on erratic
    residuals.  Two matvecs per iteration (two QMR half-steps), one fused
    reduction round.  Preconditioning is right-folded as in ``cgs``; the
    monitored history is Freund's residual-norm BOUND tau*sqrt(2k+1)
    (PETSc's monitor shows the same bound), while the returned ``rnorm`` is
    the recomputed true residual.
    """
    psolve = pc_apply or _identity_pc
    bmv = lambda v: matvec(psolve(v))
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype
    tiny = jnp.finfo(rdtype).tiny
    norm = partial(_norm, axis_name=axis_name)
    dot = partial(_dot, axis_name=axis_name)
    check = partial(default_convergence_check, rtol=rtol, atol=atol,
                    divtol=divtol, maxit=maxit)

    bnorm = norm(b)
    r0 = b if x0 is None else b - matvec(x0)
    rt0 = r0
    tau0 = norm(r0)
    rho0 = dot(rt0, r0)
    v0 = bmv(r0)
    hist = jnp.full((maxit + 1,), jnp.nan, rdtype).at[0].set(tau0)
    reason0 = check(tau0, bnorm, jnp.int32(0))
    reason0 = jnp.where(
        (jnp.abs(rho0) < tiny) & (reason0 == CONVERGED_ITERATING),
        DIVERGED_BREAKDOWN, reason0)

    def cond(st):
        return _keep_iterating(st["reason"], conv_sync_axis)

    def half(ym, Aym, w, tau, theta, eta, d, yacc, alpha):
        """One QMR half-step: residual update + smoothing + solution step."""
        w1 = w - alpha * Aym
        theta1 = _norm(w1, axis_name) / jnp.maximum(tau, tiny)
        c1 = 1.0 / jnp.sqrt(1.0 + theta1 ** 2)
        tau1 = tau * theta1 * c1
        eta1 = (c1 ** 2) * alpha
        sa = jnp.where(jnp.abs(alpha) > tiny, alpha, 1.0)
        d1 = ym + ((theta ** 2) * eta / sa) * d
        return w1, tau1, theta1, eta1, d1, yacc + eta1 * d1

    def body(st):
        sigma = dot(rt0, st["v"])
        breakdown = jnp.abs(sigma) < tiny
        alpha = st["rho"] / jnp.where(sigma != 0, sigma, 1.0)
        y2 = st["y1"] - alpha * st["v"]
        By2 = bmv(y2)
        # half-step m = 2k-1: the residual recurrence uses B y1 (uhat),
        # NOT the direction vector v — they differ once beta != 0
        # (v = B y1 + beta (B y2_prev + beta v_prev))
        w1, tau1, theta1, eta1, d1, yacc = half(
            st["y1"], st["uhat"], st["w"], st["tau"], st["theta"],
            st["eta"], st["d"], st["yacc"], alpha)
        # half-step m = 2k
        w2, tau2, theta2, eta2, d2, yacc = half(
            y2, By2, w1, tau1, theta1, eta1, d1, yacc, alpha)
        rho_new = dot(rt0, w2)
        breakdown |= jnp.abs(rho_new) < tiny
        beta = rho_new / jnp.where(st["rho"] != 0, st["rho"], 1.0)
        y1 = w2 + beta * y2
        uhat = bmv(y1)
        v = uhat + beta * (By2 + beta * st["v"])
        its = st["its"] + 1
        # Freund's bound ||r_m|| <= tau_m sqrt(m+1) at m = 2k
        rn = tau2 * jnp.sqrt(2.0 * its.astype(rdtype) + 1.0)
        hist = st["hist"].at[its].set(rn)
        reason = check(rn, bnorm, its)
        reason = jnp.where(breakdown & (reason == CONVERGED_ITERATING),
                           DIVERGED_BREAKDOWN, reason)
        return dict(yacc=yacc, w=w2, y1=y1, v=v, uhat=uhat, d=d2, tau=tau2,
                    theta=theta2, eta=eta2, rho=rho_new, its=its,
                    reason=reason, hist=hist)

    zeros = jnp.zeros_like(b)
    init = dict(yacc=zeros, w=r0, y1=r0, v=v0, uhat=v0, d=zeros,
                tau=tau0, theta=jnp.zeros((), rdtype),
                eta=jnp.zeros((), dtype), rho=rho0,
                its=jnp.int32(0), reason=reason0, hist=hist)
    out = jax.lax.while_loop(cond, _freeze_when_done(body, conv_sync_axis),
                             init)
    x = psolve(out["yacc"]) if x0 is None else x0 + psolve(out["yacc"])
    return KSPResult(x=x, its=out["its"], reason=out["reason"],
                     rnorm=norm(b - matvec(x)), history=out["hist"])


register_ksp("chebyshev", chebyshev)
register_ksp("gmres", gmres)
register_ksp("fgmres", fgmres)
register_ksp("lgmres", lgmres)
register_ksp("cr", cr)
register_ksp("symmlq", symmlq)
register_ksp("bcgs", bicgstab)
register_ksp("fbcgs", bicgstab)   # flexible formulation (see docstring)
register_ksp("bicgstab", bicgstab)
register_ksp("bicg", bicg)
register_ksp("bcgsl", bcgsl)
register_ksp("cg", cg)
register_ksp("pipecg", pipecg)
register_ksp("minres", minres)
register_ksp("richardson", richardson)
register_ksp("preonly", preonly)
register_ksp("gcr", gcr)
register_ksp("cgne", cgnr)      # PETSc's name for CG-on-normal-equations
register_ksp("cgnr", cgnr)
register_ksp("cgls", cgnr)
register_ksp("lsqr", lsqr)
register_ksp("cgs", cgs)
register_ksp("tfqmr", tfqmr)
