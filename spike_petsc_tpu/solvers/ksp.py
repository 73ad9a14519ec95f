"""Top-level KSP interface: options-driven solver composition.

The reference's solve path is ``KSPCreate; KSPSetOperators(A, B);
KSPSetFromOptions; KSPSolve`` (/root/reference/src/testbed.c:313-316), with
everything (method, tolerances, preconditioner, nesting) decided by the
options database.  ``solve`` reproduces that surface:

    result = solve(A, b, options=Options.from_argv(sys.argv),
                   pmat=B)            # -ksp_type gmres -pc_type banded ...

while ``make_solver`` returns a reusable jitted closure for hot paths
(factor once, solve many — the shape PETSc reuses KSP objects for).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..utils.jit import jit_closure
from ..utils.options import Options
from ..utils.registry import SOLVERS
from .operator import as_matvec
from .pc import PC, make_pc
from .types import KSPResult
from . import krylov  # noqa: F401  (registers built-in solvers)
from . import fieldsplit  # noqa: F401  (registers composite/fieldsplit PCs)
from . import mg  # noqa: F401  (registers the multigrid PC)

_DEFAULTS = dict(rtol=1e-5, atol=1e-50, divtol=1e4, maxit=10000, restart=30)


def _params_from_options(opts: Options, overrides: dict) -> dict:
    p = dict(
        rtol=opts.get_real("ksp_rtol", _DEFAULTS["rtol"]),
        atol=opts.get_real("ksp_atol", _DEFAULTS["atol"]),
        divtol=opts.get_real("ksp_divtol", _DEFAULTS["divtol"]),
        maxit=opts.get_int("ksp_max_it", _DEFAULTS["maxit"]),
        restart=opts.get_int("ksp_gmres_restart", _DEFAULTS["restart"]),
    )
    side = opts.get_string("ksp_pc_side", None)
    if side:
        p["side"] = side
    # -ksp_norm_type preconditioned|unpreconditioned (KSPSetNormType):
    # gmres/fgmres convergence-test norm; other KSPs ignore it
    norm_type = opts.get_string("ksp_norm_type", None)
    if norm_type:
        p["norm_type"] = norm_type
    # -ksp_gmres_cgs_refinement_type never|ifneeded|always
    # (KSPGMRESSetCGSRefinementType): gmres/fgmres/lgmres classical-GS
    # reorthogonalization policy; other KSPs ignore it
    cgs = opts.get_string("ksp_gmres_cgs_refinement_type", None)
    if cgs:
        p["cgs_refinement"] = cgs
    if opts.get_bool("ksp_monitor_true_residual", False):
        p["monitor_true"] = True
    p.update({k: v for k, v in overrides.items() if v is not None})
    return p


def make_solver(A, *, pmat=None, options: Optional[Options] = None,
                ksp_type: Optional[str] = None, pc_type: Optional[str] = None,
                pc: Optional[PC] = None, n_hint: Optional[int] = None,
                jit: bool = True, transpose: bool = False,
                nullspace=None, transpose_nullspace=None,
                **params) -> Callable:
    """Compose (operator, preconditioner, method) once; return solve(b, x0).

    The returned closure is jitted, so repeated solves amortize setup and
    compilation — the analogue of reusing a configured KSP object.

    ``transpose=True`` solves A^T x = b (PETSc KSPSolveTranspose): the
    operator transposes host-side and the preconditioner applies M^{-T}
    via PC.transpose() — reusing its stored factors, no refactorization.

    ``nullspace`` (solvers/nullspace.NullSpace, or ``-ksp_nullspace_constant``
    for the common L·1=0 case): singular consistent systems — b is
    projected by ``transpose_nullspace`` (defaults to ``nullspace``: the
    symmetric case), matvec outputs and the returned x by ``nullspace``
    (MatSetNullSpace / MatSetTransposeNullSpace semantics).
    """
    opts = options or Options()
    ksp_type = ksp_type or opts.get_string("ksp_type", "gmres")
    if pc is None:
        name = pc_type or opts.get_string("pc_type", "none")
        pc = make_pc(name, A if pmat is None else pmat, opts)
    if transpose:
        from .operator import transpose_operator
        A = transpose_operator(A)
        pc = pc.transpose() if pc.name != "none" else pc
        # A^T's null space is the forward transpose-null space and vice
        # versa: swap the pair so projections stay attached to the right
        # operator side
        nullspace, transpose_nullspace = (
            transpose_nullspace if transpose_nullspace is not None
            else nullspace, nullspace)
    # -mat_matvec_impl auto|blocktri|xla: operator SpMV route
    # (the MatMult engine of the hot loop, /root/reference/src/testbed.c:310)
    matvec, n, op_dtype = as_matvec(
        A, n_hint=n_hint, impl=opts.get_string("mat_matvec_impl", "auto"))
    pc_apply = pc.apply if pc.name != "none" else None
    if nullspace is None and opts.get_bool("ksp_nullspace_constant", False):
        from .nullspace import make_nullspace
        nullspace = make_nullspace(
            n, constant=True,
            dtype=op_dtype if op_dtype is not None else jnp.float32)
    ns, tns = nullspace, (transpose_nullspace if transpose_nullspace
                          is not None else nullspace)
    if tns is not None:
        # matvec OUTPUTS live in residual space = range(A) = null(A^T)^perp:
        # project them by the LEFT null space (a no-op in exact arithmetic
        # that controls roundoff drift).  Projecting by the RIGHT null space
        # here would silently change the operator — for nonsymmetric A,
        # P_ns A is singular in a way that blows up the Hessenberg
        # least-squares (x picked up a ~1e15 null component before the
        # final projection, which f64 cancellation could not remove).
        base_matvec = matvec
        matvec = lambda v: tns.remove(base_matvec(v))  # noqa: E731
    if ns is not None and pc_apply is not None:
        # PC outputs must be projected EVERY application (PETSc's
        # KSP_PCApply calls MatNullSpaceRemove): M^{-1} of a shifted
        # factor maps zero-mean residuals to vectors with a nonzero null
        # component, and short-recurrence methods (cg/bcgs) accumulate
        # that drift in x unboundedly — measured f32 CG on the Neumann
        # Laplacian reached mean ~1e8 before the final projection, which
        # cancellation could no longer remove (round-5 dryrun dissect).
        base_pc = pc_apply
        pc_apply = lambda v: ns.remove(base_pc(v))  # noqa: E731

    method = SOLVERS.get(ksp_type)
    kw = _params_from_options(opts, params)
    if ksp_type == "richardson":
        sc = opts.get_real("ksp_richardson_scale", None)
        if sc is not None:
            kw.setdefault("scale", sc)
    if ksp_type == "chebyshev" and "emin" not in kw:
        # -ksp_chebyshev_eigenvalues emin,emax pins the bounds explicitly;
        # -ksp_chebyshev_esteig [a,b,c,d] estimates them from Ritz values of
        # a short setup-time Arnoldi run on M^{-1}A (KSPChebyshevEstEig),
        # transformed as (a*lmin + b*lmax, c*lmin + d*lmax).  Explicit
        # bounds win when both are given (PETSc semantics).
        ev = opts.get_list("ksp_chebyshev_eigenvalues")
        if ev is not None:
            if len(ev) != 2:
                raise ValueError(
                    "-ksp_chebyshev_eigenvalues expects 'emin,emax', got "
                    f"{ev!r}")
            kw["emin"], kw["emax"] = float(ev[0]), float(ev[1])
        elif opts.has("ksp_chebyshev_esteig"):
            tr = opts.get_list("ksp_chebyshev_esteig") or []
            if tr and len(tr) != 4:
                raise ValueError(
                    "-ksp_chebyshev_esteig expects 'a,b,c,d' (or no value "
                    f"for the default transform), got {tr!r}")
            transform = (tuple(float(t) for t in tr) if tr
                         else krylov.ESTEIG_DEFAULT_TRANSFORM)
            eigs = krylov.estimate_extreme_eigs(
                matvec, n, op_dtype,
                m=opts.get_int("ksp_chebyshev_esteig_steps", 10),
                pc_apply=pc_apply)
            kw["emin"], kw["emax"] = krylov.chebyshev_esteig_bounds(
                eigs, transform)
    if ksp_type == "lgmres":
        # -ksp_lgmres_augment: number of stored error-approximation vectors
        # appended to each restart cycle (PETSc KSPLGMRESSetAugDim)
        kw.setdefault("aug", opts.get_int("ksp_lgmres_augment", 2))
    if ksp_type == "bcgsl":
        # -ksp_bcgsl_ell: the MR-polynomial degree (PETSc KSPBCGSLSetEll)
        kw.setdefault("ell", opts.get_int("ksp_bcgsl_ell", 2))
    if ksp_type in ("bicg", "cgne", "cgnr", "cgls", "lsqr"):
        # bicg's shadow recurrence and the normal-equations family
        # (cgne/cgnr/cgls/lsqr) need A^T and M^{-T}: transpose the
        # operator host-side and reuse the PC's stored factors
        # (PC.transpose -> spike_transpose; no refactorization).  Each
        # entry is wired independently so a user-supplied
        # matvec_transpose (the callable-operator escape hatch) still
        # gets the PC transpose, and a user-supplied pc_apply_transpose
        # is never clobbered (code-review r3)
        if "matvec_transpose" not in kw:
            from .operator import transpose_operator
            mvt, _, _ = as_matvec(
                transpose_operator(A), n_hint=n_hint,
                impl=opts.get_string("mat_matvec_impl", "auto"))
            if ns is not None:
                # A^T's residual space is range(A^T) = null(A)^perp: the
                # drift projection for transpose matvecs is the RIGHT null
                # space of A (the left null space of A^T)
                _mvt_base = mvt
                mvt = lambda v: ns.remove(_mvt_base(v))  # noqa: E731
            kw["matvec_transpose"] = mvt
        if pc_apply is not None and "pc_apply_transpose" not in kw:
            _pta = pc.transpose().apply
            # the transpose solve's solution space drops null(A^T): same
            # KSP_PCApply projection, with the LEFT null space
            kw["pc_apply_transpose"] = (_pta if tns is None else
                                        (lambda v: tns.remove(_pta(v))))

    def _solve(b, x0=None):
        if tns is not None:
            b = tns.remove(b)     # consistency: drop the left-null part
        res = method(matvec, b, x0, pc_apply, **kw)
        if ns is not None:
            # uniqueness: return the minimal-norm representative
            import dataclasses as _dc
            res = _dc.replace(res, x=ns.remove(res.x))
        return res

    return jit_closure(_solve) if jit else _solve


def make_solver_many(A, *, pmat=None, options: Optional[Options] = None,
                     ksp_type: Optional[str] = None,
                     pc_type: Optional[str] = None, pc: Optional[PC] = None,
                     n_hint: Optional[int] = None, jit: bool = True,
                     transpose: bool = False, nullspace=None,
                     transpose_nullspace=None, **params) -> Callable:
    """Compose a BATCHED multi-RHS solver: solve(B[n, r], X0=None) returns a
    column-batched KSPResult (x [n, r]; its/reason/rnorm per column).

    One iteration loop drives ALL columns (solvers/krylov_many.py): the
    operator is applied as a true [n, r] block and the PC uses its native
    multi-RHS apply when it has one (``PC.apply_many`` — spike-family
    factors stream ONCE per iteration for all r columns), else a vmap of
    the single-RHS apply.  Per-column convergence freezes finished columns.

    ``ksp_type``: one of krylov_many.MANY_SOLVERS ("gmres", "bcgs"/
    "bicgstab", "cg", "richardson", "preonly").  For per-column control
    with other methods, map a ``make_solver`` closure over columns instead.

    ``transpose=True`` serves A^T X = B on the same stored factors
    (PC.transpose; vmapped apply when the transposed PC has no native
    multi-RHS form).

    ``nullspace`` / ``transpose_nullspace``: as in :func:`make_solver`
    (NullSpace.remove handles [n, r] batches natively).
    """
    from .krylov_many import MANY_SOLVERS
    opts = options or Options()
    ksp_type = ksp_type or opts.get_string("ksp_type", "bcgs")
    if ksp_type not in MANY_SOLVERS:
        raise ValueError(
            f"no batched engine for ksp_type {ksp_type!r}: available "
            f"{sorted(set(MANY_SOLVERS))} (other methods: lax.map a "
            "make_solver closure over columns)")
    method = MANY_SOLVERS[ksp_type]
    if pc is None:
        name = pc_type or opts.get_string("pc_type", "none")
        pc = make_pc(name, A if pmat is None else pmat, opts)
    if transpose:
        from .operator import transpose_operator
        A = transpose_operator(A)
        pc = pc.transpose() if pc.name != "none" else pc
        nullspace, transpose_nullspace = (
            transpose_nullspace if transpose_nullspace is not None
            else nullspace, nullspace)
    # true multi-RHS operator apply: the operator streams once per iteration
    # for ALL r columns (as_matvec_many routes wide bands through batched
    # [b,b]@[b,r] products; a vmap of the single-RHS matvec would
    # re-stream it per column)
    from .operator import as_matvec_many
    matvec_many, n, op_dtype = as_matvec_many(
        A, n_hint=n_hint, impl=opts.get_string("mat_matvec_impl", "auto"))
    if nullspace is None and opts.get_bool("ksp_nullspace_constant", False):
        from .nullspace import make_nullspace
        nullspace = make_nullspace(
            n, constant=True,
            dtype=op_dtype if op_dtype is not None else jnp.float32)
    ns, tns = nullspace, (transpose_nullspace if transpose_nullspace
                          is not None else nullspace)
    if tns is not None:
        # left-null-space drift projection of the residual-space outputs
        # (see make_solver); NullSpace.remove batches over [n, r]
        base_mv_many = matvec_many
        matvec_many = lambda X: tns.remove(base_mv_many(X))  # noqa: E731
    if pc.name == "none":
        pc_apply_many = None
    else:
        pc_apply_many = pc.apply_many or jax.vmap(pc.apply, in_axes=1,
                                                  out_axes=1)
    if ns is not None and pc_apply_many is not None:
        # KSP_PCApply-style projection of every PC output (see make_solver)
        base_pcm = pc_apply_many
        pc_apply_many = lambda X: ns.remove(base_pcm(X))  # noqa: E731
    kw = _params_from_options(opts, params)
    for extra in ("norm_type", "monitor_true"):    # not in the batched
        kw.pop(extra, None)                        # engines' surface
    if ksp_type == "richardson":
        sc = opts.get_real("ksp_richardson_scale", None)
        if sc is not None:
            kw.setdefault("scale", sc)

    def _solve(B, X0=None):
        if tns is not None:
            B = tns.remove(B)
        res = method(matvec_many, B, X0, pc_apply_many, **kw)
        if ns is not None:
            import dataclasses as _dc
            res = _dc.replace(res, x=ns.remove(res.x))
        return res

    return jit_closure(_solve) if jit else _solve


def solve_many(A, B, X0=None, *, pmat=None,
               options: Optional[Options] = None,
               ksp_type: Optional[str] = None, pc_type: Optional[str] = None,
               pc: Optional[PC] = None, transpose: bool = False,
               **params) -> KSPResult:
    """One-shot batched multi-RHS solve (PETSc KSPMatSolve role):
    ``solve_many(A, B[n, r])`` -> column-batched KSPResult.  Options-driven
    like ``solve``; composes ``make_solver_many`` (one iteration loop for
    all columns, native multi-RHS PCApply)."""
    solver = make_solver_many(A, pmat=pmat, options=options,
                              ksp_type=ksp_type, pc_type=pc_type, pc=pc,
                              n_hint=B.shape[0] if hasattr(B, "shape")
                              else None,
                              jit=False, transpose=transpose, **params)
    B = jnp.asarray(B)
    return solver(B, None if X0 is None else jnp.asarray(X0))


def solve(A, b, x0=None, *, pmat=None, options: Optional[Options] = None,
          ksp_type: Optional[str] = None, pc_type: Optional[str] = None,
          pc: Optional[PC] = None, monitor: bool = False,
          view: bool = False, transpose: bool = False,
          **params) -> KSPResult:
    """One-shot options-driven solve (KSPSolve equivalent).

    ``pmat`` is the preconditioning matrix B when it differs from A — exactly
    KSPSetOperators(ksp, A, B) (/root/reference/src/testbed.c:314).
    ``view=True`` prints the configured solver hierarchy before solving
    (PETSc ``-ksp_view``).  ``transpose=True`` solves A^T x = b
    (KSPSolveTranspose; the PC reuses its stored factors via
    PC.transpose())."""
    opts = options or Options()
    unscale = None
    if opts.get_bool("ksp_diagonal_scale", False):
        # PETSc KSPSetDiagonalScale / -ksp_diagonal_scale: symmetrically
        # scale the system by s = 1/sqrt(|diag(pmat)|) — solve
        # (S A S)(S^-1 x) = S b, return x = S y.  The residual history is
        # that of the scaled system, as in PETSc.  -ksp_diagonal_scale_fix
        # is accepted and a no-op: this library never mutates the caller's
        # operators, so they are always "restored".
        from ..ops.band import (BandedMatrix, banded_diagonal,
                                banded_diagonal_scale)
        opts.get_bool("ksp_diagonal_scale_fix", True)
        if pc is not None:
            raise ValueError(
                "-ksp_diagonal_scale with an explicitly constructed PC is "
                "ambiguous (the PC was built from the UNSCALED operators); "
                "pass pc_type/options and let solve build it")
        base = A if pmat is None else pmat
        if not isinstance(A, BandedMatrix) or \
                not isinstance(base, BandedMatrix):
            raise ValueError(
                "-ksp_diagonal_scale needs banded operators (a matrix-free "
                "operator has no accessible diagonal); scale the system "
                "yourself for callable operators")
        d = banded_diagonal(base)
        ad = jnp.abs(d)
        s = jnp.where(ad > 0, 1.0 / jnp.sqrt(jnp.where(ad > 0, ad, 1)),
                      1.0).astype(d.real.dtype)
        A = banded_diagonal_scale(A, s, s)
        if pmat is not None:
            pmat = banded_diagonal_scale(pmat, s, s)
        b = s * jnp.asarray(b)
        if x0 is not None:
            x0 = jnp.asarray(x0) / s
        unscale = s
    if pc is None:
        name = pc_type or opts.get_string("pc_type", "none")
        pc = make_pc(name, A if pmat is None else pmat, opts)
    if view:
        kt = ksp_type or opts.get_string("ksp_type", "gmres")
        n = b.shape[0] if hasattr(b, "shape") else None
        print(view_str(kt, _params_from_options(opts, params), pc, n=n))
    solver = make_solver(A, pmat=pmat, options=options, ksp_type=ksp_type,
                         pc_type=pc_type, pc=pc,
                         n_hint=b.shape[0] if hasattr(b, "shape") else None,
                         jit=False, transpose=transpose, **params)
    b = jnp.asarray(b)
    res = solver(b, None if x0 is None else jnp.asarray(x0))
    if unscale is not None:
        import dataclasses
        res = dataclasses.replace(res, x=res.x * unscale)
    if opts.get_bool("ksp_error_if_not_converged", False) \
            and int(res.reason) <= 0:
        # PETSc -ksp_error_if_not_converged: fail fast instead of letting
        # a diverged solution flow downstream
        from .types import reason_str
        raise RuntimeError(
            f"KSPSolve did not converge: {reason_str(res.reason)} after "
            f"{int(res.its)} iterations (rnorm {float(res.rnorm):.3e})")
    if monitor:
        import numpy as _np
        print_monitor(res, bnorm=float(_np.linalg.norm(_np.asarray(b))))
    if opts.get_bool("ksp_compute_eigenvalues", False):
        # PETSc -ksp_compute_eigenvalues: Ritz estimates of the
        # preconditioned operator's spectrum after the solve.  PETSc reads
        # them from the solver's own Hessenberg; here a dedicated Arnoldi
        # run (same operator, same PC, b as the starting vector) computes
        # them — identical estimates for GMRES, and available for every
        # KSP type.
        import numpy as _np
        op = A
        if transpose:
            from .operator import transpose_operator
            op = transpose_operator(A)
        mv, n, dt = as_matvec(op, n_hint=b.shape[0],
                              impl=opts.get_string("mat_matvec_impl",
                                                   "auto"))
        pcx = pc.transpose() if transpose and pc.name != "none" else pc
        eigs = krylov.estimate_extreme_eigs(
            mv, n, dt, m=min(n, max(int(res.its), 2), 30),
            pc_apply=pcx.apply if pcx.name != "none" else None,
            v0=b.astype(dt))
        order = _np.argsort(eigs.real)
        print("Iteratively computed eigenvalues")
        for e in eigs[order]:
            print(f"{e.real:g} + {e.imag:g}i")
    if opts.get_bool("ksp_compute_singularvalues", False):
        # PETSc -ksp_compute_singularvalues / KSPComputeExtremeSingular-
        # Values: extreme singular values (condition estimate) of the
        # preconditioned operator, here from a post-solve Golub–Kahan run
        # riding the transpose stack (A^T matvec + PC.transpose on stored
        # factors)
        from .operator import transpose_operator
        op = A
        if transpose:
            op = transpose_operator(A)
        impl = opts.get_string("mat_matvec_impl", "auto")
        mv, n, dt = as_matvec(op, n_hint=b.shape[0], impl=impl)
        mvt, _, _ = as_matvec(transpose_operator(op), n_hint=b.shape[0],
                              impl=impl)
        pcx = pc.transpose() if transpose and pc.name != "none" else pc
        pc_fwd = pcx.apply if pcx.name != "none" else None
        pc_tr = pcx.transpose().apply if pcx.name != "none" else None
        smax, smin = krylov.estimate_extreme_singular_values(
            mv, mvt, n, dt,
            m=min(n, max(2 * max(int(res.its), 2), 10), 60),
            pc_apply=pc_fwd, pc_apply_transpose=pc_tr, v0=b.astype(dt))
        cond = smax / smin if smin > 0 else float("inf")
        print(f"Iteratively computed extreme singular values: "
              f"max {smax:g} min {smin:g} max/min {cond:g}")
    return res


def view_str(ksp_type: str, params: dict, pc: Optional[PC],
             n: Optional[int] = None) -> str:
    """-ksp_view text: the configured solver hierarchy, PETSc KSPView/PCView
    style (the reference inspects solvers the same way through PETSc's
    options-driven viewers; cf. PCView_Banded,
    /root/reference/src/matbanded.c:196-211)."""
    lines = ["KSP Object:", f"  type: {ksp_type}"]
    if ksp_type in ("gmres", "fgmres"):
        lines.append(f"    restart={params.get('restart', 30)}, modified "
                     "Gram-Schmidt, Givens-rotation least squares")
    if ksp_type == "chebyshev":
        lines.append("    eigenvalue bounds from preset/power estimates")
    lines.append(f"  maximum iterations={params.get('maxit')}")
    lines.append(f"  tolerances: relative={params.get('rtol'):g}, "
                 f"absolute={params.get('atol'):g}, "
                 f"divergence={params.get('divtol'):g}")
    side = params.get("side", "right" if ksp_type == "fgmres" else "left")
    lines.append(f"  {side} preconditioning")
    if n is not None:
        lines.append(f"  operator size: {n} x {n}")
    if pc is None or pc.name == "none":
        lines.append("PC Object:\n  type: none")
    else:
        lines.append("PC Object:")
        lines.append(pc.describe(1))
    return "\n".join(lines)


def print_monitor(res: KSPResult, bnorm=None) -> None:
    """-ksp_monitor style residual printout; when the solver recorded
    unpreconditioned norms, prints both columns like PETSc's
    -ksp_monitor_true_residual (/root/reference/src/makefile:18).

    ``bnorm``: ||b|| for the ||r(i)||/||b|| column.  Without it the initial
    true residual is used — identical for zero initial guesses, but pass
    the real ||b|| when monitoring warm-started solves."""
    import numpy as np

    from .types import reason_str
    h = np.asarray(res.history)
    th = None if res.true_history is None else np.asarray(res.true_history)
    tb = None
    if th is not None:
        tb = float(bnorm) if bnorm is not None else float(th[0])
        if not np.isfinite(tb) or tb <= 0:
            tb = 1.0
    for i in range(int(res.its) + 1):
        if np.isfinite(h[i]):
            if th is not None and np.isfinite(th[i]):
                print(f"{i:5d} KSP preconditioned resid norm {h[i]:.12e} "
                      f"true resid norm {th[i]:.12e} ||r(i)||/||b|| "
                      f"{th[i] / tb:.12e}")
            else:
                print(f"{i:5d} KSP Residual norm {h[i]:.12e}")
    print(f"Converged reason: {reason_str(res.reason)} after {int(res.its)} its")
