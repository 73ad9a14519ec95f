"""Operator normalization: anything matrix-like -> a jittable matvec closure.

The reference's KSP consumes PETSc ``Mat`` objects whose MatMult dispatches by
type (SeqAIJ/MPIAIJ).  Here the "Mat" is whatever the caller has — a
``BandedMatrix``, a ``BlockTridiagonal``, a dense ``jax.Array``, a host SciPy
sparse matrix (shipped to device as BCOO), or an arbitrary callable — and the
KSP layer only ever sees ``matvec: [n] -> [n]``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.band import BandedMatrix, banded_matvec
from ..ops.blocktri import BlockTridiagonal, blocktri_matvec


def _tag(mv, route: str):
    """Annotate a matvec closure with the route that built it (read by
    bench/tests to verify 'auto' dispatch decisions)."""
    mv._route = route
    return mv


_IMPLS = ("auto", "blocktri", "xla")


def _check_impl(impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(f"unknown matvec impl {impl!r}: expected auto, "
                         f"blocktri, or xla (-mat_matvec_impl)")


def _bt_gate(a: BandedMatrix) -> Tuple[bool, bool]:
    """The band->blocktri conversion gate shared by the single- and
    multi-RHS routes: (feasible, wide).

    ``feasible``: the 128-blocked conversion needs b=128 >= max(kl, ku), a
    few tiles of rows, and a real dtype of at most 32 bits.  ``wide``: the
    conversion stores 3*128 values per row against w in band form, so
    'auto' only converts bands wide enough that the blowup is modest
    (< ~4x)."""
    bt_ok = (max(a.kl, a.ku) <= 128 and a.n >= 4 * 128
             and jnp.dtype(a.dtype).itemsize <= 4)
    return bt_ok, bt_ok and a.kl + a.ku + 1 >= 96


def _blocktri_split(a: BandedMatrix):
    """(apply, operand) on the block-tridiagonal conversion: three batched
    [b, b] @ [b] products per block row (ops.blocktri.blocktri_matvec)."""
    from ..ops.blocktri import band_to_blocktri
    T = band_to_blocktri(a, 128)
    nb, b, n = T.nb, T.b, a.n

    def apply_bt(Tm, x):
        xb = jnp.pad(x, (0, nb * b - n)).reshape(nb, b)
        return blocktri_matvec(Tm, xb).reshape(-1)[:n]
    return apply_bt, T


def _band_split(a: BandedMatrix, impl: str):
    """Resolve a BandedMatrix SpMV route to a closure-free triple
    ``(apply, operand, route)`` with ``apply(operand, x)`` pure in its
    array arguments — ``operand`` is the prepared operator pytree, so a
    caller can pass it to a jitted function as an argument instead of
    baking a GB-sized constant into the program.

    'auto' follows a measured tuning record for this card when one exists
    (utils/tuning.py, written by ``tools/tune.py``); otherwise the
    row-major shifted-axpy form, the fastest single-RHS route measured on
    the H100 (PERF.md).  An explicit 'blocktri' on a band the conversion
    cannot take raises."""
    if impl == "auto":
        from ..utils.platform import platform_key
        from ..utils.tuning import matvec_route_hint
        hint = matvec_route_hint(platform_key(),
                                 a.kl + a.ku + 1, dtype=a.dtype, n=a.n)
        impl = "blocktri" if hint == "blocktri" and _bt_gate(a)[0] else "xla"
    if impl == "blocktri":
        if not _bt_gate(a)[0]:
            raise ValueError(
                f"matvec impl 'blocktri' needs max(kl, ku) <= 128, n >= 512 "
                f"and a real dtype of at most 32 bits; got kl={a.kl}, "
                f"ku={a.ku}, n={a.n}, dtype={a.dtype}")
        return (*_blocktri_split(a), "blocktri")
    return banded_matvec, a, "xla"


def as_matvec_split(a, impl: str = "auto"):
    """Closure-free form of :func:`as_matvec` for BandedMatrix operators:
    returns ``(apply, operand, n, dtype)`` with ``apply(operand, x)`` (see
    :func:`_band_split`)."""
    _check_impl(impl)
    if not isinstance(a, BandedMatrix):
        raise TypeError("as_matvec_split supports BandedMatrix operators; "
                        "use as_matvec for other representations")
    apply, operand, route = _band_split(a, impl)
    # tag a per-call wrapper, not the shared library function
    tagged = _tag(lambda op, x: apply(op, x), route)
    return tagged, operand, a.n, a.dtype


def transpose_operator(a):
    """Host-side operator transpose (pure transpose, no conjugation) for
    KSPs that iterate on A^T (`-ksp_type bicg`).  Callables cannot be
    transposed — pass an explicit operator representation."""
    if isinstance(a, BandedMatrix):
        from ..ops.band import banded_transpose
        return banded_transpose(a)
    if isinstance(a, BlockTridiagonal):
        tT = lambda x: jnp.swapaxes(x, -1, -2)
        zb = jnp.zeros_like(a.D[:1])
        return BlockTridiagonal(
            D=tT(a.D),
            L=jnp.concatenate([zb, tT(a.U[:-1])], axis=0),
            U=jnp.concatenate([tT(a.L[1:]), zb], axis=0))
    if callable(a):
        raise TypeError(
            "cannot transpose a bare matvec callable; pass an explicit "
            "operator (BandedMatrix / BlockTridiagonal / sparse / dense) "
            "or supply matvec_transpose yourself")
    try:
        import scipy.sparse as sp
        if sp.issparse(a):
            return a.T.tocsr()
    except ImportError:  # pragma: no cover
        pass
    arr = jnp.asarray(a)
    if arr.ndim == 2:
        return arr.T
    raise TypeError(f"cannot transpose operator of type {type(a)!r}")


def as_matvec(a, n_hint: int = None,
              impl: str = "auto") -> Tuple[Callable, int, object]:
    """Return (matvec, n, dtype) for any supported operator representation.

    ``impl`` selects the BandedMatrix route (ignored for other types):
      * "auto"     — a measured tuning record for this card, else "xla";
      * "blocktri" — a one-time block-tridiagonal conversion, then batched
                     block products (raises where the conversion does not
                     apply);
      * "xla"      — the shifted-axpy form on band storage.
    """
    _check_impl(impl)
    if isinstance(a, BandedMatrix):
        apply, operand, route = _band_split(a, impl)
        return _tag((lambda x: apply(operand, x)), route), a.n, a.dtype

    if isinstance(a, BlockTridiagonal):
        nb, b = a.nb, a.b
        n = nb * b

        def mv(x):
            return blocktri_matvec(a, x.reshape(nb, b)).reshape(n)
        return mv, n, a.dtype

    if callable(a):
        if n_hint is None:
            raise ValueError("callable operator requires n_hint (vector size)")
        return a, n_hint, None

    return _as_matvec_other(a)


def _as_matvec_other(a) -> Tuple[Callable, int, object]:

    # host scipy sparse -> band+outliers split when the matrix has band
    # structure (streamed band, gathered outliers), else device BCOO: a
    # BCOO matvec pays gather cost on every nonzero, the split only on the
    # out-of-band few (ops/split.py).
    try:
        import scipy.sparse as sp
        if sp.issparse(a):
            n = a.shape[0]
            from ..ops.split import split_if_profitable, split_matvec
            sm = split_if_profitable(a)
            if sm is not None:
                return (lambda x: split_matvec(sm, x)), n, sm.dtype
            from jax.experimental import sparse as jsparse
            coo = a.tocoo()
            bcoo = jsparse.BCOO(
                (jnp.asarray(coo.data),
                 jnp.stack([jnp.asarray(coo.row), jnp.asarray(coo.col)], axis=1)),
                shape=coo.shape)

            def mv(x):
                return bcoo @ x
            return mv, n, bcoo.dtype
    except ImportError:  # pragma: no cover
        pass

    arr = jnp.asarray(a) if not isinstance(a, (jax.Array, np.ndarray)) else jnp.asarray(a)
    if arr.ndim == 2:
        n = arr.shape[0]
        return (lambda x: arr @ x), n, arr.dtype

    raise TypeError(f"cannot build a matvec from {type(a)!r}")


def as_matvec_many(a, n_hint: int = None,
                   impl: str = "auto") -> Tuple[Callable, int, object]:
    """Return (matvec_many: [n, r] -> [n, r], n, dtype): a TRUE multi-RHS
    operator apply for batched Krylov serving (solvers/krylov_many.py).

    A ``vmap`` of the single-RHS matvec re-streams the operator once PER
    COLUMN every iteration; here a wide band takes one band->blocktri
    conversion and applies all r columns as batched [b, b] @ [b, r]
    products — the operator blocks stream ONCE per apply for the whole
    batch (the distributed engines do the same via ``local_matvec_many``).

    Dense operators batch natively (``A @ X``).  Everything else (narrow
    bands, sparse, callables) falls back to the vmapped single-RHS route,
    tagged ``vmap_<route>``.

    Memory note: the blocktri route materializes a SECOND at-rest copy of
    the operator at 3*128 floats per row for the closure's lifetime,
    alongside the original band.  The 'auto' width gate keeps the blowup
    < ~4x; ``impl="blocktri"`` forced on a narrow band has no such bound
    (~55x for w=7) — size accordingly when serving n~1e6 operators.
    """
    _check_impl(impl)
    if isinstance(a, BandedMatrix) and impl in ("auto", "blocktri"):
        # same gate as the single-RHS 'auto' (_bt_gate; the conversion's
        # at-rest blowup is the binding constraint, not speed).  The
        # measured tuning record (matvec_route_hint) is intentionally NOT
        # consulted here: it stores single-RHS streaming profiles, and the
        # multi-RHS blocktri apply streams blocks once for ALL r columns —
        # a single-RHS 'xla' winner does not transfer to r>>1.
        # impl='blocktri' forces the route for narrow bands where a large r
        # still amortizes the blowup (see memory note above).
        bt_ok, wide = _bt_gate(a)
        if impl == "blocktri" and not bt_ok:
            _band_split(a, impl)        # raises the conversion-gate error
        if bt_ok and (impl == "blocktri" or wide):
            from ..ops.blocktri import band_to_blocktri
            T = band_to_blocktri(a, 128)
            nb, b = T.nb, T.b

            def mv_many(X):
                Xb = jnp.pad(X, ((0, nb * b - a.n), (0, 0)))
                Xb = Xb.reshape(nb, b, -1)
                return blocktri_matvec(T, Xb).reshape(nb * b, -1)[:a.n]
            return _tag(mv_many, "blocktri_many"), a.n, a.dtype

    if isinstance(a, BlockTridiagonal):
        nb, b = a.nb, a.b
        n = nb * b

        def mv_many(X):
            return blocktri_matvec(a, X.reshape(nb, b, -1)).reshape(n, -1)
        return _tag(mv_many, "blocktri_many"), n, a.dtype

    if not (isinstance(a, BandedMatrix) or callable(a)):
        try:
            import scipy.sparse as sp
            is_sp = sp.issparse(a)
        except ImportError:  # pragma: no cover
            is_sp = False
        if not is_sp:
            arr = jnp.asarray(a)
            if arr.ndim == 2:
                return (_tag((lambda X: arr @ X), "dense_many"),
                        arr.shape[0], arr.dtype)

    mv, n, dt = as_matvec(a, n_hint=n_hint, impl=impl)
    return (_tag(jax.vmap(mv, in_axes=1, out_axes=1),
                 f"vmap_{getattr(mv, '_route', 'op')}"), n, dt)
