"""Null-space handling for singular consistent systems (PETSc MatNullSpace).

The reference's pipeline is built around graph Laplacians (``MatLaplacian``,
/root/reference/src/spectralPartition.c:63-139) whose constant vector is a
null space — L·1 = 0 is a hard-checked invariant there (:264-272).  Solving
such systems with a Krylov method needs two projections:

* **consistency**: the components of b along the LEFT null space (the null
  space of A^T) must be removed, or no solution exists and the iteration
  stalls at the inconsistency floor;
* **uniqueness**: the solution is only defined up to the null space of A —
  projecting the iterates/solution picks the minimal-norm representative.

PETSc attaches this to the Mat (``MatSetNullSpace`` /
``MatSetTransposeNullSpace``; ``MatNullSpaceRemove`` inside KSPSolve).  Here
it is a small orthonormal-basis pytree threaded through
``make_solver(nullspace=...)`` / ``solve(..., nullspace=...)``:

* the operator's matvec output is projected (keeps the Krylov space inside
  range(A) for symmetric problems — PETSc does the equivalent removal on
  the preconditioned residual),
* b is projected by the TRANSPOSE null space (defaults to ``nullspace``
  itself, the symmetric case; pass ``transpose_nullspace=`` when A is
  nonsymmetric with a distinct left null space),
* the returned x is projected by ``nullspace``.

Jittable throughout: ``remove`` is two skinny matmuls ([n, m] with m tiny),
and ``NullSpace`` is a registered dataclass pytree, so it passes freely
through jit/vmap/shard_map boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class NullSpace:
    """An orthonormal basis of a (tiny) null space.

    ``vecs``: [n, m] with orthonormal columns (m = dimension, typically 1).
    ``constant``: informational flag — True when the basis contains the
    normalized constant vector (the PETSc ``has_cnst`` bit).
    """

    vecs: jax.Array
    constant: bool = False

    @property
    def dim(self) -> int:
        return self.vecs.shape[1]

    def remove(self, v: jax.Array) -> jax.Array:
        """Project the null-space components out of ``v`` ([n] or [n, r]) —
        MatNullSpaceRemove."""
        q = self.vecs.astype(v.dtype)
        if jnp.iscomplexobj(v):
            q = q.astype(v.dtype)
        hi = jax.lax.Precision.HIGHEST
        coeff = jnp.matmul(jnp.conj(q).T, v, precision=hi)
        return v - jnp.matmul(q, coeff, precision=hi)


jax.tree_util.register_dataclass(
    NullSpace, data_fields=["vecs"], meta_fields=["constant"])


def make_nullspace(n: Optional[int] = None, *, constant: bool = False,
                   vecs=None, dtype=None) -> NullSpace:
    """Build an orthonormal NullSpace (MatNullSpaceCreate).

    ``constant=True`` includes the normalized constant vector; ``vecs``
    ([n] / [n, m] / sequence of [n]) adds user vectors, orthonormalized
    together with the constant via QR.  The columns must be linearly
    independent (as PETSc requires)."""
    cols = []
    if vecs is not None:
        v = jnp.asarray(vecs)
        if v.ndim == 1:
            v = v[:, None]
        elif v.ndim != 2:
            raise ValueError(f"vecs must be [n] or [n, m], got {v.shape}")
        if dtype is not None:
            v = v.astype(dtype)
        cols.append(v)
        n = v.shape[0] if n is None else n
        if v.shape[0] != n:
            raise ValueError(f"vecs rows {v.shape[0]} != n {n}")
    if constant:
        if n is None:
            raise ValueError("constant nullspace needs n (or vecs)")
        dt = dtype or (cols[0].dtype if cols else jnp.float32)
        one = jnp.ones((n, 1), dt) / jnp.sqrt(jnp.asarray(n, dt))
        cols.insert(0, one)
    if not cols:
        raise ValueError("empty null space: pass constant=True and/or vecs")
    V = jnp.concatenate(cols, axis=1) if len(cols) > 1 else cols[0]
    if V.shape[1] == 1:
        Q = V / jnp.linalg.norm(V, axis=0, keepdims=True)
    else:
        Q, _ = jnp.linalg.qr(V)
    return NullSpace(vecs=Q, constant=constant)
