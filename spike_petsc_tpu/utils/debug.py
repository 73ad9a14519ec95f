"""Numerical-health checks: typed factorization status, NaN guards, f64
shadow runs.

The reference's failure model is fail-fast SETERRQ plus MC64's structured
INFO(1) codes (+1 structurally singular, +2 scaling overflow,
/root/reference/src/hslmc64.c:259-287), and its only memory/race tooling is
CHKMEMQ probes (/root/reference/src/wbm.c:254).  On a device the hazards
are numerical: singular Schur pivots inside jit, silent f32 degradation,
NaN propagation.  These helpers surface them as typed results rather than
exceptions inside jit (SURVEY.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# status codes, MC64 INFO(1)-style
OK = 0
SINGULAR = 1            # non-finite factors: a Schur pivot was singular
ILL_CONDITIONED = 2     # pivot growth beyond threshold


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FactorHealth:
    """Jittable health report of a block-Thomas/SPIKE factorization."""

    status: jax.Array        # int32 code
    max_inverse_norm: jax.Array
    nonfinite: jax.Array     # bool


def factor_health(fact, growth_threshold: float = 1e12) -> FactorHealth:
    """Inspect a BlockTriFactor / SpikeFactor pytree for singular or
    exploding pivots (the surface PETSc exposes via -pc_factor_shift checks).
    """
    leaves = [x for x in jax.tree_util.tree_leaves(fact)
              if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
              and x.size > 0]
    nonfinite = jnp.zeros((), bool)
    maxnorm = jnp.zeros(())
    for leaf in leaves:
        nonfinite |= ~jnp.all(jnp.isfinite(leaf))
        maxnorm = jnp.maximum(maxnorm, jnp.max(jnp.abs(leaf)))
    status = jnp.where(nonfinite, SINGULAR,
                       jnp.where(maxnorm > growth_threshold,
                                 ILL_CONDITIONED, OK)).astype(jnp.int32)
    return FactorHealth(status=status, max_inverse_norm=maxnorm,
                        nonfinite=nonfinite)


def check_finite(x, name: str = "array") -> None:
    """Host-side fail-fast NaN/Inf check (CHKMEMQ analogue for numerics)."""
    arr = np.asarray(x)
    if not np.isfinite(arr).all():
        bad = int((~np.isfinite(arr)).sum())
        raise FloatingPointError(
            f"{name}: {bad}/{arr.size} non-finite entries")


def shadow_check(fn, *args, rtol: float = 1e-4, **kwargs):
    """Run ``fn`` twice — as given and with inputs promoted to float64 — and
    report the relative deviation (the 'optional float64 shadow run' of
    SURVEY.md §5).  Returns (result, deviation)."""
    res = fn(*args, **kwargs)

    def promote(x):
        if hasattr(x, "dtype") and jnp.issubdtype(
                jnp.asarray(x).dtype, jnp.floating):
            return jnp.asarray(x, jnp.float64)
        return x

    args64 = jax.tree_util.tree_map(promote, args)
    kwargs64 = jax.tree_util.tree_map(promote, kwargs)
    res64 = fn(*args64, **kwargs64)

    a = np.asarray(jax.tree_util.tree_leaves(res)[0], dtype=np.float64)
    b = np.asarray(jax.tree_util.tree_leaves(res64)[0], dtype=np.float64)
    denom = np.linalg.norm(b) or 1.0
    dev = float(np.linalg.norm(a - b) / denom)
    return res, dev
