"""Differentiable banded solves (implicit-function adjoint).

A capability class the reference cannot offer: ``solve_banded_diff`` is a
banded direct solve that participates in JAX autodiff.  Gradients follow the
standard implicit adjoint of x = A^{-1} b:

    dL/db      = A^{-T} g                      (one transpose SPIKE solve)
    dL/dA      = -(A^{-T} g) x^T  restricted to the band:
    dL/ddata[i, d] = -lam[i] * x[i + d - kl]

so the backward pass REUSES the forward factorization through
``spike_transpose`` (transpose sweeps over the same stored blocks — no band
transpose, no conversion, no new block inversions) plus one solve — and
never differentiates through the factorization recurrences (which would be
both slow and unstable).  This enables end-to-end training/optimization
loops whose inner step is a banded/SPIKE solve (PDE-constrained
optimization, learned preconditioners, differentiable physics).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .band import BandedMatrix
from .spike import spike_factor, spike_solve, spike_transpose


@partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def solve_banded_diff(data: jax.Array, rhs: jax.Array, kl: int, ku: int,
                      K: int = 1) -> jax.Array:
    """Differentiable solve of the banded system defined by diagonal-offset
    ``data`` ([n, kl+ku+1]); gradients flow to both ``data`` and ``rhs``."""
    band = BandedMatrix(data=data, kl=kl, ku=ku)
    sf = spike_factor(band, K=K)
    return spike_solve(sf, rhs)


def _fwd(data, rhs, kl, ku, K):
    band = BandedMatrix(data=data, kl=kl, ku=ku)
    sf = spike_factor(band, K=K)
    x = spike_solve(sf, rhs)
    return x, (sf, x)


def _bwd(kl, ku, K, res, g):
    sf, x = res
    lam = spike_solve(spike_transpose(sf), g)       # A^{-T} g
    # band-restricted outer product: ddata[i, d] = -lam[i] * x[i + d - kl],
    # built from w shifted slices (streamed, no gather; see banded_matvec)
    n = x.shape[0]
    w = kl + ku + 1
    xpad = jnp.pad(x, (kl, ku))
    xg = jnp.stack([jax.lax.dynamic_slice_in_dim(xpad, d, n)
                    for d in range(w)], axis=1)
    ddata = -lam[:, None] * xg
    # the data cotangent must carry the PRIMAL data dtype (sf.Btip keeps it
    # even when factor storage is cast), not the solution dtype — mixed
    # f32-data/f64-rhs runs would otherwise get a promoted gradient
    return ddata.astype(sf.Btip.dtype), lam.astype(x.dtype)


solve_banded_diff.defvjp(_fwd, _bwd)
