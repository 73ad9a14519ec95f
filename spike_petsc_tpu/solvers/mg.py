"""Geometric multigrid preconditioner for banded operators (PCMG role).

The reference reaches multigrid through PETSc's registry (``-pc_type mg``);
here the capability is rebuilt for the banded operators this
framework owns:

* **Hierarchy**: 1-D factor-2 coarsening with linear interpolation P and
  full-weighting restriction R = P^T; coarse operators are Galerkin
  products A_c = P^T A P, formed once at setup on the host (scipy sparse)
  and re-extracted as device bands — the bandwidth roughly halves per
  level, so the whole hierarchy costs ~2x the fine band's memory.
* **Smoothers**: weighted block-Jacobi (default omega 2/3) or block-SSOR
  (``solvers.pc.pc_sor``) — both jittable device sweeps.
* **Coarse solve**: exact single-partition SPIKE factorization.
* **Apply**: a V(pre, post)-cycle staged as one XLA computation; grid
  transfers are matrix-free interleave/fold ops (no gathers).

Geometric 1-D coarsening suits banded operators whose graph is 1-D-elliptic
(the tridiagonal/narrow-band Laplacians of BASELINE config 1); for general
reordered sparse systems prefer the SPIKE/ASM factorization PCs.  The win
over a direct factorization is O(n·w) setup+apply versus O(n·b²): at narrow
bandwidth and large n the V-cycle PC is the cheaper route to mesh-size-
independent iteration counts.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..ops.band import BandedMatrix, banded_diagonal, banded_matvec
from ..ops.spike import spike_factor, spike_solve, spike_transpose
from ..utils.options import Options
from .pc import PC, _as_banded, register_pc


def _band_to_csr(band: BandedMatrix) -> sp.csr_matrix:
    """Host CSR from diagonal-offset band storage (data[i, d] = A[i, i+d-kl])."""
    n, kl, ku = band.n, band.kl, band.ku
    data = np.asarray(band.data, dtype=np.float64)
    diags, offs = [], []
    for j in range(kl + ku + 1):
        d = j - kl
        v = data[max(0, -d):n - max(0, d), j]
        if v.size:
            diags.append(v)
            offs.append(d)
    return sp.diags(diags, offs, shape=(n, n), format="csr")


def _interp(n_f: int) -> sp.csr_matrix:
    """1-D linear interpolation P: [n_f, n_c] with coarse points at even
    fine indices (vectorized build — n can be 1e6+)."""
    n_c = (n_f + 1) // 2
    even = np.arange(0, n_f, 2)
    odd = np.arange(1, n_f, 2)
    rows = [even, odd]
    cols = [even // 2, odd // 2]
    vals = [np.ones(even.size), np.full(odd.size, 0.5)]
    right = odd // 2 + 1
    keep = right < n_c
    rows.append(odd[keep])
    cols.append(right[keep])
    vals.append(np.full(keep.sum(), 0.5))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_f, n_c))


def _prolong(xc: jax.Array, n_f: int) -> jax.Array:
    """Device P @ xc (matrix-free interleave)."""
    xc_next = jnp.concatenate([xc[1:], jnp.zeros_like(xc[:1])], axis=0)
    odd = 0.5 * (xc + xc_next)
    xf = jnp.stack([xc, odd], axis=1).reshape(-1)
    return xf[:n_f]


def _restrict(rf: jax.Array, n_c: int) -> jax.Array:
    """Device P^T @ rf (matrix-free fold)."""
    rfp = jnp.zeros((2 * n_c,), rf.dtype).at[:rf.shape[0]].set(rf)
    pairs = rfp.reshape(n_c, 2)
    even, oddv = pairs[:, 0], pairs[:, 1]
    odd_prev = jnp.concatenate([jnp.zeros_like(oddv[:1]), oddv[:-1]], axis=0)
    return even + 0.5 * (oddv + odd_prev)


class _Level:
    __slots__ = ("band", "smooth", "smooth_t", "n")

    def __init__(self, band, smooth, smooth_t):
        self.band = band
        self.smooth = smooth        # r -> approximate A^{-1} r
        self.smooth_t = smooth_t    # transpose smoother (for M^{-T})
        self.n = band.n


def _make_smoother(band: BandedMatrix, kind: str, opts: Options):
    """Returns (smooth, smooth_t): jittable approximate inverses used as
    x += smooth(r - A x).  smooth_t applies the TRANSPOSE smoother."""
    if kind == "jacobi":
        omega = float(opts.get_real("pc_mg_jacobi_omega", 2.0 / 3.0))
        d = banded_diagonal(band)
        dinv = omega * jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 1.0)
        f = lambda r: dinv * r
        return f, f                     # diagonal: self-transpose
    if kind == "sor":
        from .pc import make_pc
        pc = make_pc("sor", band, opts.scoped("mg_smoother_"))
        return pc.apply, pc.transpose().apply
    raise ValueError(f"unknown -pc_mg_smoother {kind!r} (jacobi | sor)")


def _build_hierarchy(band: BandedMatrix, opts: Options):
    """Galerkin hierarchy: list of _Level + the coarse factorization."""
    kind = opts.get_string("pc_mg_smoother", "jacobi")
    coarse_size = opts.get_int("pc_mg_coarse_size", 64)
    max_levels = opts.get_int("pc_mg_levels", 0)       # 0 = auto
    dtype = band.dtype

    levels = [_Level(band, *_make_smoother(band, kind, opts))]
    a = _band_to_csr(band)
    while levels[-1].n > max(2 * coarse_size, 4) and (
            max_levels <= 0 or len(levels) < max_levels):
        n_f = a.shape[0]
        P = _interp(n_f)
        a = (P.T @ a @ P).tocsr()
        a.eliminate_zeros()
        from .. import sparse as hsp
        data, kl, ku = hsp.csr_to_banded_arrays(a)
        cband = BandedMatrix(data=jnp.asarray(data, dtype=dtype), kl=kl,
                             ku=ku)
        levels.append(_Level(cband, *_make_smoother(cband, kind, opts)))
    cb = levels[-1].band
    fact = spike_factor(cb, K=1, inverter="auto")
    fact_t = spike_transpose(fact, band=cb)
    return levels, fact, fact_t


def _make_vcycle(levels, fact, pre: int, post: int, transposed: bool,
                 fact_t=None):
    """Build the jittable V(pre, post)-cycle closure.

    ``transposed=True`` applies the EXACT transpose of the forward cycle:
    A^T matvecs, transposed smoothers with pre/post swapped, transposed
    coarse solve — P and R = P^T swap into each other, so the grid
    transfers are reused as-is.  This is what makes PCApplyTranspose exact
    for bicg/adjoint solves.
    """
    from ..ops.band import banded_matvec_t

    mv = banded_matvec_t if transposed else banded_matvec
    npre, npost = (post, pre) if transposed else (pre, post)

    def cycle(lvl: int, r: jax.Array) -> jax.Array:
        if lvl == len(levels) - 1:
            sol = fact_t if transposed else fact
            return spike_solve(sol, r)
        L = levels[lvl]
        smooth = L.smooth_t if transposed else L.smooth
        if npre > 0:
            x = smooth(r)
            for _ in range(npre - 1):
                x = x + smooth(r - mv(L.band, x))
        else:
            x = jnp.zeros_like(r)
        resid = r - mv(L.band, x)
        n_c = levels[lvl + 1].n
        xc = cycle(lvl + 1, _restrict(resid, n_c))
        x = x + _prolong(xc, L.n)
        for _ in range(npost):
            x = x + smooth(r - mv(L.band, x))
        return x

    return partial(cycle, 0)


@register_pc("mg")
def pc_mg(pmat, opts: Options) -> PC:
    """Geometric multigrid V-cycle preconditioner (``-pc_type mg``).

    Options: ``-pc_mg_levels`` (0 = coarsen until ``-pc_mg_coarse_size``,
    default 64), ``-pc_mg_smoother jacobi|sor`` (jacobi), ``-pc_mg_
    jacobi_omega`` (2/3), ``-pc_mg_smooth_down/-pc_mg_smooth_up`` (1/1),
    smoother sub-options under the ``mg_smoother_`` prefix (e.g.
    ``-mg_smoother_pc_sor_omega``).  See the module docstring for the
    design and the operator class it suits.
    """
    band = _as_banded(pmat, opts)
    pre = opts.get_int("pc_mg_smooth_down", 1)
    post = opts.get_int("pc_mg_smooth_up", 1)
    levels, fact, fact_t = _build_hierarchy(band, opts)
    apply = _make_vcycle(levels, fact, pre, post, transposed=False)
    info = dict(levels=len(levels),
                coarse_n=levels[-1].n,
                smoother=opts.get_string("pc_mg_smoother", "jacobi"),
                smooth=(pre, post))

    def apply_many(R):
        return jax.vmap(apply, in_axes=1, out_axes=1)(R)

    def _mk_transpose(_info=info):
        at = _make_vcycle(levels, fact, pre, post, transposed=True,
                          fact_t=fact_t)
        return PC(name="mg_transpose", apply=at,
                  apply_many=lambda R: jax.vmap(at, in_axes=1,
                                                out_axes=1)(R),
                  info=_info)

    return PC(name="mg", apply=apply, apply_many=apply_many, info=info,
              make_transpose=_mk_transpose)
