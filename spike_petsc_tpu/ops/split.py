"""Band + outliers split operator: streamed SpMV for general sparse.

The reference's production workloads are general AIJ matrices (SuiteSparse
fixtures, /root/reference/src/testbed.c:3-8) whose MatMult is the Krylov
hot loop (/root/reference/src/testbed.c:310).  After the WBM/RCM pipeline
most of the weight sits in a central band, but scattered outliers keep the
matrix from being strictly banded — and a BCOO device operator pays
gather/scatter cost on EVERY nonzero.  Split

    A  =  B (band, diagonal-offset storage)  +  R (outlier remainder, COO)

and the n*(2k+1) band entries stream (the shifted-slice XLA form) while
only the few outliers pay the gather + segment-sum path.  The split is EXACT — unlike ``-banded_pre_mat``
(which truncates to build a preconditioner), the remainder keeps every
out-of-band entry, so this is an operator representation, not an
approximation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .band import BandedMatrix, banded_matvec

# cost of one BCOO nonzero relative to one streamed band entry: the BCOO
# matvec's time per nonzero over the band matvec's time per stored entry,
# measured on the H100 at n=1e6 (PERF.md); used only to pick the split
# bandwidth and to decide whether the split beats plain BCOO
_SCALAR_COST = 20


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SplitBandedMatrix:
    """Exact A = band + outliers; outlier triplets sorted by row."""

    band: BandedMatrix
    rows: jax.Array          # [nnz_out] int32 (sorted, ascending)
    cols: jax.Array          # [nnz_out] int32
    vals: jax.Array          # [nnz_out]

    @property
    def n(self) -> int:
        return self.band.n

    @property
    def dtype(self):
        return self.band.dtype

    @property
    def nnz_out(self) -> int:
        return self.vals.shape[0]


def split_cost(n: int, k: int, nnz_out: int) -> float:
    """Relative matvec cost model: streamed band elements + scalar-weighted
    outliers.  Comparable across k and against the all-scalar BCOO cost
    ``_SCALAR_COST * nnz``."""
    return n * (2 * k + 1) + _SCALAR_COST * nnz_out


def split_plan(a, kmax: int = 255):
    """(k, nnz_out, profitable): the cost-optimal split bandwidth, its
    outlier count, and whether the split beats an all-scalar BCOO matvec —
    computed from the |i-j| entry-count histogram alone (no arrays built,
    no device transfers).  ``kmax`` caps the band at w = 2k+1 <= 511, where
    the band matvec still unrolls its diagonals."""
    import scipy.sparse as sp
    coo = sp.csr_matrix(a).tocoo()
    n = coo.shape[0]
    if coo.shape[1] != n:
        # band storage is square-only; rectangular operators (fieldsplit
        # off-diagonal blocks A01/A10) take the BCOO route
        return 0, coo.nnz, False
    dist = np.abs(coo.row - coo.col)
    counts = np.bincount(dist, minlength=n)
    kcap = int(min(kmax, n - 1))
    # outliers remaining beyond each candidate k, and the cost curve
    out_beyond = counts.sum() - np.cumsum(counts)          # nnz with d > k
    ks = np.arange(kcap + 1)
    cost = n * (2 * ks + 1) + _SCALAR_COST * out_beyond[:kcap + 1]
    k = int(np.argmin(cost))
    nnz_out = int(out_beyond[k])
    profitable = bool(split_cost(n, k, nnz_out)
                      < 0.7 * _SCALAR_COST * coo.nnz)
    return k, nnz_out, profitable


def split_from_csr(a, kmax: int = 255, dtype=None) -> SplitBandedMatrix:
    """Build the split operator at the cost-optimal bandwidth (see
    split_plan; widening the band trades n streamed elements per diagonal
    against _SCALAR_COST per outlier it absorbs)."""
    import scipy.sparse as sp
    k, _, _ = split_plan(a, kmax=kmax)
    coo = sp.csr_matrix(a).tocoo()
    n = coo.shape[0]
    dist = np.abs(coo.row - coo.col)
    keep = dist <= k
    data = np.zeros((n, 2 * k + 1), dtype=dtype or coo.data.dtype)
    np.add.at(data, (coo.row[keep], coo.col[keep] - coo.row[keep] + k),
              coo.data[keep])
    r, c, v = coo.row[~keep], coo.col[~keep], coo.data[~keep]
    order = np.argsort(r, kind="stable")
    vals = v[order] if dtype is None else v[order].astype(dtype)
    return SplitBandedMatrix(
        band=BandedMatrix(data=jnp.asarray(data), kl=k, ku=k),
        rows=jnp.asarray(r[order], jnp.int32),
        cols=jnp.asarray(c[order], jnp.int32),
        vals=jnp.asarray(vals))   # canonicalized like the band data


def split_if_profitable(a, kmax: int = 255, dtype=None):
    """The routing entry: None when BCOO wins the cost model (nothing is
    built or transferred in that case), else the built SplitBandedMatrix."""
    _, _, profitable = split_plan(a, kmax=kmax)
    return split_from_csr(a, kmax=kmax, dtype=dtype) if profitable else None


def split_matvec(sm: SplitBandedMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x: vector-speed band + scalar outliers (sorted segment sum)."""
    y = banded_matvec(sm.band, x)
    if sm.nnz_out:
        y = y + jax.ops.segment_sum(
            sm.vals * x[sm.cols], sm.rows, num_segments=sm.n,
            indices_are_sorted=True)
    return y
