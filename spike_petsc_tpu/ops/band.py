"""Banded matrix storage and core operations.

The reference stores banded approximations as general sparse AIJ matrices and
re-extracts them per run (`MatCreateSubMatrixBanded`,
/root/reference/src/matbanded.c:22-107).  Here we instead keep a dense
*diagonal-offset* layout

    data[i, d] == A[i, i + d - kl]   for d in [0, kl + ku],

i.e. row ``i`` of ``data`` holds the in-band entries of row ``i`` of ``A``
left-aligned at offset ``-kl``.  Out-of-range positions are zero.  This layout

* is a single contiguous ``[n, w]`` array in device memory
  (``w = kl + ku + 1``),
* turns SpMV into ``w`` shifted axpys (or one gather + row reduction),
* reshapes for free into block-tridiagonal form (see ``blocktri.py``) whose
  factorization runs as batched ``b x b`` matmuls.

Everything here is jittable; host-side sparse preprocessing lives in
``spike_petsc_tpu.sparse``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BandedMatrix:
    """Banded matrix in diagonal-offset storage.

    Attributes:
      data: ``[n, kl + ku + 1]`` array; ``data[i, d] = A[i, i + d - kl]``.
      kl:   number of subdiagonals (static).
      ku:   number of superdiagonals (static).
    """

    data: jax.Array
    kl: int = field(metadata=dict(static=True))
    ku: int = field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.kl + self.ku + 1

    @property
    def dtype(self):
        return self.data.dtype


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------

def banded_from_dense(a: jax.Array, kl: int, ku: int) -> BandedMatrix:
    """Extract the [-kl, ku] band of a dense matrix into offset storage."""
    n = a.shape[0]
    rows = jnp.arange(n)[:, None]
    offs = jnp.arange(-kl, ku + 1)[None, :]
    cols = rows + offs
    valid = (cols >= 0) & (cols < n)
    data = jnp.where(valid, a[rows, jnp.clip(cols, 0, n - 1)], 0)
    return BandedMatrix(data=data, kl=kl, ku=ku)


def banded_to_dense(b: BandedMatrix) -> jax.Array:
    n, kl, ku = b.n, b.kl, b.ku
    rows = jnp.arange(n)[:, None]
    offs = jnp.arange(-kl, ku + 1)[None, :]
    cols = rows + offs
    valid = (cols >= 0) & (cols < n)
    a = jnp.zeros((n, n), b.dtype)
    return a.at[rows, jnp.clip(cols, 0, n - 1)].add(jnp.where(valid, b.data, 0))


def banded_from_coo(rows, cols, vals, n: int, kl: int, ku: int,
                    dtype=None) -> BandedMatrix:
    """Scatter COO triplets into band storage; out-of-band entries dropped.

    Jittable analogue of the copy loop in the reference's banded extraction
    (/root/reference/src/matbanded.c:84-99).
    """
    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    vals = jnp.asarray(vals, dtype=dtype)
    off = cols - rows + kl
    inband = (off >= 0) & (off <= kl + ku)
    w = kl + ku + 1
    # route out-of-band entries to a scratch row that we drop afterwards
    r = jnp.where(inband, rows, n)
    d = jnp.where(inband, off, 0)
    data = jnp.zeros((n + 1, w), vals.dtype).at[r, d].add(vals)
    return BandedMatrix(data=data[:n], kl=kl, ku=ku)


def banded_transpose(b: BandedMatrix) -> BandedMatrix:
    """Transpose in band storage: A^T[i, i+d] = A[i+d, i].

    dataT[i, j'] = data[i + j' - ku, (w-1) - j']: each transposed diagonal
    is a row-shifted copy of the mirrored source diagonal — w static
    shifted slices, streamed without a gather.  Very wide bands keep the
    gather (setup-time only).
    """
    n, kl, ku = b.n, b.kl, b.ku
    w = b.width
    if w <= 512:
        cols = []
        for jp in range(w):
            src = b.data[:, w - 1 - jp]
            s = jp - ku                      # row shift
            if s >= 0:
                col = jnp.pad(src[s:], (0, min(s, n)))
            else:
                col = jnp.pad(src[:n + s], (min(-s, n), 0))
            cols.append(col[:n])
        data = jnp.stack(cols, axis=1)
        return BandedMatrix(data=data, kl=ku, ku=kl)
    rows = jnp.arange(n)[:, None]
    offs = jnp.arange(-ku, kl + 1)[None, :]           # transposed band widths swap
    src_row = rows + offs                             # A^T[i, i+d] = A[i+d, i]
    src_off = -offs + kl                              # column i = (i+d) + (i - (i+d)) -> offset -d
    valid = (src_row >= 0) & (src_row < n)
    data = jnp.where(
        valid,
        b.data[jnp.clip(src_row, 0, n - 1), src_off],
        0,
    )
    return BandedMatrix(data=data, kl=ku, ku=kl)


# ---------------------------------------------------------------------------
# Matvec
# ---------------------------------------------------------------------------

def banded_matvec(b: BandedMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x for band storage: w shifted axpys
    y[i] = sum_d data[i, d] * x[i + d - kl].

    The unrolled shifted-slice form fuses into one elementwise XLA kernel
    that streams the band once (no gather).  On the H100 it was the faster
    of this form and a diagonal-major [w, n] copy of the band (PERF.md).
    Very wide bands fall back to a fori_loop over diagonals to keep the
    program size bounded.  Supports x of shape [n] or [n, nrhs].
    """
    n, kl, ku = b.n, b.kl, b.ku
    w = b.width
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    xp = jnp.pad(x, ((kl, ku), (0, 0)))
    if w <= 512:
        y = jnp.zeros_like(x)
        for d in range(w):
            y = y + b.data[:, d:d + 1] * \
                jax.lax.dynamic_slice_in_dim(xp, d, n, axis=0)
    else:
        def body(d, acc):
            col = jax.lax.dynamic_slice_in_dim(b.data, d, 1, axis=1)
            seg = jax.lax.dynamic_slice_in_dim(xp, d, n, axis=0)
            return acc + col * seg
        y = jax.lax.fori_loop(0, w, body, jnp.zeros_like(x))
    return y[:, 0] if squeeze else y


def banded_matvec_t(b: BandedMatrix, x: jax.Array) -> jax.Array:
    """y = A^T @ x."""
    return banded_matvec(banded_transpose(b), x)


def banded_diagonal(b: BandedMatrix) -> jax.Array:
    """Main diagonal of A (MatGetDiagonal equivalent,
    /root/reference/src/testbed.c:223)."""
    return b.data[:, b.kl]


def banded_diagonal_scale(b: BandedMatrix, dr=None, dc=None) -> BandedMatrix:
    """diag(dr) @ A @ diag(dc) in band storage, either factor optional
    (MatDiagonalScale equivalent — the reference applies the WBM scaling
    vectors this way, /root/reference/src/wbm.c:570).

    Row scaling is a broadcast multiply; column scaling multiplies each
    stored diagonal by a shifted slice of ``dc`` (same shifted-slice pattern
    as :func:`banded_matvec`, with no per-entry gather).
    Jittable; returns a new matrix (inputs are never mutated).
    """
    data = b.data
    n, kl, ku, w = b.n, b.kl, b.ku, b.width
    if dr is not None:
        data = data * jnp.asarray(dr, data.dtype)[:, None]
    if dc is not None:
        dcp = jnp.pad(jnp.asarray(dc, data.dtype), (kl, ku))
        if w <= 512:
            cols = [data[:, d] * jax.lax.dynamic_slice_in_dim(dcp, d, n)
                    for d in range(w)]
            data = jnp.stack(cols, axis=1)
        else:
            def body(d, acc):
                col = jax.lax.dynamic_slice_in_dim(acc, d, 1, axis=1)
                seg = jax.lax.dynamic_slice_in_dim(dcp, d, n)[:, None]
                return jax.lax.dynamic_update_slice_in_dim(
                    acc, col * seg, d, axis=1)
            data = jax.lax.fori_loop(0, w, body, data)
    return BandedMatrix(data=data, kl=kl, ku=ku)


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def banded_shift(b: BandedMatrix, alpha) -> BandedMatrix:
    """A + alpha*I in band storage (MatShift equivalent — the role of
    PETSc's ``-pc_factor_shift_*`` pre-shifts, cf. the nonzero-shift in the
    reference's canned recipe, /root/reference/src/makefile:17-18)."""
    return BandedMatrix(data=b.data.at[:, b.kl].add(alpha), kl=b.kl, ku=b.ku)


def banded_scale(b: BandedMatrix, alpha) -> BandedMatrix:
    """alpha * A (MatScale equivalent)."""
    return BandedMatrix(data=b.data * alpha, kl=b.kl, ku=b.ku)


def banded_axpy(y: BandedMatrix, alpha, x: BandedMatrix) -> BandedMatrix:
    """Y + alpha * X in band storage (MatAXPY equivalent).  The result's
    band is the union of the operands' bands; widening is a zero pad of
    the diagonal-offset axis, so mismatched bands cost one copy."""
    if y.n != x.n:
        raise ValueError(f"banded_axpy: size mismatch {y.n} vs {x.n}")
    kl, ku = max(y.kl, x.kl), max(y.ku, x.ku)

    def expand(m: BandedMatrix) -> jax.Array:
        return jnp.pad(m.data, ((0, 0), (kl - m.kl, ku - m.ku)))

    return BandedMatrix(data=expand(y) + alpha * expand(x), kl=kl, ku=ku)


def banded_bandwidth(b: BandedMatrix, tol: float = 0.0) -> tuple:
    """Effective (kl, ku) of the stored band: the largest offsets with any
    entry of magnitude > tol.  Mirrors MatComputeBandwidth
    (/root/reference/src/testbed.c:209)."""
    mask = jnp.abs(b.data) > tol
    any_off = jnp.any(mask, axis=0)                    # [w]
    offs = jnp.arange(-b.kl, b.ku + 1)
    kl_eff = jnp.max(jnp.where(any_off, -offs, 0))
    ku_eff = jnp.max(jnp.where(any_off, offs, 0))
    return kl_eff, ku_eff


def pad_banded(b: BandedMatrix, n_pad: int, unit_diagonal: bool = True) -> BandedMatrix:
    """Pad to ``n_pad`` rows; padding rows get a unit diagonal so the padded
    operator stays nonsingular (identity on the padding subspace)."""
    if n_pad == b.n:
        return b
    extra = n_pad - b.n
    pad = jnp.zeros((extra, b.width), b.dtype)
    if unit_diagonal:
        pad = pad.at[:, b.kl].set(1)
    return BandedMatrix(data=jnp.concatenate([b.data, pad], axis=0), kl=b.kl, ku=b.ku)


def banded_from_numpy_dense(a: np.ndarray, kl: int, ku: int) -> BandedMatrix:
    return banded_from_dense(jnp.asarray(a), kl, ku)


def extract_banded_device(rows, cols, vals, n: int, kmax: int = 50,
                          frac: float = 0.95):
    """Norm-fraction band selection + extraction entirely on device.

    Jittable twin of sparse.extract_banded / MatCreateSubMatrixBanded
    (/root/reference/src/matbanded.c:38-103): a segment-sum histogram of
    |a_ij| by diagonal distance, cumulative-sum bandwidth pick (smallest
    k < kmax reaching frac of the 1-norm, else kmax), then a masked scatter
    into band storage of width 2*kmax+1 (static shape; entries beyond the
    chosen k are zeroed).  Returns (BandedMatrix, k, achieved_frac);
    note kl = ku = kmax statically — slice down on host if a tight band is
    needed.
    """
    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    vals = jnp.asarray(vals)
    dist = jnp.abs(rows - cols)
    absval = jnp.abs(vals)
    hist = jax.ops.segment_sum(absval, jnp.minimum(dist, n - 1),
                               num_segments=n)
    norm_a = jnp.sum(absval)
    cum = jnp.cumsum(hist)
    reached = cum >= frac * norm_a
    first = jnp.argmax(reached)
    k = jnp.where(jnp.any(reached[:kmax]), first, kmax).astype(jnp.int32)
    norm_b = cum[jnp.minimum(k, n - 1)]
    keep = dist <= k
    bm = banded_from_coo(rows, cols, jnp.where(keep, vals, 0), n, kmax, kmax)
    achieved = jnp.where(norm_a > 0, norm_b / norm_a, 1.0)
    return bm, k, achieved
