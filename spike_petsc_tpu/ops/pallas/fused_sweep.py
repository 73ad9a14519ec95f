"""Block-Thomas sweeps as Pallas kernels for CUDA GPUs (``backend="triton"``).

The XLA path (``ops.spike._batched_tri_solve``) runs each sweep as a
``lax.scan`` whose every step is a small batched ``[K, b, b] @ [K, b, r]``
product: ~nb steps per sweep, each a separate kernel launch moving only a few
MB.  Here each partition is one program that walks its whole block chain
in-kernel:

  * grid = (K, r / rc) — one program per partition (and per chunk of ``rc``
    right-hand sides); nothing carries between programs;
  * the forward kernel runs ``y_i = r_i - F_i y_{i-1}`` with the carry in
    registers and writes ``y`` to device memory;
  * the backward kernel runs ``x_i = Sinv_i (y_i - U_i x_{i+1})`` (or, for
    ``method='spd'`` factors, ``x_i = Sinv_i y_i - F_{i+1}^T x_{i+1}``);
  * factor tiles are loaded inside the loop; their addresses depend only on
    the loop index, so Triton's software pipeliner (``num_stages``) overlaps
    the next tiles' loads with the current step.

Factor tiles may be stored bf16 (``blocktri.cast_factor``): they are promoted
to f32 in registers and every carry stays f32.  Single-RHS matvecs are an
elementwise multiply plus a row reduction in f32.  Multi-RHS products run
through ``pl.dot`` on the tensor cores: three TF32 passes for f32 factors
(near-f32 products), one for bf16 factors (see ``_dot_precision``).

This realizes the banded triangular solves inside the reference's
PCApply_Banded (/root/reference/src/matbanded.c:184-192).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# factor dtypes the kernels stream; carries are f32
_FACTOR_DTYPES = (jnp.float32, jnp.bfloat16)


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def fused_sweep_feasible(fact, b: int, rhs_dtype=jnp.float32) -> bool:
    """Whether the kernels handle these factors: method='inv'/'spd'
    block-Thomas factors stored f32 or bf16, a power-of-two block size
    (Triton tiles), and an f32 right-hand side.  f64 and complex solves
    take the XLA scan."""
    from ..blocktri import BlockTriFactor
    return (isinstance(fact, BlockTriFactor)
            and fact.method in ("inv", "spd")
            and any(jnp.dtype(fact.F.dtype) == jnp.dtype(d)
                    for d in _FACTOR_DTYPES)
            and jnp.dtype(rhs_dtype) == jnp.dtype(jnp.float32)
            and _pow2(b) and b >= 16)


def _mv(m, v):
    """y[a] = sum_c m[a, c] v[c]."""
    return jnp.sum(m * v[None, :], axis=1)


def _mv_t(m, v):
    """y[a] = sum_c m[c, a] v[c] (transposed block)."""
    return jnp.sum(m * v[:, None], axis=0)


def _mm(m, v, precision):
    """[b, b] @ [b, rc] on the tensor cores."""
    return pl.dot(m, v, precision=precision)


def _mm_t(m, v, precision):
    return pl.dot(m, v, trans_a=True, precision=precision)


def _fwd_kernel(f_ref, r_ref, y_ref, *, nb, many, precision):
    # f_ref [nb, b, b]; r_ref / y_ref [nb, b] or [nb, b, rc]
    y0 = r_ref[0].astype(jnp.float32)
    y_ref[0] = y0

    def body(i, y_prev):
        f = f_ref[i].astype(jnp.float32)
        prod = _mm(f, y_prev, precision) if many else _mv(f, y_prev)
        y = r_ref[i].astype(jnp.float32) - prod
        y_ref[i] = y
        return y

    jax.lax.fori_loop(1, nb, body, y0)


def _bwd_kernel_inv(sinv_ref, u_ref, y_ref, x_ref, *, nb, many, precision):
    mv = partial(_mm, precision=precision) if many else _mv
    x_last = mv(sinv_ref[nb - 1].astype(jnp.float32), y_ref[nb - 1])
    x_ref[nb - 1] = x_last

    def body(j, x_next):
        i = nb - 1 - j
        t = y_ref[i] - mv(u_ref[i].astype(jnp.float32), x_next)
        x = mv(sinv_ref[i].astype(jnp.float32), t)
        x_ref[i] = x
        return x

    jax.lax.fori_loop(1, nb, body, x_last)


def _bwd_kernel_spd(sinv_ref, f_ref, y_ref, x_ref, *, nb, many, precision):
    # symmetric factors store no U: Sinv_i U_i = F_{i+1}^T
    mv = partial(_mm, precision=precision) if many else _mv
    mv_t = partial(_mm_t, precision=precision) if many else _mv_t
    x_last = mv(sinv_ref[nb - 1].astype(jnp.float32), y_ref[nb - 1])
    x_ref[nb - 1] = x_last

    def body(j, x_next):
        i = nb - 1 - j
        x = (mv(sinv_ref[i].astype(jnp.float32), y_ref[i])
             - mv_t(f_ref[i + 1].astype(jnp.float32), x_next))
        x_ref[i] = x
        return x

    jax.lax.fori_loop(1, nb, body, x_last)


def _dot_precision(tile_dtype, interpret: bool):
    """Multi-RHS product precision.  bf16 tiles: one TF32 pass (the XLA
    scan's DEFAULT).  f32 tiles: three TF32 passes (TF32x3, error near
    f32 rounding) — IEEE f32 ``pl.dot`` runs on the FMA units and measured
    slower than the XLA scan on the H100 (PERF.md).  The interpreter has
    no TF32 algorithms and computes in IEEE f32."""
    if jnp.dtype(tile_dtype).itemsize < 4:
        return jax.lax.Precision.DEFAULT
    if interpret:
        return jax.lax.Precision.HIGHEST
    return jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def _sweeps(fact, rhs, *, rc, interpret, num_warps, num_stages):
    """Both sweeps over rhs [K, nb, b(, r)] in f32."""
    K, nb, b, _ = fact.F.shape
    many = rhs.ndim == 4
    precision = _dot_precision(fact.F.dtype, interpret)
    mat = pl.BlockSpec((None, nb, b, b), lambda p, c: (p, 0, 0, 0))
    if many:
        grid = (K, rhs.shape[-1] // rc)
        vec = pl.BlockSpec((None, nb, b, rc), lambda p, c: (p, 0, 0, c))
    else:
        grid = (K, 1)
        vec = pl.BlockSpec((None, nb, b), lambda p, c: (p, 0, 0))
    call = partial(
        pl.pallas_call, grid=grid, out_specs=vec,
        out_shape=jax.ShapeDtypeStruct(rhs.shape, jnp.float32),
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        interpret=interpret)
    kw = dict(nb=nb, many=many, precision=precision)
    y = call(partial(_fwd_kernel, **kw), in_specs=[mat, vec],
             name="spike_fwd_sweep")(fact.F, rhs)
    if fact.method == "spd":
        return call(partial(_bwd_kernel_spd, **kw), in_specs=[mat, mat, vec],
                    name="spike_bwd_sweep_spd")(fact.Sinv, fact.F, y)
    return call(partial(_bwd_kernel_inv, **kw), in_specs=[mat, mat, vec],
                name="spike_bwd_sweep")(fact.Sinv, fact.U, y)


def _check(fact, rhs):
    if not fused_sweep_feasible(fact, rhs.shape[2], rhs.dtype):
        F = getattr(fact, "F", None)
        raise ValueError(
            "the Pallas sweep kernels need method='inv'/'spd' block-Thomas "
            "factors stored f32 or bf16, a power-of-two block size and an "
            f"f32 right-hand side; got {type(fact).__name__} "
            f"method={getattr(fact, 'method', None)!r}, factor dtype "
            f"{getattr(F, 'dtype', None)}, block {rhs.shape[2]}, rhs "
            f"{rhs.dtype} (use impl='xla')")


# launch shapes, the fastest measured on the H100 at the flagship (PERF.md):
# single RHS 16 warps x 3 stages; multi-RHS 16 columns per program, 8 warps,
# 3 stages for bf16 tiles and 2 for f32 ones (the ``pl.dot`` operands are
# staged in shared memory, and three f32 [128, 128] stages exceed the
# 227 KB a block may use)
_RC = 16


@partial(jax.jit, static_argnames=("interpret",))
def blocktri_solve_fused_pallas(fact, rhs: jax.Array,
                                interpret: bool = False) -> jax.Array:
    """Batched block-Thomas solve: fact has leading partition dim K,
    rhs [K, nb, b] -> x [K, nb, b] (f32)."""
    _check(fact, rhs)
    return _sweeps(fact, rhs, rc=1, interpret=interpret, num_warps=16,
                   num_stages=3)


@partial(jax.jit, static_argnames=("interpret",))
def blocktri_solve_fused_many_pallas(fact, rhs: jax.Array,
                                     interpret: bool = False) -> jax.Array:
    """Multi-RHS form: rhs [K, nb, b, r] -> x [K, nb, b, r] (f32).  Each
    program sweeps 16 columns; r is zero-padded to a multiple of 16."""
    _check(fact, rhs)
    r = rhs.shape[-1]
    rp = -(-r // _RC) * _RC
    if rp != r:
        rhs = jnp.pad(rhs, ((0, 0), (0, 0), (0, 0), (0, rp - r)))
    stages = 3 if jnp.dtype(fact.F.dtype).itemsize < 4 else 2
    x = _sweeps(fact, rhs, rc=_RC, interpret=interpret, num_warps=8,
                num_stages=stages)
    return x[..., :r]
