"""Rank-ordered collective printing — PetscSynchronizedPrintf analog.

The reference prints per-rank diagnostics in rank order via
``PetscSynchronizedPrintf/Flush`` (/root/reference/src/wbm.c:294,395).  The
mesh equivalent cannot let every device write to stdout (callbacks
arrive in arbitrary order); instead the values are all-gathered over the
mesh axis and printed ONCE, in rank order, from the axis's first device.

Usable inside ``shard_map`` programs::

    sync_print("diag weight = {:.3e}", w_local, axis="p")

prints one ``[rank] ...`` line per device, in order, wherever the host
stdout lives.  Cost: one small all_gather (the values printed) — the same
traffic PetscSynchronizedPrintf pays to ship strings to rank 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sync_print(fmt: str, *args, axis: str, prefix: str = "[{rank}] ") -> None:
    """Print ``fmt.format(*args)`` for every device along ``axis``, in rank
    order, exactly once.  ``args`` are per-device arrays/scalars."""
    ops = [jax.lax.all_gather(jnp.asarray(a), axis) for a in args]
    if not ops:
        ops = [jax.lax.all_gather(jax.lax.axis_index(axis), axis)]
        blank = True
    else:
        blank = False
    idx = jax.lax.axis_index(axis)

    def host_print(*arrs):
        n = arrs[0].shape[0]
        for r in range(n):
            vals = () if blank else tuple(a[r] for a in arrs)
            print(prefix.format(rank=r) + fmt.format(*vals), flush=True)

    def do(operands):
        jax.debug.callback(host_print, *operands)
        return jnp.zeros((), jnp.int32)

    jax.lax.cond(idx == 0, do, lambda _: jnp.zeros((), jnp.int32), tuple(ops))
