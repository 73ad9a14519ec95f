"""``jit_closure``: jit a closure whose captured arrays enter as arguments.

A plain ``jax.jit`` of a closure (a solver bound to its operator and
factors) embeds every captured array in the compiled program as a
constant: at production sizes (GBs of factors) XLA then compiles for
minutes, keeps a second copy of the data on the device, and cannot place
arrays sharded over a mesh.  ``jit_closure`` traces the closure once per
argument signature and compiles it with the captured arrays as ordinary
arguments, which keep their placement and sharding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def jit_closure(fn):
    """``jax.jit(fn)`` with ``fn``'s closed-over arrays passed as arguments.

    Called inside an enclosing trace (the captured values are then tracers
    of that trace), ``fn`` runs inline: the enclosing ``jit`` compiles it.
    """
    cache = {}

    def call(*args, **kwargs):
        flat, tree = jax.tree_util.tree_flatten((args, kwargs))
        key = (tree, tuple((jnp.shape(a), jnp.result_type(a)) for a in flat))
        hit = cache.get(key)
        if hit is None:
            closed, shape = jax.make_jaxpr(
                lambda a, k: fn(*a, **k), return_shape=True)(args, kwargs)
            if any(isinstance(c, jax.core.Tracer) for c in closed.consts):
                return fn(*args, **kwargs)
            run = jax.jit(lambda consts, *xs: jax.core.eval_jaxpr(
                closed.jaxpr, consts, *xs))
            hit = cache[key] = (run, closed.consts,
                                jax.tree_util.tree_structure(shape))
        run, consts, out_tree = hit
        return jax.tree_util.tree_unflatten(out_tree, run(consts, *flat))

    return call
