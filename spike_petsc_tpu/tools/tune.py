"""Operator-route tuner: measure every SpMV route at YOUR shape, record it.

    python -m spike_petsc_tpu.tools.tune -n 1000000 -halfbw 100
    python -m spike_petsc_tpu.tools.tune -n 200000 -kl 13 -ku 13 -reps 20

Each run times the feasible routes (the shifted-axpy form on band storage,
and the block-tridiagonal conversion) through the library's own dispatch
(``as_matvec_split(impl=...)``), prints one JSON line, and merges the winner
into the tuning record (``SPIKE_TUNING_FILE``, default
``<checkout>/.tuning.json``) that ``as_matvec("auto")`` consults on the same
card.  Each time is the median of ``-reps`` calls, each ended by
``block_until_ready``.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    import jax
    import jax.numpy as jnp

    from ..ops.band import BandedMatrix
    from ..solvers.operator import as_matvec_split
    from ..utils import tuning
    from ..utils.options import Options

    opts = Options.from_argv(sys.argv[1:] if argv is None else argv)
    platform_req = opts.get_string("platform")
    if platform_req:
        jax.config.update("jax_platforms", platform_req)
    n = opts.get_int("n", 1_000_000)
    hb = opts.get_int("halfbw", None)
    kl = opts.get_int("kl", hb if hb is not None else 100)
    ku = opts.get_int("ku", hb if hb is not None else 100)
    reps = opts.get_int("reps", 20)
    dt = opts.get_string("dtype", "f32")
    if dt == "f64":
        # without x64 the arrays silently downcast to f32 and the record
        # would mislabel f32 timings as f64 (code-review r3)
        jax.config.update("jax_enable_x64", True)
    dtype = {"f32": jnp.float32, "f64": jnp.float64,
             "bf16": jnp.bfloat16}[dt]
    w = kl + ku + 1
    platform = tuning.platform_key()    # card-qualified ("gpu:h100-80gb-hbm3")

    key = jax.random.PRNGKey(0)
    data = jax.random.uniform(key, (n, w), dtype, minval=-1.0, maxval=1.0)
    data = data.at[:, kl].set(jnp.sum(jnp.abs(data), axis=1) + 1.0)
    band = BandedMatrix(data=data, kl=kl, ku=ku)
    x0 = jax.random.normal(jax.random.PRNGKey(1), (n,), dtype)

    from ..solvers.operator import _bt_gate

    routes = {}
    for name in ("xla", "blocktri"):
        if name == "blocktri" and not _bt_gate(band)[0]:
            continue                          # the conversion does not apply
        mv, operand, _, _ = as_matvec_split(band, impl=name)
        routes[name] = tuning.measure_matvec_ms(mv, x0, reps=reps,
                                                operand=operand)
    if not routes:
        print(json.dumps({"error": "no feasible route", "n": n, "w": w}))
        return 1
    winner = min(routes, key=routes.get)
    path = tuning.update(platform, "banded_matvec",
                         tuning.matvec_key(w, dtype), {
                             **{f"{k}_ms": v for k, v in routes.items()},
                             "winner": winner, "n": n, "dtype": dt})
    print(json.dumps({"platform": platform, "n": n, "w": w, "dtype": dt,
                      **{f"{k}_ms": v for k, v in routes.items()},
                      "winner": winner, "tuning_file": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
