"""Device mesh construction and partition-axis conventions.

The framework's parallelism maps the reference's row-block MPI distribution
(PETSc MPIAIJ, /root/reference/src/wbm.c:205-218) onto a named
``jax.sharding.Mesh`` axis:

  axis "p"   — SPIKE partition axis (one or more band partitions per
               device); collectives ride the devices' interconnect
  axis "rhs" — optional batch axis over independent right-hand sides
               (embarrassingly parallel, the "data parallel" analogue)

Multi-slice deployments (groups of devices joined by a slower link) add an
outer axis and keep "p" within a slice so the reduced-system all-gather
stays on the fast intra-slice link.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "p") -> Mesh:
    """1-D mesh over the first n_devices devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]), (axis,))


def make_mesh_2d(shape: Sequence[int], axes=("rhs", "p")) -> Mesh:
    devs = jax.devices()
    need = int(np.prod(shape))
    if need > len(devs):
        raise ValueError(f"requested {need} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:need]).reshape(tuple(shape)), tuple(axes))


def shard_leading(mesh: Mesh, x, axis: str = "p"):
    """Place array x with its leading dim sharded over ``axis``."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))
