"""The one place that asks which machine the program runs on.

Every ``auto`` dispatch that could pick a hand-written kernel asks
:func:`gpu_kernels_available`; every explicit request for such a kernel goes
through :func:`require_gpu_kernels`, which raises instead of silently running
an interpreter or another route.  Tuning records are keyed by
:func:`platform_key`, and every entry point that compiles at scale (the
testbed, ``bench.py``, ``chip_smoke.py``, the tests) sets up the persistent
compilation cache through :func:`enable_compile_cache`.
"""

from __future__ import annotations

import os

import jax

# repository root (the directory holding the package): the fixed default
# home of the persistent compilation cache
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_ROOT, ".jax_cache")


def backend() -> str:
    return jax.default_backend()


def gpu_kernels_available() -> bool:
    """True when the Pallas (``backend="triton"``) kernels compile for the
    default backend: a CUDA GPU.  On every other backend ``auto`` takes the
    plain XLA routes."""
    return backend() == "gpu"


def require_gpu_kernels(what: str, interpret: bool = False) -> None:
    """Raise for an explicit kernel request the backend cannot run.
    ``interpret=True`` (tests only) runs the kernel in the Pallas
    interpreter on any backend."""
    if interpret or gpu_kernels_available():
        return
    raise ValueError(
        f"{what} is a CUDA GPU kernel and the default backend is "
        f"{backend()!r}; use the 'xla' route (or 'auto') here")


def default_inverter() -> str:
    """The batched-inverse engine 'auto' resolves to.  On the GPU the
    Newton–Schulz iteration (batched matrix products) factors the flagship
    band faster than the pivoted-LU inverse (measured in PERF.md);
    elsewhere the pivoted LU.  Newton's diagonal-dominance assumption is guarded by
    the PC layer's probe solve (solvers.pc._newton_safety_net)."""
    return "newton" if backend() == "gpu" else "lapack"


def platform_key() -> str:
    """Card-qualified platform key for tuning records.  Route crossovers
    are properties of the card, so a GPU key names the device kind
    (``"NVIDIA H100 80GB HBM3"`` -> ``"gpu:h100-80gb-hbm3"``) and a record
    measured on one card never applies to another.  Other backends use the
    bare backend name."""
    b = backend()
    if b != "gpu":
        return b
    kind = jax.devices()[0].device_kind.lower().strip()
    if kind.startswith("nvidia "):
        kind = kind[len("nvidia "):]
    return "gpu:" + "-".join(kind.split())


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    function sets no directory.  Otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache`` (git-ignored): the path is part of what makes
    a later process find the entries again."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return env or DEFAULT_CACHE_DIR
