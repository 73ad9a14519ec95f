"""Measured-route tuning records: let 'auto' dispatch follow hardware data.

The banded operator SpMV has two routes (the shifted-axpy form on band
storage, and a block-tridiagonal conversion + batched block products) whose
crossover is a property of the card: one card's numbers do not transfer to
another, nor to the CPU backend.  This module closes the loop:

  * ``tools/tune.py`` times every feasible route on the card it runs on and
    records the winner per (platform key, bandwidth) in a small JSON file;
  * ``as_matvec("auto")`` consults the record first (nearest bandwidth
    within 2x on the same card) and falls back to the band form when no
    measurement exists.

The platform key names the card (``utils.platform.platform_key``, e.g.
``"gpu:h100-80gb-hbm3"``).  The file is tiny, merged atomically, lives at
``<checkout>/.tuning.json`` (git-ignored), and ``SPIKE_TUNING_FILE``
overrides its location (tests point it at a tmpdir).  No record ships with
the package.
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
from typing import Optional

from .platform import _ROOT, platform_key  # noqa: F401  (re-exported)

_DEFAULT = os.path.join(_ROOT, ".tuning.json")
_cache = {"path": None, "mtime": None, "data": None}


def record_path() -> str:
    return os.environ.get("SPIKE_TUNING_FILE", _DEFAULT)


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def load() -> dict:
    """The tuning record (``{}`` when none has been written)."""
    path = record_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}
    if _cache["path"] == path and _cache["mtime"] == mtime:
        return _cache["data"]
    data = _read_json(path)
    _cache.update(path=path, mtime=mtime, data=data)
    return data


_warned_platforms: set = set()


def _warn_generation_fallback(platform: str, others: list) -> None:
    if platform in _warned_platforms:
        return
    _warned_platforms.add(platform)
    import warnings
    warnings.warn(
        f"no tuning measurements for platform {platform!r}; records exist "
        f"for {sorted(others)} but route crossovers do not transfer "
        f"between cards — using the default route. Run "
        f"`python -m spike_petsc_tpu.tools.tune` on this card to record "
        f"measured routes.", RuntimeWarning, stacklevel=3)


def matvec_key(w: int, dtype) -> str:
    """Record key for a banded matvec measurement: total width + dtype
    (route crossovers are dtype properties: itemsize gates feasibility and
    halves/doubles streamed bytes)."""
    import numpy as np
    return f"{int(w)}:{np.dtype(dtype).name}"


def update(platform: str, kind: str, key: str, entry: dict) -> str:
    """Merge one measurement into the record (atomic rename write).

    Layout: ``{platform: {kind: {key: entry}}}`` — e.g.
    ``{"gpu:h100-80gb-hbm3": {"banded_matvec": {"201:float32":
    {"winner": "xla", "n": 1000000, ...}}}}``.  Returns the path written.
    """
    path = record_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # deep-copy: load() returns the shared cache object; mutating it in
    # place would leave phantom entries in memory if the write below fails
    data = copy.deepcopy(load()) if os.path.exists(path) else {}
    data.setdefault(platform, {}).setdefault(kind, {})[str(key)] = entry
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tuning-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _cache.update(path=None, mtime=None, data=None)   # force re-read
    return path


def matvec_route_hint(platform: str, w: int, dtype=None,
                      n: Optional[int] = None) -> Optional[str]:
    """The measured winner for a banded matvec of total width ``w`` on
    ``platform``, or None when no applicable measurement exists.

    A measurement applies when its dtype matches, its width is within 2x,
    and (when both are known) its problem size is within 8x — a winner
    measured at n=1e6 says nothing about an n=300 system where one-time
    conversion overhead dominates.

    Card discipline: ``platform`` is the :func:`platform_key` form
    (``"gpu:h100-80gb-hbm3"``).  Records for OTHER cards (or a bare
    ``"gpu"`` key) never match — when only such records exist, a one-time
    RuntimeWarning says the default route applies untested on this card.
    """
    import numpy as np
    data = load()
    rec = data.get(platform, {}).get("banded_matvec", {})
    if not rec and platform.startswith("gpu"):
        others = [p for p in data
                  if p != platform and (p == "gpu" or p.startswith("gpu:"))
                  and data.get(p, {}).get("banded_matvec")]
        if others:
            _warn_generation_fallback(platform, others)
        return None
    dt = np.dtype(dtype).name if dtype is not None else None
    best = None
    for wk, e in rec.items():
        try:
            wpart, _, dpart = wk.partition(":")
            wv = float(wpart)
        except ValueError:
            continue
        if dt is not None and dpart and dpart != dt:
            continue
        if n is not None and e.get("n"):
            nratio = max(float(e["n"]), n) / max(min(float(e["n"]), n), 1.0)
            if nratio > 8.0:
                continue
        ratio = max(wv, w) / max(min(wv, w), 1.0)
        if ratio <= 2.0 and (best is None or ratio < best[0]):
            best = (ratio, e.get("winner"))
    return best[1] if best else None


def measure_matvec_ms(mv, x, reps: int = 20, operand=None) -> float:
    """Median wall time of one matvec in ms, each call ended by
    ``block_until_ready`` after a compiling warm-up call.  ``operand``:
    when given, ``mv`` is the closure-free two-argument form
    ``mv(operand, x)`` (solvers.operator.as_matvec_split) and the operand
    is passed to the jitted call as an argument."""
    import time

    import jax

    fn = jax.jit(mv)
    args = (x,) if operand is None else (operand, x)
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(max(reps, 3)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e3
