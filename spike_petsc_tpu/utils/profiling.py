"""Tracing / profiling / observability.

The reference delegates tracing to PETSc: PetscInfo event notes, per-function
stack tracing, -log_summary stage logging (SURVEY.md §5;
/root/reference/src/matbanded.c:175).  Equivalents provided here:

* ``scope(name)`` — named trace annotation: shows up in the JAX/XLA profiler
  timeline (jax.named_scope) AND accumulates host-side wall-clock per stage
  (the -log_summary analogue).
* ``log_event`` / ``event_log`` — structured event records (phase, matrix
  size, bandwidth, residuals) replacing PetscInfo prints.
* ``start_trace``/``stop_trace`` — thin wrappers over jax.profiler for
  capturing device traces.
* ``stage_report()`` — per-stage cumulative wall-clock/hit-count table.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Any, Dict, List

import jax

_STAGES: Dict[str, Dict[str, float]] = defaultdict(
    lambda: {"time": 0.0, "count": 0})
_EVENTS: List[dict] = []
_VERBOSITY = 0


def set_verbosity(level: int) -> None:
    """0 = silent, 1 = events printed, 2 = + stage timings (mirrors MC64's
    ICNTL(5) diagnostic levels, /root/reference/src/hslmc64.c:233-241)."""
    global _VERBOSITY
    _VERBOSITY = level


@contextlib.contextmanager
def scope(name: str):
    """Named profiling scope: device-trace annotation + host stage timer."""
    t0 = time.perf_counter()
    with jax.named_scope(name):
        yield
    dt = time.perf_counter() - t0
    s = _STAGES[name]
    s["time"] += dt
    s["count"] += 1
    if _VERBOSITY >= 2:
        print(f"[stage] {name}: {dt * 1e3:.3f} ms")


def log_event(event: str, **fields: Any) -> None:
    rec = dict(event=event, t=time.time(), **fields)
    _EVENTS.append(rec)
    if _VERBOSITY >= 1:
        print(f"[event] {json.dumps(rec, default=str)}")


def event_log() -> List[dict]:
    return list(_EVENTS)


def clear() -> None:
    _STAGES.clear()
    _EVENTS.clear()


def stage_report() -> str:
    """-log_summary style cumulative table."""
    lines = [f"{'stage':<32} {'count':>8} {'total_ms':>12} {'avg_ms':>10}"]
    for name, s in sorted(_STAGES.items(), key=lambda kv: -kv[1]["time"]):
        c = int(s["count"])
        lines.append(f"{name:<32} {c:>8} {s['time'] * 1e3:>12.2f} "
                     f"{s['time'] / max(c, 1) * 1e3:>10.3f}")
    return "\n".join(lines)


def start_trace(logdir: str) -> None:
    jax.profiler.start_trace(logdir)


def stop_trace() -> None:
    jax.profiler.stop_trace()
