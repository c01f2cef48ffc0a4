"""Tracing / profiling hooks — torch.profiler integration + span timing.

Counterpart of ``neurondb_tpu/utils/tracing.py`` (which wraps
``jax.profiler``). This module provides:

- ``trace(name)``: context manager that is at once a
  ``torch.profiler.record_function`` range (a named span in any
  ``torch.profiler`` trace, CPU or CUDA), an NVTX range when CUDA is
  initialised (visible to Nsight), and a wall-clock span recorded in the
  process-local registry;
- ``start_profile(logdir)`` / ``stop_profile()`` / ``profile(logdir)``:
  a whole-program ``torch.profiler.profile`` capture with the CPU
  activity, and the CUDA activity when a card is present; on stop the
  Chrome trace is written to ``<logdir>/TRACE_FILE`` (open it in
  chrome://tracing or Perfetto);
- ``annotate_fn(name)``: decorator variant for entry points;
- ``spans()`` / ``summary()`` / ``reset()`` / ``prometheus_text()``:
  per-span counts and latency stats that feed the Prometheus exporter
  beside the engine metrics; ``prometheus_text`` gives the JAX module's
  text for the same spans.

Divergences: ``device_memory_profile`` returns
``torch.cuda.memory._snapshot()`` pickled (allocator segments and
blocks), where the JAX module returns ``jax.profiler``'s pprof bytes; it
needs a card. ``stop_profile`` returns ``logdir`` as the JAX module does;
the trace file's path is ``os.path.join(logdir, TRACE_FILE)``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

TRACE_FILE = "trace.json"

_lock = threading.Lock()
_spans: Dict[str, Dict[str, float]] = {}
_active_logdir: Optional[str] = None
_active_prof: Optional[torch.profiler.profile] = None


def _record(name: str, seconds: float) -> None:
    with _lock:
        s = _spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                     "max_s": 0.0})
        s["count"] += 1
        s["total_s"] += seconds
        s["max_s"] = max(s["max_s"], seconds)


@contextlib.contextmanager
def trace(name: str):
    """Wall-clock span + ``record_function`` range (+ NVTX range once CUDA
    is initialised)."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    t0 = time.perf_counter()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        _record(name, time.perf_counter() - t0)


def annotate_fn(name: Optional[str] = None) -> Callable:
    def deco(fn: Callable) -> Callable:
        label = name or f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with trace(label):
                return fn(*a, **k)
        return wrapped
    return deco


def _all_threads():
    """Kineto's switch that records the ops of every thread (the serving
    path runs in handler and batcher threads); an older torch has none,
    and its trace holds the calling thread's ops (the card's kernels are
    recorded from every thread either way)."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except TypeError:
        return {}


def start_profile(logdir: str) -> None:
    """Begin a whole-program ``torch.profiler`` capture: every thread's
    ops, CPU and (with a card) CUDA."""
    global _active_logdir, _active_prof
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, **_all_threads())
    prof.start()
    _active_prof, _active_logdir = prof, logdir


def stop_profile() -> Optional[str]:
    """End the capture and write its Chrome trace into the logdir."""
    global _active_logdir, _active_prof
    prof, out = _active_prof, _active_logdir
    _active_prof = _active_logdir = None
    if prof is None:
        return None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, TRACE_FILE))
    return out


@contextlib.contextmanager
def profile(logdir: str):
    start_profile(logdir)
    try:
        yield
    finally:
        stop_profile()


def device_memory_profile(path: Optional[str] = None) -> bytes:
    """Snapshot the card's allocator (``torch.cuda.memory._snapshot``),
    pickled; optionally saved to ``path``. Raises without a card."""
    blob = pickle.dumps(torch.cuda.memory._snapshot())
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def spans() -> Dict[str, Dict[str, float]]:
    with _lock:
        return {k: dict(v) for k, v in _spans.items()}


def summary() -> List[Dict[str, Any]]:
    out = []
    for name, s in sorted(spans().items()):
        avg = s["total_s"] / s["count"] if s["count"] else 0.0
        out.append({"span": name, "count": int(s["count"]),
                    "avg_ms": round(avg * 1e3, 3),
                    "max_ms": round(s["max_s"] * 1e3, 3),
                    "total_s": round(s["total_s"], 3)})
    return out


def reset() -> None:
    with _lock:
        _spans.clear()


def prometheus_text() -> str:
    """Span stats in Prometheus exposition format (joins the metrics
    exporter's output)."""
    lines = []
    for row in summary():
        lines.append(f"ndb_span_count{{span=\"{row['span']}\"}} "
                     f"{row['count']}")
        lines.append(f"ndb_span_total_seconds{{span=\"{row['span']}\"}} "
                     f"{row['total_s']}")
    return "\n".join(lines) + ("\n" if lines else "")
