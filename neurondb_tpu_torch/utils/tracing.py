"""Tracing / profiling hooks — torch.profiler integration, spans and
counters.

Counterpart of ``neurondb_tpu/utils/tracing.py`` (which wraps
``jax.profiler``). Tracing is on exactly while a ``torch.profiler``
records (``profile()`` below, the benchmark's traced stretch, or any
other ``torch.profiler.profile``): torch's own flag decides, and there is
no other switch. This module provides:

- ``trace(name)``: a span. Off, one flag check and a shared no-op
  context. On, a ``torch.profiler.record_function`` range (in the
  profiler's trace, on the same clock as the card's kernels and copies)
  whose wall time goes into the process-local registry: count, total,
  max, and self time (the span's time less the time its child spans on
  the same thread cover);
- ``count(name, n)``: adds ``n`` (a Python int, or a 0-d tensor added on
  its device to the counter's running sum there and read only when
  ``counters()`` is, so counting never waits for the device) to a
  counter; nothing when off;
- ``start_profile(logdir)`` / ``stop_profile()`` / ``profile(logdir)``:
  a whole-program ``torch.profiler.profile`` capture with the CPU
  activity, and the CUDA activity when a card is present; on stop the
  Chrome trace is written to ``<logdir>/TRACE_FILE`` (open it in
  chrome://tracing or Perfetto);
- ``annotate_fn(name)``: decorator variant for entry points;
- ``spans()`` / ``counters()`` / ``summary()`` / ``reset()``: the
  registry; ``summary()``'s rows are the JAX module's.

A span or count records while a profiler records, and also inside a
span that records (so a request that began while the profiler recorded
is recorded whole, though the profiler stops before it ends).

Divergences: spans record only under a profiler, where the JAX module
records every span; ``device_memory_profile`` returns
``torch.cuda.memory._snapshot()`` pickled (allocator segments and
blocks), where the JAX module returns ``jax.profiler``'s pprof bytes; it
needs a card. ``stop_profile`` returns ``logdir`` as the JAX module does;
the trace file's path is ``os.path.join(logdir, TRACE_FILE)``. The JAX
module's ``prometheus_text`` has no port: nothing exports spans.
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
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"

_lock = threading.Lock()
_spans: Dict[str, Dict[str, float]] = {}
_counts: Dict[str, list] = {}      # name -> [host int, {device: 0-d sum}]
_local = threading.local()         # .stack: this thread's open spans
_NULL = contextlib.nullcontext()
_active_logdir: Optional[str] = None
_active_prof: Optional[torch.profiler.profile] = None

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:
    _profiling = torch._C._autograd._profiler_enabled


def recording() -> bool:
    """Whether a span or count begun now records: while a profiler
    records, and inside a span of this thread that records."""
    return bool(_profiling() or getattr(_local, "stack", None))


def _record(name: str, seconds: float, self_s: float) -> None:
    with _lock:
        s = _spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                     "max_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += seconds
        s["max_s"] = max(s["max_s"], seconds)
        s["self_s"] += self_s


def _add(name: str, n) -> None:
    with _lock:
        c = _counts.setdefault(name, [0, {}])
        if isinstance(n, torch.Tensor):
            held = c[1].get(n.device)
            c[1][n.device] = n if held is None else held + n
        else:
            c[0] += int(n)


class _Span:
    """A recording span: a ``record_function`` range, its wall time and
    self time added to the registry on exit."""

    __slots__ = ("name", "_range", "_t0", "_child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._child = 0.0
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._child += dt
        self._range.__exit__(*exc)
        _record(self.name, dt, dt - self._child)
        return False


def trace(name: str):
    """A span named ``name`` (a context manager): a shared no-op unless
    ``recording()``."""
    return _Span(name) if recording() else _NULL


def count(name: str, n) -> None:
    """Add ``n`` (a Python int or a 0-d tensor, on any device) to the
    counter ``name`` if ``recording()``. A caller that computes a tensor
    to count checks ``recording()`` first, so that no device work runs
    while tracing is off."""
    if recording():
        _add(name, n)


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
    """Each span's count, ``total_s``, ``max_s`` and ``self_s``."""
    with _lock:
        return {k: dict(v) for k, v in _spans.items()}


def counters() -> Dict[str, int]:
    """Each counter's total (reading a tensor counted on a device waits
    for it)."""
    with _lock:
        held = {k: (c[0], list(c[1].values())) for k, c in _counts.items()}
    return {k: total + sum(int(t) for t in tensors)
            for k, (total, tensors) in held.items()}


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
    """Clear the spans and the counters."""
    with _lock:
        _spans.clear()
        _counts.clear()
