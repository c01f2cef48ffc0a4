"""The traced run: ``torch.profiler`` over a stretch of the window, read
back from its Chrome trace.

The benchmark puts its own spans (``record_function`` ranges) around its
calls into the program: ``bench.dispatch`` around each search call,
``bench.fanout`` around each host copy of a batch's results,
``bench.wait`` where the client waits for a free slot, and
``bench.traced`` over the traced stretch. The device's activity (kernels,
copies, memsets) is reduced within ``bench.traced``: its busy time (the
union of the intervals), the kernels by name, the launches, and the idle
gaps named by the benchmark spans the host was in.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("bench.dispatch", "bench.fanout", "bench.wait")
WINDOW_SPAN = "bench.traced"
NAME_CHARS = 160           # kernel names kept in the breakdown


def _all_threads() -> Dict:
    """Kineto's switch that records the ops of every thread (the client
    and the fan-out run in their own threads); an older torch has none."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def start() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, **_all_threads())
    prof.start()
    return prof


def stop(prof: torch.profiler.profile) -> None:
    """Stop recording (the events are read later, by ``events``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()


def events(prof: torch.profiler.profile) -> List[Dict]:
    """A stopped profiler's complete ("X") events, from its Chrome trace
    (written to a temporary file and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    kernel_s: Dict[str, float] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, pattern) -> float:
        """Device seconds of kernels whose name matches ``pattern`` (a
        compiled regular expression)."""
        return sum(s for n, s in self.kernel_s.items() if pattern.search(n))

    def breakdown(self) -> Dict[str, List]:
        top = sorted(self.kernel_s.items(), key=lambda t: -t[1])[:10]
        gaps = sorted(self.idle_s.items(), key=lambda t: -t[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def summarize(events: List[Dict]) -> TraceSummary:
    """Reduce a trace's events within its ``bench.traced`` span (the
    host's spans, not their projections onto the device's timeline)."""
    events = [e for e in events if e.get("cat") != "gpu_user_annotation"]
    win = [e for e in events if e.get("name") == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev: List[Tuple[float, float]] = []
    kernel_s: Dict[str, float] = {}
    launches = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = str(e.get("name", "?"))
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
        if e.get("cat") == "kernel":
            launches += 1
    busy = _union(dev)
    host = {n: _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in events if e.get("name") == n])
            for n in HOST_SPANS}
    starts = {n: [s for s, _ in iv] for n, iv in host.items()}

    def inside(n: str, t: float) -> bool:
        j = bisect.bisect_right(starts[n], t) - 1
        return j >= 0 and t < host[n][j][1]

    idle_s: Dict[str, float] = {}
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            mid = 0.5 * (t + a)
            name = "+".join(n.split(".", 1)[1] for n in HOST_SPANS
                            if inside(n, mid)) or "none"
            idle_s[name] = idle_s.get(name, 0.0) + (a - t) * 1e-6
        t = max(t, b)
    return TraceSummary(window_s=(w1 - w0) * 1e-6,
                        busy_s=sum(b - a for a, b in busy) * 1e-6,
                        launches=launches, kernel_s=kernel_s, idle_s=idle_s)
