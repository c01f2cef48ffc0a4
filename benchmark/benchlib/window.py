"""The measured window: a closed loop with a fixed number of batches in
flight.

One client thread takes the next batch of the pool as soon as a slot is
free, calls the driver's ``dispatch`` (the program's search call) and
hands the result to a fan-out thread, which calls the driver's
``collect`` (the copy of ids and distances into host memory), keeps the
sampled rows of the answer, marks the batch complete and frees its slot.
A batch's latency runs from when the client took it to when its results
were in host memory. The client takes no batch after the window closes;
the batches still in flight are waited for (up to ``DRAIN_S``) and
judged, but not counted.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

DRAIN_S = 60.0      # seconds past the close a batch in flight may take


@dataclass
class Batch:
    seq: int
    slot: int
    t_take: float
    t_dispatched: float = 0.0
    t_done: Optional[float] = None
    ans_d: Optional[np.ndarray] = None
    ans_i: Optional[np.ndarray] = None
    error: Optional[str] = None


@dataclass
class WindowResult:
    t_start: float
    t_end: float
    batches: List[Batch]

    def in_window(self) -> List[Batch]:
        """Batches whose results reached host memory within the window."""
        return [b for b in self.batches if b.error is None
                and b.t_done is not None and b.t_done <= self.t_end]


def _span(on: bool, name: str):
    return torch.profiler.record_function(name) if on \
        else contextlib.nullcontext()


def run_window(dispatch: Callable, collect: Callable, pool: Sequence,
               sample: np.ndarray, *, depth: int, seconds: float,
               tracer=None) -> WindowResult:
    """Drive ``pool`` round robin through ``dispatch`` / ``collect`` for
    ``seconds`` with at most ``depth`` batches in flight. With a
    ``tracer`` (``begin()``, ``end()``, ``batches``) the benchmark's spans
    are recorded, ``begin`` is called before the first batch and ``end``
    once ``tracer.batches`` batches are complete, both from this
    thread."""
    slots = threading.Semaphore(depth)
    handoff: "queue.Queue" = queue.Queue()
    done: List[Batch] = []
    spans = tracer is not None
    traced = threading.Event()
    clock = {}
    started = threading.Event()

    def client():
        seq = 0
        while True:
            with _span(spans, "bench.wait"):
                slots.acquire()
            now = time.perf_counter()
            if seq == 0:
                clock["start"] = now
                clock["end"] = now + seconds
                started.set()
            elif now >= clock["end"]:
                slots.release()
                break
            rec = Batch(seq=seq, slot=seq % len(pool), t_take=now)
            handle = None
            try:
                with _span(spans, "bench.dispatch"):
                    handle = dispatch(pool[rec.slot])
            except Exception as e:  # noqa: BLE001 - a failed batch counts
                rec.error = f"dispatch: {e!r}"
            rec.t_dispatched = time.perf_counter()
            handoff.put((rec, handle))
            seq += 1
        handoff.put(None)

    def fanout():
        while True:
            item = handoff.get()
            if item is None:
                return
            rec, handle = item
            if rec.error is None:
                try:
                    with _span(spans, "bench.fanout"):
                        d, i = collect(handle)
                    rec.t_done = time.perf_counter()
                    rows = sample[rec.slot]
                    rec.ans_d = np.asarray(d)[rows]
                    rec.ans_i = np.asarray(i)[rows]
                except Exception as e:  # noqa: BLE001 - a failed batch
                    rec.error = f"collect: {e!r}"
            done.append(rec)
            slots.release()
            if spans and len(done) == tracer.batches:
                traced.set()

    threads = [threading.Thread(target=client, name="bench-client",
                                daemon=True),
               threading.Thread(target=fanout, name="bench-fanout",
                                daemon=True)]
    if spans:
        tracer.begin()
    for t in threads:
        t.start()
    started.wait()
    if spans:
        traced.wait(timeout=seconds + DRAIN_S)
        tracer.end()
    for t in threads:
        t.join(timeout=seconds + DRAIN_S + 5.0)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a batch in flight never came back within "
                           f"{DRAIN_S:.0f} s of the window's close")
    return WindowResult(t_start=clock["start"], t_end=clock["end"],
                        batches=sorted(done, key=lambda b: b.seq))
