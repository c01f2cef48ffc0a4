"""Micro-batching for the serving path.

The reference serves each HTTP search with its own SQL query
(NeuronAgent/cmd/agent-server/main.go:97-120 routes straight into the
engine). On the card a per-request search is the worst shape: the
grouped scan kernel is built for thousands of queries per launch, and a
1-row search pays the whole host path of a search alone. The
MicroBatcher closes the gap between HTTP's one-request-at-a-time shape
and the card's batch appetite: concurrent requests queue for up to
``window_ms``, run as ONE ``index.search`` call, and fan back out to
their waiters.

Counterpart of ``neurondb_tpu/service/batcher.py``, with two
divergences:

- no padding: the JAX batcher pads each batch to a power-of-two row
  count (at least ``pad_floor``) so XLA compiles a handful of shapes;
  nothing on the card compiles per shape, so the port searches the real
  rows only. ``pad_floor`` is accepted and kept for compatibility, and
  ``stats`` keep their meaning (``max_rows`` counts real rows);
- the dispatch/fan-out overlap: JAX returns unmaterialised device
  arrays, so its dispatch thread queues batch N+1 while the fan-out
  thread waits on batch N. The port gets the same overlap by asking the
  index for device tensors (``out="device"``) where the index's state
  allows it (``index.device_out_ok()``: an IVFFlat index with no spill
  buffer and int32 ids), decided before the call; the fan-out thread
  then makes the host copy. Any other index returns host arrays from
  the dispatch thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def to_host(a) -> np.ndarray:
    """A search result as a host numpy array (waits for the device)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


class MicroBatcher:
    """Batch concurrent single-query searches into one device dispatch.

    Parameters
    ----------
    index: any object with ``search(queries, k=..., **kw)``.
    window_ms: max time the FIRST request in a batch waits for company.
    max_batch: hard cap on rows per dispatch.
    wire: "f32" (default) or "int8" — quantize the assembled batch to
        the 1-byte query wire before dispatch (index/base.py
        ``quantize_queries_int8``).
    pad_floor: accepted for compatibility; the port does not pad.
    depth: the most batches in flight between dispatch and fan-out.
    search_kw: fixed kwargs forwarded to every ``index.search`` call
        (e.g. ``{"nprobe": 8}``).
    """

    def __init__(self, index, *, window_ms: float = 10.0,
                 max_batch: int = 4096, wire: str = "f32",
                 pad_floor: int = 1, depth: int = 4,
                 search_kw: Optional[Dict[str, Any]] = None):
        self.index = index
        self.window = window_ms / 1000.0
        self.max_batch = int(max_batch)
        self.pad_floor = int(pad_floor)
        self.wire = wire
        self.search_kw = dict(search_kw or {})
        self.stats = {"batches": 0, "requests": 0, "max_rows": 0}
        self._cond = threading.Condition()
        self._pending: List[Dict[str, Any]] = []
        self._closed = False
        # dispatch/fan-out pipeline: with device output the dispatch
        # thread starts batch N+1 while the card still computes batch N;
        # the fan-out thread blocks on the host copy and wakes the
        # waiters. ``depth`` bounds in-flight batches.
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ndb-microbatcher")
        self._fanout = threading.Thread(target=self._fanout_loop,
                                        daemon=True,
                                        name="ndb-microbatcher-out")
        self._thread.start()
        self._fanout.start()

    # -- client side ----------------------------------------------------
    def search(self, vector, k: int = 10, timeout: float = 30.0):
        """Blocking single-query search; returns (distances, ids) 1-D."""
        q = np.asarray(vector, np.float32).reshape(-1)
        # validate BEFORE enqueueing: one wrong-dimension vector in an
        # assembled batch would otherwise fan its error out to every
        # request sharing the dispatch
        dim = getattr(self.index, "dim", None)
        if dim is not None and q.size != dim:
            raise ValueError(
                f"query has dim {q.size}, index expects {dim}")
        req: Dict[str, Any] = {"q": q, "k": int(k),
                               "ev": threading.Event(),
                               "deadline": time.monotonic() + timeout}
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._pending.append(req)
            self._cond.notify()
        if not req["ev"].wait(timeout):
            raise TimeoutError("search timed out in micro-batcher")
        if "err" in req:
            raise req["err"]
        return req["d"], req["ids"]

    def close(self) -> None:
        """Drain and stop. The fan-out sentinel is posted ONLY by the
        dispatch thread (after its last batch's results are already in
        ``_inflight``), so waiters of in-flight batches are never
        stranded by a sentinel jumping ahead of their results."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join()                    # posts the sentinel last
        self._fanout.join(timeout=30.0)

    # -- batcher side ---------------------------------------------------
    def _take_batch(self) -> List[Dict[str, Any]]:
        with self._cond:
            while not self._pending and not self._closed:
                self._cond.wait()
            if self._closed and not self._pending:
                return []
            deadline = time.monotonic() + self.window
            while (len(self._pending) < self.max_batch
                   and not self._closed):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(timeout=left)
            batch = self._pending[:self.max_batch]
            self._pending = self._pending[self.max_batch:]
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                self._inflight.put(None)       # wake + stop fan-out
                return
            try:
                self._dispatch_batch(batch)
            except Exception as e:  # noqa: BLE001 — fan the error out
                for r in batch:
                    r["err"] = e
                    r["ev"].set()

    def _dispatch_batch(self, batch: List[Dict[str, Any]]) -> None:
        # drop requests whose client already timed out: nobody is
        # waiting for their rows
        now = time.monotonic()
        batch = [r for r in batch if r["deadline"] > now]
        if not batch:
            return
        n = len(batch)
        q = np.stack([r["q"] for r in batch])
        kmax = max(r["k"] for r in batch)
        if self.wire == "int8":
            from neurondb_tpu_torch.index.base import quantize_queries_int8
            qw: Any = quantize_queries_int8(q)
        else:
            qw = q
        kw = dict(self.search_kw)
        ok = getattr(self.index, "device_out_ok", None)
        if ok is not None and ok():
            kw["out"] = "device"               # the fan-out copies to host
        d, ids = self.index.search(qw, k=kmax, **kw)
        self.stats["batches"] += 1
        self.stats["requests"] += n
        self.stats["max_rows"] = max(self.stats["max_rows"], n)
        self._inflight.put((batch, d, ids))    # backpressure at depth

    def _fanout_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, d, ids = item
            try:
                d = to_host(d)                   # blocks until computed
                ids = to_host(ids)
            except Exception as e:  # noqa: BLE001
                for r in batch:
                    r["err"] = e
                    r["ev"].set()
                continue
            for i, r in enumerate(batch):
                r["d"] = d[i, :r["k"]]
                r["ids"] = ids[i, :r["k"]]
                r["ev"].set()
