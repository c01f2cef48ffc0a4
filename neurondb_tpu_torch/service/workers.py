"""Background maintenance workers — queue executor, auto-tuner, defrag.

Reference: NeuronDB/src/worker/ — four bgworkers registered in _PG_init:
- neuranq: SKIP LOCKED job queue executor (embed/rerank/cache_refresh/
  http_call job types, worker_queue.c:454-476);
- neuranmon: auto-tuner sampling latency/recall and adjusting ef_search
  by +/-20% within [16, 512] toward SLOs (worker_tuner.c:326-342);
- neuranllm: LLM job processor (lives in service.llm's job queue);
- neurandefrag: HNSW compaction / tombstone pruning with maintenance
  windows (worker_defrag.c).

Here the workers are daemon threads around the engine objects. The tuner
implements the reference's control law exactly (multiplicative +/-20%
steps clamped to the envelope).

Counterpart of ``neurondb_tpu/service/workers.py`` (no jax there): the
same workers over the port's store and indexes (``VectorStore.compact``,
``IVFFlatIndex.rebuild_lists``, ``HNSWIndex.compact``) and the port's
``worker_*`` / ``tuner_*`` / ``defrag_*`` knobs.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from neurondb_tpu_torch.config import get_config


@dataclass
class Job:
    job_id: int
    kind: str                       # embed | rerank | cache_refresh | call
    payload: Dict
    status: str = "queued"
    result: Any = None
    error: str = ""
    attempts: int = 0


class QueueWorker:
    """neuranq parity: typed job queue with retries."""

    def __init__(self, handlers: Optional[Dict[str, Callable]] = None):
        self.handlers = handlers or {}
        self._q: "queue.Queue[int]" = queue.Queue()
        self._jobs: Dict[int, Job] = {}
        self._next = 1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def register(self, kind: str, fn: Callable[[Dict], Any]) -> None:
        self.handlers[kind] = fn

    def enqueue(self, kind: str, payload: Dict) -> int:
        with self._lock:
            jid = self._next
            self._next += 1
        self._jobs[jid] = Job(jid, kind, payload)
        self._q.put(jid)
        return jid

    def status(self, job_id: int) -> Job:
        return self._jobs[job_id]

    def start(self) -> None:
        if self._thread and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def drain(self, timeout: float = 10.0) -> None:
        t0 = time.time()
        while time.time() - t0 < timeout:
            if all(j.status in ("done", "failed")
                   for j in self._jobs.values()):
                return
            time.sleep(0.01)

    def _loop(self) -> None:
        cfg = get_config()
        while not self._stop.is_set():
            try:
                jid = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            job = self._jobs[jid]
            job.status = "running"
            job.attempts += 1
            fn = self.handlers.get(job.kind)
            try:
                if fn is None:
                    raise ValueError(f"no handler for {job.kind!r}")
                job.result = fn(job.payload)
                job.status = "done"
            except Exception as e:  # noqa: BLE001
                if job.attempts < cfg.worker_queue_retry_max:
                    job.status = "queued"
                    self._q.put(jid)
                else:
                    job.status = "failed"
                    job.error = str(e)


class AutoTuner:
    """neuranmon parity: SLO-driven ef_search controller.

    Control law (worker_tuner.c:326-342): if measured recall is below the
    target, ef *= 1.2; if recall meets target and latency exceeds its
    target, ef *= 0.8; clamp to [ef_min, ef_max].
    """

    def __init__(self, *, target_recall: Optional[float] = None,
                 target_latency_ms: Optional[float] = None,
                 ef_min: Optional[int] = None, ef_max: Optional[int] = None):
        cfg = get_config()
        self.target_recall = target_recall if target_recall is not None \
            else cfg.tuner_target_recall
        self.target_latency_ms = target_latency_ms \
            if target_latency_ms is not None else cfg.tuner_target_latency_ms
        self.ef_min = ef_min if ef_min is not None else cfg.tuner_ef_min
        self.ef_max = ef_max if ef_max is not None else cfg.tuner_ef_max
        self.history: List[Dict] = []

    def step(self, ef: int, measured_recall: float,
             measured_latency_ms: float) -> int:
        new_ef = ef
        if measured_recall < self.target_recall:
            new_ef = int(round(ef * 1.2))
        elif measured_latency_ms > self.target_latency_ms:
            new_ef = int(round(ef * 0.8))
        new_ef = max(self.ef_min, min(self.ef_max, new_ef))
        self.history.append({"ef": ef, "recall": measured_recall,
                             "latency_ms": measured_latency_ms,
                             "new_ef": new_ef, "ts": time.time()})
        return new_ef

    def tune_index(self, index, queries, ground_truth_ids, *, k: int = 10,
                   iters: int = 8) -> int:
        """Closed-loop tuning against a ground-truth sample."""
        from neurondb_tpu_torch.ml.metrics import recall_at_k
        ef = getattr(index, "ef_search", 64)
        for _ in range(iters):
            t0 = time.time()
            _, ids = index.search(queries, k=k, ef=ef)
            lat = (time.time() - t0) / max(len(queries), 1) * 1000.0
            rec = recall_at_k(ids, ground_truth_ids, k)
            new_ef = self.step(ef, rec, lat)
            if new_ef == ef:
                break
            ef = new_ef
        index.ef_search = ef
        return ef


class DefragWorker:
    """neurandefrag parity: compact stores/indexes when tombstone ratio
    exceeds the threshold, inside a maintenance window check."""

    def __init__(self, *, tombstone_ratio: Optional[float] = None,
                 window: Optional[Callable[[], bool]] = None):
        cfg = get_config()
        self.tombstone_ratio = tombstone_ratio if tombstone_ratio is not None \
            else cfg.defrag_tombstone_ratio
        self.window = window or (lambda: True)
        self.runs: List[Dict] = []

    def maybe_compact(self, store) -> bool:
        """Compact a VectorStore if its deleted fraction crosses the
        threshold. Returns True when compaction ran."""
        size = store.size
        live = len(store)
        if size == 0 or not self.window():
            return False
        ratio = (size - live) / size
        if ratio < self.tombstone_ratio:
            return False
        t0 = time.time()
        store.compact()
        self.runs.append({"ts": t0, "seconds": time.time() - t0,
                          "reclaimed": size - live})
        return True

    def maybe_rebuild(self, index) -> bool:
        """Fold IVF spill buffers back into posting lists."""
        if hasattr(index, "_spill") and index._spill:
            index.rebuild_lists()
            self.runs.append({"ts": time.time(), "kind": "ivf_rebuild"})
            return True
        return False

    def maybe_vacuum(self, index) -> bool:
        """Physically remove tombstoned entries once the dead ratio
        crosses the threshold (hnsw_am.c bulkdelete / neurandefrag
        compaction parity): HNSW.compact() repairs back-links in place;
        IVF rebuild_lists() drops dead rows from its posting lists."""
        ratio = getattr(index, "dead_ratio", 0.0)
        if ratio < self.tombstone_ratio or not self.window():
            return False
        t0 = time.time()
        if hasattr(index, "compact"):
            removed = index.compact()
        else:
            index.rebuild_lists()
            removed = -1
        self.runs.append({"ts": t0, "seconds": time.time() - t0,
                          "kind": "index_vacuum", "removed": removed})
        return True
