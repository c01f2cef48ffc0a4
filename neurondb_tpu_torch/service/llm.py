"""LLM gateway: provider router with a cache, a rate limit and fail-open.

Counterpart of ``neurondb_tpu/service/llm.py``, on the port's
``config.py`` (its ``llm_*`` and ``worker_queue_retry_max`` knobs):
``LLMRouter`` applies cache -> rate limit -> provider -> fail-open in
that order, with an async job queue served by one worker thread.

- ``LocalProvider`` is the on-device runtime: embed and rerank run the
  port's ``default_embedder`` and ``default_cross_encoder`` (the
  exported models when ``NEURONDB_TORCH_WEIGHTS`` /
  ``NEURONDB_TORCH_CROSS_WEIGHTS`` name an export, else the offline
  doubles), ``complete`` runs ``ml.gpt.GPT2LM`` when one is passed in or
  ``NEURONDB_TORCH_GPT_WEIGHTS`` names an export directory (the JAX
  package reads ``NEURONDB_TPU_GPT_WEIGHTS``), else an extractive summary
  that says so. Its models live on ``device`` (default
  ``config.device``);
- ``OpenAIProvider`` and ``HFProvider`` speak the HTTP protocols through
  urllib; tests drive them through a ``transport`` callable;
- ``LLMRouter.complete_batch`` serves the cached prompts from the cache.
  When the first available provider decodes a batch natively
  (``native_batch``: ``LocalProvider`` with a ``GPT2LM``), the rest go to
  it as one ``complete_batch`` (one batched decode), where the JAX router
  completes the prompts one at a time; the rate limit is still taken
  once a prompt, and if the batch fails, fail-open sends each of its
  prompts on to the providers after it, one at a time. Any other
  provider gets each prompt on its own, rate-limited and failed over
  prompt by prompt, as in the JAX router.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from neurondb_tpu_torch.config import ENV_PREFIX, get_config, resolve_device


class ProviderError(RuntimeError):
    pass


class BaseProvider:
    name = "base"

    def complete(self, prompt: str, **kw) -> str:
        raise ProviderError(f"{self.name} has no completion support")

    def complete_batch(self, prompts: Sequence[str], **kw) -> List[str]:
        return [self.complete(p, **kw) for p in prompts]

    def native_batch(self) -> bool:
        """True when ``complete_batch`` is one call, not a loop of
        ``complete``."""
        return False

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        raise ProviderError(f"{self.name} has no embedding support")

    def rerank(self, query: str, docs: Sequence[str]) -> np.ndarray:
        raise ProviderError(f"{self.name} has no rerank support")

    def available(self) -> bool:
        return True


class LocalProvider(BaseProvider):
    """On-device runtime (the huggingface-local provider): embed and
    rerank on the port's encoders, ``complete`` on ``GPT2LM`` when weights
    are available (an ``lm`` passed in, or an export directory named by
    ``NEURONDB_TORCH_GPT_WEIGHTS``), else an extractive summary."""

    name = "local"

    def __init__(self, dim: int = 256, seed: int = 0, lm=None, device=None):
        self._dim = dim
        self._seed = seed
        self._device = resolve_device(device)
        self._embedder = None
        self._cross = None
        self._lm = lm
        self._lm_checked = lm is not None

    def _ensure(self):
        if self._embedder is None:
            from neurondb_tpu_torch.ml.transformer import (
                default_cross_encoder, default_embedder)
            self._embedder = default_embedder(dim=self._dim, seed=self._seed,
                                              device=self._device)
            self._cross = default_cross_encoder(dim=self._dim, seed=self._seed,
                                                device=self._device)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        self._ensure()
        return self._embedder(list(texts))

    def rerank(self, query: str, docs: Sequence[str]) -> np.ndarray:
        self._ensure()
        return self._cross(query, list(docs))

    def _ensure_lm(self):
        if not self._lm_checked:
            self._lm_checked = True
            wdir = os.environ.get(ENV_PREFIX + "GPT_WEIGHTS")
            if wdir and os.path.isfile(os.path.join(wdir, "weights.npz")):
                from neurondb_tpu_torch.ml.gpt import GPT2LM
                self._lm = GPT2LM.from_dir(wdir, device=self._device)
        return self._lm

    @staticmethod
    def _gen_kw(kw) -> Dict:
        return dict(max_tokens=int(kw.get("max_tokens", 64)),
                    temperature=float(kw.get("temperature", 0.0)),
                    top_k=int(kw.get("top_k", 0)),
                    top_p=float(kw.get("top_p", 1.0)),
                    seed=int(kw.get("seed", 0)))

    def complete(self, prompt: str, **kw) -> str:
        lm = self._ensure_lm()
        if lm is not None:
            return lm.complete(prompt, **self._gen_kw(kw))
        # extractive fallback: no generative weights are configured
        sents = [s.strip() for s in prompt.replace("\n", ". ").split(".")
                 if s.strip()]
        head = sents[-3:] if len(sents) > 3 else sents
        return "[extractive-local] " + ". ".join(head)

    def native_batch(self) -> bool:
        return self._ensure_lm() is not None

    def complete_batch(self, prompts: Sequence[str], **kw) -> List[str]:
        """One batched decode over the prompts (left-padded together)."""
        lm = self._ensure_lm()
        if lm is None:
            return [self.complete(p, **kw) for p in prompts]
        return lm.complete_batch([lm.tok.encode(p) for p in prompts],
                                 **self._gen_kw(kw))


class OpenAIProvider(BaseProvider):
    """OpenAI-compatible chat/embedding HTTP client (openai_http.c)."""

    name = "openai"

    def __init__(self, api_key: str = "", endpoint: str = "",
                 model: str = "gpt-4o-mini",
                 embed_model: str = "text-embedding-3-small",
                 timeout_s: float = 30.0,
                 transport: Optional[Callable] = None):
        self.api_key = api_key
        self.endpoint = (endpoint or "https://api.openai.com/v1").rstrip("/")
        self.model = model
        self.embed_model = embed_model
        self.timeout_s = timeout_s
        self._transport = transport or self._http

    def _http(self, path: str, payload: Dict) -> Dict:
        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def available(self) -> bool:
        return bool(self.api_key)

    def complete(self, prompt: str, **kw) -> str:
        out = self._transport("/chat/completions", {
            "model": kw.get("model", self.model),
            "messages": [{"role": "user", "content": prompt}],
            "temperature": kw.get("temperature", 0.0),
            "max_tokens": kw.get("max_tokens", 512),
        })
        return out["choices"][0]["message"]["content"]

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = self._transport("/embeddings", {
            "model": self.embed_model, "input": list(texts)})
        return np.asarray([d["embedding"] for d in out["data"]], np.float32)

    def rerank(self, query: str, docs: Sequence[str]) -> np.ndarray:
        scores = []
        for d in docs:
            txt = self.complete(
                "Rate the relevance of the document to the query from 0 to "
                f"10. Reply with a number only.\nQuery: {query}\n"
                f"Document: {d}")
            try:
                scores.append(float(txt.strip().split()[0]))
            except (ValueError, IndexError):
                scores.append(0.0)
        return np.asarray(scores, np.float32)


class HFProvider(BaseProvider):
    """HF Inference API client (hf_http.c)."""

    name = "huggingface"

    def __init__(self, api_key: str = "", model: str = "",
                 endpoint: str = "https://api-inference.huggingface.co",
                 timeout_s: float = 30.0,
                 transport: Optional[Callable] = None):
        self.api_key = api_key
        self.model = model
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s
        self._transport = transport or self._http

    def _http(self, path: str, payload: Dict) -> Any:
        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def available(self) -> bool:
        return bool(self.api_key and self.model)

    def complete(self, prompt: str, **kw) -> str:
        out = self._transport(f"/models/{self.model}",
                              {"inputs": prompt, "parameters": kw})
        if isinstance(out, list) and out and "generated_text" in out[0]:
            return out[0]["generated_text"]
        return str(out)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = self._transport(f"/models/{self.model}",
                              {"inputs": list(texts)})
        return np.asarray(out, np.float32)


class LLMCache:
    """TTL response cache (llm_cache.c parity)."""

    def __init__(self, ttl_s: Optional[float] = None, max_entries: int = 4096):
        self.ttl_s = ttl_s if ttl_s is not None else \
            get_config().llm_cache_ttl_s
        self.max_entries = max_entries
        self._d: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(op: str, payload: Any) -> str:
        return hashlib.sha256(
            (op + "\x00" + json.dumps(payload, sort_keys=True,
                                      default=str)).encode()).hexdigest()

    def get(self, op: str, payload: Any):
        k = self._key(op, payload)
        with self._lock:
            ent = self._d.get(k)
            if ent and time.time() - ent[0] < self.ttl_s:
                self.hits += 1
                return ent[1]
            if ent:
                del self._d[k]
            self.misses += 1
            return None

    def put(self, op: str, payload: Any, value: Any) -> None:
        k = self._key(op, payload)
        with self._lock:
            if len(self._d) >= self.max_entries:
                oldest = min(self._d, key=lambda kk: self._d[kk][0])
                del self._d[oldest]
            self._d[k] = (time.time(), value)


class _RateLimiter:
    def __init__(self, qps: float):
        self.qps = qps
        self._last = 0.0
        self._lock = threading.Lock()

    def acquire(self) -> None:
        if self.qps <= 0:
            return
        with self._lock:
            wait = self._last + 1.0 / self.qps - time.time()
            if wait > 0:
                time.sleep(wait)
            self._last = time.time()


@dataclass
class LLMJob:
    job_id: int
    op: str
    payload: Dict
    status: str = "queued"          # queued | running | done | failed
    result: Any = None
    error: str = ""
    attempts: int = 0


class LLMRouter:
    """Provider dispatch with fail-open fallback (llm_router.c:66-95) and
    an async job queue (ndb_llm_enqueue + neuranllm worker)."""

    def __init__(self, providers: Optional[List[BaseProvider]] = None,
                 *, fail_open: Optional[bool] = None,
                 cache: Optional[LLMCache] = None,
                 rate_limit_qps: Optional[float] = None):
        cfg = get_config()
        self.providers = providers or [LocalProvider()]
        self.fail_open = cfg.llm_fail_open if fail_open is None else fail_open
        self.cache = cache or LLMCache()
        self._limiter = _RateLimiter(
            cfg.llm_rate_limit_qps if rate_limit_qps is None
            else rate_limit_qps)
        self._jobs: Dict[int, LLMJob] = {}
        self._jobq: "queue.Queue[int]" = queue.Queue()
        self._next_job = 1
        self._job_lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _dispatch(self, op: str, *args, **kw):
        return self._dispatch_over(self.providers, op, *args, **kw)

    def _dispatch_over(self, providers: Sequence[BaseProvider], op: str,
                       *args, **kw):
        last_err: Optional[Exception] = None
        for prov in providers:
            if not prov.available():
                continue
            try:
                self._limiter.acquire()
                return getattr(prov, op)(*args, **kw)
            except Exception as e:  # noqa: BLE001 - fail-open semantics
                last_err = e
                if not self.fail_open:
                    raise
        if last_err is not None:
            raise ProviderError(f"all providers failed: {last_err}")
        raise ProviderError("no available provider")

    # ---- sync API (ndb_llm_* parity) ----
    def complete(self, prompt: str, **kw) -> str:
        cached = self.cache.get("complete", [prompt, kw])
        if cached is not None:
            return cached
        out = self._dispatch("complete", prompt, **kw)
        self.cache.put("complete", [prompt, kw], out)
        return out

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        cached = self.cache.get("embed", list(texts))
        if cached is not None:
            return cached
        out = self._dispatch("embed", list(texts))
        self.cache.put("embed", list(texts), out)
        return out

    def rerank(self, query: str, docs: Sequence[str]) -> np.ndarray:
        return self._dispatch("rerank", query, list(docs))

    def complete_batch(self, prompts: Sequence[str], **kw) -> List[str]:
        """Cached prompts from the cache, the rest through
        ``_complete_uncached``, each result cached under its prompt."""
        out: List[Optional[str]] = [self.cache.get("complete", [p, kw])
                                    for p in prompts]
        todo = [i for i, o in enumerate(out) if o is None]
        if todo:
            done = self._complete_uncached([prompts[i] for i in todo], **kw)
            for i, text in zip(todo, done):
                out[i] = text
                self.cache.put("complete", [prompts[i], kw], text)
        return out

    def _complete_uncached(self, prompts: List[str], **kw) -> List[str]:
        """One ``complete_batch`` on the first available provider when it
        batches natively (the rate limit taken once a prompt; on failure,
        fail-open sends each prompt on to the providers after it), else
        each prompt dispatched on its own."""
        avail = [p for p in self.providers if p.available()]
        if avail and avail[0].native_batch():
            try:
                for _ in prompts:
                    self._limiter.acquire()
                return avail[0].complete_batch(prompts, **kw)
            except Exception as e:  # noqa: BLE001 - fail-open semantics
                if not self.fail_open:
                    raise
                if len(avail) == 1:
                    raise ProviderError(f"all providers failed: {e}") from e
            return [self._dispatch_over(avail[1:], "complete", p, **kw)
                    for p in prompts]
        return [self._dispatch("complete", p, **kw) for p in prompts]

    # ---- async jobs (llm_jobs.c / worker_llm.c parity) ----
    def enqueue(self, op: str, payload: Dict) -> int:
        with self._job_lock:
            jid = self._next_job
            self._next_job += 1
        self._jobs[jid] = LLMJob(jid, op, payload)
        self._jobq.put(jid)
        self._ensure_worker()
        return jid

    def job_status(self, job_id: int) -> LLMJob:
        return self._jobs[job_id]

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._worker_loop,
                                            daemon=True)
            self._worker.start()

    def _worker_loop(self) -> None:
        cfg = get_config()
        while not self._stop.is_set():
            try:
                jid = self._jobq.get(timeout=0.2)
            except queue.Empty:
                continue
            job = self._jobs[jid]
            job.status = "running"
            job.attempts += 1
            try:
                if job.op == "complete":
                    job.result = self.complete(job.payload["prompt"])
                elif job.op == "embed":
                    job.result = self.embed(job.payload["texts"])
                elif job.op == "rerank":
                    job.result = self.rerank(job.payload["query"],
                                             job.payload["docs"])
                else:
                    raise ProviderError(f"unknown op {job.op}")
                job.status = "done"
            except Exception as e:  # noqa: BLE001
                if job.attempts < cfg.worker_queue_retry_max:
                    job.status = "queued"
                    self._jobq.put(jid)
                else:
                    job.status = "failed"
                    job.error = str(e)

    def shutdown(self) -> None:
        self._stop.set()


def router_from_config(device=None) -> LLMRouter:
    """The provider chain from config (the ``llm_provider`` knob); the
    local provider's models on ``device``."""
    cfg = get_config()
    chain: List[BaseProvider] = []
    if cfg.llm_provider in ("local", "auto"):
        chain.append(LocalProvider(device=device))
    if cfg.llm_provider in ("openai", "auto") or cfg.llm_api_key:
        chain.append(OpenAIProvider(api_key=cfg.llm_api_key,
                                    endpoint=cfg.llm_endpoint,
                                    model=cfg.llm_model or "gpt-4o-mini"))
    if cfg.llm_provider in ("http", "huggingface"):
        chain.append(HFProvider(api_key=cfg.llm_api_key,
                                model=cfg.llm_model))
    if not chain:
        chain.append(LocalProvider(device=device))
    return LLMRouter(chain)
