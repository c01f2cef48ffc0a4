"""Configuration — the same knobs as ``neurondb_tpu.config.NDBConfig``.

Same fields, the same dotted-name get/set/reset and ``configure``, plus
a ``device`` and an ``ivf_kernel`` field. ``device`` defaults to
``"cuda"``: entry points run on the card unless the caller asks for the
CPU (``device="cpu"`` or ``configure(device="cpu")``, as the tests do),
and nothing picks the CPU on its own. Environment overrides are read
under the prefix ``NEURONDB_TORCH_<UPPER_SNAKE>`` so the two packages can
be configured apart in one process.

Knobs that name a TPU mechanism keep their field for parity but are
served as follows in this package:

- ``ivf_coarse_rt`` / ``topk_recall_target`` < 1.0: served by exact
  ``torch.topk`` (there is no approximate PartialReduce on the card);
- ``ivf_select``: ``"packed"`` (the default, as in the JAX package),
  ``"blockmin"`` or ``"exact"``, the grouped scan kernel's three
  selection modes. The IVF-PQ search reads it too (packed keys when it
  is ``"packed"``, exact for the other two) where the JAX package reads
  the env var ``NEURONDB_TPU_IVF_SELECT``;
- ``ivf_kernel`` (a field of this package only): ``"grouped"`` (the
  default, as in the JAX package) or ``"probe"``, the IVFFlat route
  below the exact point; the counterpart of the JAX package's env var
  ``NEURONDB_TPU_IVF_KERNEL``, read here as ``NEURONDB_TORCH_IVF_KERNEL``.
  An unknown name raises at search time, where the JAX package silently
  takes its round-1 route;
- ``store_dtype="auto"``: bf16 on CUDA, f32 elsewhere (the JAX package's
  "bf16 on TPU").
"""

from __future__ import annotations

import dataclasses
import os
import threading
from dataclasses import dataclass, fields
from typing import Any, Dict, Optional

import torch


@dataclass
class NDBConfig:
    """All runtime knobs. Field names mirror ``neurondb_tpu.config``."""

    # ---- index / ANN knobs ----
    hnsw_m: int = 16
    hnsw_ef_construction: int = 200
    hnsw_ef_search: int = 64
    hnsw_ml: float = 0.36
    hnsw_max_level: int = 16
    hnsw_k: int = 10
    hnsw_build_wave: int = 1024
    hnsw_build_rt: float = 0.99
    ivf_nlists: int = 100
    ivf_nprobe: int = 10
    ivf_kmeans_iters: int = 50
    ivf_kmeans_tol: float = 1e-3
    ivf_sample_cap: int = 10000
    ivf_qt: int = 0                       # grouped-scan queries/tile (0=auto)
    ivf_coarse_rt: float = 0.99           # served exactly (see module doc)
    ivf_select: str = "packed"            # packed | blockmin | exact
    ivf_kernel: str = "grouped"           # grouped | probe (see module doc)
    bm25_scorer: str = "tiled"

    # ---- compute mode ----
    compute_mode: str = "auto"
    use_pallas: bool = True
    batch_size: int = 1024
    scan_chunk: int = 65536               # N-dimension chunk for flat scans
    distance_dtype: str = "float32"
    store_dtype: str = "auto"             # auto = bf16 on CUDA, f32 elsewhere
    topk_recall_target: float = 1.0       # served exactly (see module doc)

    # ---- LLM / embedding gateway ----
    llm_provider: str = "local"
    llm_model: str = ""
    llm_endpoint: str = ""
    llm_api_key: str = ""
    llm_timeout_ms: int = 30000
    llm_cache_ttl_s: int = 300
    llm_rate_limit_qps: float = 0.0
    llm_fail_open: bool = True

    # ---- workers ----
    worker_queue_poll_ms: int = 100
    worker_queue_retry_max: int = 3
    tuner_enable: bool = False
    tuner_target_recall: float = 0.95
    tuner_target_latency_ms: float = 50.0
    tuner_ef_min: int = 16
    tuner_ef_max: int = 512
    defrag_enable: bool = False
    defrag_tombstone_ratio: float = 0.2

    # ---- metrics / observability ----
    metrics_enable: bool = True
    prometheus_port: int = 9187

    # ---- quotas / tenancy ----
    quota_max_vectors: int = 0
    quota_max_qps: float = 0.0
    quota_max_bytes: int = 0

    # ---- misc ----
    seed: int = 0
    max_dim: int = 16000
    validate_inputs: bool = True

    # ---- torch only ----
    device: str = "cuda"                  # the card; CPU runs ask for "cpu"

    def show(self, name: str) -> Any:
        return getattr(self, _norm(name))

    def set(self, name: str, value: Any) -> None:
        key = _norm(name)
        cur = getattr(self, key)  # raises AttributeError for unknown knob
        if cur is not None and value is not None and not isinstance(value, type(cur)):
            value = type(cur)(value)
        setattr(self, key, value)

    def reset(self, name: str) -> None:
        key = _norm(name)
        setattr(self, key, _DEFAULTS[key])

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _norm(name: str) -> str:
    name = name.strip()
    for prefix in ("neurondb_tpu_torch.", "neurondb_tpu.", "neurondb.", "ndb."):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name


_DEFAULTS = {f.name: f.default for f in fields(NDBConfig)}
ENV_PREFIX = "NEURONDB_TORCH_"

_lock = threading.Lock()
_config: Optional[NDBConfig] = None


def _from_env(cfg: NDBConfig) -> NDBConfig:
    for f in fields(NDBConfig):
        env = os.environ.get(ENV_PREFIX + f.name.upper())
        if env is None:
            continue
        if f.type in ("bool", bool):
            cfg.set(f.name, env.lower() in ("1", "true", "on", "yes"))
        else:
            cfg.set(f.name, env)
    return cfg


def get_config() -> NDBConfig:
    global _config
    with _lock:
        if _config is None:
            _config = _from_env(NDBConfig())
        return _config


def set_config(cfg: NDBConfig) -> None:
    global _config
    with _lock:
        _config = cfg


def configure(**kwargs: Any) -> NDBConfig:
    """Set many knobs at once: ``configure(ivf_nprobe=16)``."""
    cfg = get_config()
    for k, v in kwargs.items():
        cfg.set(k, v)
    return cfg


def resolve_device(device=None) -> torch.device:
    """``device`` argument of an index or encoder constructor ->
    torch.device; ``None`` takes ``config.device`` (``"cuda"`` unless
    configured). Nothing falls back to the CPU: without a card, the
    default fails at the first tensor put on ``"cuda"``."""
    dev = get_config().device if device is None else device
    if isinstance(dev, str) and dev == "auto":
        raise ValueError('device "auto" names no device (nothing picks '
                         'the CPU on its own): pass "cuda", "cuda:N", '
                         '"cpu" or a torch.device')
    return torch.device(dev)


def resolve_store_dtype(device: torch.device,
                        store_dtype: Optional[str] = None) -> torch.dtype:
    """``store_dtype`` knob -> the posting store's dtype on ``device``."""
    sd = get_config().store_dtype if store_dtype is None else store_dtype
    if sd == "auto":
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if sd == "bfloat16":
        return torch.bfloat16
    if sd == "float32":
        return torch.float32
    raise ValueError(f"unknown store_dtype {sd!r}; "
                     "known: auto, bfloat16, float32")
