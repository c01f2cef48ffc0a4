"""Multi-tenancy: quotas, usage metering, row-level security filters.

Reference: NeuronDB/src/tenant/multi_tenant.c (tenant workers, usage
metering, policy, audit), src/scan/scan_quota.c (per-tenant vector-count/
storage/QPS limits) and src/scan/scan_rls.c (RLS policy enforcement in
ANN scans). Here enforcement happens at the API layer: a TenantManager
tracks per-tenant usage, enforces quotas on ingest/search, and applies
row-visibility predicates to search results.

Counterpart of ``neurondb_tpu/service/tenant.py``: the same quotas and
RLS over the port's ``Client`` collections; the default quota comes from
the port's ``quota_*`` knobs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from neurondb_tpu_torch.config import get_config


class QuotaExceeded(RuntimeError):
    pass


@dataclass
class TenantQuota:
    max_vectors: int = 0        # 0 = unlimited
    max_bytes: int = 0
    max_qps: float = 0.0


@dataclass
class TenantUsage:
    vectors: int = 0
    bytes: int = 0
    queries: int = 0
    last_window: float = field(default_factory=time.time)
    window_queries: int = 0


@dataclass
class AuditEvent:
    ts: float
    tenant: str
    action: str
    detail: Dict


class TenantManager:
    def __init__(self):
        cfg = get_config()
        self._default = TenantQuota(cfg.quota_max_vectors,
                                    cfg.quota_max_bytes, cfg.quota_max_qps)
        self._quotas: Dict[str, TenantQuota] = {}
        self._usage: Dict[str, TenantUsage] = {}
        self._rls: Dict[str, Callable[[int, Dict], bool]] = {}
        self.audit_log: List[AuditEvent] = []
        self._lock = threading.Lock()

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        with self._lock:
            self._quotas[tenant] = quota

    def set_rls_policy(self, tenant: str,
                       predicate: Callable[[int, Dict], bool]) -> None:
        """Row predicate (id, metadata) -> visible?"""
        self._rls[tenant] = predicate

    def usage(self, tenant: str) -> TenantUsage:
        with self._lock:
            return self._usage.setdefault(tenant, TenantUsage())

    def _quota(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, self._default)

    def _audit(self, tenant: str, action: str, **detail) -> None:
        self.audit_log.append(AuditEvent(time.time(), tenant, action, detail))

    # ---- enforcement ----
    def check_ingest(self, tenant: str, n_vectors: int, n_bytes: int) -> None:
        q = self._quota(tenant)
        u = self.usage(tenant)
        # check-and-increment under one lock: a TOCTOU window here would
        # let concurrent ingests blow past the quota
        with self._lock:
            if q.max_vectors and u.vectors + n_vectors > q.max_vectors:
                self._audit(tenant, "quota_reject", kind="vectors")
                raise QuotaExceeded(
                    f"tenant {tenant!r} vector quota {q.max_vectors} "
                    "exceeded")
            if q.max_bytes and u.bytes + n_bytes > q.max_bytes:
                self._audit(tenant, "quota_reject", kind="bytes")
                raise QuotaExceeded(
                    f"tenant {tenant!r} storage quota {q.max_bytes} "
                    "exceeded")
            u.vectors += n_vectors
            u.bytes += n_bytes
        self._audit(tenant, "ingest", vectors=n_vectors, bytes=n_bytes)

    def check_query(self, tenant: str) -> None:
        q = self._quota(tenant)
        u = self.usage(tenant)
        now = time.time()
        with self._lock:
            if now - u.last_window >= 1.0:
                u.last_window = now
                u.window_queries = 0
            u.window_queries += 1
            u.queries += 1
            if q.max_qps and u.window_queries > q.max_qps:
                self._audit(tenant, "quota_reject", kind="qps")
                raise QuotaExceeded(
                    f"tenant {tenant!r} QPS quota {q.max_qps} exceeded")

    def filter_results(self, tenant: str, ids: np.ndarray,
                       dists: np.ndarray,
                       metadata: Optional[Dict[int, Dict]] = None
                       ) -> tuple:
        """Apply the tenant's RLS predicate to (ids, dists) rows."""
        pred = self._rls.get(tenant)
        if pred is None:
            return ids, dists
        ids = np.asarray(ids)
        dists = np.asarray(dists)
        md = metadata or {}
        mask = np.asarray([i >= 0 and pred(int(i), md.get(int(i), {}))
                           for i in ids.ravel()]).reshape(ids.shape)
        return (np.where(mask, ids, -1),
                np.where(mask, dists, np.float32(np.inf)))


class TenantScopedCollection:
    """Quota+RLS wrapper over a client Collection (scan-layer parity)."""

    def __init__(self, collection, manager: TenantManager, tenant: str):
        self.collection = collection
        self.manager = manager
        self.tenant = tenant

    def add(self, vectors, **kw):
        v = np.atleast_2d(np.asarray(vectors, np.float32))
        self.manager.check_ingest(self.tenant, len(v), v.nbytes)
        return self.collection.add(v, **kw)

    def search(self, query, k: int = 10, **kw):
        self.manager.check_query(self.tenant)
        res = self.collection.search(query, k=k, **kw)
        pred = self.manager._rls.get(self.tenant)
        if pred is None:
            return res
        return [r for r in res if pred(r["id"], r.get("metadata", {}))]
