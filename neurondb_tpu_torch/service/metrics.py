"""Metrics registry + Prometheus exposition + engine stat view.

Reference: pg_stat_neurondb view with per-index query counts / latency /
recall (NeuronDB/src/metrics/pg_stat_neurondb.c), Prometheus HTTP exporter
bgworker on port 9187 (src/metrics/prometheus.c:50,115,164), NeuronAgent
/metrics endpoint.

Counterpart of ``neurondb_tpu/service/metrics.py`` (no jax there, so the
same code): the same metric names under the same ``neurondb_tpu``
namespace, so dashboards read either package; the exporter's default
port is the port's ``prometheus_port`` knob.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from neurondb_tpu_torch.config import get_config


class Counter:
    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0):
        with self._lock:
            self.value += v


class Gauge:
    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = v


class Histogram:
    """Fixed-bucket latency histogram + rolling mean/max."""

    BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, float("inf"))

    def __init__(self):
        self.counts = [0] * len(self.BUCKETS)
        self.total = 0.0
        self.n = 0
        self.max = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float):
        with self._lock:
            for i, b in enumerate(self.BUCKETS):
                if v <= b:
                    self.counts[i] += 1
                    break
            self.total += v
            self.n += 1
            self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


class MetricsRegistry:
    def __init__(self, namespace: str = "neurondb_tpu"):
        self.namespace = namespace
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._hists.setdefault(name, Histogram())

    @contextmanager
    def timer(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.histogram(name).observe(time.time() - t0)

    def prometheus_text(self) -> str:
        out: List[str] = []
        ns = self.namespace
        for n, c in self._counters.items():
            out.append(f"# TYPE {ns}_{n} counter")
            out.append(f"{ns}_{n} {c.value}")
        for n, g in self._gauges.items():
            out.append(f"# TYPE {ns}_{n} gauge")
            out.append(f"{ns}_{n} {g.value}")
        for n, h in self._hists.items():
            out.append(f"# TYPE {ns}_{n} histogram")
            cum = 0
            for b, cnt in zip(h.BUCKETS, h.counts):
                cum += cnt
                lb = "+Inf" if b == float("inf") else str(b)
                out.append(f'{ns}_{n}_bucket{{le="{lb}"}} {cum}')
            out.append(f"{ns}_{n}_sum {h.total}")
            out.append(f"{ns}_{n}_count {h.n}")
        return "\n".join(out) + "\n"

    # ---- pg_stat_neurondb analog ----
    def stat_view(self) -> List[Dict]:
        rows = []
        for n, h in self._hists.items():
            rows.append({"metric": n, "calls": h.n,
                         "avg_seconds": round(h.mean, 6),
                         "max_seconds": round(h.max, 6)})
        for n, c in self._counters.items():
            rows.append({"metric": n, "calls": int(c.value),
                         "avg_seconds": None, "max_seconds": None})
        return rows


_global = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    return _global


class PrometheusExporter:
    """Standalone exporter HTTP server (prometheus.c bgworker parity;
    default port from the prometheus_port knob)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: Optional[int] = None):
        self.registry = registry or get_metrics()
        self.host = host
        self.port = port if port is not None else get_config().prometheus_port
        reg = self.registry

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                body = reg.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._handler = Handler
        self._httpd = None
        self._thread = None

    def start(self) -> int:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
