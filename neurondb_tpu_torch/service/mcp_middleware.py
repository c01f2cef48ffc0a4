"""MCP middleware chain — auth, logging, rate-limit, metrics, timeout,
validation.

Reference: NeuronMCP/internal/middleware/ (one file per concern, chained
around every tools/call). Each middleware here is a callable
``(name, args, next) -> result``; MCPServer.use() appends to the chain
and tools/call runs through it outermost-first.

Counterpart of ``neurondb_tpu/service/mcp_middleware.py`` (no jax there,
the same code over the port's ``MetricsRegistry``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

Next = Callable[[str, Dict], Any]


class MCPError(Exception):
    """Carries a JSON-RPC error code."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


AUTH_ERROR = -32001
RATE_LIMITED = -32002
TIMEOUT_ERROR = -32003


class AuthMiddleware:
    """API-key check: the key rides in params._meta.api_key (stdio MCP
    has no headers). No configured keys = auth disabled, matching the
    agent server's APIKeyAuth semantics."""

    def __init__(self, keys: Optional[List[str]] = None):
        import hashlib
        self._hashes = {hashlib.sha256(k.encode()).hexdigest()
                        for k in (keys or [])}

    def add_key(self, key: str) -> None:
        import hashlib
        self._hashes.add(hashlib.sha256(key.encode()).hexdigest())

    def __call__(self, name: str, args: Dict, nxt: Next) -> Any:
        if self._hashes:
            import hashlib
            key = (args.get("_meta") or {}).get("api_key")
            if key is None or hashlib.sha256(
                    str(key).encode()).hexdigest() not in self._hashes:
                raise MCPError(AUTH_ERROR, "unauthorized")
        return nxt(name, args)


class RateLimitMiddleware:
    """Token bucket: ``qps`` sustained, ``burst`` instantaneous."""

    def __init__(self, qps: float = 50.0, burst: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.qps = float(qps)
        self.burst = float(burst if burst is not None else max(qps, 1))
        self._tokens = self.burst
        self._last = clock()
        self._clock = clock
        self._lock = threading.Lock()

    def __call__(self, name: str, args: Dict, nxt: Next) -> Any:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.qps)
            self._last = now
            if self._tokens < 1.0:
                raise MCPError(RATE_LIMITED, "rate limit exceeded")
            self._tokens -= 1.0
        return nxt(name, args)


class LoggingMiddleware:
    """Structured per-call records (tool, ms, ok/error)."""

    def __init__(self, sink: Optional[Callable[[Dict], None]] = None,
                 keep: int = 1000):
        self.records: List[Dict] = []
        self._sink = sink
        self._keep = keep

    def __call__(self, name: str, args: Dict, nxt: Next) -> Any:
        t0 = time.time()
        rec = {"tool": name, "ts": t0}
        try:
            out = nxt(name, args)
            rec["ok"] = True
            return out
        except Exception as e:
            rec["ok"] = False
            rec["error"] = str(e)
            raise
        finally:
            rec["ms"] = round((time.time() - t0) * 1e3, 3)
            self.records.append(rec)
            del self.records[:-self._keep]
            if self._sink:
                self._sink(rec)


class MetricsMiddleware:
    """Counters + latency into a MetricsRegistry (Prometheus-exported)."""

    def __init__(self, registry=None):
        if registry is None:
            from neurondb_tpu_torch.service.metrics import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry

    def __call__(self, name: str, args: Dict, nxt: Next) -> Any:
        self.registry.counter("mcp_tool_calls_total").inc()
        try:
            with self.registry.timer(f"mcp_tool_{name}_seconds"):
                return nxt(name, args)
        except Exception:
            self.registry.counter("mcp_tool_errors_total").inc()
            raise


class TimeoutMiddleware:
    """Bounds a tool call's wall clock; the worker thread is abandoned
    on timeout (Python can't kill it) but the caller gets an error."""

    def __init__(self, seconds: float = 30.0):
        self.seconds = float(seconds)

    def __call__(self, name: str, args: Dict, nxt: Next) -> Any:
        box: Dict[str, Any] = {}

        def run():
            try:
                box["out"] = nxt(name, args)
            except Exception as e:  # noqa: BLE001
                box["err"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(self.seconds)
        if t.is_alive():
            raise MCPError(TIMEOUT_ERROR,
                           f"tool {name!r} timed out after "
                           f"{self.seconds}s")
        if "err" in box:
            raise box["err"]
        return box.get("out")


class ValidationMiddleware:
    """Checks args against the registered inputSchema: required fields,
    primitive types, unknown-field rejection (strict=True)."""

    _TYPES = {"string": str, "integer": int, "number": (int, float),
              "boolean": bool, "array": list, "object": dict}

    def __init__(self, schemas: Dict[str, Dict], strict: bool = False):
        self._schemas = schemas
        self.strict = strict

    def __call__(self, name: str, args: Dict, nxt: Next) -> Any:
        schema = self._schemas.get(name)
        if schema:
            props = schema.get("properties", {})
            for req in schema.get("required", []):
                if req not in args:
                    raise ValueError(f"missing required field {req!r}")
            for key, val in args.items():
                if key == "_meta":
                    continue
                if key not in props:
                    if self.strict:
                        raise ValueError(f"unknown field {key!r}")
                    continue
                want = self._TYPES.get(props[key].get("type"))
                if want and not isinstance(val, want):
                    raise ValueError(
                        f"field {key!r} must be {props[key]['type']}")
                if props[key].get("type") in ("number", "integer"):
                    if isinstance(val, bool):
                        raise ValueError(
                            f"field {key!r} must be numeric, got bool")
        return nxt(name, args)


def build_chain(middlewares: List[Callable], terminal: Next) -> Next:
    """Compose middlewares outermost-first around the terminal handler."""
    nxt = terminal
    for mw in reversed(middlewares):
        nxt = (lambda mw, inner: lambda n, a: mw(n, a, inner))(mw, nxt)
    return nxt
