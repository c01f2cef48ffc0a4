"""REST server — the NeuronAgent HTTP surface on stdlib http.server.

Reference routes (NeuronAgent/cmd/agent-server/main.go:97-120):
/api/v1/agents, /api/v1/sessions, /api/v1/sessions/<id>/messages, /health,
/metrics (Prometheus text). Adds engine endpoints the Go server proxied
through SQL: /api/v1/search (vector search over a registered collection).

Counterpart of ``neurondb_tpu/service/rest.py``: the same routes over the
port's agent runtime and indexes. Search results leave as lists or raw
bytes made from host numpy arrays (a torch tensor is copied to the host
first), never through ``json.dumps(default=str)``, which would turn a
tensor into its repr. ``enable_batching`` picks the int8 wire for the
port's ``index.base.BaseIndex`` collections, as the JAX server does for
its own.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from neurondb_tpu_torch.service.agent import AgentRuntime, APIKeyAuth
from neurondb_tpu_torch.service.batcher import to_host
from neurondb_tpu_torch.service.metrics import MetricsRegistry


class RESTServer:
    def __init__(self, runtime: Optional[AgentRuntime] = None,
                 host: str = "127.0.0.1", port: int = 8080,
                 auth: Optional[APIKeyAuth] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.runtime = runtime or AgentRuntime()
        self.auth = auth or APIKeyAuth()
        self.metrics = metrics or MetricsRegistry()
        self.collections: Dict[str, Any] = {}   # name -> index with .search
        self.collection_docs: Dict[str, list] = {}
        self.batchers: Dict[str, Any] = {}      # name -> MicroBatcher
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"       # keep-alive: serving
            # clients reuse connections; HTTP/1.0 resets them per request

            def log_message(self, *a):          # silence
                pass

            def _send(self, code: int, obj: Any):
                body = json.dumps(obj, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authed(self) -> bool:
                role = outer.auth.check(self.headers.get("X-API-Key"))
                if role is None:
                    self._send(401, {"error": "unauthorized"})
                    return False
                return True

            def _body(self) -> Dict:
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                outer.metrics.counter("http_requests_total").inc()
                if self.path == "/ws" or self.path.startswith("/ws?"):
                    # Auth BEFORE the upgrade (reference mounts /ws behind
                    # AuthMiddleware, NeuronAgent cmd/agent-server/main.go:94).
                    # Browser WS clients can't set headers, so accept the
                    # key as a query param too.
                    key = self.headers.get("X-API-Key")
                    if key is None and "?" in self.path:
                        from urllib.parse import parse_qs, urlsplit
                        qs = parse_qs(urlsplit(self.path).query)
                        key = (qs.get("key") or qs.get("api_key")
                               or [None])[0]
                    if outer.auth.check(key) is None:
                        return self._send(401, {"error": "unauthorized"})
                    from neurondb_tpu_torch.service.websocket import (
                        handle_ws_upgrade, serve_agent_ws)
                    sock = handle_ws_upgrade(self)
                    if sock is None:
                        return self._send(400,
                                          {"error": "websocket upgrade "
                                                    "required"})
                    serve_agent_ws(sock, outer.runtime)
                    self.close_connection = True
                    return
                if self.path == "/health":
                    return self._send(200, {"status": "ok"})
                if self.path == "/metrics":
                    text = outer.metrics.prometheus_text()
                    body = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if not self._authed():
                    return
                if self.path == "/api/v1/agents":
                    return self._send(200, [vars(a) for a in
                                            outer.runtime.agents.values()])
                m = re.fullmatch(r"/api/v1/sessions/([\w-]+)/messages",
                                 self.path)
                if m:
                    msgs = outer.runtime.history(m.group(1))
                    return self._send(200, [vars(x) for x in msgs])
                self._send(404, {"error": "not found"})

            # SSE streaming (streaming.go:12-75): `stream: true` on the
            # messages route answers text/event-stream with `chunk`
            # events (50-char content slices) and a final `done` event
            # carrying tool-call metadata; errors arrive as `error`
            # events on the stream, not HTTP status codes.
            def _sse(self, event: str, data: Dict) -> None:
                payload = json.dumps(data, default=str)
                self.wfile.write(
                    f"event: {event}\ndata: {payload}\n\n".encode())
                self.wfile.flush()

            def _stream_message(self, session_id: str, content: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                # no Content-Length on an event stream: close delimits
                # the body (close_connection below enforces it server-side)
                self.send_header("Connection", "close")
                self.send_header("X-Accel-Buffering", "no")
                self.end_headers()
                try:
                    with outer.metrics.timer("agent_execute_seconds"):
                        msg = outer.runtime.execute(session_id, content)
                except Exception as e:  # noqa: BLE001
                    self._sse("error", {"error": str(e)})
                    self.close_connection = True
                    return
                text = msg.content or ""
                chunk = 50                      # chars/chunk, as reference
                for i in range(0, len(text), chunk):
                    self._sse("chunk", {"content": text[i:i + chunk]})
                self._sse("done", {"message_id": msg.message_id,
                                   "tool_calls": msg.tool_calls})
                self.close_connection = True

            def do_POST(self):
                outer.metrics.counter("http_requests_total").inc()
                if not self._authed():
                    return
                try:
                    if self.path == "/api/v1/agents":
                        b = self._body()
                        a = outer.runtime.create_agent(
                            b.get("name", "agent"),
                            b.get("system_prompt", ""),
                            b.get("tools"))
                        return self._send(201, vars(a))
                    if self.path == "/api/v1/sessions":
                        b = self._body()
                        s = outer.runtime.create_session(
                            b["agent_id"], b.get("metadata"))
                        return self._send(201, vars(s))
                    m = re.fullmatch(r"/api/v1/sessions/([\w-]+)/messages",
                                     self.path)
                    if m:
                        b = self._body()
                        if b.get("stream"):
                            return self._stream_message(m.group(1),
                                                        b.get("content", ""))
                        with outer.metrics.timer("agent_execute_seconds"):
                            msg = outer.runtime.execute(
                                m.group(1), b.get("content", ""))
                        return self._send(200, vars(msg))
                    if self.path == "/api/v1/search":
                        b = self._body()
                        name = b.get("collection", "default")
                        idx = outer.collections.get(name)
                        if idx is None:
                            return self._send(404,
                                              {"error": f"no collection "
                                                        f"{name!r}"})
                        q = np.asarray(b["vector"], np.float32)
                        k = int(b.get("k", 10))
                        bat = outer.batchers.get(name)
                        with outer.metrics.timer("search_seconds"):
                            if bat is not None and q.ndim == 1:
                                d, ids = bat.search(q, k=k)
                            else:
                                d, ids = idx.search(q, k=k)
                        return self._send(200, {
                            "ids": to_host(ids).tolist(),
                            "distances": to_host(d).tolist()})
                    if self.path.startswith("/api/v1/search.bin"):
                        # Binary wire: no float-list JSON to parse or
                        # encode on the host. Body: raw little-endian
                        # f32 query vector; response: k int64 ids + k
                        # f32 distances, packed. Params via query string.
                        from urllib.parse import parse_qs, urlsplit
                        qs = parse_qs(urlsplit(self.path).query)
                        name = (qs.get("collection") or ["default"])[0]
                        k = int((qs.get("k") or ["10"])[0])
                        idx = outer.collections.get(name)
                        if idx is None:
                            return self._send(404,
                                              {"error": f"no collection "
                                                        f"{name!r}"})
                        n = int(self.headers.get("Content-Length") or 0)
                        q = np.frombuffer(self.rfile.read(n),
                                          np.float32).copy()   # writable
                        bat = outer.batchers.get(name)
                        with outer.metrics.timer("search_seconds"):
                            if bat is not None:
                                d, ids = bat.search(q, k=k)
                            else:
                                d, ids = idx.search(q, k=k)
                        body = (to_host(ids).astype(np.int64).tobytes()
                                + to_host(d).astype(np.float32).tobytes())
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        self.send_header("X-NDB-K", str(k))
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    self._send(404, {"error": "not found"})
                except KeyError as e:
                    self._send(404, {"error": f"not found: {e}"})
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error": str(e)})

        self._handler = Handler
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def add_collection(self, name: str, index) -> None:
        self.collections[name] = index

    def enable_batching(self, name: str, *, window_ms: float = 10.0,
                        max_batch: int = 4096, wire: Optional[str] = None,
                        pad_floor: int = 1, **search_kw) -> None:
        """Route single-vector /api/v1/search requests for `name`
        through a MicroBatcher (one device dispatch per 10 ms window
        instead of one per HTTP request — see service/batcher.py).

        ``wire`` defaults to the int8 query wire for BaseIndex
        collections (the JAX server's choice, and the wire bench.py
        serves) and to "f32" for index objects whose search() doesn't
        route queries through index/base.as_batch. Pass "f32" explicitly
        for a full-precision wire (tiny-dim / extreme-dynamic-range)."""
        from neurondb_tpu_torch.index.base import BaseIndex
        from neurondb_tpu_torch.service.batcher import MicroBatcher
        idx = self.collections[name]
        if wire is None:
            wire = "int8" if isinstance(idx, BaseIndex) else "f32"
        self.batchers[name] = MicroBatcher(
            idx, window_ms=window_ms,
            max_batch=max_batch, wire=wire, pad_floor=pad_floor,
            search_kw=search_kw)

    def start(self) -> int:
        # stdlib default listen backlog is 5; serving benches open
        # dozens of connections at once and a full accept queue shows
        # up client-side as connection resets
        srv_cls = type("_RESTHTTPServer", (ThreadingHTTPServer,),
                       {"request_queue_size": 128})
        self._httpd = srv_cls((self.host, self.port), self._handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        for b in self.batchers.values():
            b.close()
        self.batchers.clear()
