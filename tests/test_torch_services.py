"""The serving layer: REST (JSON, binary wire, micro-batched), the
micro-batcher, the agent runtime, SSE and /ws, metrics and tracing — the
torch port against the JAX package on the CPU.

Both servers run side by side on port 0 over the same data: a
``FlatIndex`` each, and an ``IVFFlatIndex`` built by the JAX package and
carried into the port with ``from_state`` (the same centroids and
lists). The port's IVF selection is pinned exact (the JAX CPU route is
exact). Every network wait has its own timeout.
"""

import base64
import concurrent.futures as cf
import json
import os
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import neurondb_tpu.index as JI
from neurondb_tpu.service import agent as JAG
from neurondb_tpu.service import batcher as JB
from neurondb_tpu.service import llm as JL
from neurondb_tpu.service import metrics as JMET
from neurondb_tpu.service import rest as JREST
from neurondb_tpu.utils import tracing as JTR
import neurondb_tpu_torch.config as TC
from neurondb_tpu_torch.index.flat import FlatIndex as TFlat
from neurondb_tpu_torch.index.ivf import IVFFlatIndex as TIVF
from neurondb_tpu_torch.service import agent as TAG
from neurondb_tpu_torch.service import batcher as TB
from neurondb_tpu_torch.service import llm as TL
from neurondb_tpu_torch.service import metrics as TMET
from neurondb_tpu_torch.service import rest as TREST
from neurondb_tpu_torch.service import websocket as TWS
from neurondb_tpu_torch.utils import tracing as TTR

N, DIM, NQ, K = 2000, 32, 48, 10
# f32 distances with sums in another order: a swap is allowed only
# between two neighbours whose distances tie at this relative rounding
TIE_RTOL = 1e-5
HTTP_TIMEOUT = 10


@pytest.fixture(scope="module", autouse=True)
def _cpu_exact_one_thread():
    prev_cfg, prev_threads = TC._config, torch.get_num_threads()
    TC.set_config(TC.NDBConfig(device="cpu", ivf_select="exact"))
    torch.set_num_threads(1)
    yield
    TC.set_config(prev_cfg)
    torch.set_num_threads(prev_threads)


def _scripted(pkg, responses):
    class Scripted(pkg.BaseProvider):
        name = "scripted"

        def __init__(self):
            self.responses = list(responses)

        def complete(self, prompt, **kw):
            return self.responses.pop(0) if self.responses else "ok"

        def embed(self, texts):
            return np.ones((len(texts), 4), np.float32)
    return Scripted()


@pytest.fixture(scope="module")
def data(rng_mod):
    centers = rng_mod.standard_normal((16, DIM)).astype(np.float32) * 2.0
    x = (centers[rng_mod.integers(0, 16, N)]
         + rng_mod.standard_normal((N, DIM)).astype(np.float32))
    q = (x[rng_mod.choice(N, NQ, replace=False)]
         + 0.3 * rng_mod.standard_normal((NQ, DIM)).astype(np.float32))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def servers(data):
    """(JAX server, port server) with collections flat / ivf, and
    micro-batched copies flat_b / ivf_b (int8 wire, nprobe 4)."""
    x, _ = data
    jivf = JI.IVFFlatIndex(x, nlists=32, seed=0)
    arrays, meta = jivf._state()
    tivf = TIVF.from_state({k: np.asarray(v) for k, v in arrays.items()},
                           dict(meta, metric="l2", dim=DIM), device="cpu")
    pairs = {"flat": (JI.FlatIndex(x), TFlat(x, device="cpu")),
             "ivf": (jivf, tivf)}
    out = []
    for side, (mod, ag, llm) in enumerate(((JREST, JAG, JL),
                                           (TREST, TAG, TL))):
        rt = ag.AgentRuntime(llm.LLMRouter(
            [_scripted(llm, ["hello there"] * 64)]))
        srv = mod.RESTServer(rt, port=0)
        for name, both in pairs.items():
            srv.add_collection(name, both[side])
            srv.add_collection(name + "_b", both[side])
            srv.enable_batching(name + "_b", window_ms=5.0, max_batch=64,
                                nprobe=4)
        out.append((srv, srv.start()))
    yield out
    for srv, _ in out:
        srv.stop()


def _post(port, path, payload=None, raw=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data)
    req.add_header("Content-Type", "application/octet-stream" if raw
                   is not None else "application/json")
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
        return r.status, r.headers, r.read()


def _search(port, name, q, wire):
    if wire == "json":
        code, _, body = _post(port, "/api/v1/search",
                              {"collection": name, "vector": q.tolist(),
                               "k": K})
        out = json.loads(body)
        return code, np.asarray(out["ids"]), np.asarray(out["distances"])
    code, hdr, body = _post(port, f"/api/v1/search.bin?collection={name}"
                                  f"&k={K}", raw=q.tobytes())
    k = int(hdr["X-NDB-K"])
    return (code, np.frombuffer(body[:8 * k], np.int64),
            np.frombuffer(body[8 * k:], np.float32))


def _same_neighbours(ti, td, ji, jd):
    """Ids equal in order, apart from swaps inside a distance tie."""
    assert ti.shape == ji.shape
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    for r in range(ti.shape[0]):
        for c in np.nonzero(ti[r] != ji[r])[0]:
            band = np.abs(jd[r] - jd[r, c]) <= \
                TIE_RTOL * max(abs(jd[r, c]), 1.0)
            assert ti[r, c] in ji[r][band], (r, c, ti[r], ji[r])


@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("route", ["json", "bin", "json_batched",
                                   "bin_batched"])
def test_rest_search_ids_equal_jax(servers, data, kind, route):
    """Every route's answers over the port's index equal the JAX
    server's over the JAX index; the batched routes send their requests
    concurrently so that batches form, through the int8 wire."""
    _, q = data
    name = kind + ("_b" if route.endswith("batched") else "")
    wire = route.split("_")[0]
    got = []
    for srv, port in servers:
        with cf.ThreadPoolExecutor(8) as ex:
            res = list(ex.map(lambda v: _search(port, name, v, wire), q))
        assert all(code == 200 for code, _, _ in res)
        got.append((np.stack([r[1] for r in res]),
                    np.stack([r[2] for r in res])))
    (ji, jd), (ti, td) = got
    _same_neighbours(ti, td, ji, jd)
    if route.endswith("batched"):
        for srv, _ in servers:
            st = srv.batchers[name].stats
            assert st["requests"] >= NQ and st["batches"] < st["requests"]


def test_batched_answers_equal_one_direct_search(servers, data):
    """The micro-batched int8 route answers as one direct search of all
    queries over the int8 wire (the check the card's smoke run makes)."""
    from neurondb_tpu_torch.index.base import quantize_queries_int8
    _, q = data
    srv, port = servers[1]
    direct_d, direct_i = srv.collections["ivf_b"].search(
        quantize_queries_int8(q), k=K, nprobe=4)
    with cf.ThreadPoolExecutor(16) as ex:
        res = list(ex.map(lambda v: _search(port, "ivf_b", v, "bin"), q))
    ids = np.stack([r[1] for r in res])
    _same_neighbours(ids, np.stack([r[2] for r in res]), direct_i, direct_d)


def test_rest_unknown_collection_and_auth(servers, data):
    _, q = data
    for srv, port in servers:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _search(port, "nope", q[0], "json")
        assert ei.value.code == 404
    codes = []
    for mod, ag in ((JREST, JAG), (TREST, TAG)):
        auth = ag.APIKeyAuth()
        key = auth.issue("user")
        srv = mod.RESTServer(port=0, auth=auth)
        port = srv.start()
        try:
            url = f"http://127.0.0.1:{port}/api/v1/agents"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(url, timeout=HTTP_TIMEOUT)
            req = urllib.request.Request(url, headers={"X-API-Key": key})
            with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
                codes.append((ei.value.code, r.status, json.loads(r.read())))
        finally:
            srv.stop()
    assert codes[0] == codes[1] == (401, 200, [])


class _Recorder:
    """An IVF index that records the kwargs of each search."""

    def __init__(self, index):
        self.index, self.calls = index, []
        self.dim = index.dim

    def device_out_ok(self):
        return self.index.device_out_ok()

    def search(self, q, k=10, **kw):
        self.calls.append(dict(kw))
        return self.index.search(q, k=k, **kw)


def test_batcher_asks_device_output_from_the_index_state(data):
    """``out="device"`` is asked for exactly when the index's state
    allows it (no spill buffer, int32 ids), decided before the call; a
    spill buffer turns it off, and the answers stay right both ways."""
    x, q = data
    idx = TIVF(x, nlists=16, seed=0, device="cpu")
    rec = _Recorder(idx)
    bat = TB.MicroBatcher(rec, window_ms=1.0, search_kw={"nprobe": 4})
    try:
        d, ids = bat.search(x[7], k=3)
        assert ids[0] == 7 and isinstance(ids, np.ndarray)
        assert rec.calls[-1] == {"nprobe": 4, "out": "device"}
        idx.add(x[:2] + 100.0)                       # a spill buffer
        assert not idx.device_out_ok()
        d, ids = bat.search(x[9], k=3)
        assert ids[0] == 9
        assert rec.calls[-1] == {"nprobe": 4}
    finally:
        bat.close()


@pytest.mark.parametrize("pkg", [JB, TB], ids=["jax", "torch"])
def test_batcher_error_fanout_and_dim_check(pkg):
    class Boom:
        dim = 4

        def search(self, q, k=10, **kw):
            raise ValueError("boom")

    bat = pkg.MicroBatcher(Boom(), window_ms=1.0)
    try:
        with pytest.raises(ValueError, match="boom"):
            bat.search(np.zeros(4, np.float32), k=2)
        with pytest.raises(ValueError, match="dim 3"):
            bat.search(np.zeros(3, np.float32), k=2)
    finally:
        bat.close()
    with pytest.raises(RuntimeError, match="closed"):
        bat.search(np.zeros(4, np.float32), k=2)


def test_batcher_stats_and_padding_divergence(data):
    """The JAX batcher pads each batch to a power of two; the port
    searches the real rows only. ``stats`` count the same things."""
    x, _ = data
    seen = {}
    for pkg in (JB, TB):
        rows = []

        class Flat:
            dim = DIM

            def search(self, q, k=10, **kw):
                rows.append(len(q))
                d = np.zeros((len(q), k), np.float32)
                return d, np.tile(np.arange(k), (len(q), 1))

        bat = pkg.MicroBatcher(Flat(), window_ms=50.0, max_batch=64)
        try:
            with cf.ThreadPoolExecutor(5) as ex:
                list(ex.map(lambda v: bat.search(v, k=2), x[:5]))
        finally:
            bat.close()
        seen[pkg] = (rows, dict(bat.stats))
    assert seen[JB][1]["requests"] == seen[TB][1]["requests"] == 5
    assert sum(seen[TB][0]) == 5                    # no padded rows
    assert all(r & (r - 1) == 0 for r in seen[JB][0])


def test_rest_answers_tensors_as_lists(data):
    """An index that returns torch tensors still answers numbers (the
    JSON encoder's ``default=str`` would have written the repr)."""
    x, _ = data

    class TensorIndex:
        dim = DIM

        def search(self, q, k=10, **kw):
            return torch.zeros(k), torch.arange(k)

    srv = TREST.RESTServer(port=0)
    srv.add_collection("t", TensorIndex())
    port = srv.start()
    try:
        code, ids, d = _search(port, "t", x[0], "json")
        assert code == 200 and ids.tolist() == list(range(K))
        code, ids, d = _search(port, "t", x[0], "bin")
        assert ids.tolist() == list(range(K)) and d.dtype == np.float32
    finally:
        srv.stop()


def test_rest_agent_flow_and_sse_equal_jax(servers):
    seen = []
    for srv, port in servers:
        _, _, b = _post(port, "/api/v1/agents", {"name": "bot"})
        agent = json.loads(b)
        _, _, b = _post(port, "/api/v1/sessions",
                        {"agent_id": agent["agent_id"]})
        sess = json.loads(b)
        path = f"/api/v1/sessions/{sess['session_id']}/messages"
        code, _, b = _post(port, path, {"content": "hi"})
        msg = json.loads(b)
        code, hdr, raw = _post(port, path, {"content": "hi", "stream": True})
        assert hdr["Content-Type"] == "text/event-stream"
        events = []
        for block in raw.decode().strip().split("\n\n"):
            lines = dict(ln.split(": ", 1) for ln in block.split("\n"))
            ev = json.loads(lines["data"])
            ev.pop("message_id", None)
            events.append((lines["event"], ev))
        _, _, raw_err = _post(port, "/api/v1/sessions/none/messages",
                              {"content": "x", "stream": True})
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=HTTP_TIMEOUT) as r:
            metrics = r.read().decode()
        seen.append((msg["role"], msg["content"], events,
                     raw_err.decode().split("\n")[0],
                     "http_requests_total" in metrics))
    assert seen[0] == seen[1]
    assert seen[1][0] == "assistant" and "hello there" in seen[1][1]
    assert seen[1][3] == "event: error" and seen[1][4]


def _mask_frame(payload: bytes) -> bytes:
    mask = b"\x01\x02\x03\x04"
    body = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return bytes([0x81, 0x80 | len(payload)]) + mask + body


@pytest.mark.parametrize("pkg", [(JREST, JAG, JL), (TREST, TAG, TL)],
                         ids=["jax", "torch"])
def test_ws_roundtrip(pkg):
    mod, ag, llm = pkg
    rt = ag.AgentRuntime(llm.LLMRouter([_scripted(llm, ["ws-reply"])]))
    sess = rt.create_session(rt.create_agent("ws").agent_id)
    srv = mod.RESTServer(rt, port=0)
    port = srv.start()
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=HTTP_TIMEOUT)
        key = base64.b64encode(b"0123456789abcdef").decode()
        s.sendall((f"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                   f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                   f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(1024)
        assert b"101" in buf.split(b"\r\n")[0]
        assert TWS.accept_key(key).encode() in buf
        s.sendall(_mask_frame(json.dumps(
            {"session_id": sess.session_id, "content": "hi"}).encode()))
        _, payload = TWS.decode_frame(s, require_mask=False)
        assert json.loads(payload)["content"] == "ws-reply"
        _, payload = TWS.decode_frame(s, require_mask=False)
        assert json.loads(payload)["type"] == "done"
        s.sendall(bytes([0x88, 0x80]) + b"\x00\x00\x00\x00")
        op, _ = TWS.decode_frame(s, require_mask=False)
        assert op == TWS.OP_CLOSE
        s.close()
    finally:
        srv.stop()


def test_agent_calc_tool_and_memory_equal_jax():
    out = []
    for ag, llm in ((JAG, JL), (TAG, TL)):
        rt = ag.AgentRuntime(llm.LLMRouter([_scripted(
            llm, ['{"tool": "calc", "input": {"expression": "2**10 + 3"}}',
                  "done"])]))
        sess = rt.create_session(rt.create_agent("a").agent_id)
        msg = rt.execute(sess.session_id, "compute")
        hist = [(m.role, m.content) for m in rt.history(sess.session_id)]
        out.append((msg.content, msg.tool_calls, hist,
                    rt.memory.search(sess.agent_id, "compute", k=1)))
        auth = ag.APIKeyAuth()
        assert auth.check(None) == "anonymous"
        key = auth.issue("admin")
        assert auth.check(key) == "admin" and auth.check("x") is None
    assert out[0] == out[1]
    assert out[1][1][0]["result"] == "1027"


def test_agent_memory_on_the_local_embedder():
    """The default router's LocalProvider embeds the memory with the
    port's default embedder on ``config.device``."""
    rt = TAG.AgentRuntime()
    rt.memory.add("a1", "the capital of france is paris")
    rt.memory.add("a1", "bananas are yellow")
    assert rt.memory.search("a1", "the capital of france", k=1) == \
        ["the capital of france is paris"]
    assert rt.memory._vecs["a1"].shape[0] == 2


# ---------------------------------------------------------------------------
# metrics and tracing
# ---------------------------------------------------------------------------

def test_metrics_registry_text_equal_jax():
    texts = []
    for mod in (JMET, TMET):
        reg = mod.MetricsRegistry()
        reg.counter("queries").inc(3)
        reg.gauge("lists").set(7)
        for v in (0.0005, 0.02, 0.3, 7.0):
            reg.histogram("lat").observe(v)
        texts.append((reg.prometheus_text(), reg.stat_view()))
    assert texts[0] == texts[1]


def test_prometheus_exporter_serves_metrics():
    reg = TMET.MetricsRegistry()
    reg.counter("hits").inc()
    exp = TMET.PrometheusExporter(reg, port=0)
    port = exp.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=HTTP_TIMEOUT) as r:
            assert "neurondb_tpu_hits 1.0" in r.read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/x",
                                   timeout=HTTP_TIMEOUT)
    finally:
        exp.stop()
    assert TMET.PrometheusExporter().port == TC.get_config().prometheus_port


def test_prometheus_text_equal_jax():
    """The same spans give the same span text and summary."""
    JTR.reset()
    TTR.reset()
    for name, secs in (("search.coarse", 0.0021), ("search.scan", 0.0135),
                       ("search.coarse", 0.004), ("rest-handler", 1.25)):
        JTR._record(name, secs)
        TTR._record(name, secs)
    assert TTR.summary() == JTR.summary()
    assert TTR.prometheus_text() == JTR.prometheus_text()
    assert 'ndb_span_count{span="search.coarse"} 2' in TTR.prometheus_text()
    TTR.reset()
    JTR.reset()
    assert TTR.prometheus_text() == JTR.prometheus_text() == ""


def test_trace_span_in_a_cpu_profiler_trace(tmp_path):
    TTR.reset()

    @TTR.annotate_fn("ndb.annotated")
    def work():
        return torch.ones(64, 64) @ torch.ones(64, 64)

    with TTR.profile(str(tmp_path)):
        with TTR.trace("ndb.span"):
            torch.ones(128, 128).sum()
        work()
    assert TTR.stop_profile() is None            # nothing left running
    trace = json.loads((tmp_path / TTR.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"ndb.span", "ndb.annotated"} <= names
    assert {r["span"]: r["count"] for r in TTR.summary()} == \
        {"ndb.span": 1, "ndb.annotated": 1}
    TTR.reset()


def test_device_memory_profile_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        TTR.device_memory_profile(os.path.join(tmp_path, "m.pkl"))


def test_batcher_stress_every_request_gets_its_own_answer(data):
    """More client threads than cores and a short interpreter switch
    interval: every request must come back with its own query's answer
    and the stats must count every request once."""
    import sys
    import threading
    x, _ = data
    idx = TFlat(x[:500], device="cpu")
    bat = TB.MicroBatcher(idx, window_ms=1.0, max_batch=16)
    n_threads, per = 3 * (os.cpu_count() or 2), 8
    wrong, done = [], []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(t):
            for j in range(per):
                row = (t * per + j) % 500
                _, ids = bat.search(x[row], k=2, timeout=60.0)
                if ids[0] != row:
                    wrong.append((row, ids.tolist()))
            done.append(t)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
        bat.close()
    assert sorted(done) == list(range(n_threads)) and not wrong
    assert bat.stats["requests"] == n_threads * per
    assert bat.stats["max_rows"] <= 16
