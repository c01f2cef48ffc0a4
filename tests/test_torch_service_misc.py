"""The rest of the service layer: the sandbox, data management, tenancy,
the workers and the ONNX gateway — the torch port against the JAX
package on the CPU, on the same seeded numpy inputs.

The JAX package's own ``tests/test_safeeval.py`` cases run here against
the port's copy: each case function runs with the module's sandbox names
bound to the port's and the agent and LLM modules it imports resolved to
the port's.
"""

import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import neurondb_tpu.client as JCL
import neurondb_tpu.index as JI
from neurondb_tpu.ml import transformer as JT
from neurondb_tpu.service import data_management as JD
from neurondb_tpu.service import onnx_runtime as JO
from neurondb_tpu.service import tenant as JTEN
from neurondb_tpu.service import workers as JW
from neurondb_tpu.store import VectorStore as JStore
from neurondb_tpu.utils import safeeval as JS
import neurondb_tpu_torch.config as TC
from neurondb_tpu_torch.client import Client as TClient
from neurondb_tpu_torch.index.ivf import IVFFlatIndex as TIVF
from neurondb_tpu_torch.ml.metrics import recall_at_k
from neurondb_tpu_torch.service import agent as TAG
from neurondb_tpu_torch.service import data_management as TD
from neurondb_tpu_torch.service import llm as TL
from neurondb_tpu_torch.service import onnx_runtime as TO
from neurondb_tpu_torch.service import tenant as TTEN
from neurondb_tpu_torch.service import workers as TW
from neurondb_tpu_torch.store import VectorStore as TStore
from neurondb_tpu_torch.utils import safeeval as TS

DIM = 16


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    prev_cfg, prev_threads = TC._config, torch.get_num_threads()
    TC.set_config(TC.NDBConfig(device="cpu"))
    torch.set_num_threads(1)
    yield
    TC.set_config(prev_cfg)
    torch.set_num_threads(prev_threads)


# ---------------------------------------------------------------------------
# safeeval: the JAX package's cases on the port's copy
# ---------------------------------------------------------------------------

_spec = importlib.util.spec_from_file_location(
    "_jax_safeeval_cases",
    Path(__file__).resolve().parent / "test_safeeval.py")
JAX_CASES = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JAX_CASES)


@pytest.mark.parametrize("name", sorted(n for n in dir(JAX_CASES)
                                        if n.startswith("test_")))
def test_jax_safeeval_case_on_the_port(name, monkeypatch):
    fn = getattr(JAX_CASES, name)
    g = dict(fn.__globals__, SafeEvalError=TS.SafeEvalError,
             safe_eval=TS.safe_eval, safe_exec=TS.safe_exec)
    monkeypatch.setitem(sys.modules, "neurondb_tpu.service.agent", TAG)
    monkeypatch.setitem(sys.modules, "neurondb_tpu.service.llm", TL)
    monkeypatch.setitem(sys.modules, "neurondb_tpu.utils.safeeval", TS)
    types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                       fn.__closure__)()


@pytest.mark.parametrize("src", [
    "2 + 3 * 4", "(1 + 2) / 4", "2 ** 10", "sum([x*x for x in range(10)])",
    "sorted([3, 1, 2])", "max(3, 1, 2) - min(4, 5)", "round(sqrt(2), 6)",
    "'ab' * 3", "9**9**9**9", "__import__('os')", "().__class__",
    "lambda: 1", "1 / 0", "undefined_name"])
def test_safe_eval_same_answer_or_error(src):
    out = []
    for mod in (JS, TS):
        try:
            out.append(("ok", mod.safe_eval(src)))
        except mod.SafeEvalError as e:
            out.append(("sandbox", str(e)))
        except Exception as e:  # noqa: BLE001 — the class must match
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# data management
# ---------------------------------------------------------------------------

@pytest.fixture()
def stores(rng):
    x = rng.standard_normal((1500, DIM)).astype(np.float32)
    js, ts = JStore(DIM), TStore(DIM, device="cpu")
    js.add(x)
    ts.add(x)
    return js, ts, x


def test_snapshot_survives_in_place_writes(stores, rng):
    """The port-only hazard: the port's store writes in place, so a
    snapshot that held references would see later adds and deletes."""
    js, ts, x = stores
    q = x[rng.choice(len(x), 64, replace=False)] + \
        0.3 * rng.standard_normal((64, DIM)).astype(np.float32)
    answers = []
    for store, mod in ((js, JD), (ts, TD)):
        tt = mod.TimeTravelStore(store)
        tt.snapshot("before")
        before = tt.search_as_of("before", q, k=10)
        # mutate in place: new rows right on the queries, 5% deleted,
        # and rows overwritten in the padded tensor's free capacity
        store.add(q + 1e-3)
        store.delete(np.arange(0, 1500, 20))
        now = store.search(q, k=10)
        after = tt.search_as_of("before", q, k=10)
        assert not np.array_equal(np.asarray(now[1]), np.asarray(before[1]))
        np.testing.assert_array_equal(np.asarray(after[1]),
                                      np.asarray(before[1]))
        np.testing.assert_array_equal(np.asarray(after[0]),
                                      np.asarray(before[0]))
        assert tt.list_snapshots()[0]["n"] == 1500
        answers.append(before)
        tt.drop_snapshot("before")
        assert not tt.list_snapshots()
    np.testing.assert_array_equal(answers[1][1], answers[0][1])
    np.testing.assert_allclose(answers[1][0], answers[0][0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fmt", ["int8", "uint8", "int4", "binary", "f16"])
def test_cold_tier_restores_what_jax_restores(stores, fmt):
    js, ts, x = stores
    got = []
    for store, mod in ((js, JD), (ts, TD)):
        ct = mod.ColdTier(fmt)
        assert ct.demote(store, [3, 4, 9, 700]) == 4 and ct.size == 4
        assert len(store) == 1496
        assert ct.restore(store, [9, 3, 12345]) == 2 and ct.size == 2
        got.append(np.asarray(store.get([3, 9])))
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6, atol=1e-6)
    if fmt == "int8":
        bound = np.abs(x[[3, 9]]).max(1, keepdims=True) / 127.0 / 2
        assert (np.abs(got[1] - x[[3, 9]]) <= bound + 1e-6).all()


def test_vacuum_equal_jax(stores):
    js, ts, _ = stores
    reps = []
    for store, mod in ((js, JD), (ts, TD)):
        store.delete(np.arange(100))
        rep = mod.vacuum(store)
        rep.pop("seconds")
        reps.append((rep, mod.vacuum(store), len(store), store.size))
    assert reps[0] == reps[1]
    assert reps[1][0] == {"ran": True, "reclaimed_rows": 100}


def test_delta_compress_bytes_equal_jax(rng):
    base = rng.standard_normal((200, DIM)).astype(np.float32)
    new = base.copy()
    new[3, 2] += 1.0
    new[150] *= 0.5
    blob = TD.delta_compress(base, new)
    assert blob == JD.delta_compress(base, new)
    np.testing.assert_array_equal(TD.delta_decompress(base, blob), new)
    with pytest.raises(ValueError, match="equal shapes"):
        TD.delta_compress(base, new[:5])


def test_rebalance_lowers_the_imbalance_and_keeps_recall(rng):
    """Rows added in one region (the spill buffer) skew the lists; the
    rebalance folds them in and re-trains the centroids over every row
    (the JAX package's seed stream: ``seed + 1``)."""
    base = rng.standard_normal((2000, DIM)).astype(np.float32)
    hot = (rng.standard_normal((1500, DIM)) * 0.2 + 2.0).astype(np.float32)
    q = np.concatenate([base[:32], hot[:32]]) + \
        0.05 * rng.standard_normal((64, DIM)).astype(np.float32)
    allx = np.concatenate([base, hot])
    d = ((q.astype(np.float64)[:, None] - allx[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    folded = TIVF(base, nlists=16, seed=0, device="cpu")
    folded.add(hot)
    folded.rebuild_lists()
    idx = TIVF(base, nlists=16, seed=0, device="cpu")
    idx.add(hot)
    rep = TD.rebalance_ivf(idx, imbalance_threshold=100.0)   # spill: runs
    assert rep["ran"] and not idx._spill
    assert idx.stats()["imbalance"] < folded.stats()["imbalance"]
    r_bal = recall_at_k(idx.search(q, k=10, nprobe=4)[1], gt)
    r_fold = recall_at_k(folded.search(q, k=10, nprobe=4)[1], gt)
    assert r_bal >= r_fold - 0.02
    # the JAX module on the same index state lowers it too
    j = JI.IVFFlatIndex(base, nlists=16, seed=0)
    j.add(hot)
    jrep = JD.rebalance_ivf(j, imbalance_threshold=100.0)
    assert jrep["ran"] and rep["imbalance_before"] == pytest.approx(
        jrep["imbalance_before"], rel=0.25)
    assert not TD.rebalance_ivf(idx, imbalance_threshold=100.0)["ran"]


# ---------------------------------------------------------------------------
# tenancy
# ---------------------------------------------------------------------------

def _tenant_run(mod):
    tm = mod.TenantManager()
    tm.set_quota("a", mod.TenantQuota(max_vectors=100, max_bytes=10_000,
                                      max_qps=3))
    out = []
    for n, b in ((60, 3000), (50, 100), (30, 9000), (30, 100)):
        try:
            tm.check_ingest("a", n, b)
            out.append("ok")
        except mod.QuotaExceeded as e:
            out.append(str(e))
    for _ in range(5):
        try:
            tm.check_query("a")
            out.append("q")
        except mod.QuotaExceeded as e:
            out.append(str(e))
    tm.set_rls_policy("a", lambda i, md: i % 2 == 0 and
                      md.get("tag") != "secret")
    ids = np.array([[0, 1, 2, -1], [4, 6, 7, 8]])
    d = np.arange(8, dtype=np.float32).reshape(2, 4)
    fi, fd = tm.filter_results("a", ids, d, {6: {"tag": "secret"}})
    u = tm.usage("a")
    return (out, fi.tolist(), fd.tolist(), (u.vectors, u.bytes, u.queries),
            [(e.action, e.detail) for e in tm.audit_log])


def test_tenant_quotas_and_rls_equal_jax():
    assert _tenant_run(TTEN) == _tenant_run(JTEN)


def test_tenant_scoped_collection_equal_jax(rng):
    x = rng.standard_normal((400, DIM)).astype(np.float32)
    q = x[7] + 0.01
    got = []
    for mod, client in ((JTEN, JCL.Client()), (TTEN, TClient(device="cpu"))):
        col = client.create_collection("t", DIM)
        tm = mod.TenantManager()
        tm.set_quota("acme", mod.TenantQuota(max_vectors=500, max_qps=2))
        scoped = mod.TenantScopedCollection(col, tm, "acme")
        scoped.add(x)
        with pytest.raises(mod.QuotaExceeded):
            scoped.add(x[:200])
        tm.set_rls_policy("acme", lambda i, md: i % 3 != 0)
        res = scoped.search(q, k=10)
        assert all(r["id"] % 3 for r in res)
        scoped.search(q, k=10)
        with pytest.raises(mod.QuotaExceeded, match="QPS"):
            scoped.search(q, k=10)
        got.append(([r["id"] for r in res], [r["distance"] for r in res]))
    assert got[0][0] == got[1][0]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def test_autotuner_control_law_equal_jax():
    steps = [(64, 0.80, 10.0), (77, 0.90, 10.0), (92, 0.97, 80.0),
             (74, 0.99, 20.0), (500, 0.5, 1.0), (16, 0.99, 99.0),
             (20, 0.95, 50.0)]
    runs = []
    for mod in (JW, TW):
        tu = mod.AutoTuner(target_recall=0.95, target_latency_ms=50.0,
                           ef_min=16, ef_max=512)
        runs.append([tu.step(*s) for s in steps])
    assert runs[0] == runs[1] == [77, 92, 74, 74, 512, 16, 20]
    cfg = TC.get_config()
    tu = TW.AutoTuner()
    assert (tu.target_recall, tu.ef_min, tu.ef_max) == \
        (cfg.tuner_target_recall, cfg.tuner_ef_min, cfg.tuner_ef_max)


def test_autotuner_closed_loop_equal_jax():
    class Index:
        ef_search = 16

        def search(self, queries, k=10, ef=64):
            # recall grows with ef: the first min(k, ef // 8) ids right
            good = min(k, ef // 8)
            ids = np.tile(np.arange(k), (len(queries), 1))
            ids[:, good:] += 1000
            return None, ids

    gt = np.tile(np.arange(10), (4, 1))
    out = []
    for mod in (JW, TW):
        idx = Index()
        tu = mod.AutoTuner(target_recall=0.95, target_latency_ms=1e9)
        ef = tu.tune_index(idx, np.zeros((4, 2)), gt, k=10, iters=20)
        out.append((ef, idx.ef_search, [h["new_ef"] for h in tu.history]))
    assert out[0] == out[1]


def test_queue_worker_retries_equal_jax():
    out = []
    for mod in (JW, TW):
        flaky = {"n": 0}

        def sometimes(p):
            flaky["n"] += 1
            if flaky["n"] < 2:
                raise RuntimeError("transient")
            return p["v"] * 2

        w = mod.QueueWorker({"double": sometimes})
        w.register("boom", lambda p: 1 / 0)
        ids = [w.enqueue("double", {"v": 21}), w.enqueue("boom", {}),
               w.enqueue("missing", {})]
        w.start()
        try:
            w.drain(timeout=10.0)
        finally:
            w.stop()
        out.append([(w.status(i).status, w.status(i).result,
                     w.status(i).error, w.status(i).attempts) for i in ids])
    assert out[0] == out[1]
    assert out[1][0][:2] == ("done", 42)


def test_queue_worker_embed_jobs_through_the_embedding_service():
    from neurondb_tpu_torch.service.embeddings import EmbeddingService
    svc = EmbeddingService()
    w = TW.QueueWorker({"embed": lambda p: svc.embed_batch(p["texts"])})
    ids = [w.enqueue("embed", {"texts": [f"doc {i}", f"doc {i + 1}"]})
           for i in range(4)]
    w.start()
    try:
        w.drain(timeout=30.0)
    finally:
        w.stop()
    for i in ids:
        job = w.status(i)
        assert job.status == "done" and job.result.shape == (2, 256)


def test_defrag_worker_equal_jax(rng):
    x = rng.standard_normal((300, DIM)).astype(np.float32)
    out = []
    for store, ivf, mod in ((JStore(DIM), JI.IVFFlatIndex(x, nlists=8), JW),
                            (TStore(DIM, device="cpu"),
                             TIVF(x, nlists=8, device="cpu"), TW)):
        store.add(x)
        dw = mod.DefragWorker(tombstone_ratio=0.2)
        row = [dw.maybe_compact(store)]
        store.delete(np.arange(50))
        row.append(dw.maybe_compact(store))
        store.delete(np.arange(50, 120))
        row += [dw.maybe_compact(store), len(store), store.size]
        row.append(dw.maybe_rebuild(ivf))
        ivf.add(x[:5] + 0.5)
        row += [dw.maybe_rebuild(ivf), len(ivf._spill)]
        ivf.delete(np.arange(100))
        row += [dw.maybe_vacuum(ivf), ivf.n]
        row.append([r.get("kind", "compact") for r in dw.runs])
        out.append(row)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the ONNX gateway, through the stub runtime of tests/test_onnx_runtime.py
# ---------------------------------------------------------------------------

class _StubSession:
    def __init__(self, path, opts, providers):
        self.path, self.opts, self.providers = path, opts, providers

    def run(self, output_names, inputs):
        ids = inputs["input_ids"] if "input_ids" in inputs else \
            next(iter(inputs.values()))
        x = np.asarray(ids, np.float32)
        if x.ndim == 2:                       # an encoder's [B, S, H] out
            x = np.stack([x, x * 0.5 + 1.0, -x], axis=-1)
        return [x * 2.0]


class _StubOpts:
    intra_op_num_threads = 0
    inter_op_num_threads = 0


class _StubORT:
    SessionOptions = _StubOpts
    InferenceSession = _StubSession

    @staticmethod
    def get_available_providers():
        return ["CUDAExecutionProvider", "CPUExecutionProvider"]


@pytest.fixture()
def stub_ort():
    for mod in (JO, TO):
        mod.set_runtime(_StubORT())
    yield
    for mod in (JO, TO):
        mod.set_runtime(None)
        mod._cache.evict("m.onnx")


@pytest.mark.parametrize("requested,available", [
    (None, ["CPUExecutionProvider", "CUDAExecutionProvider"]),
    (["CoreMLExecutionProvider"], ["CPUExecutionProvider"]),
    (["TensorrtExecutionProvider", "CUDAExecutionProvider"],
     ["TensorrtExecutionProvider", "CUDAExecutionProvider",
      "CPUExecutionProvider"]),
    (["CUDAExecutionProvider"], ["CUDAExecutionProvider"]),
    (None, []),
])
def test_select_providers_equal_jax(requested, available):
    assert TO.select_providers(requested, available) == \
        JO.select_providers(requested, available)
    assert TO.EP_PRIORITY == JO.EP_PRIORITY


def test_onnx_through_the_stub_equal_jax(stub_ort):
    out = []
    for mod in (JO, TO):
        cache = mod.ONNXSessionCache(max_sessions=2, intra_op_threads=3)
        s1 = cache.get("a.onnx")
        cache.get("a.onnx")
        cache.get("b.onnx")
        cache.get("c.onnx")
        assert cache.get("a.onnx") is not s1
        ids = np.array([[5, 3, 0, 0], [7, 1, 2, 0]])
        out.append((cache.stats(), s1.providers, s1.opts.intra_op_num_threads,
                    mod.onnx_predict("m.onnx", {"x": np.ones((2, 2))})[0],
                    mod.onnx_embed_text("m.onnx", ids)))
    assert out[0][:3] == out[1][:3]
    np.testing.assert_array_equal(out[1][3], out[0][3])
    np.testing.assert_allclose(out[1][4], out[0][4], rtol=1e-6)


def test_onnx_without_runtime_raises():
    assert not TO.HAVE_ORT
    with pytest.raises(RuntimeError, match="onnxruntime"):
        TO.onnx_predict("model.onnx", {})
    assert TO._cache.stats()["sessions"] == 0


def test_npz_encoder_from_a_jax_export(tmp_path):
    """An encoder the JAX package exported as a flat npz loads through
    the port's gateway and embeds as the JAX embedder does."""
    import jax
    p = JT.init_encoder_params(jax.random.PRNGKey(0), hidden=32, layers=1,
                               heads=2, ff=64, vocab_size=512, max_len=128)
    flat = {}
    for k, v in p.items():
        if k == "layers":
            for i, lyr in enumerate(v):
                for kk, vv in lyr.items():
                    if isinstance(vv, dict):
                        for k3, v3 in vv.items():
                            flat[f"layers.{i}.{kk}.{k3}"] = np.asarray(v3)
                    else:
                        flat[f"layers.{i}.{kk}"] = np.asarray(vv)
        elif isinstance(v, dict):
            for kk, vv in v.items():
                flat[f"{k}.{kk}"] = np.asarray(vv)
        else:
            flat[k] = np.asarray(v)
    path = str(tmp_path / "enc.npz")
    np.savez(path, **flat)
    texts = ["roundtrip test", "a second, longer sentence to embed"]
    want = JT.TextEmbedder(p, use_flash=False)(texts)
    emb = TO.load_npz_encoder(path, device="cpu")
    assert not emb.use_flash
    np.testing.assert_allclose(emb(texts), want, rtol=1e-4, atol=1e-5)
