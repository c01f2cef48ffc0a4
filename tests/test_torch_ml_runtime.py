"""The ML runtime's spine: the registry (its format, both ways), the
unified API, the retrieval metrics and ``Client``'s ML methods, the torch
port against the JAX package (CPU)."""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ml import api as JA
from neurondb_tpu.ml import metrics as JM
from neurondb_tpu.ml import registry as JR
from neurondb_tpu_torch.client import Client
from neurondb_tpu_torch.ml import api as TA
from neurondb_tpu_torch.ml import metrics as TM
from neurondb_tpu_torch.ml import registry as TR

FIXTURE = Path(__file__).resolve().parent / "data" / "jax_registry"
PORTED = ["anomaly_detection", "dbscan", "elastic_net", "gmm", "hierarchical",
          "kmeans", "knn_classifier", "knn_regressor", "lasso",
          "linear_regression", "logistic_regression", "minibatch_kmeans",
          "naive_bayes", "pca", "ridge", "svm"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(seed=0, n=240, d=8):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64) + \
        (X[:, 2] > 1.0).astype(np.int64)
    return X, y


def _tree_tensors(obj):
    if isinstance(obj, dict):
        return {k: _tree_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_tensors(v) for v in obj)
    if isinstance(obj, np.ndarray) and obj.dtype.kind not in "US":
        return torch.from_numpy(obj.copy())
    return obj


# ---------------------------------------------------------------------------
# registry format
# ---------------------------------------------------------------------------

def _model_tree(rng):
    w = rng.standard_normal((5, 3)).astype(np.float32)
    return {"W": w, "b": np.float32(0.25), "n": np.int32(7),
            "kernel": "rbf", "nested": [w[:2], (np.arange(4, dtype=np.int32),
                                                 None)],
            "flag": np.bool_(True), "rbf": {"gamma": np.float32(0.5)}}


def test_registry_format_is_the_jax_format(rng, tmp_path):
    tree = _model_tree(rng)
    jr = JR.ModelRegistry(str(tmp_path / "jax"))
    tr = TR.ModelRegistry(str(tmp_path / "torch"), device="cpu")
    meta = dict(hyperparams={"k": 3, "name": "x"}, metrics={"acc": 0.5})
    jid = jr.register("proj", "svm", tree, **meta)
    tid = tr.register("proj", "svm", _tree_tensors(tree), **meta)
    assert jid == tid == 1
    jd, td = tmp_path / "jax" / "model_000001", tmp_path / "torch" / "model_000001"
    assert (td / "structure.json").read_bytes() == \
        (jd / "structure.json").read_bytes()
    jm = json.loads((jd / "manifest.json").read_text())
    tm = json.loads((td / "manifest.json").read_text())
    jm.pop("created_at"), tm.pop("created_at")
    assert tm == jm
    with np.load(jd / "weights.npz") as a, np.load(td / "weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape
            np.testing.assert_array_equal(a[f], b[f])
    assert tr.list() == jr.list()


def test_registry_loads_leaves_as_tensors_and_strings(rng, tmp_path):
    tree = _model_tree(rng)
    JR.ModelRegistry(str(tmp_path)).register("p", "svm", tree)
    rec = TR.ModelRegistry(str(tmp_path), device="cpu").get(1)
    m = rec.model
    assert isinstance(m["W"], torch.Tensor) and m["W"].dtype == torch.float32
    np.testing.assert_array_equal(m["W"].numpy(), tree["W"])
    assert m["kernel"] == "rbf" and isinstance(m["kernel"], str)
    assert m["b"].ndim == 0 and float(m["b"]) == 0.25
    assert m["n"].dtype == torch.int32 and int(m["n"]) == 7
    assert bool(m["flag"]) is True and m["flag"].dtype == torch.bool
    assert isinstance(m["nested"], list) and isinstance(m["nested"][1], tuple)
    assert m["nested"][1][1] is None
    assert float(m["rbf"]["gamma"]) == 0.5
    with pytest.raises(KeyError):
        TR.ModelRegistry(str(tmp_path), device="cpu").get(2)


def _fit_pair(algorithm, X, y, hp):
    """The same model from both packages' trainers (no train-time
    evaluation), each registered in its own registry."""
    jr, tr = JR.ModelRegistry(), TR.ModelRegistry(device="cpu")
    args = (jnp.asarray(X),) if y is None else (jnp.asarray(X), jnp.asarray(y))
    jid = jr.register("p", algorithm, JA._resolve(algorithm).train(*args, **hp),
                      hp)
    targs = (TA.as_input(X, tr.device),) if y is None else \
        (TA.as_input(X, tr.device), TA.as_input(y, tr.device))
    tid = tr.register("p", algorithm, TA._resolve(algorithm).train(*targs, **hp),
                      hp)
    return jr, jid, tr, tid


@pytest.mark.parametrize("algorithm,hp", [
    ("linear_regression", {}),
    ("svm", {"kernel": "rbf", "gamma": 0.3, "sample_cap": 120}),
    ("pca", {"n_components": 3, "whiten": True}),
])
def test_registry_crosses_both_ways(tmp_path, algorithm, hp):
    """A model the JAX registry persisted loads in the port's and predicts
    the same; a model the port persisted loads in the JAX registry and
    predicts the same."""
    X, y = _data()
    yy = X @ np.arange(8, dtype=np.float32) if algorithm == "linear_regression" \
        else (None if algorithm == "pca" else y)
    jr, jid, tr, tid = _fit_pair(algorithm, X, yy, hp)
    jrec, trec = jr.get(jid), tr.get(tid)
    # JAX -> port
    JR.ModelRegistry(str(tmp_path / "j"))._persist(jrec)
    loaded = TR.ModelRegistry(str(tmp_path / "j"), device="cpu").get(jid)
    t = TA._resolve(algorithm)
    want = np.asarray(JA._resolve(algorithm).predict(jrec.model,
                                                     jnp.asarray(X)))
    got = t.predict(loaded.model, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # port -> JAX
    TR.ModelRegistry(str(tmp_path / "t"), device="cpu")._persist(trec)
    jl = JR.ModelRegistry(str(tmp_path / "t")).get(tid)
    want = t.predict(trec.model, torch.from_numpy(X)).numpy()
    got = np.asarray(JA._resolve(algorithm).predict(jl.model, jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the port's own reload predicts bit for bit
    again = TR.ModelRegistry(str(tmp_path / "t"), device="cpu").get(tid)
    assert np.array_equal(t.predict(again.model, torch.from_numpy(X)).numpy(),
                          want)


def test_jax_model_fixture_is_current(tmp_path, monkeypatch):
    """``tests/data/jax_registry``: two models the JAX registry persisted
    (an RBF dual SVM and a whitened PCA, fitted by the JAX trainers) and
    the JAX package's CPU predictions on a fixed input (``expected.npz``),
    committed so that a machine without JAX (the card's) can load them.
    This test rebuilds them with the JAX package and requires the
    committed copy to match; it writes the directory when it is
    missing."""
    X, y = _data(seed=3, n=160)
    jr = JR.ModelRegistry(str(tmp_path / "reg"))
    svm_hp = {"kernel": "rbf", "gamma": 0.25, "sample_cap": 120}
    pca_hp = {"n_components": 4, "whiten": True}
    svm, pca = JA._resolve("svm"), JA._resolve("pca")
    sid = jr.register("fixture", "svm", svm.train(
        jnp.asarray(X), jnp.asarray(y, jnp.int32), **svm_hp), svm_hp)
    pid = jr.register("fixture", "pca", pca.train(jnp.asarray(X), **pca_hp),
                      pca_hp)
    Xq = X[:32] + 0.1
    pred = {"X": Xq,
            "svm": np.asarray(svm.predict(jr.get(sid).model, jnp.asarray(Xq))),
            "pca": np.asarray(pca.predict(jr.get(pid).model, jnp.asarray(Xq)))}
    np.savez(tmp_path / "reg" / "expected.npz", **pred)
    if not FIXTURE.exists():
        shutil.copytree(tmp_path / "reg", FIXTURE)
    for mid in (sid, pid):
        sub = f"model_{mid:06d}"
        assert (FIXTURE / sub / "structure.json").read_bytes() == \
            (tmp_path / "reg" / sub / "structure.json").read_bytes()
        with np.load(FIXTURE / sub / "weights.npz") as a, \
                np.load(tmp_path / "reg" / sub / "weights.npz") as b:
            for f in b.files:
                if b[f].dtype.kind in "US":
                    assert a[f] == b[f]
                else:
                    np.testing.assert_allclose(a[f], b[f], rtol=1e-5,
                                               atol=1e-6)
    with np.load(FIXTURE / "expected.npz") as e:
        np.testing.assert_array_equal(e["svm"], pred["svm"])
        np.testing.assert_allclose(e["pca"], pred["pca"], rtol=1e-5,
                                   atol=1e-5)
        Xq = e["X"]
        monkeypatch.setattr(TR, "_registry",
                            TR.ModelRegistry(str(FIXTURE), device="cpu"))
        np.testing.assert_array_equal(TA.predict(sid, Xq, device="cpu"),
                                      e["svm"])
        np.testing.assert_allclose(TA.predict(pid, Xq, device="cpu"),
                                   e["pca"], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the unified API
# ---------------------------------------------------------------------------

def test_ported_names_and_the_rest_of_the_jax_registry():
    """Every name and alias the JAX package registers resolves to the same
    trainer here; the families ported last train and resolve too."""
    JA._ensure_loaded()
    assert TA.list_algorithms() == sorted(JA._ALGORITHMS)
    assert set(PORTED) < set(TA.list_algorithms())
    for name in JA._ALGORITHMS:
        assert TA._resolve(name).name == JA._resolve(name).name
    for alias in JA._ALIASES:
        assert TA._resolve(alias.upper()).name == JA._resolve(alias).name
    with pytest.raises(ValueError, match="unknown algorithm"):
        TA._resolve("no_such_algorithm")
    with pytest.raises(ValueError, match="unknown algorithm"):
        JA._resolve("no_such_algorithm")


def test_inputs_cast_as_jax_casts_them():
    dev = torch.device("cpu")
    assert TA.as_input(np.zeros(3, np.float64), dev).dtype == torch.float32
    assert TA.as_input(np.zeros(3, np.int64), dev).dtype == torch.int32
    assert TA.as_input([1, 2], dev).dtype == torch.int32
    assert TA.as_input(torch.zeros(2, dtype=torch.float64), dev).dtype == \
        torch.float32
    assert TA.as_input(np.zeros(2, np.uint8), dev).dtype == torch.uint8
    for a in (np.zeros(3, np.float64), np.zeros(3, np.int64), [1.5, 2.0]):
        assert str(TA.as_input(a, dev).dtype).split(".")[-1] == \
            str(jnp.asarray(a).dtype)


def test_train_swallows_evaluator_errors_but_not_runtime_errors(monkeypatch):
    X, y = _data()
    reg = TR.ModelRegistry(device="cpu")
    monkeypatch.setattr(TR, "_registry", reg)
    t = TA._resolve("naive_bayes")

    def bad_eval(exc):
        def ev(m, X, y):
            raise exc
        return ev

    for exc in (ValueError("v"), TypeError("t"), KeyError("k"),
                ZeroDivisionError("z")):
        monkeypatch.setattr(t, "evaluate", bad_eval(exc))
        mid = TA.train("p", "nb", X, y, device="cpu")
        assert list(reg.get(mid).metrics) == ["train_seconds"]
    monkeypatch.setattr(t, "evaluate", bad_eval(RuntimeError("CUDA error")))
    with pytest.raises(RuntimeError, match="CUDA error"):
        TA.train("p", "nb", X, y, device="cpu")
    with pytest.raises(ValueError, match="requires a target"):
        TA.train("p", "ridge", X, None, device="cpu")


def test_api_round_trip_matches_jax(monkeypatch):
    X, y = _data()
    Xq = X[:50] + 0.05
    jr, tr = JR.ModelRegistry(), TR.ModelRegistry(device="cpu")
    JR._registry, saved = jr, JR._registry
    try:
        jid = JA.train("p", "naive_bayes", X, y)
    finally:
        JR._registry = saved
    monkeypatch.setattr(TR, "_registry", tr)
    tid = TA.train("p", "naive_bayes", X, y, device="cpu")
    tm, jm = tr.get(tid).metrics, jr.get(jid).metrics
    assert tm.keys() == jm.keys()
    assert tm["accuracy"] == pytest.approx(jm["accuracy"], abs=1e-6)
    JR._registry, saved = jr, JR._registry
    try:
        want = JA.predict(jid, Xq)
        jev = JA.evaluate(jid, X, y)
    finally:
        JR._registry = saved
    np.testing.assert_array_equal(TA.predict(tid, Xq, device="cpu"), want)
    assert TA.evaluate(tid, X, y, device="cpu") == \
        pytest.approx(jev, abs=1e-6)
    TA.deploy(tid)
    assert tr.get(tid).status == "deployed"
    assert TA.load_model(tid)["means"].device.type == "cpu"
    with pytest.raises(ValueError, match="no evaluator"):
        TA.evaluate(TA.train("p", "dbscan", X[:60], device="cpu"), X,
                    device="cpu")


def test_client_ml_runs_on_its_device():
    X, y = _data()
    c = Client(device="cpu")
    saved = TR._registry
    TR.set_registry(TR.ModelRegistry(device="cpu"))
    try:
        mid = c.train("p", "knn", X, y, {"k": 3})
        pred = c.predict(mid, X[:20])
        assert pred.dtype == np.int32 and pred.shape == (20,)
        assert c.evaluate(mid, X, y)["accuracy"] > 0.8
        model = TR.get_registry().get(mid).model
        assert model["X"].device.type == "cpu"
    finally:
        TR.set_registry(saved)


# ---------------------------------------------------------------------------
# retrieval metrics (a copy of the JAX module)
# ---------------------------------------------------------------------------

def test_retrieval_metrics_match_jax(rng):
    got = rng.integers(0, 30, (12, 10))
    rel = rng.integers(0, 30, (12, 10))
    sets = [set(r[:5].tolist()) for r in rel]
    gains = [{int(i): float(g) for i, g in zip(r[:6], rng.random(6))}
             for r in rel]
    first = rel[:, 0]
    assert TM.recall_at_k(got, rel, 5) == JM.recall_at_k(got, rel, 5)
    assert TM.precision_at_k(got, sets, 7) == JM.precision_at_k(got, sets, 7)
    assert TM.f1_at_k(got, sets, 7) == JM.f1_at_k(got, sets, 7)
    assert TM.mean_reciprocal_rank(got, first) == \
        JM.mean_reciprocal_rank(got, first)
    assert TM.ndcg_at_k(got, gains, 8) == JM.ndcg_at_k(got, gains, 8)
