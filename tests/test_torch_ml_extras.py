"""Drift, analytics, LDA / topics, explainability, the feature store, the
GCN, mlops and automl (``ml/drift.py``, ``extras.py``, ``gnn.py``,
``mlops.py``, ``automl.py``) and ``search.rerank.train_ltr``, the torch
port against the JAX package on the same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ml import automl as JAM
from neurondb_tpu.ml import drift as JD
from neurondb_tpu.ml import extras as JX
from neurondb_tpu.ml import gnn as JG
from neurondb_tpu.ml import mlops as JMO
from neurondb_tpu.search import rerank as JRR
from neurondb_tpu.types.graph import VectorGraph as JVG
from neurondb_tpu_torch.ml import automl as TAM
from neurondb_tpu_torch.ml import drift as TD
from neurondb_tpu_torch.ml import extras as TX
from neurondb_tpu_torch.ml import gnn as TG
from neurondb_tpu_torch.ml import mlops as TMO
from neurondb_tpu_torch.ml import registry as TR
from neurondb_tpu_torch.search import rerank as TRR
from neurondb_tpu_torch.types.graph import VectorGraph as TVG

# describe: f32 means / std on the device, summed in another order than
# numpy's, and jnp-style f32 percentile weights (numpy: f64): 1e-5.
# LDA from JAX's start: digamma / exp / [D,K]x[K,V] products over a few EM
# steps, f32 in both, sums in another order.
LDA_TOL = dict(rtol=2e-4, atol=1e-6)
# GCN from JAX's init: gathers and GEMMs of f32, 10 gradient steps.
GCN_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def shifted():
    rng = np.random.default_rng(51)
    ref = rng.standard_normal((2000, 6)).astype(np.float32)
    live = rng.standard_normal((1500, 6)).astype(np.float32)
    live[:, :2] += 0.7
    live[:, 3] = np.round(live[:, 3] * 2)           # ties on the edges
    return ref, live


def test_psi_and_ks_equal_jax(shifted):
    ref, live = shifted
    for f in range(ref.shape[1]):
        assert TD.population_stability_index(ref[:, f], live[:, f],
                                             device="cpu") == \
            JD.population_stability_index(ref[:, f], live[:, f])
        assert TD.ks_statistic(ref[:, f], live[:, f], device="cpu") == \
            JD.ks_statistic(ref[:, f], live[:, f])


def test_feature_drift_report_and_embedding_drift(shifted):
    ref, live = shifted
    jr = JD.feature_drift_report(ref, live)
    tr = TD.feature_drift_report(_t(ref), _t(live))
    assert tr["any_drift"] == jr["any_drift"]
    assert tr["max_psi"] == jr["max_psi"]
    for a, b in zip(tr["features"], jr["features"]):
        for k in ("feature", "psi", "ks", "drifted"):
            assert a[k] == b[k], k
        for k in ("mean_shift", "std_ratio"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-6), k
    je, te = JD.embedding_drift(ref, live), TD.embedding_drift(_t(ref),
                                                                _t(live))
    assert te["drifted"] == je["drifted"]
    for k in ("centroid_cosine_distance", "dispersion_ratio"):
        assert te[k] == pytest.approx(je[k], rel=1e-5, abs=1e-6), k


def test_describe_correlation_histogram(shifted):
    ref, _ = shifted
    jd, td = JX.describe(ref), TX.describe(ref, device="cpu")
    for a, b in zip(td, jd):
        assert a["feature"] == b["feature"]
        for k in ("mean", "std", "min", "max", "p25", "p50", "p75"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-6), k
    np.testing.assert_allclose(TX.correlation_matrix(_t(ref)),
                               JX.correlation_matrix(ref), rtol=1e-10,
                               atol=1e-12)
    assert TX.histogram(_t(ref[:, 0]), bins=7) == JX.histogram(ref[:, 0],
                                                               bins=7)


DOCS = ["vector search on gpus", "gpu kernels for vector search",
        "cooking pasta with tomato", "tomato sauce and pasta recipes",
        "neural networks train on gpus", "fresh basil tomato salad",
        "index vectors with graphs", "graph search over vectors"] * 3


def test_lda_from_jax_start_matches():
    X, _ = TX._counts(DOCS)
    K, V = 3, X.shape[1]
    lam0 = np.asarray(jax.random.gamma(jax.random.PRNGKey(7), 100.0, (K, V))
                      * 0.01 + 0.01)
    tw, dt = JX.lda_fit(X, K, iters=4, e_steps=5, seed=7, restarts=1)
    lam, gamma = TX.lda_run(_t(X), _t(lam0), iters=4, e_steps=5)
    np.testing.assert_allclose((lam / lam.sum(1, keepdim=True)).numpy(), tw,
                               **LDA_TOL)
    np.testing.assert_allclose((gamma / gamma.sum(1, keepdim=True)).numpy(),
                               dt, **LDA_TOL)
    out = TX.lda_topics(DOCS, n_topics=3, iters=5, device="cpu")
    assert out["n_topics"] == 3 and len(out["labels"]) == len(DOCS)
    np.testing.assert_allclose(np.asarray(out["doc_topic"]).sum(1), 1.0,
                               rtol=1e-5)
    topics = TX.discover_topics(DOCS, n_topics=3, device="cpu")
    assert sum(t["size"] for t in topics["topics"]) == len(DOCS)


def test_explainability_and_feature_store():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((100, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int32)

    def predict(Xs):
        return (np.asarray(Xs)[:, 0] > 0).astype(np.int32)

    np.testing.assert_array_equal(
        TX.permutation_importance(predict, X, y, seed=3),
        JX.permutation_importance(predict, X, y, seed=3))
    m = {"coef": np.arange(4, dtype=np.float32)}
    np.testing.assert_array_equal(
        TX.linear_feature_attribution({"coef": _t(m["coef"])}, X[:3]),
        JX.linear_feature_attribution(m, X[:3]))
    for S, FD in ((TX.FeatureStore(), TX.FeatureDefinition),
                  (JX.FeatureStore(), JX.FeatureDefinition)):
        S.define(FD("age", transform=lambda v: v * 2))
        S.write("age", 1, 10.0, ts=1.0)
        S.write("age", 1, 11.0, ts=2.0)
        assert S.read("age", 1, as_of=1.5) == 20.0
        np.testing.assert_array_equal(S.matrix(["age"], [1, 2]),
                                      [[22.0], [0.0]])


def _graph(seed=3, n=60, deg=5):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (n, deg)).astype(np.int32)
    nbr[rng.uniform(size=(n, deg)) < 0.3] = -1
    X = rng.standard_normal((n, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.int32) + (X[:, 2] > 1)
    return nbr, X, y.astype(np.int32)


def test_gcn_from_jax_init_matches():
    nbr, X, y = _graph()
    tm = (np.arange(len(X)) % 3 == 0).astype(np.float32)
    jg = JVG(jnp.asarray(nbr), jnp.asarray((nbr >= 0).astype(np.float32)))
    jm = JG.gcn_fit(jg, X, y, train_mask=tm, hidden=8, iters=10, seed=4)
    init = JG.gcn_init(jax.random.PRNGKey(4), 6, 8, 3, 2)
    got = TG.gcn_train({"W": [_t(np.asarray(w)) for w in init["W"]]},
                       _t(nbr), _t(X), _t(y), _t(tm), lr=0.1, iters=10)
    for a, b in zip(got["W"], jm["params"]["W"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GCN_TOL)
    tg = TVG(_t(nbr), _t((nbr >= 0).astype(np.float32)))
    np.testing.assert_allclose(
        TG.gcn_forward(got, tg, _t(X)).numpy(),
        np.asarray(JG.gcn_forward(jm["params"], jg, jnp.asarray(X))),
        **GCN_TOL)
    model = {"params": got, "neighbors": tg.neighbors, "weights": tg.weights}
    np.testing.assert_array_equal(TG.gcn_predict(model, _t(X)).numpy(),
                                  np.asarray(JG.gcn_predict(jm, X)))
    fit = TG.gcn_fit(tg, _t(X), _t(y), train_mask=tm, hidden=8, iters=5)
    assert fit["params"]["W"][0].shape == (6, 8)


def test_mlops_is_the_jax_copy():
    out = []
    for M in (JMO, TMO):
        ab = M.ABTestManager(seed=3)
        ab.create("t", 1, 2, traffic_split=0.4)
        for i in range(300):
            mid = ab.route("t")
            ab.record_outcome("t", mid, success=(i % (3 if mid == 2 else 4))
                              == 0)
        ev = ab.evaluate("t")
        rng = np.random.default_rng(0)
        mon = M.ModelMonitor(1, rng.standard_normal((500, 3)))
        mon.observe(rng.standard_normal((200, 3)) + 1.0,
                    predictions=np.ones(200))
        flags = M.FeatureFlags()
        flags.set("f", enabled=True, rollout=0.5)
        out.append((ev, mon.summary()["psi_max"], mon.psi().tolist(),
                    [flags.enabled("f", subject=str(i)) for i in range(20)]))
    assert out[0] == out[1]


@pytest.fixture()
def fresh_registry():
    TR.set_registry(TR.ModelRegistry(device="cpu"))
    yield
    TR.set_registry(None)


def test_automl_leaderboard_folds_and_winner(fresh_registry):
    rng = np.random.default_rng(61)
    X = rng.standard_normal((120, 4)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] > 0).astype(np.int64)
    algos = ["logistic_regression", "naive_bayes", "knn_classifier", "svm"]
    jr = JAM.automl("p", X, y, algorithms=algos, folds=3, register=False)
    tr = TAM.automl("p", X, y, algorithms=algos, folds=3, device="cpu")
    one = 1.0 / 40
    assert [r["algorithm"] for r in tr["leaderboard"]] == \
        [r["algorithm"] for r in jr["leaderboard"]]
    for a, b in zip(tr["leaderboard"], jr["leaderboard"]):
        assert a["score"] == pytest.approx(b["score"], abs=one)
        assert a["hyperparams"] == b["hyperparams"]
    assert tr["best_algorithm"] == jr["best_algorithm"]
    assert TR.get_registry().get(tr["model_id"]).algorithm == \
        tr["best_algorithm"]
    jc = JAM.cross_validate("naive_bayes", X, y, folds=4, seed=2)
    tc = TAM.cross_validate("naive_bayes", X, y, folds=4, seed=2,
                            device="cpu")
    assert tc["fold_scores"] == jc["fold_scores"]
    folds = list(TAM._folds(len(X), 4, 2))
    idx = np.random.default_rng(2).permutation(len(X))
    for f, (trn, val) in enumerate(folds):
        np.testing.assert_array_equal(val, idx[f::4])
        np.testing.assert_array_equal(trn, np.setdiff1d(idx, idx[f::4]))
    assert TAM._grid(JAM.DEFAULT_SPACES["classify"]["random_forest"]) == \
        JAM._grid(JAM.DEFAULT_SPACES["classify"]["random_forest"])
    assert TAM.DEFAULT_SPACES == JAM.DEFAULT_SPACES
    fe_t = TAM.auto_feature_engineering(X, log1p=True)
    fe_j = JAM.auto_feature_engineering(X, log1p=True)
    assert fe_t["names"] == fe_j["names"]
    np.testing.assert_array_equal(fe_t["X"], fe_j["X"])


def test_train_ltr_matches_jax():
    rng = np.random.default_rng(71)
    f = rng.standard_normal((80, 5)).astype(np.float32)
    rel = (f @ np.arange(5, dtype=np.float32) + rng.uniform(size=80)).astype(
        np.float32)
    np.testing.assert_allclose(TRR.train_ltr(f, rel, device="cpu"),
                               JRR.train_ltr(f, rel), rtol=1e-4, atol=1e-5)
