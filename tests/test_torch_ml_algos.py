"""The ML algorithm families of this slice: k-means variants and cluster
scores, the linear family, PCA, GMM, kNN / naive Bayes / SVM, DBSCAN,
agglomerative clustering and anomaly detection, the torch port against the
JAX package on the same numpy inputs (CPU), and every registered
algorithm through the port's API with a persist/reload round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ml import cluster_extra as JCE
from neurondb_tpu.ml import gmm as JGMM
from neurondb_tpu.ml import kmeans as JKM
from neurondb_tpu.ml import linear as JLIN
from neurondb_tpu.ml import neighbors as JNB
from neurondb_tpu.ml import pca as JPCA
from neurondb_tpu_torch.ml import api as TA
from neurondb_tpu_torch.ml import cluster_extra as TCE
from neurondb_tpu_torch.ml import gmm as TGMM
from neurondb_tpu_torch.ml import kmeans as TKM
from neurondb_tpu_torch.ml import linear as TLIN
from neurondb_tpu_torch.ml import neighbors as TNB
from neurondb_tpu_torch.ml import pca as TPCA
from neurondb_tpu_torch.ml import registry as TR

# deterministic solvers, f32 sums in another order: relative agreement,
# absolute near 0 (the normal equations' f32 error on unit-scale
# coefficients)
FIT_TOL = dict(rtol=2e-4, atol=1e-4)
INERTIA_MARGIN = 0.05    # fits from different random streams


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _clustered(seed, n=1200, d=16, ncl=12, spread=3.0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((ncl, d)).astype(np.float32) * spread
    lab = rng.integers(0, ncl, n)
    return (c[lab] + rng.standard_normal((n, d))).astype(np.float32), lab


def _targets(x, seed=1, classes=4):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(x.shape[1]).astype(np.float32)
    W = rng.standard_normal((x.shape[1], classes)).astype(np.float32)
    y_reg = (x @ w + 0.1 * rng.standard_normal(len(x))).astype(np.float32)
    y_bin = (x @ w > np.median(x @ w)).astype(np.int32)
    y_mc = np.argmax(x @ W + rng.standard_normal((len(x), classes)),
                     axis=1).astype(np.int32)
    return y_reg, y_bin, y_mc


# ---------------------------------------------------------------------------
# k-means variants and the cluster-quality scores
# ---------------------------------------------------------------------------

def test_minibatch_kmeans_inertia_near_jax():
    """Different random streams (seeding, batches): held to the JAX fit's
    inertia within INERTIA_MARGIN."""
    x, _ = _clustered(0, n=1500)
    js = JKM.minibatch_kmeans_fit(jnp.asarray(x), 8, batch=256, iters=60)
    ts = TKM.minibatch_kmeans_fit(_t(x), 8, batch=256, iters=60)
    assert ts.n_iter == 60 and ts.shift == 0.0
    assert abs(ts.inertia - float(js.inertia)) <= \
        INERTIA_MARGIN * float(js.inertia), (ts.inertia, float(js.inertia))
    # the reported inertia is that of the returned centroids
    d2 = ((x[:, None, :] - ts.centroids.numpy()[None]) ** 2).sum(-1).min(1)
    assert ts.inertia == pytest.approx(float(d2.sum()), rel=1e-4)
    again = TKM.minibatch_kmeans_fit(_t(x), 8, batch=256, iters=60)
    assert torch.equal(again.centroids, ts.centroids)


def test_silhouette_and_davies_bouldin_match_jax(monkeypatch):
    monkeypatch.setattr(TKM, "SCORE_ROWS", 97)        # several chunks
    x, _ = _clustered(1, n=900)
    c = x[:10]
    labels = np.array(JKM.kmeans_predict(jnp.asarray(c), jnp.asarray(x)))
    labels[labels == 3] = 2                           # an empty cluster
    # the JAX scores are eager jnp code: one jit compiles each at once
    js = float(jax.jit(JKM.silhouette_score, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(labels), 10))
    jd = float(jax.jit(JKM.davies_bouldin_index, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(labels), 10))
    ts = float(TKM.silhouette_score(_t(x), _t(labels), 10))
    td = float(TKM.davies_bouldin_index(_t(x), _t(labels), 10))
    assert ts == pytest.approx(js, rel=1e-5)
    assert td == pytest.approx(jd, rel=1e-5)


# ---------------------------------------------------------------------------
# linear family
# ---------------------------------------------------------------------------

def _close_tree(t, j, tol=FIT_TOL):
    for k in j:
        np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]), **tol,
                                   err_msg=k)


def test_linear_and_ridge_match_jax():
    x, _ = _clustered(2)
    y, _, _ = _targets(x)
    Y2 = np.stack([y, -2 * y + 1], 1)
    for kw, yy in (({}, y), ({"l2": 3.0}, Y2), ({"fit_intercept": False}, y)):
        j = JLIN.linear_regression_fit(jnp.asarray(x), jnp.asarray(yy), **kw)
        t = TLIN.linear_regression_fit(_t(x), _t(yy), **kw)
        _close_tree(t, j)
        np.testing.assert_allclose(
            TLIN.linear_regression_predict(t, _t(x)).numpy(),
            np.asarray(jax.jit(JLIN.linear_regression_predict)(
                j, jnp.asarray(x))), rtol=1e-4, atol=1e-4)
    tm = TLIN.regression_metrics(t, _t(x), _t(y))
    jm = jax.jit(JLIN.regression_metrics)(j, jnp.asarray(x), jnp.asarray(y))
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("fit,kw", [("lasso_fit", {"l1": 0.05}),
                                    ("lasso_fit", {"l1": 0.3, "l2": 0.1}),
                                    ("elastic_net_fit", {"alpha": 0.2})])
def test_lasso_and_elastic_net_match_jax(fit, kw):
    x, _ = _clustered(3, n=800)
    y, _, _ = _targets(x)
    j = getattr(JLIN, fit)(jnp.asarray(x), jnp.asarray(y), iters=200, **kw)
    t = getattr(TLIN, fit)(_t(x), _t(y), iters=200, **kw)
    _close_tree(t, j, dict(rtol=1e-3, atol=1e-4))
    assert int((t["coef"] == 0).sum()) == int((np.asarray(j["coef"]) == 0).sum())


@pytest.mark.parametrize("classes", [2, 4])
def test_logistic_regression_matches_jax(classes):
    x, _ = _clustered(4, n=800, d=8)
    x = x / 4.0
    _, y_bin, y_mc = _targets(x, classes=classes)
    y = y_bin if classes == 2 else y_mc
    j = JLIN.logistic_regression_fit(jnp.asarray(x), jnp.asarray(y), iters=8,
                                     num_classes=classes)
    t = TLIN.logistic_regression_fit(_t(x), _t(y), iters=8,
                                     num_classes=classes)
    _close_tree(t, j, dict(rtol=2e-3, atol=2e-4))
    jp = np.asarray(jax.jit(JLIN.logistic_predict_proba)(j, jnp.asarray(x)))
    tp = TLIN.logistic_predict_proba(t, _t(x)).numpy()
    np.testing.assert_allclose(tp, jp, atol=2e-4)
    acc_t = float(TLIN.classification_metrics(t, _t(x), _t(y))["accuracy"])
    acc_j = float((jp.argmax(1) == y).mean())
    assert abs(acc_t - acc_j) <= 2 / len(x)     # a near-0.5 row may flip


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("whiten", [False, True])
def test_pca_matches_jax_up_to_sign(whiten):
    x, _ = _clustered(5, n=700, d=12)
    j = JPCA.pca_fit(jnp.asarray(x), 5, whiten=whiten)
    t = TPCA.pca_fit(_t(x), 5, whiten=whiten)
    for k in ("mean", "explained_variance", "explained_variance_ratio"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-4, atol=1e-5)
    jc, tc = np.asarray(j["components"]), t["components"].numpy()
    sign = np.sign((jc * tc).sum(1))                # one sign per component
    np.testing.assert_allclose(tc * sign[:, None], jc, atol=1e-4)
    z = TPCA.pca_transform(t, _t(x)).numpy()
    jz, jback = jax.jit(lambda m, a: (
        JPCA.pca_transform(m, a),
        JPCA.pca_inverse_transform(m, JPCA.pca_transform(m, a))))(
            j, jnp.asarray(x))
    np.testing.assert_allclose(z * sign[None, :], np.asarray(jz),
                               rtol=1e-3, atol=1e-3)
    back = TPCA.pca_inverse_transform(t, _t(z)).numpy()
    np.testing.assert_allclose(back, np.asarray(jback), atol=1e-3)


def test_random_projection_within_jl_bound():
    """Both draws are Gaussian N(0, 1/C) matrices: with C = 256 and 60
    points, every pairwise squared distance keeps its length within
    JL_EPS (the Johnson-Lindenstrauss bound for that C and n), in both
    packages."""
    JL_EPS = 0.5
    x, _ = _clustered(6, n=60, d=64)
    for z in (TPCA.random_projection(_t(x), 256).numpy(),
              np.asarray(JPCA.random_projection(jnp.asarray(x), 256))):
        i, j = np.triu_indices(60, 1)
        r = ((z[i] - z[j]) ** 2).sum(1) / ((x[i] - x[j]) ** 2).sum(1)
        assert (np.abs(r - 1.0) < JL_EPS).all(), (r.min(), r.max())
    a = TPCA.random_projection(_t(x), 16, seed=3)
    assert torch.equal(a, TPCA.random_projection(_t(x), 16, seed=3))


# ---------------------------------------------------------------------------
# GMM: EM from JAX's own seeding
# ---------------------------------------------------------------------------

def test_gmm_em_from_jax_init_matches_jax():
    x, _ = _clustered(7, n=600, d=8, ncl=5)
    k, iters, reg = 5, 30, 1e-6
    xj = jnp.asarray(x)
    means0 = jax.jit(JKM.kmeans_plusplus_init, static_argnums=1)(
        xj, k, jax.random.PRNGKey(0))
    var0 = jnp.tile(jnp.var(xj, axis=0)[None, :] + reg, (k, 1))
    w0 = jnp.full((k,), 1.0 / k)
    j = JGMM.gmm_fit(xj, k, iters=iters, seed=0)
    t = TGMM._gmm_em(_t(x), _t(np.asarray(means0)), _t(np.asarray(var0)),
                    _t(np.asarray(w0)), iters=iters, reg=reg)
    for name in ("means", "variances", "weights"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
    assert float(t.log_likelihood) == pytest.approx(float(j.log_likelihood),
                                                    rel=1e-5)
    np.testing.assert_array_equal(
        TGMM.gmm_predict(t, _t(x)).numpy(),
        np.asarray(jax.jit(JGMM.gmm_predict)(j, xj)))
    np.testing.assert_allclose(TGMM.gmm_score_samples(t, _t(x)).numpy(),
                               np.asarray(jax.jit(JGMM.gmm_score_samples)(
                                   j, xj)), rtol=1e-4, atol=1e-3)
    # the port's own seeding: a fit at least as likely as its start
    m0, v0, w0_ = TGMM.gmm_init(_t(x), k)
    start = torch.logsumexp(TGMM._log_prob(_t(x), m0, v0, w0_), 1).sum()
    assert float(TGMM.gmm_fit(_t(x), k, iters=iters).log_likelihood) > \
        float(start)


# ---------------------------------------------------------------------------
# kNN, naive Bayes, SVM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 300, 1000, 4096, 9001])
def test_grouped_selection_is_topk_smallest_bit_for_bit(n):
    """The one-pass grouped selection under kNN's scan (``topk_smallest``
    on rows wider than ``ROW_SORT_MAX``) gives a stable sort's positions:
    ties (integer data) to the lower index, -0.0 equal to 0.0, +-inf, and
    NaN after every number."""
    from neurondb_tpu_torch.ops import topk as TK
    g = torch.Generator().manual_seed(n)
    d2 = torch.randint(-3, 7, (6, n), generator=g).float()
    d2[1, ::7] = float("nan")
    d2[2, ::5] = -0.0
    d2[3, ::3] = float("-inf")
    d2[4, n // 2:] = float("inf")
    want = torch.sort(d2, dim=-1, stable=True).indices
    for k in (1, 5, 40):
        kk = min(k, n)
        assert torch.equal(TK._grouped_positions(d2, kk), want[:, :kk])
        v, p = TK.topk_smallest(d2, k)
        assert torch.equal(p, want[:, :kk])
        assert torch.equal(v.nan_to_num(), torch.gather(
            d2, 1, want[:, :kk]).nan_to_num())


def test_knn_matches_jax(monkeypatch):
    monkeypatch.setattr(TNB, "BLOCK_FLOATS", 4096)   # several query blocks
    x, lab = _clustered(8, n=900)
    y_reg, _, _ = _targets(x)
    q = x[:150] + 0.3
    for y, task in ((lab.astype(np.int32), "classify"), (y_reg, "regress")):
        j = JNB.knn_fit(jnp.asarray(x), jnp.asarray(y), k=5, task=task)
        t = TNB.knn_fit(_t(x), _t(y), k=5, task=task)
        want = np.asarray(JNB.knn_predict(j, jnp.asarray(q)))
        got = TNB.knn_predict(t, _t(q)).numpy()
        if task == "classify":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_naive_bayes_matches_jax():
    x, lab = _clustered(9, n=1000)
    lab = (lab % 5).astype(np.int32)
    j = JNB.naive_bayes_fit(jnp.asarray(x), jnp.asarray(lab), num_classes=6)
    t = TNB.naive_bayes_fit(_t(x), _t(lab), num_classes=6)   # one empty class
    _close_tree(t, j, dict(rtol=1e-4, atol=1e-5))
    np.testing.assert_array_equal(
        TNB.naive_bayes_predict(t, _t(x)).numpy(),
        np.asarray(jax.jit(JNB.naive_bayes_predict)(j, jnp.asarray(x))))


def test_linear_svm_matches_jax():
    x, _ = _clustered(10, n=800, d=8)
    _, y_bin, y_mc = _targets(x)
    for y, c in ((y_bin, 2), (y_mc, 4)):
        j = JNB.svm_fit(jnp.asarray(x), jnp.asarray(y), num_classes=c,
                        iters=60)
        t = TNB.svm_fit(_t(x), _t(y), num_classes=c, iters=60)
        np.testing.assert_allclose(t["W"].numpy(), np.asarray(j["W"]),
                                   rtol=1e-4, atol=1e-5)
        agree = (TNB.svm_predict(t, _t(x)).numpy()
                 == np.asarray(JNB.svm_predict(j, jnp.asarray(x)))).mean()
        assert agree >= 0.995


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_kernel_matrix_and_dual_svm_match_jax(kernel):
    x, _ = _clustered(11, n=200, d=6)
    x = x / 4.0
    _, y_bin, _ = _targets(x)
    kw = dict(kernel=kernel, gamma=0.5, degree=2, coef0=1.0)
    for k in ("linear", "rbf", "poly"):
        kk = dict(kw, kernel=k)
        np.testing.assert_allclose(
            TNB.kernel_matrix(_t(x[:50]), _t(x), **kk).numpy(),
            np.asarray(jax.jit(JNB.kernel_matrix, static_argnames="kernel")(
                jnp.asarray(x[:50]), jnp.asarray(x), **kk)),
            rtol=1e-5, atol=1e-5)
    j = JNB.svm_kernel_fit(x, y_bin, C=1.0, iters=100, sample_cap=150, **kw)
    t = TNB.svm_kernel_fit(_t(x), _t(y_bin), C=1.0, iters=100,
                           sample_cap=150, **kw)
    # the same numpy subsample, the same support vectors (within tolerance
    # of the 1e-6 C cut), the same decisions
    assert abs(int(t["n_support"]) - int(j["n_support"])) <= 2
    np.testing.assert_allclose(t["b"].numpy(), np.asarray(j["b"]),
                               rtol=1e-3, atol=1e-3)
    want = np.asarray(JNB.svm_kernel_decision(j, jnp.asarray(x)))
    got = TNB.svm_kernel_decision(t, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert t["kernel"] == kernel and t["degree"].dtype == torch.int32


def test_rbf_features_approximate_the_kernel():
    """Different draws from JAX's: both approximate exp(-gamma |a-b|^2)
    with 1024 features to within RFF_TOL on average."""
    RFF_TOL = 0.05
    x, _ = _clustered(12, n=80, d=6)
    x = x / 4.0
    exact = TNB.kernel_matrix(_t(x), _t(x), kernel="rbf", gamma=0.5).numpy()
    jrbf = jax.jit(JNB.rbf_features, static_argnums=1)
    for f in (TNB.rbf_features(_t(x), 1024, gamma=0.5).numpy(),
              np.asarray(jrbf(jnp.asarray(x), 1024, gamma=0.5))):
        assert np.abs(f @ f.T - exact).mean() < RFF_TOL


# ---------------------------------------------------------------------------
# DBSCAN, agglomerative, anomaly detection
# ---------------------------------------------------------------------------

def test_dbscan_matches_jax(monkeypatch):
    monkeypatch.setattr(TCE, "CHECK_EVERY", 2)
    x, _ = _clustered(13, n=250, d=4, ncl=5, spread=6.0)
    x = np.concatenate([x, np.full((3, 4), 40.0, np.float32)])   # noise
    j = JCE.dbscan_fit(jnp.asarray(x), eps=1.5, min_samples=5)
    t = TCE.dbscan_fit(_t(x), eps=1.5, min_samples=5)
    np.testing.assert_array_equal(t["labels"].numpy(), np.asarray(j["labels"]))
    np.testing.assert_array_equal(t["core"].numpy(), np.asarray(j["core"]))
    assert (t["labels"][-3:] == -1).all()
    q = x[::7] + 0.2
    np.testing.assert_array_equal(TCE.dbscan_predict(t, _t(q)).numpy(),
                                  np.asarray(jax.jit(JCE.dbscan_predict)(
                                      j, jnp.asarray(q))))


def test_agglomerative_matches_jax():
    x, _ = _clustered(14, n=160, d=4, ncl=4, spread=8.0)
    j = JCE.agglomerative_fit(jnp.asarray(x), 4)
    t = TCE.agglomerative_fit(_t(x), 4)
    np.testing.assert_array_equal(t["labels"].numpy(), np.asarray(j["labels"]))
    np.testing.assert_array_equal(t["active"].numpy(), np.asarray(j["active"]))
    act = t["active"].numpy()
    np.testing.assert_allclose(t["centroids"].numpy()[act],
                               np.asarray(j["centroids"])[act], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        TCE.relabel_consecutive(t["labels"]).numpy(),
        np.asarray(JCE.relabel_consecutive(j["labels"])))


def test_outlier_scores_match_jax():
    x, _ = _clustered(15, n=500, d=6)
    x[:4] += 25.0                                   # planted outliers
    for name, kw in (("zscore_outliers", {}), ("iqr_outliers", {}),
                     ("zscore_outliers", {"threshold": 2.0})):
        np.testing.assert_array_equal(
            getattr(TCE, name)(_t(x), **kw).numpy(),
            np.asarray(jax.jit(getattr(JCE, name))(jnp.asarray(x), **kw)))
    np.testing.assert_allclose(TCE.knn_outlier_scores(_t(x), 5).numpy(),
                               np.asarray(JCE.knn_outlier_scores(
                                   jnp.asarray(x), 5)), rtol=1e-4, atol=1e-4)
    # isolation scores: other draws than JAX's, the same phenomenon (the
    # planted outliers score above the inliers' median, and their mean
    # above the inliers' 99th percentile, as the JAX package's do here)
    s = TCE.isolation_scores(_t(x), n_trees=30).numpy()
    assert s[:4].min() > np.median(s[4:]), s[:4]
    assert s[:4].mean() > np.percentile(s[4:], 99), s[:4]


# ---------------------------------------------------------------------------
# every registered algorithm through the API, persisted and reloaded
# ---------------------------------------------------------------------------

CASES = {
    "kmeans": ({"k": 6}, None), "minibatch_kmeans": ({"k": 6, "iters": 20},
                                                      None),
    "linear_regression": ({}, "reg"), "ridge": ({"alpha": 2.0}, "reg"),
    "lasso": ({"alpha": 0.05, "iters": 100}, "reg"),
    "elastic_net": ({"alpha": 0.05, "iters": 100}, "reg"),
    "logistic_regression": ({"iters": 10}, "mc"), "gmm": ({"k": 3}, None),
    "pca": ({"n_components": 4, "whiten": True}, None),
    "dbscan": ({"eps": 2.0}, None), "hierarchical": ({"n_clusters": 5}, None),
    "knn_classifier": ({"k": 3}, "mc"), "knn_regressor": ({}, "reg"),
    "naive_bayes": ({}, "mc"), "svm": ({"iters": 50}, "bin"),
    "anomaly_detection": ({}, None),
}


@pytest.mark.parametrize("algorithm", sorted(CASES))
def test_every_algorithm_trains_predicts_and_reloads(algorithm, tmp_path,
                                                     monkeypatch):
    x, _ = _clustered(16, n=300, d=8)
    y_reg, y_bin, y_mc = _targets(x, classes=3)
    hp, target = CASES[algorithm]
    y = {"reg": y_reg, "bin": y_bin, "mc": y_mc, None: None}[target]
    reg = TR.ModelRegistry(str(tmp_path), device="cpu")
    monkeypatch.setattr(TR, "_registry", reg)
    mid = TA.train("p", algorithm, x.astype(np.float64), y, hp, device="cpu")
    rec = reg.get(mid)
    assert rec.metrics["train_seconds"] >= 0
    pred = TA.predict(mid, x[:40], device="cpu")
    assert len(pred) == 40 and np.isfinite(pred.astype(np.float64)).all()
    TR.set_registry(TR.ModelRegistry(str(tmp_path), device="cpu"))
    np.testing.assert_array_equal(TA.predict(mid, x[:40], device="cpu"), pred)
    if TA._resolve(algorithm).evaluate is not None:
        ev = TA.evaluate(mid, x, y, device="cpu")
        assert ev and all(np.isfinite(v) for v in ev.values())


@pytest.mark.parametrize("solver", ["dual", "rff"])
def test_svm_solvers_through_the_api(solver, tmp_path, monkeypatch):
    x, _ = _clustered(17, n=300, d=8)
    x = x / 4.0
    _, y_bin, _ = _targets(x)
    reg = TR.ModelRegistry(str(tmp_path), device="cpu")
    monkeypatch.setattr(TR, "_registry", reg)
    hp = {"solver": solver, "gamma": 0.2, "iters": 80, "sample_cap": 200}
    mid = TA.train("p", "svm", x, y_bin, hp, device="cpu")
    assert reg.get(mid).metrics["accuracy"] > 0.8
    pred = TA.predict(mid, x, device="cpu")
    TR.set_registry(TR.ModelRegistry(str(tmp_path), device="cpu"))
    np.testing.assert_array_equal(TA.predict(mid, x, device="cpu"), pred)
