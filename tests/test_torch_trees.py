"""The tree ensembles (``ml/trees.py``): quantile bins, the level-wise
histogram grower, random forest, gradient boosting and the ensemble
predictors, the torch port against the JAX package on the same numpy
inputs (CPU), and the three families through the port's API."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ml import api as JA
from neurondb_tpu.ml import trees as JT
from neurondb_tpu_torch.ml import api as TA
from neurondb_tpu_torch.ml import trees as TT

# Leaf values are means (f32 sums over the same rows in the same order on
# the CPU, then a division): 1e-6 absolute, the tolerance the trees'
# structure does not need (classification counts are exact integers).
LEAF_TOL = dict(rtol=1e-6, atol=1e-6)
# Ensemble outputs add leaf values over trees: the same sums, a few ulps.
RAW_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(seed=0, n=400, d=12, classes=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X[:, 3] = np.round(X[:, 3])                  # ties across bin edges
    X[:, 5] = 1.0                                # a constant feature
    W = rng.standard_normal((d, classes)).astype(np.float32)
    y = np.argmax(X @ W + 0.3 * rng.standard_normal((n, classes)),
                  1).astype(np.int32)
    yr = (X @ W[:, 0] + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y, yr


def _same_tree(jt, tt):
    """feat / tbin equal; leaf values within LEAF_TOL."""
    for k in ("feat", "tbin"):
        np.testing.assert_array_equal(np.asarray(jt[k]), tt[k].numpy(), k)
    np.testing.assert_allclose(tt["leaf"].numpy(), np.asarray(jt["leaf"]),
                               **LEAF_TOL)


@pytest.mark.parametrize("shape", [(600, 12), (257, 5), (64, 3)])
def test_quantile_bins_and_bin_features_bit_for_bit(shape):
    rng = np.random.default_rng(shape[0])
    X = rng.standard_normal(shape).astype(np.float32)
    X[: shape[0] // 3, 0] = 0.5                  # a run of equal values
    ej = np.asarray(JT.quantile_bins(jnp.asarray(X)))
    et = TT.quantile_bins(_t(X)).numpy()
    np.testing.assert_array_equal(et, ej)
    Xq = np.concatenate([X, ej.T[:, :shape[1]][:5]])   # values on the edges
    np.testing.assert_array_equal(TT.bin_features(_t(Xq), _t(ej)).numpy(),
                                  np.asarray(JT.bin_features(Xq, ej)))


def test_cumsum_xla_is_jax_cpu_cumsum():
    rng = np.random.default_rng(3)
    for shape, axis in (((4, 7, 64), 2), ((1000,), 0), ((3, 17), 1),
                        ((2, 300, 2), 1)):
        x = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(
            TT.cumsum_xla(_t(x), axis).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(x), axis=axis)))


@pytest.mark.parametrize("depth,min_leaf,weighted", [
    (3, 1, False), (4, 5, False), (4, 1, True)])
def test_grow_tree_classification_equal(depth, min_leaf, weighted):
    X, y, _ = _data()
    Xb = np.asarray(JT.bin_features(X, JT.quantile_bins(jnp.asarray(X))))
    Y = np.eye(3, dtype=np.float32)[y]
    w = (np.random.default_rng(1).poisson(1.0, len(X)).astype(np.float32)
         if weighted else np.ones(len(X), np.float32))
    jt = JT.grow_tree(jnp.asarray(Xb), jnp.asarray(Y), jnp.asarray(w),
                      depth=depth, min_leaf=min_leaf)
    tt = TT.grow_tree(_t(Xb), _t(Y), _t(w), depth=depth, min_leaf=min_leaf)
    _same_tree(jt, tt)
    np.testing.assert_allclose(
        TT.tree_predict(tt, _t(Xb), depth=depth).numpy(),
        np.asarray(JT.tree_predict(jt, jnp.asarray(Xb), depth=depth)),
        **LEAF_TOL)


def test_grow_tree_regression_equal_on_the_cpu():
    """Regression sums are floats: on the CPU both packages add each
    segment's rows in row order, so the trees agree."""
    X, _, yr = _data(seed=2)
    Xb = np.asarray(JT.bin_features(X, JT.quantile_bins(jnp.asarray(X))))
    w = np.ones(len(X), np.float32)
    jt = JT.grow_tree(jnp.asarray(Xb), jnp.asarray(yr[:, None]),
                      jnp.asarray(w), depth=4, min_leaf=5)
    tt = TT.grow_tree(_t(Xb), _t(yr[:, None]), _t(w), depth=4, min_leaf=5)
    _same_tree(jt, tt)


def _jax_forest_draws(seed, n_trees, N, F, feature_frac):
    """The bootstrap weights and feature masks random_forest_fit draws."""
    ws, ms = [], []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_trees):
        k1, k2 = jax.random.split(key)
        ws.append(np.asarray(jax.random.poisson(k1, 1.0, (N,)),
                             np.float32))
        ms.append(np.asarray(jax.random.uniform(k2, (F,)) < feature_frac))
    return np.stack(ws), np.stack(ms)


@pytest.mark.parametrize("task", ["classify", "regress"])
def test_forest_from_jax_draws(task):
    X, y, yr = _data(seed=4)
    target = y if task == "classify" else yr
    jm = JT.random_forest_fit(X, target, task=task, n_trees=4, depth=3,
                              seed=5)
    W, M = _jax_forest_draws(5, 4, *X.shape, 0.7)
    Xb, Y, _, _ = TT._prep(_t(X), _t(target), task, None)
    tt = TT.forest_from_draws(Xb, Y, _t(W), _t(M), depth=3, min_leaf=1)
    _same_tree(jm["trees"], tt)


def test_random_forest_draws_and_predicts():
    X, y, _ = _data(seed=6)
    m = TT.random_forest_fit(_t(X), _t(y), n_trees=6, depth=4, seed=1)
    assert m["trees"]["feat"].shape == (6, 31)
    assert not torch.equal(m["trees"]["feat"][0], m["trees"]["feat"][1])
    m2 = TT.random_forest_fit(_t(X), _t(y), n_trees=6, depth=4, seed=1)
    assert all(torch.equal(m["trees"][k], m2["trees"][k]) for k in m["trees"])
    acc = (TT.ensemble_predict(m, _t(X)).numpy() == y).mean()
    assert acc > 0.7, acc
    p = TT.ensemble_predict_proba(m, _t(X)).numpy()
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("task", ["classify", "regress"])
def test_decision_tree_and_gradient_boosting_match_jax(task):
    X, y, yr = _data(seed=7)
    target = y if task == "classify" else yr
    for jfit, tfit, kw in (
            (JT.decision_tree_fit, TT.decision_tree_fit, dict(depth=4)),
            (JT.gradient_boosting_fit, TT.gradient_boosting_fit,
             dict(n_trees=6, depth=3))):
        jm = jfit(X, target, task=task, **kw)
        tm = tfit(_t(X), _t(target), task=task, **kw)
        for k in ("feat", "tbin"):
            np.testing.assert_array_equal(tm["trees"][k].numpy(),
                                          np.asarray(jm["trees"][k]))
        np.testing.assert_allclose(tm["trees"]["leaf"].numpy(),
                                   np.asarray(jm["trees"]["leaf"]),
                                   **RAW_TOL)
        np.testing.assert_allclose(TT.ensemble_raw(tm, _t(X)).numpy(),
                                   np.asarray(JT.ensemble_raw(jm, X)),
                                   **RAW_TOL)
        pj = np.asarray(JT.ensemble_predict(jm, X))
        pt = TT.ensemble_predict(tm, _t(X)).numpy()
        if task == "classify":
            np.testing.assert_array_equal(pt, pj)
        else:
            np.testing.assert_allclose(pt, pj, **RAW_TOL)
        np.testing.assert_allclose(
            TT.ensemble_predict_proba(tm, _t(X)).numpy(),
            np.asarray(JT.ensemble_predict_proba(jm, X)), **RAW_TOL)


@pytest.mark.parametrize("algo", ["dt", "rf", "gbt"])
def test_tree_families_through_the_api(algo):
    """train / predict / evaluate through the port's API; DT and GBT
    (no random draws) evaluate as JAX's do."""
    X, y, _ = _data(seed=8)
    hp = {"depth": 3, "n_trees": 5} if algo not in ("dt", "decision_tree") \
        else {"depth": 3}
    tid = TA.train("p", algo, X, y, hp, device="cpu")
    pred = TA.predict(tid, X, device="cpu")
    ev = TA.evaluate(tid, X, y, device="cpu")
    assert ev["accuracy"] == pytest.approx(float((pred == y).mean()),
                                           abs=1e-6)
    if TA._resolve(algo).name != "random_forest":
        jid = JA.train("p", algo, X, y, hp)
        np.testing.assert_array_equal(pred, JA.predict(jid, X))
        assert ev["accuracy"] == pytest.approx(
            JA.evaluate(jid, X, y)["accuracy"], abs=1e-6)
