"""XGBoost / LightGBM / CatBoost semantics (``ml/boosting.py``): the
three growers, the fits and predictors, ordered boosting and ordered
target statistics, the torch port against the JAX package on the same
numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ml import api as JA
from neurondb_tpu.ml import boosting as JB
from neurondb_tpu.ml import trees as JT
from neurondb_tpu_torch.ml import api as TA
from neurondb_tpu_torch.ml import boosting as TB

# Leaf values -G / (H + l2): f32 sums over the same rows; on the CPU in
# the same order, but XLA fuses other arithmetic into FMAs (its CPU
# backend contracts a * b + c): 1e-6.
LEAF_TOL = dict(rtol=1e-6, atol=1e-6)
# Raw scores add lr * leaf over rounds; gradients go through sigmoid /
# softmax, whose last bits differ between the two libraries.
RAW_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((500, 10)).astype(np.float32)
    W = rng.standard_normal((10, 3)).astype(np.float32)
    y = np.argmax(X @ W + 0.3 * rng.standard_normal((500, 3)),
                  1).astype(np.int32)
    yr = (X @ W[:, 0] + 0.1 * rng.standard_normal(500)).astype(np.float32)
    Xb = np.asarray(JT.bin_features(X, JT.quantile_bins(jnp.asarray(X))))
    # logistic gradients of a raw score: g in (-1, 1), h = p (1 - p)
    p = 1.0 / (1.0 + np.exp(-(X @ W[:, 1])))
    yb = (y == 0).astype(np.float32)
    g = (p - yb).astype(np.float32)
    h = np.maximum(p * (1 - p), 1e-6).astype(np.float32)
    return X, y, yr, Xb, g, h


def test_grow_xgb_tree_equal(data):
    _, _, _, Xb, g, h = data
    fm = np.ones(Xb.shape[1], bool)
    fm[2] = False
    kw = dict(depth=3, n_bins=64, l2=1.0, gamma=0.0, min_child_weight=1.0)
    jt = JB._grow_xgb_tree(jnp.asarray(Xb), jnp.asarray(g), jnp.asarray(h),
                           jnp.asarray(fm), **kw)
    tt = TB._grow_xgb_tree(_t(Xb), _t(g), _t(h), _t(fm), **kw)
    for k in ("feat", "tbin"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
    assert 2 not in tt["feat"].tolist()
    np.testing.assert_allclose(tt["leaf"].numpy(), np.asarray(jt["leaf"]),
                               **LEAF_TOL)


def test_grow_leafwise_tree_equal(data):
    _, _, _, Xb, g, h = data
    kw = dict(num_leaves=4, n_bins=64, l2=1.0, gamma=0.0,
              min_child_weight=1.0)
    jt = JB._grow_leafwise_tree(Xb, g, h, **kw)
    tt = TB._grow_leafwise_tree(_t(Xb), _t(g), _t(h), **kw)
    for k in ("feat", "tbin", "left", "right"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
    np.testing.assert_allclose(tt["leaf"].numpy(), np.asarray(jt["leaf"]),
                               **LEAF_TOL)


def test_grow_oblivious_tree_equal(data):
    _, _, _, Xb, g, h = data
    kw = dict(depth=3, n_bins=64, l2=3.0, min_child_weight=1.0)
    jf, jb, jm = JB._grow_oblivious_tree(jnp.asarray(Xb), jnp.asarray(g),
                                         jnp.asarray(h), **kw)
    tf, tb, tm = TB._grow_oblivious_tree(_t(Xb), _t(g), _t(h), **kw)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        TB._oblivious_leaf_index(_t(Xb), tf, tb).numpy(), np.asarray(jm))


CASES = {
    "xgboost binary": (JB.xgboost_fit, TB.xgboost_fit, "xgboost_raw",
                       dict(n_trees=4, depth=3), "bin"),
    "xgboost 3-class": (JB.xgboost_fit, TB.xgboost_fit, "xgboost_raw",
                        dict(n_trees=3, depth=3), "mc"),
    "xgboost regress": (JB.xgboost_fit, TB.xgboost_fit, "xgboost_raw",
                        dict(n_trees=4, depth=3, task="regress"), "reg"),
    "lightgbm binary": (JB.lightgbm_fit, TB.lightgbm_fit, "lightgbm_raw",
                        dict(n_trees=4, num_leaves=6), "bin"),
    "lightgbm goss": (JB.lightgbm_fit, TB.lightgbm_fit, "lightgbm_raw",
                      dict(n_trees=3, num_leaves=5, goss=True), "mc"),
    "catboost binary": (JB.catboost_fit, TB.catboost_fit, "catboost_raw",
                        dict(n_trees=4, depth=3), "bin"),
    "catboost 3-class": (JB.catboost_fit, TB.catboost_fit, "catboost_raw",
                         dict(n_trees=3, depth=3), "mc"),
    "catboost plain regress": (JB.catboost_fit, TB.catboost_fit,
                               "catboost_raw",
                               dict(n_trees=4, depth=3, task="regress",
                                    ordered=False), "reg"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_boosting_fits_match_jax(case, data):
    """Trees (the same host draws: GOSS and CatBoost's permutation) and
    raw scores; classification predictions equal."""
    X, y, yr, _, _, _ = data
    jfit, tfit, raw, kw, target = CASES[case]
    yy = {"bin": (y == 0).astype(np.int32), "mc": y, "reg": yr}[target]
    jm = jfit(X, yy, **kw)
    tm = tfit(_t(X), _t(yy), **kw)
    for k in jm["trees"]:
        if k == "leaf":
            np.testing.assert_allclose(tm["trees"][k].numpy(),
                                       np.asarray(jm["trees"][k]), **RAW_TOL)
        else:
            np.testing.assert_array_equal(tm["trees"][k].numpy(),
                                          np.asarray(jm["trees"][k]), k)
    rj = np.asarray(getattr(JB, raw)(jm, X))
    rt = getattr(TB, raw)(tm, _t(X)).numpy()
    np.testing.assert_allclose(rt, rj, **RAW_TOL)
    pred = {"xgboost_raw": TB.xgboost_predict, "lightgbm_raw":
            TB.lightgbm_predict, "catboost_raw": TB.catboost_predict}[raw]
    if target != "reg":
        np.testing.assert_array_equal(pred(tm, _t(X)).numpy(),
                                      rj.argmax(1))
    if raw == "xgboost_raw":
        np.testing.assert_allclose(TB.xgboost_predict_proba(tm, _t(X)).numpy(),
                                   np.asarray(JB.xgboost_predict_proba(jm, X)),
                                   **RAW_TOL)


def test_ordered_target_encode_equal():
    rng = np.random.default_rng(2)
    cat = rng.integers(0, 5, 200)
    y = rng.integers(0, 2, 200).astype(np.float32)
    perm = rng.permutation(200)
    np.testing.assert_array_equal(TB.ordered_target_encode(cat, y, perm),
                                  JB.ordered_target_encode(cat, y, perm))


def test_xgboost_colsample_masks_features(data):
    X, y, _, _, _, _ = data
    m = TB.xgboost_fit(_t(X), _t((y == 0).astype(np.int32)), n_trees=3,
                       depth=2, colsample=0.3, seed=4)
    per_round = [set(m["trees"]["feat"][t].reshape(-1).tolist()) - {-1}
                 for t in range(3)]
    assert all(len(s) <= 4 for s in per_round), per_round


@pytest.mark.parametrize("algo", ["xgboost", "lightgbm", "catboost"])
def test_boosting_names_resolve_as_in_jax(algo, data):
    """The API aliases each name to gradient_boosting in both packages;
    the trainer registered under the name evaluates as JAX's."""
    X, y, _, _, _, _ = data
    JA._ensure_loaded()
    assert TA._resolve(algo).name == JA._resolve(algo).name == \
        "gradient_boosting"
    hp = {"n_trees": 2, "learning_rate": 0.3}
    hp.update({"num_leaves": 4} if algo == "lightgbm" else {"depth": 3})
    yb = (y == 0).astype(np.int32)
    jt, tt = JA._ALGORITHMS[algo], TA._ALGORITHMS[algo]
    jm = jt.train(jnp.asarray(X), jnp.asarray(yb), **hp)
    tm = tt.train(_t(X), _t(yb), **hp)
    np.testing.assert_array_equal(tt.predict(tm, _t(X)).numpy(),
                                  np.asarray(jt.predict(jm, jnp.asarray(X))))
    assert tt.evaluate(tm, _t(X), _t(yb))["accuracy"] == pytest.approx(
        jt.evaluate(jm, jnp.asarray(X), jnp.asarray(yb))["accuracy"],
        abs=1e-6)
