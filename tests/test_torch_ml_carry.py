"""Models of the families ported last cross the two registries both ways
with equal predictions (trees, XGBoost / LightGBM / CatBoost, time
series, the recommender, the MLP, Q-learning), the committed JAX-format
fixture ``tests/data/jax_registry_ml2``, and the API's names against the
JAX package's (CPU)."""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ml import api as JA
from neurondb_tpu.ml import registry as JR
from neurondb_tpu_torch.ml import api as TA
from neurondb_tpu_torch.ml import registry as TR

FIXTURE = Path(__file__).resolve().parent / "data" / "jax_registry_ml2"
# The same model tree in both packages: regression outputs sum the same
# f32 leaves (trees) or run the same GEMMs and recurrences in another
# order (MLP, ALS, forecasts).
PRED_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    JA._ensure_loaded()
    TA._ensure_loaded()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clf(seed=0, n=200, d=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int32) + \
        (X[:, 2] > 1.0).astype(np.int32)
    return X, y


def _series(n=200, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (0.05 * t + np.sin(2 * np.pi * t / 12)
            + 0.2 * rng.standard_normal(n)).astype(np.float32)


def _triples(seed=2):
    rng = np.random.default_rng(seed)
    u, i = np.nonzero(rng.uniform(size=(20, 15)) < 0.5)
    r = rng.integers(1, 6, len(u))
    return np.stack([u, i, r], 1).astype(np.float32)


def _transitions(seed=3):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 9, 120)
    a = rng.integers(0, 3, 120)
    s2 = (s + a) % 9
    return np.stack([s, a, (s2 == 8).astype(np.float32), s2],
                    1).astype(np.float32)


def _cases():
    X, y = _clf()
    steps = np.array([7])
    return {
        "decision_tree": (X, y, {"depth": 2}, X),
        "random_forest": (X, y, {"n_trees": 2, "depth": 2}, X),
        "gradient_boosting": (X, X[:, 0] * 2.0, {"task": "regress",
                                                  "n_trees": 3,
                                                  "depth": 2}, X),
        "xgboost": (X, y, {"n_trees": 2, "depth": 2}, X),
        "lightgbm": (X, (y > 0).astype(np.int32),
                     {"n_trees": 2, "num_leaves": 3}, X),
        "catboost": (X, X[:, 1], {"task": "regress", "n_trees": 2,
                                  "depth": 2}, X),
        "timeseries": (_series(), None, {"method": "holt_winters"}, steps),
        "arima": (_series(), None, {"p": 2, "q": 1}, steps),
        "recommender": (_triples(), None, {"iters": 3, "factors": 4},
                        _triples()[:, :2]),
        "neural_network": (X, y, {"hidden": (8,), "epochs": 5}, X),
        "reinforcement_learning": (_transitions(), None, {"epochs": 3},
                                   np.arange(9)),
    }


def _jax_scalars(tree):
    """A JAX-registry reload holds Python scalars as 0-d arrays, which the
    JAX predictors cannot take as static arguments (``depth``): give them
    back as the trainers return them."""
    if isinstance(tree, dict):
        return {k: _jax_scalars(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_scalars(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.ndim == 0:
        return str(tree) if tree.dtype.kind in "US" else tree.item()
    return tree


def _pred(p):
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


@pytest.mark.parametrize("case", sorted(_cases()))
def test_models_cross_both_registries(tmp_path, case):
    X, y, hp, Xp = _cases()[case]
    name = case
    jt, tt = JA._ALGORITHMS[name], TA._ALGORITHMS[name]
    jargs = (jnp.asarray(X),) if y is None else (jnp.asarray(X),
                                                  jnp.asarray(y))
    targs = (TA.as_input(X, torch.device("cpu")),) if y is None else \
        (TA.as_input(X, torch.device("cpu")),
         TA.as_input(y, torch.device("cpu")))
    jm = jt.train(*jargs, **hp)
    tm = tt.train(*targs, **hp)
    Xj, Xt = jnp.asarray(Xp), TA.as_input(Xp, torch.device("cpu"))
    # JAX -> port
    jid = JR.ModelRegistry(str(tmp_path / "j")).register("p", name, jm, hp)
    loaded = TR.ModelRegistry(str(tmp_path / "j"), device="cpu").get(jid)
    want = _pred(jt.predict(jm, Xj))
    got = _pred(tt.predict(loaded.model, Xt))
    np.testing.assert_allclose(got, want, **PRED_TOL)
    # port -> JAX
    tid = TR.ModelRegistry(str(tmp_path / "t"), device="cpu").register(
        "p", name, tm, hp)
    jl = JR.ModelRegistry(str(tmp_path / "t")).get(tid)
    want = _pred(tt.predict(tm, Xt))
    got = _pred(jt.predict(_jax_scalars(jl.model), Xj))
    np.testing.assert_allclose(got, want, **PRED_TOL)
    # and the port's own reload predicts bit for bit
    again = TR.ModelRegistry(str(tmp_path / "t"), device="cpu").get(tid)
    np.testing.assert_array_equal(_pred(tt.predict(again.model, Xt)), want)


def test_jax_ml2_fixture_is_current(tmp_path):
    """``tests/data/jax_registry_ml2``: an XGBoost model (binary) and a
    Holt-Winters model the JAX registry persisted, and the JAX package's
    CPU predictions (``expected.npz``), committed so that a machine
    without JAX (the card's) loads them. Rebuilt here with the JAX
    package; the committed copy must match (the directory is written
    when missing). The port predicts the same from it."""
    X, y = _clf(seed=5, n=160)
    yb = (y > 0).astype(np.int32)
    jr = JR.ModelRegistry(str(tmp_path / "reg"))
    xgb_hp = {"n_trees": 4, "depth": 3}
    xgb, ts = JA._ALGORITHMS["xgboost"], JA._ALGORITHMS["timeseries"]
    xid = jr.register("fixture", "xgboost", xgb.train(
        jnp.asarray(X), jnp.asarray(yb), **xgb_hp), xgb_hp)
    hw_hp = {"method": "holt_winters", "season": 12}
    hid = jr.register("fixture", "timeseries", ts.train(
        jnp.asarray(_series(240, seed=6)), **hw_hp), hw_hp)
    Xq = X[:40] + 0.05
    pred = {"X": Xq,
            "xgboost": np.asarray(xgb.predict(jr.get(xid).model,
                                              jnp.asarray(Xq))),
            "holt_winters": np.asarray(ts.predict(jr.get(hid).model,
                                                  jnp.asarray([24])))}
    np.savez(tmp_path / "reg" / "expected.npz", **pred)
    if not FIXTURE.exists():
        shutil.copytree(tmp_path / "reg", FIXTURE)
    for mid in (xid, hid):
        sub = f"model_{mid:06d}"
        assert (FIXTURE / sub / "structure.json").read_bytes() == \
            (tmp_path / "reg" / sub / "structure.json").read_bytes()
        with np.load(FIXTURE / sub / "weights.npz") as a, \
                np.load(tmp_path / "reg" / sub / "weights.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for f in b.files:
                if b[f].dtype.kind in "US":
                    assert a[f] == b[f]
                else:
                    np.testing.assert_allclose(a[f], b[f], rtol=1e-5,
                                               atol=1e-6)
    reg = TR.ModelRegistry(str(FIXTURE), device="cpu")
    with np.load(FIXTURE / "expected.npz") as e:
        for key, v in pred.items():
            np.testing.assert_allclose(e[key], v, rtol=1e-5, atol=1e-5)
        got = TA._ALGORITHMS["xgboost"].predict(
            reg.get(xid).model, torch.from_numpy(e["X"]))
        np.testing.assert_array_equal(got.numpy(), e["xgboost"])
        got = TA._ALGORITHMS["timeseries"].predict(
            reg.get(hid).model, torch.tensor([24]))
        np.testing.assert_allclose(got.numpy(), e["holt_winters"],
                                   **PRED_TOL)


def test_names_and_aliases_equal_the_jax_registry():
    assert TA.list_algorithms() == JA.list_algorithms()
    assert not hasattr(TA, "NOT_PORTED")
    for name in JA._ALGORITHMS:
        assert TA._resolve(name).name == JA._resolve(name).name
        assert TA._ALGORITHMS[name].task == JA._ALGORITHMS[name].task
    for alias in JA._ALIASES:
        assert TA._resolve(alias.upper()).name == JA._resolve(alias).name
