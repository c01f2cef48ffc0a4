"""The MLP (``ml/neural.py``: Adam held to optax's step for step from
JAX's init) and reinforcement learning (``ml/rl.py``: Q-learning's plain
loop, the recurrence kernel's CPU version, and LinUCB), the torch port
against the JAX package on the same numpy inputs (CPU)."""

import jax
import numpy as np
import pytest
import torch

from neurondb_tpu.ml import neural as JNN
from neurondb_tpu.ml import rl as JRL
from neurondb_tpu_torch.ml import api as TA
from neurondb_tpu_torch.ml import neural as TNN
from neurondb_tpu_torch.ml import rl as TRL
from neurondb_tpu_torch.ops.kernels import ml_recurrence as MR

# 20 Adam steps from the same init: torch.optim.Adam divides by
# sqrt(nu) / sqrt(1 - b2^t) + eps where optax takes sqrt(nu / (1 - b2^t))
# + eps, and the gradients' sums run in another order.
MLP_TOL = dict(rtol=1e-4, atol=2e-5)
# Q-learning: the same f32 recurrence; XLA's CPU backend fuses its
# multiply-adds into FMAs where the plain loop rounds each product.
Q_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def clf():
    rng = np.random.default_rng(31)
    X = (rng.standard_normal((300, 8)) * 3.0 + 1.0).astype(np.float32)
    W = rng.standard_normal((8, 3)).astype(np.float32)
    y = np.argmax(X @ W, 1).astype(np.int32)
    return X, y


@pytest.mark.parametrize("task", ["classify", "regress"])
def test_mlp_matches_optax_from_jax_init(clf, task):
    X, y = clf
    target = y if task == "classify" else (X[:, 0] - 2 * X[:, 1]).astype(
        np.float32)
    jm = JNN.mlp_fit(X, target, hidden=(16, 8), task=task, epochs=20,
                     lr=1e-2)
    out = 3 if task == "classify" else 1
    init = JNN._init_mlp(jax.random.PRNGKey(0), [8, 16, 8, out])
    mu = X.mean(0)
    sd = np.maximum(X.std(0), 1e-6)
    np.testing.assert_allclose(np.asarray(jm["mu"]), mu, rtol=1e-6)
    Xn = (_t(X) - _t(np.asarray(jm["mu"]))) / \
        _t(np.asarray(jm["sd"]))
    params = {k: [_t(np.asarray(a)) for a in v] for k, v in init.items()}
    got = TNN.mlp_train(params, Xn, _t(target), task=task, lr=1e-2,
                        epochs=20)
    for k in ("W", "b"):
        for a, b in zip(got[k], jm["params"][k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MLP_TOL)
    tm = {"params": got, "mu": _t(np.asarray(jm["mu"])),
          "sd": _t(np.asarray(jm["sd"])),
          "classify": torch.tensor(task == "classify")}
    pj = np.asarray(JNN.mlp_predict(jm, X))
    pt = TNN.mlp_predict(tm, _t(X)).numpy()
    if task == "classify":
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_allclose(TNN.mlp_predict_proba(tm, _t(X)).numpy(),
                                   np.asarray(JNN.mlp_predict_proba(jm, X)),
                                   rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(pt, pj, rtol=1e-3, atol=1e-3)


def test_mlp_fit_and_minibatches_train(clf):
    X, y = clf
    for batch in (0, 64):
        m = TNN.mlp_fit(_t(X), _t(y), hidden=(16,), epochs=150, lr=1e-2,
                        batch=batch)
        acc = (TNN.mlp_predict(m, _t(X)).numpy() == y).mean()
        assert acc > 0.85, (batch, acc)
    for alias in ("mlp", "deeplearning", "deep_learning", "neural_network"):
        assert TA._resolve(alias).name == "neural_network"


@pytest.fixture(scope="module")
def transitions():
    """A 5 x 5 gridworld: 4 actions, reward 1 on entering the corner."""
    rng = np.random.default_rng(41)
    side = 5
    s = rng.integers(0, side * side, 300)
    a = rng.integers(0, 4, 300)
    r_, c_ = s // side, s % side
    dr = np.array([-1, 1, 0, 0])[a]
    dc = np.array([0, 0, -1, 1])[a]
    s2 = np.clip(r_ + dr, 0, side - 1) * side + np.clip(c_ + dc, 0, side - 1)
    rew = (s2 == side * side - 1).astype(np.float32) - 0.01
    return np.stack([s, a, rew, s2], 1).astype(np.float32)


def test_q_learning_plain_loop_matches_jax(transitions):
    Qj = np.asarray(JRL.q_learning_fit(transitions, n_states=25,
                                       n_actions=4, epochs=5))
    Qt = TRL.q_learning_fit(_t(transitions), n_states=25, n_actions=4,
                            epochs=5).numpy()
    np.testing.assert_allclose(Qt, Qj, **Q_TOL)
    np.testing.assert_array_equal(TRL.q_policy(torch.from_numpy(Qt)),
                                  JRL.q_policy(Qj))
    mid = TA.train("p", "reinforcement_learning", transitions,
                   hyperparams={"epochs": 5}, device="cpu")
    np.testing.assert_array_equal(TA.predict(mid, np.arange(25),
                                             device="cpu"),
                                  Qj.argmax(1))


def test_q_learning_plain_is_the_update_rule():
    """Two transitions by hand: Q[0,1] = 0.9 * 0 + 0.1 * (1 + 0.95 * 0),
    then Q[1,0] = 0.1 * (0.5 + 0.95 * max Q[0])."""
    s, a = torch.tensor([0, 1]), torch.tensor([1, 0])
    r, s2 = torch.tensor([1.0, 0.5]), torch.tensor([1, 0])
    Q = MR.q_learning(s, a, r, s2, torch.zeros(2, 2), alpha=0.1, gamma=0.95,
                      epochs=1)
    a1 = np.float32(0.1) * np.float32(1.0)
    want = np.float32(0.1) * (np.float32(0.5) + np.float32(0.95) * a1)
    assert float(Q[0, 1]) == pytest.approx(float(a1), rel=1e-7)
    assert float(Q[1, 0]) == pytest.approx(float(want), rel=1e-6)


def test_linucb_matches_jax():
    rng = np.random.default_rng(3)
    jb, tb = JRL.LinUCB(3, 4, alpha=0.5), TRL.LinUCB(3, 4, alpha=0.5)
    for _ in range(40):
        x = rng.standard_normal(4)
        arm = jb.select(x)
        assert tb.select(x) == arm
        r = float(x[arm] > 0)
        jb.update(arm, x, r)
        tb.update(arm, x, r)
    np.testing.assert_array_equal(tb.A, jb.A)
    np.testing.assert_array_equal(tb.b, jb.b)
