"""Time series (``ml/timeseries.py``: AR, Holt-Winters on its recurrence,
decomposition, ARIMA, anomaly windows) and the ALS recommender
(``ml/recommender.py``), the torch port against the JAX package on the
same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ml import recommender as JRC
from neurondb_tpu.ml import timeseries as JTS
from neurondb_tpu_torch.ml import api as TA
from neurondb_tpu_torch.ml import recommender as TRC
from neurondb_tpu_torch.ml import timeseries as TTS
from neurondb_tpu_torch.ops.kernels import ml_recurrence as MR

# Least-squares solves on the same f32 products, summed in another order
# (XLA also fuses multiply-adds): coefficients to 1e-4.
FIT_TOL = dict(rtol=1e-4, atol=1e-4)
# Holt-Winters: the same f32 recurrence, but XLA's CPU backend fuses its
# multiply-adds into FMAs where the port rounds each product: 1e-5
# relative on series of unit scale over 400 steps.
HW_TOL = dict(rtol=1e-5, atol=1e-5)
# ALS from JAX's start: batched 8 x 8 solves over 5 alternations, sums in
# another order: 1e-4.
ALS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def series():
    """Trend + season 12 + AR(2) noise, 400 points."""
    rng = np.random.default_rng(21)
    n = 400
    e = np.zeros(n)
    for i in range(2, n):
        e[i] = 0.5 * e[i - 1] - 0.2 * e[i - 2] + rng.standard_normal()
    t = np.arange(n)
    return (0.02 * t + 2.0 * np.sin(2 * np.pi * t / 12) + e).astype(
        np.float32)


def test_ar_fit_and_forecast(series):
    jm = JTS.ar_fit(series, order=4)
    tm = TTS.ar_fit(_t(series), order=4)
    np.testing.assert_allclose(tm["coef"].numpy(), np.asarray(jm["coef"]),
                               **FIT_TOL)
    np.testing.assert_allclose(float(tm["mean"]), float(jm["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["sigma2"]), float(jm["sigma2"]),
                               rtol=1e-4)
    np.testing.assert_allclose(
        TTS.ar_forecast(tm, _t(series), steps=6).numpy(),
        np.asarray(JTS.ar_forecast(jm, series, steps=6)), **FIT_TOL)


def _jax_hw_start(y, season):
    y = jnp.asarray(y)
    level0 = jnp.mean(y[:season])
    trend0 = (jnp.mean(y[season:2 * season]) - level0) / season
    return level0, trend0, y[:season] - level0


@pytest.mark.parametrize("season", [12, 7])
def test_holt_winters_plain_recurrence_matches_jax(series, season):
    """The plain loop from JAX's start against the JAX scan."""
    jm = JTS.holt_winters_fit(series, season=season)
    l0, t0, s0 = (_t(np.asarray(v)) for v in _jax_hw_start(series, season))
    level, trend, seas, fitted = MR.holt_winters_plain(
        _t(series), l0, t0, s0, alpha=0.3, beta=0.1, gamma=0.1)
    np.testing.assert_allclose(fitted.numpy(), np.asarray(jm["fitted"]),
                               **HW_TOL)
    np.testing.assert_allclose(seas.numpy(), np.asarray(jm["seasonal"]),
                               **HW_TOL)
    np.testing.assert_allclose([float(level), float(trend)],
                               [float(jm["level"]), float(jm["trend"])],
                               **HW_TOL)
    tm = TTS.holt_winters_fit(_t(series), season=season)
    np.testing.assert_allclose(tm["fitted"].numpy(), np.asarray(jm["fitted"]),
                               **HW_TOL)
    np.testing.assert_allclose(
        TTS.holt_winters_forecast(tm, steps=15).numpy(),
        np.asarray(JTS.holt_winters_forecast(jm, steps=15)), **HW_TOL)


def test_seasonal_decompose_and_anomaly_windows(series):
    y = series.copy()
    y[200] += 15.0
    jd = JTS.seasonal_decompose(y, season=12)
    td = TTS.seasonal_decompose(_t(y), season=12)
    for k in ("trend", "seasonal", "residual"):
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                   rtol=1e-5, atol=1e-5)
    flags = TTS.ts_anomaly_windows(_t(y), window=12, z=3.0).numpy()
    np.testing.assert_array_equal(
        flags, np.asarray(JTS.ts_anomaly_windows(y, window=12, z=3.0)))
    assert flags[200]
    np.testing.assert_allclose(TTS.moving_average(_t(y), 5).numpy(),
                               np.asarray(JTS.moving_average(y, 5)),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def arima111(series):
    """JAX's ARIMA(1,1,1) on the series, shared by the tests below."""
    return JTS.arima_fit(series, 1, 1, 1)


@pytest.mark.parametrize("order", [(1, 1, 1), (2, 0, 0), (0, 2, 2)])
def test_arima_fit_and_forecast(series, arima111, order):
    p, d, q = order
    jm = arima111 if order == (1, 1, 1) else JTS.arima_fit(series, p, d, q)
    tm = TTS.arima_fit(_t(series), p, d, q)
    np.testing.assert_allclose(tm["ar_coeffs"].numpy(),
                               np.asarray(jm["ar_coeffs"]), **FIT_TOL)
    np.testing.assert_allclose(tm["ma_coeffs"].numpy(),
                               np.asarray(jm["ma_coeffs"]), **FIT_TOL)
    np.testing.assert_allclose(float(tm["sigma2"]), float(jm["sigma2"]),
                               rtol=1e-4)
    np.testing.assert_allclose(TTS.arima_forecast(tm, steps=8).numpy(),
                               np.asarray(JTS.arima_forecast(jm, steps=8)),
                               rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError):
        TTS.arima_fit(_t(series[:10]), 4, 1, 4)


def test_arima_evaluate(series, arima111):
    tm = TTS.arima_fit(_t(series), 1, 1, 1)
    je = JTS.arima_evaluate(arima111, series, horizon=8)
    te = TTS.arima_evaluate(tm, _t(series), horizon=8)
    for k in je:
        assert te[k] == pytest.approx(je[k], rel=1e-3, abs=1e-4), k


def test_timeseries_through_the_api(series, arima111):
    for hp in ({}, {"method": "holt_winters"}, {"method": "arima"}):
        mid = TA.train("p", "timeseries", series, hyperparams=hp,
                       device="cpu")
        out = TA.predict(mid, np.array([6]), device="cpu")
        assert out.shape == (6,) and np.isfinite(out).all()
    mid = TA.train("p", "arima", series, device="cpu")
    np.testing.assert_allclose(
        TA.predict(mid, np.array([4]), device="cpu"),
        np.asarray(JTS.arima_forecast(arima111, steps=4)),
        rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# ALS
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ratings():
    rng = np.random.default_rng(5)
    U, I, f = 40, 30, 4
    R = (rng.standard_normal((U, f)) @ rng.standard_normal((f, I))
         + 3.0).astype(np.float32)
    M = (rng.uniform(size=(U, I)) < 0.4).astype(np.float32)
    return R * M, M


def _jax_als_start(U, I, factors, seed):
    ku, ki = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(ku, (U, factors)) * 0.1),
            np.asarray(jax.random.normal(ki, (I, factors)) * 0.1))


def test_als_from_jax_start_matches(ratings):
    R, M = ratings
    jm = JRC.als_fit(R, M, factors=8, iters=5, l2=0.1, seed=3)
    P0, Q0 = _jax_als_start(*R.shape, 8, 3)
    P, Q = TRC.als_run(_t(R), _t(M), _t(P0), _t(Q0), iters=5, l2=0.1)
    np.testing.assert_allclose(P.numpy(), np.asarray(jm["user_factors"]),
                               **ALS_TOL)
    np.testing.assert_allclose(Q.numpy(), np.asarray(jm["item_factors"]),
                               **ALS_TOL)
    tm = {"user_factors": P, "item_factors": Q}
    np.testing.assert_allclose(TRC.predict_ratings(tm).numpy(),
                               np.asarray(JRC.predict_ratings(jm)), **ALS_TOL)
    js, ji = JRC.similar_items(jm, 3, k=5)
    ts, ti = TRC.similar_items(tm, 3, k=5)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)
    ex = M[2] > 0
    np.testing.assert_allclose(TRC.recommend(tm, 2, k=5, exclude_mask=ex)[0],
                               JRC.recommend(jm, 2, k=5, exclude_mask=ex)[0],
                               **ALS_TOL)
    feats = np.random.default_rng(1).standard_normal((30, 6))
    for a, b in ((TRC.recommend_content_based(feats, 4, k=5),
                  JRC.recommend_content_based(feats, 4, k=5)),
                 (TRC.recommend_hybrid(tm, feats, 1, k=5),
                  JRC.recommend_hybrid(jm, feats, 1, k=5))):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-4, atol=1e-4)
    assert TRC.user_similarity(R, M, 0, 1) == JRC.user_similarity(R, M, 0, 1)


def test_recommender_through_the_api(ratings):
    R, M = ratings
    u, i = np.nonzero(M)
    trip = np.stack([u, i, R[u, i]], 1).astype(np.float32)
    mid = TA.train("p", "recommender", trip, hyperparams={"iters": 5},
                   device="cpu")
    pred = TA.predict(mid, trip[:, :2], device="cpu")
    rmse = float(np.sqrt(((pred - trip[:, 2]) ** 2).mean()))
    assert pred.shape == (len(trip),) and rmse < 0.5, rmse
