"""Time-series models — AR / forecasting, Holt-Winters, decomposition,
ARIMA, anomaly windows.

Counterpart of ``neurondb_tpu/ml/timeseries.py``. Reference:
NeuronDB/src/ml/ml_timeseries.c. AR fitting is one ridge least-squares
solve over the lagged design matrix (GEMM + Cholesky); ARIMA(p, d, q) is
Hannan-Rissanen two-stage least squares on the differenced series (a
long-AR proxy for the innovations, then one joint solve over AR lags and
lagged innovations); decomposition is moving averages.

Divergences:

- ``holt_winters_fit``'s recurrence runs in ``ops/kernels/ml_recurrence``:
  on a card the hand-written kernel (one launch for the whole series), on
  the CPU the plain torch loop; both equal each other bit for bit. Its
  start (the first season's mean and the trend from the second) is a
  torch mean, whose sum may differ from XLA's in the last bit;
- ``ar_forecast`` / ``arima_forecast`` run their ``lax.scan`` of a few
  steps as a Python loop of torch ops;
- ``jnp.var`` / ``jnp.std`` divide by N: the port passes
  ``correction=0`` (torch divides by N - 1 by default);
- ``moving_average`` is a 1-D convolution (``F.conv1d``); its sums may
  run in another order than ``jnp.convolve``'s.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from neurondb_tpu_torch.ml.linear import _solve_pos
from neurondb_tpu_torch.ops.kernels import ml_recurrence as MR


def _lag_matrix(y: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    rows = y.shape[0] - p
    return y.unfold(0, p, 1)[:rows], y[p:]


def _ridge(X: torch.Tensor, t: torch.Tensor, l2: float) -> torch.Tensor:
    G = X.T @ X + l2 * torch.eye(X.shape[1], device=X.device)
    return _solve_pos(G, X.T @ t)


def ar_fit(y, order: int = 4, l2: float = 1e-6) -> Dict:
    """Autoregressive AR(p) by ridge least squares."""
    y = y.float()
    mu = y.mean()
    yc = y - mu
    X, t = _lag_matrix(yc, order)
    w = _ridge(X, t, l2)
    resid = t - X @ w
    return {"coef": w, "mean": mu, "sigma2": resid.var(correction=0),
            "order": torch.tensor(order, dtype=torch.int32, device=y.device)}


def ar_forecast(model: Dict, y, steps: int = 8) -> torch.Tensor:
    y = y.float() - model["mean"]
    p = int(model["order"])
    hist = y[-p:]
    preds = []
    for _ in range(steps):
        nxt = hist @ model["coef"]
        hist = torch.cat([hist[1:], nxt[None]])
        preds.append(nxt)
    return torch.stack(preds) + model["mean"]


def holt_winters_fit(y, *, season: int = 12, alpha: float = 0.3,
                     beta: float = 0.1, gamma: float = 0.1) -> Dict:
    """Additive Holt-Winters smoothing state."""
    y = y.float()
    level0 = y[:season].mean()
    trend0 = (y[season:2 * season].mean() - level0) / season
    seas0 = y[:season] - level0
    level, trend, seas, fitted = MR.holt_winters(
        y, level0, trend0, seas0, alpha=alpha, beta=beta, gamma=gamma)
    return {"level": level, "trend": trend, "seasonal": seas,
            "fitted": fitted,
            "season": torch.tensor(season, dtype=torch.int32,
                                   device=y.device)}


def holt_winters_forecast(model: Dict, steps: int = 8) -> torch.Tensor:
    season = int(model["season"])
    dev = model["seasonal"].device
    h = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    seas = model["seasonal"].repeat(steps // season + 1)[:steps]
    return model["level"] + h * model["trend"] + seas


def moving_average(y, window: int = 5) -> torch.Tensor:
    y = y.float()
    kernel = torch.ones(window, device=y.device) / window
    # jnp.convolve flips the kernel; a constant kernel is its own flip
    return F.conv1d(y[None, None], kernel[None, None])[0, 0]


def seasonal_decompose(y, season: int = 12) -> Dict:
    """Additive decomposition: trend (centered MA), seasonal, residual."""
    y = y.float()
    n = y.shape[0]
    trend = moving_average(y, season)
    pad = n - trend.shape[0]
    lo = pad // 2
    trend_full = torch.cat([trend[:1].expand(lo), trend,
                            trend[-1:].expand(pad - lo)])
    detr = y - trend_full
    n_season = n // season
    seas_prof = detr[: n_season * season].reshape(n_season, season).mean(0)
    seas_prof = seas_prof - seas_prof.mean()
    seasonal = seas_prof.repeat(n // season + 1)[:n]
    return {"trend": trend_full, "seasonal": seasonal,
            "residual": y - trend_full - seasonal}


# ---------------------------------------------------------------------------
# ARIMA(p, d, q) (ml_timeseries.c:443 train_arima, :702 forecast_arima,
# :957 evaluate_arima_by_model_id), the MA part by Hannan-Rissanen
# ---------------------------------------------------------------------------

def _difference(y: torch.Tensor, d: int) -> torch.Tensor:
    """d-fold first differencing."""
    for _ in range(d):
        if y.shape[0] < 2:
            raise ValueError("cannot difference below length 2")
        y = y[1:] - y[:-1]
    return y


def arima_fit(y, p: int = 1, d: int = 1, q: int = 1,
              l2: float = 1e-6) -> Dict:
    """Fit ARIMA(p, d, q) by Hannan-Rissanen two-stage least squares."""
    y = y.float()
    dev = y.device
    if p < 0 or p > 32 or d < 0 or d > 4 or q < 0 or q > 32:
        raise ValueError("arima order out of bounds (p,q in [0,32], d in [0,4])")
    z = _difference(y, d)
    n = int(z.shape[0])
    m = max(p + q, min(n // 4, 2 * (p + q) + 4), 1)
    if n < m + max(p, q) + 4:
        raise ValueError(f"need at least {m + max(p, q) + 4} observations "
                         f"after differencing, got {n}")
    mu = z.mean()
    zc = z - mu
    if q > 0:
        # stage 1: innovations from a long-AR proxy
        Xl, tl = _lag_matrix(zc, m)
        wl = _ridge(Xl, tl, l2)
        e = torch.cat([torch.zeros(m, device=dev), tl - Xl @ wl])
        # stage 2: joint LS over AR lags and lagged innovations
        lag = max(p, q)
        rows = n - lag
        cols = [zc[lag - i: lag - i + rows] for i in range(1, p + 1)]
        cols += [e[lag - j: lag - j + rows] for j in range(1, q + 1)]
        X = torch.stack(cols, 1)
        t = zc[lag:]
        w = _ridge(X, t, l2)
        phi, theta = w[:p], w[p:]
        resid = torch.cat([torch.zeros(lag, device=dev), t - X @ w])
    elif p > 0:
        Xl, tl = _lag_matrix(zc, p)
        phi = _ridge(Xl, tl, l2)
        theta = torch.zeros(0, device=dev)
        resid = torch.cat([torch.zeros(p, device=dev), tl - Xl @ phi])
    else:
        phi = torch.zeros(0, device=dev)
        theta = torch.zeros(0, device=dev)
        resid = zc
    return {"p": p, "d": d, "q": q, "intercept": mu,
            "ar_coeffs": phi, "ma_coeffs": theta, "residuals": resid,
            "sigma2": resid.var(correction=0) if resid.numel()
            else torch.tensor(0.0, device=dev),
            "last_values": y[-(max(p, 1) + d + 8):]}


def arima_forecast(model: Dict, y=None, steps: int = 8) -> torch.Tensor:
    """h-step forecast: the AR + MA recursion on the differenced scale,
    then d-fold cumulative re-integration."""
    p, d, q = int(model["p"]), int(model["d"]), int(model["q"])
    hist = (y if y is not None else model["last_values"]).float()
    dev = hist.device
    phi = model["ar_coeffs"].to(dev)
    theta = model["ma_coeffs"].to(dev)
    mu = model["intercept"].to(dev)
    z = _difference(hist, d) - mu
    zhist = torch.cat([torch.zeros(max(p, 1), device=dev), z])[-max(p, 1):]
    ehist = torch.cat([torch.zeros(max(q, 1), device=dev),
                       model["residuals"].to(dev).float()])[-max(q, 1):]
    zf = []
    for _ in range(steps):
        nxt = torch.zeros((), device=dev)
        if p:
            nxt = nxt + zhist[-p:].flip(0) @ phi
        if q:
            nxt = nxt + ehist[-q:].flip(0) @ theta
        zhist = torch.cat([zhist[1:], nxt[None]])
        ehist = torch.cat([ehist[1:], torch.zeros(1, device=dev)])
        zf.append(nxt)
    out = torch.stack(zf) + mu
    tails = [hist]
    for _ in range(d):
        tails.append(tails[-1][1:] - tails[-1][:-1])
    for lvl in range(d - 1, -1, -1):
        out = tails[lvl][-1] + torch.cumsum(out, 0)
    return out


def arima_evaluate(model: Dict, y, horizon: int = 8) -> Dict[str, float]:
    """Hold out the last ``horizon`` points, forecast them, report
    mse / mae / rmse / mape."""
    y = y.float()
    p, d, q = int(model["p"]), int(model["d"]), int(model["q"])
    if y.shape[0] <= horizon + d + max(p, q) + 4:
        raise ValueError("series too short for requested horizon")
    train, test = y[:-horizon], y[-horizon:]
    m = arima_fit(train, p, d, q)
    pred = arima_forecast(m, train, steps=horizon)
    err = pred - test
    mae = float(err.abs().mean())
    mse = float((err ** 2).mean())
    denom = torch.clamp(test.abs(), min=1e-9)
    return {"mse": mse, "mae": mae, "rmse": mse ** 0.5,
            "mape": float((err.abs() / denom).mean()),
            "horizon": float(horizon)}


def ts_anomaly_windows(y, window: int = 12, z: float = 3.0) -> torch.Tensor:
    """Rolling z-score anomaly flags."""
    y = y.float()
    n = y.shape[0]
    w = y.unfold(0, window, 1)[: n - window]
    mu = w.mean(1)
    sd = torch.clamp(w.std(1, correction=0), min=1e-9)
    flags = (y[window:] - mu).abs() / sd > z
    return torch.cat([torch.zeros(window, dtype=torch.bool, device=y.device),
                      flags])
