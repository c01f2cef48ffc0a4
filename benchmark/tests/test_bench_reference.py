"""The reference against a NumPy brute force, and the judge's numbers on
answers altered by hand."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401 - puts the benchmark on the path
from benchlib import check
from benchlib import reference as R


def _data(metric, n=3000, d=24, s=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32) * 3
    q = rng.standard_normal((s, d)).astype(np.float32) * 3
    return x, q


def _numpy_knn(x, q, k, metric):
    x = x.astype(np.float64)
    q = q.astype(np.float64)
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = 1.0 - q @ x.T
    else:
        d = np.sqrt(((q[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    i = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, i, 1), i


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_exact_knn_matches_numpy(metric, monkeypatch):
    x, q = _data(metric)
    monkeypatch.setattr(R, "ROW_CHUNK", 700)      # several chunks
    monkeypatch.setattr(R, "QUERY_BLOCK", 16)     # several blocks
    xr, qr = R.prepare(torch.from_numpy(x), metric), \
        R.prepare(torch.from_numpy(q), metric)
    d, i = R.exact_knn(xr, qr, 10, metric)
    nd, ni = _numpy_knn(x, q, 10, metric)
    assert (i.numpy() == ni).mean() > 0.99        # ties at float32
    np.testing.assert_allclose(d.numpy(), nd, rtol=1e-4, atol=1e-4)
    direct = R.distances_of(xr, qr, i, metric).numpy()
    np.testing.assert_allclose(direct, nd, rtol=1e-5, atol=1e-5)


def test_distances_of_marks_ids_outside_the_corpus():
    x, q = _data("l2", n=50, s=2)
    ids = torch.tensor([[0, 49], [-1, 50]])
    d = R.distances_of(torch.from_numpy(x), torch.from_numpy(q), ids, "l2")
    assert torch.isfinite(d[0]).all() and torch.isnan(d[1]).all()


def test_quantized_rows_lose_precision_in_order():
    x, _ = _data("l2", n=500)
    t = torch.from_numpy(x)
    err = {p: float((R.quantized_rows(t, p) - t).abs().mean())
           for p in ("int8", "fp8")}
    bf16 = float((t.to(torch.bfloat16).float() - t).abs().mean())
    assert bf16 < err["int8"] < err["fp8"]


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_judge_on_exact_and_altered_answers(metric):
    x, q = _data(metric, n=2000, s=30, seed=1)
    xr = R.prepare(torch.from_numpy(x), metric)
    qr = R.prepare(torch.from_numpy(q), metric)
    d, i = R.exact_knn(xr, qr, 10, metric)
    rows = np.arange(30)
    exact = check.judge(xr, qr, d, i, rows, d.numpy(), i.numpy(), metric)
    assert exact["unanswered"] == 0 and exact["recall_miss"] == 0
    assert exact["dist_gap"] < 1e-4
    shifted = check.judge(xr, qr, d, i, rows, d.numpy(),
                          (i.numpy() + 1) % 2000, metric)
    assert shifted["recall_miss"] > 0.5 and shifted["dist_gap"] > 0.01
    dup = i.numpy().copy()
    dup[3, 1] = dup[3, 0]
    missing = i.numpy().copy()
    missing[5, :] = -1
    assert check.judge(xr, qr, d, i, rows, d.numpy(), dup,
                       metric)["unanswered"] == 1
    assert check.judge(xr, qr, d, i, rows, d.numpy(), missing,
                       metric)["unanswered"] == 1
    ok, out = check.verdict(exact, {"unanswered": 0, "recall_miss": 0.01,
                                    "dist_gap": 0.01})
    assert ok and list(out) == ["unanswered", "recall_miss", "dist_gap"]
    assert not check.verdict(shifted, {"unanswered": 0, "recall_miss": 0.01,
                                       "dist_gap": 0.01})[0]


def test_sample_rows_depend_only_on_the_seed():
    a = check.sample_rows(2**31 + 5, 3, 100, 10)
    b = check.sample_rows(2**31 + 5, 3, 100, 10)
    c = check.sample_rows(2**31 + 6, 3, 100, 10)
    assert a.shape == (3, 10) and (a == b).all() and not (a == c).all()
    assert all(len(set(r)) == 10 for r in a)
