"""The roofline counts against cases worked by hand."""

from __future__ import annotations

import numpy as np
import pytest

import bench_tiny  # noqa: F401 - puts the benchmark on the path
from benchlib import counts as C


def test_least_seconds_takes_the_larger_bound():
    t, by = C.least_seconds(3.35e12, {"bf16": 989e12})
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = C.least_seconds(1.0, {"bf16": 989e12, "f32": 165e12})
    assert by == "operations" and t == pytest.approx(1.0 + 1.0)


def test_probe_rows_counts_pairs_and_distinct_lists():
    sizes = np.array([5, 7, 0, 3])
    probes = np.array([[0, 1], [1, 3], [1, 0]])
    # pairs: 5+7, 7+3, 7+5 = 34; distinct lists 0, 1, 3: 5+7+3 = 15
    assert C.probe_rows(sizes, probes) == (34, 15)


def test_grouped_scan_work_by_hand():
    sizes = np.array([10, 20, 30])
    probes = np.array([[0, 2], [2, 1]])          # B 2, nprobe 2
    w = C.grouped_scan_work(sizes, probes, dim=4, k=3, store_bytes=2,
                            rate="bf16")
    # rows read once: 60 x 4 x 2 = 480; queries 2 x 4 x 4 = 32; top-3 out
    # 2 x 3 x 8 = 48 -> 560 bytes; products (10+30+30+20) x 2 x 4 = 720
    # and norms 60 x 2 x 4 = 480
    assert w["bytes"] == 560.0
    assert w["flops"] == {"bf16": 720.0 + 480.0}


def test_coarse_and_search_work_by_hand():
    c = C.coarse_work(2, 3, 4, 2)
    # queries 32 + centroids 48 + probes 2 x 2 x 4 = 16 -> 96 bytes;
    # 2 x 4 x (2 x 3 + 3) = 72 f32 operations
    assert c == {"bytes": 96.0, "flops": {"f32": 72.0}}
    sizes = np.array([10, 20, 30])
    probes = np.array([[0, 2], [2, 1]])
    s = C.ivf_search_work(sizes, probes, nlists=3, dim=4, k=3,
                          store_bytes=2, rate="bf16")
    # scan 560 + coarse 96 - queries counted twice (32) - probes (16)
    assert s["bytes"] == 560.0 + 96.0 - 32.0 - 16.0
    assert s["flops"] == {"bf16": 1200.0, "f32": 72.0}


def test_exact_work_by_hand():
    w = C.exact_work(2, 5, dim=4, k=3, store_bytes=2, rate="bf16")
    # store 5 x 4 x 2 = 40, queries 32, out 48; 2 x 4 x (2 x 5 + 5) = 120
    assert w == {"bytes": 120.0, "flops": {"bf16": 120.0}}


def test_add_work_sums_bytes_and_rates():
    a = {"bytes": 1.0, "flops": {"bf16": 2.0}}
    b = {"bytes": 3.0, "flops": {"bf16": 1.0, "f32": 5.0}}
    assert C.add_work([a, b]) == {"bytes": 4.0,
                                  "flops": {"bf16": 3.0, "f32": 5.0}}


def test_headline_scan_bound_is_bytes_at_the_bf16_rate():
    """One batch of the headline cell: 65,536 queries x nprobe 8 over 1,024
    lists of ~977 rows; every list probed. Bytes: 1M x 128 x 2 + the
    queries (33.5 MB) + the top-10 (5.2 MB) ~ 0.295 GB (88 us); products
    2 x 128 x 65,536 x 8 x 977 = 131 GFLOP (133 us at 989 TFLOP/s)."""
    sizes = np.full(1024, 977)
    probes = (np.arange(65536 * 8) % 1024).reshape(65536, 8)
    w = C.grouped_scan_work(sizes, probes, dim=128, k=10, store_bytes=2,
                            rate="bf16")
    t, by = C.least_seconds(w["bytes"], w["flops"])
    assert by == "operations"
    assert t == pytest.approx(2 * 128 * (65536 * 8 * 977 + 1024 * 977)
                              / 989e12)
