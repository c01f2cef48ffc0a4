"""Quantization formats and QuantizedFlatIndex: the torch port against
the JAX package on the same numpy inputs (CPU). Codes, scales, offsets
and dequantized values must be bit-identical; index ids identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.index.flat import QuantizedFlatIndex as JQF
from neurondb_tpu.types import quantized as JQ
from neurondb_tpu_torch.index.flat import QuantizedFlatIndex as TQF
from neurondb_tpu_torch.types import quantized as TQ

FORMATS = tuple(TQ.FORMATS)
# f32 on both sides, sums in another order. ip / cosine: rtol 1e-5 (atol
# 1e-5 near 0); l2 from the expansion |q|^2 + |x|^2 - 2 q.x: d^2 within
# 1e-5 of those terms (~2 DIM at unit-variance rows)
RTOL = ATOL = 1e-5
N, DIM, NQ = 2000, 32, 40


def _words(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw words, whatever its dtype."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy()
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def _jwords(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize]) \
        if a.dtype.kind in "fV" else a


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dim", [33, 7, 128])
def test_quantize_bits_match_jax(rng, fmt, dim):
    x = (rng.standard_normal((300, dim)) * 3).astype(np.float32)
    x[3] = 0.0                     # zero vector: unit scale
    x[4] = 1.5                     # constant row: uint8's hi == lo
    x[5, :3] = -2.0
    j = JQ.quantize(jnp.asarray(x), fmt)
    t = TQ.quantize(x, fmt, device="cpu")
    assert (t.fmt, t.dim) == (j.fmt, j.dim) and t.nbytes == j.nbytes
    np.testing.assert_array_equal(_words(t.codes), _jwords(j.codes))
    np.testing.assert_array_equal(_words(t.scale), _jwords(j.scale))
    np.testing.assert_array_equal(_words(t.offset), _jwords(j.offset))
    np.testing.assert_array_equal(_words(TQ.dequantize(t)),
                                  _jwords(JQ.dequantize(j)))
    np.testing.assert_array_equal(_words(t.dequantize()),
                                  _words(TQ.dequantize(t)))


def test_single_vector_and_unknown_format():
    v = np.linspace(-1, 1, 9, dtype=np.float32)
    t = TQ.quantize(v, "int4", device="cpu")
    j = JQ.quantize(jnp.asarray(v), "int4")
    assert tuple(t.codes.shape) == j.codes.shape == (1, 5)
    with pytest.raises(ValueError, match="unknown quantization format"):
        TQ.quantize(v, "int3", device="cpu")


@pytest.mark.parametrize("fmt", ["int8", "binary", "ternary", "f16"])
def test_quantize_analyze_matches_jax(rng, fmt):
    x = rng.standard_normal((200, 24)).astype(np.float32)
    got = TQ.quantize_analyze(x, fmt, device="cpu")
    want = JQ.quantize_analyze(jnp.asarray(x), fmt)
    assert got.keys() == want.keys()
    for key, w in want.items():
        if isinstance(w, str):
            assert got[key] == w
        else:
            assert got[key] == pytest.approx(w, rel=1e-5, abs=1e-7), key


def test_aliases_and_packers(rng):
    x = rng.standard_normal((5, 11)).astype(np.float32)
    for name in ("int8", "fp16", "binary", "uint8", "ternary", "int4",
                 "fp8_e4m3", "fp8_e5m2"):
        got = getattr(TQ, f"vector_to_{name}")(x, device="cpu")
        want = getattr(JQ, f"vector_to_{name}")(jnp.asarray(x))
        np.testing.assert_array_equal(_words(got.codes), _jwords(want.codes))
    vals = torch.from_numpy(rng.integers(0, 16, (4, 9)).astype(np.uint8))
    np.testing.assert_array_equal(
        TQ._unpack_nibbles(TQ._pack_nibbles(vals, 9), 9), vals)
    crumbs = vals & 3
    np.testing.assert_array_equal(
        TQ._unpack_crumbs(TQ._pack_crumbs(crumbs, 9), 9), crumbs)
    np.testing.assert_array_equal(
        TQ._unpack_bits(TQ._pack_bits(vals & 1), 9), vals & 1)


def test_quantize_places_host_arrays_on_the_configured_device(monkeypatch):
    """A host array goes to ``config.device`` (nothing picks the CPU on
    its own: "auto" names no device and raises); a tensor stays on its
    own device; ``device`` is passed through by every entry point."""
    from neurondb_tpu_torch import config as TC
    x = np.linspace(-1, 1, 24, dtype=np.float32).reshape(3, 8)
    monkeypatch.setattr(TC, "_config", None)
    TC.configure(device="auto")
    try:
        for call in (lambda: TQ.quantize(x, "int8"),
                     lambda: TQ.quantize_analyze(x, "int8"),
                     lambda: TQ.vector_to_int8(x)):
            with pytest.raises(ValueError, match="auto"):
                call()
        assert TQ.quantize(torch.from_numpy(x), "int8").codes.device.type \
            == "cpu"
        assert TQ.vector_to_binary(x, device="cpu").codes.device.type == "cpu"
        TC.configure(device="cpu")
        assert TQ.quantize(x, "int4").codes.device.type == "cpu"
    finally:
        TC.set_config(None)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    q = x[:NQ] + 0.1 * rng.standard_normal((NQ, DIM)).astype(np.float32)
    return x, q


def _close(metric, got, want):
    if metric == "l2":
        np.testing.assert_allclose(got ** 2, want ** 2, rtol=RTOL,
                                   atol=RTOL * 2 * DIM)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fmt", ["int8", "f16", "uint8", "int4", "ternary",
                                 "fp8_e4m3", "binary"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_quantized_flat_ids_match_jax(data, fmt, metric):
    x, q = data
    j = JQF(x, fmt=fmt, metric=metric)
    t = TQF(x, fmt=fmt, metric=metric, device="cpu")
    assert t.compression_bytes == j.compression_bytes
    for rerank in (0, 8):
        jd, ji = j.search(q, k=10, rerank=rerank)
        td, ti = t.search(q, k=10, rerank=rerank)
        np.testing.assert_array_equal(ti, ji)
        _close(metric if rerank or fmt != "binary" else "hamming", td, jd)


@pytest.mark.parametrize("fmt,min_recall", [
    ("int8", 0.95), ("f16", 0.99), ("binary", 0.5)])
def test_quantized_flat_recall_bars(data, fmt, min_recall):
    """The JAX package's bars (tests/test_index.py), against exact l2."""
    x, q = data
    d2 = (q ** 2).sum(1)[:, None] + (x ** 2).sum(1)[None, :] - 2 * q @ x.T
    truth = np.argsort(d2, axis=1)[:, :10]
    _, ids = TQF(x, fmt=fmt, metric="l2", device="cpu").search(q, k=10,
                                                               rerank=8)
    hits = [len(set(a) & set(b)) for a, b in zip(ids, truth)]
    assert np.mean(hits) / 10 >= min_recall


def test_quantized_flat_without_originals_and_small_k(data):
    x, q = data
    t = TQF(x[:300], fmt="int8", metric="ip", keep_originals=False,
            device="cpu")
    j = JQF(x[:300], fmt="int8", metric="ip", keep_originals=False)
    td, ti = t.search(q, k=5, rerank=8)          # no originals: coarse only
    jd, ji = j.search(q, k=5, rerank=8)
    np.testing.assert_array_equal(ti, ji)
    _close("ip", td, jd)
    assert t.device_bytes == t.compression_bytes + 300 * 4
    d1, i1 = t.search(q[0], k=3)                  # a single query
    assert d1.shape == i1.shape == (3,)
    tk = TQF(x[:6], fmt="f16", device="cpu", ids=np.arange(6) * 10)
    _, ik = tk.search(q[:2], k=9)                 # k past n
    assert ik.shape == (2, 6) and set(ik[0]) == set(np.arange(6) * 10)


@pytest.mark.parametrize("fmt", ["int8", "bf16", "fp8_e4m3", "f16", "binary"])
def test_save_load_across_packages(tmp_path, data, fmt):
    x, q = data
    t = TQF(x, fmt=fmt, metric="l2", ids=np.arange(N) * 3 + 1, device="cpu")
    j = JQF(x, fmt=fmt, metric="l2", ids=np.arange(N) * 3 + 1)
    _, want = j.search(q, k=10, rerank=4)
    t.save(str(tmp_path / "t"))
    j.save(str(tmp_path / "j"))
    for path in ("t", "j"):
        tl = TQF.load(str(tmp_path / path), device="cpu")
        jl = JQF.load(str(tmp_path / path))
        assert tl.q.codes.dtype == t.q.codes.dtype
        np.testing.assert_array_equal(_words(tl.q.codes), _words(t.q.codes))
        assert tl.compression_bytes == t.compression_bytes
        for idx in (tl, jl):
            _, got = idx.search(q, k=10, rerank=4)
            np.testing.assert_array_equal(got, want)
    # npz keeps no bf16 or fp8, so their codes are saved as f32 values:
    # the JAX package then holds f32 codes and counts 4 bytes a component
    if fmt in ("bf16", "fp8_e4m3"):
        assert JQF.load(str(tmp_path / "j")).compression_bytes > \
            j.compression_bytes
