"""VectorStore, vector ops, the exotic types and the tuning heuristics:
the torch port against the JAX package on the same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu import store as JS
from neurondb_tpu.index import tuning as JT
from neurondb_tpu.ops import vector_ops as JV
from neurondb_tpu.types import exotic as JE
from neurondb_tpu_torch import store as TS
from neurondb_tpu_torch.index import tuning as TT
from neurondb_tpu_torch.ops import vector_ops as TV
from neurondb_tpu_torch.types import exotic as TE

QTOL = dict(rtol=1e-6, atol=1e-7)   # quantiles: f32 weights, XLA may fuse


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several workers share the machine's cores: one intra-op thread
    keeps this module's small torch ops from contending."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# vector ops
# ---------------------------------------------------------------------------

UNARY = ["vector_abs", "vector_square", "vector_exp", "vector_negate",
         "vector_sum", "vector_mean", "vector_min", "vector_max",
         "vector_var", "vector_stddev", "vector_norm", "vector_argmin",
         "vector_argmax", "vector_median", "vector_normalize",
         "vector_standardize", "vector_minmax_normalize", "vector_softmax",
         "batch_normalize", "batch_sum", "batch_avg", "vector_dims"]
BINARY = ["vector_add", "vector_sub", "vector_mul", "vector_hadamard",
          "vector_div", "vector_concat", "vector_eq", "vector_ne"]


@pytest.fixture(scope="module")
def unary_case():
    """One input and the JAX results of every unary op, computed in one
    jit (one compile for all of them)."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    x[2] = 0.0                                   # zero vector: guards
    x[3, :4] = x[3, 4:8]                         # ties for the median
    names = [n for n in UNARY if n != "vector_dims"]
    want = jax.jit(lambda a: {n: getattr(JV, n)(a) for n in names})(
        jnp.asarray(x))
    return x, {n: np.asarray(v) for n, v in want.items()}


@pytest.mark.parametrize("name", UNARY)
def test_unary_ops_match_jax(unary_case, name):
    x, want = unary_case
    if name == "vector_dims":
        assert TV.vector_dims(_t(x)) == JV.vector_dims(jnp.asarray(x)) == 9
        return
    got = getattr(TV, name)(_t(x)).numpy()
    assert got.shape == want[name].shape
    # f32 reductions in another order
    np.testing.assert_allclose(got, want[name], rtol=2e-6, atol=1e-6)


@pytest.fixture(scope="module")
def binary_case():
    rng = np.random.default_rng(32)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    y = x.copy()
    y[1:] = rng.standard_normal((4, 7)).astype(np.float32)
    want = jax.jit(lambda a, b: {n: getattr(JV, n)(a, b) for n in BINARY})(
        jnp.asarray(x), jnp.asarray(y))
    return x, y, {n: np.asarray(v) for n, v in want.items()}


@pytest.mark.parametrize("name", BINARY)
def test_binary_ops_match_jax(binary_case, name):
    x, y, want = binary_case
    got = getattr(TV, name)(_t(x), _t(y)).numpy()
    np.testing.assert_array_equal(got, want[name])


def _access_and_transforms(V, x, mask):
    return [V.vector_get(x, 2), V.vector_set(x, 1, 7.5),
            V.vector_slice(x, 1, 4), V.vector_append(x[0], 9.0),
            V.vector_scale(x, 2.5), V.vector_translate(x, -1.0),
            V.vector_clip(x, 2.5, 3.5), V.vector_pow(x, 2.0),
            V.vector_sqrt(x), V.vector_log(x),
            V.vector_cross_product(x[:, :3], x[:, 3:]),
            V.batch_avg(x, mask)]


def test_access_and_transforms_match_jax(rng):
    x = rng.standard_normal((4, 6)).astype(np.float32) + 3.0
    mask = np.array([True, False, True, False])
    # the JAX side in one jit: one compile for all twelve
    want = jax.jit(lambda a, m: _access_and_transforms(JV, a, m))(
        jnp.asarray(x), jnp.asarray(mask))
    got = _access_and_transforms(TV, _t(x), _t(mask))
    assert TV.vector_dims(_t(x)) == JV.vector_dims(jnp.asarray(x)) == 6
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="3-dimensional"):
        TV.vector_cross_product(_t(x), _t(x))


QS = [0.0, 0.77, (0.1, 0.5, 0.9)]
Q_SHAPES = [(7,), (3, 4, 10)]


@pytest.fixture(scope="module")
def quantile_case():
    """Inputs and the JAX quantile / percentile / median of each, in one
    jit."""
    rng = np.random.default_rng(33)
    xs = [rng.standard_normal(sh).astype(np.float32) for sh in Q_SHAPES]

    def all_of(*arrays):
        out = {}
        for si, a in enumerate(arrays):
            out[("median", si)] = JV.vector_median(a)
            for qi, q in enumerate(QS):
                jq = jnp.asarray(q) if isinstance(q, tuple) else q
                out[("quantile", si, qi)] = JV.vector_quantile(a, jq)
                out[("percentile", si, qi)] = JV.vector_percentile(a, jq * 100)
        return out

    want = jax.jit(all_of)(*[jnp.asarray(x) for x in xs])
    return xs, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("qi", range(len(QS)))
def test_quantile_percentile_median_interpolate_as_jax(quantile_case, qi):
    xs, want = quantile_case
    q = QS[qi]
    for si, x in enumerate(xs):
        got = TV.vector_quantile(_t(x), q)
        assert got.shape == want[("quantile", si, qi)].shape
        np.testing.assert_allclose(got.numpy(), want[("quantile", si, qi)],
                                   **QTOL)
        got = TV.vector_percentile(_t(x), np.asarray(q) * 100)
        assert got.shape == want[("percentile", si, qi)].shape
        np.testing.assert_allclose(got.numpy(), want[("percentile", si, qi)],
                                   **QTOL)
        np.testing.assert_array_equal(TV.vector_median(_t(x)).numpy(),
                                      want[("median", si)])


def test_quantile_of_a_lane_with_nan_is_nan():
    x = np.array([[1.0, np.nan, 3.0], [1.0, 2.0, 3.0]], np.float32)
    got = TV.vector_quantile(_t(x), 0.5).numpy()
    want = np.asarray(JV.vector_quantile(jnp.asarray(x), 0.5))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert got[1] == want[1] == 2.0


def test_hash_matches_jax_bit_for_bit(rng):
    x = rng.standard_normal((64, 33)).astype(np.float32)
    x[0] = 0.0
    x[1] = -0.0                                   # another bit pattern
    x[2, 5] = np.inf
    want = np.asarray(JV.vector_hash(jnp.asarray(x))).astype(np.int64)
    got = TV.vector_hash(_t(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** 32
    # leading dims broadcast; an int input hashes its f32 value
    np.testing.assert_array_equal(
        TV.vector_hash(_t(x.reshape(4, 16, 33))).numpy(), want.reshape(4, 16))
    xi = np.arange(12, dtype=np.int32).reshape(3, 4)
    np.testing.assert_array_equal(
        TV.vector_hash(_t(xi)).numpy(),
        np.asarray(JV.vector_hash(jnp.asarray(xi))).astype(np.int64))


@pytest.mark.parametrize("name", ["vector_lt", "vector_le", "vector_gt",
                                  "vector_ge"])
def test_lexicographic_comparisons_bit_for_bit(rng, name):
    x = rng.integers(-2, 3, (200, 5)).astype(np.float32)
    y = x.copy()
    flip = rng.random((200, 5)) < 0.3
    y[flip] = rng.integers(-2, 3, int(flip.sum()))
    want = np.asarray(getattr(JV, name)(jnp.asarray(x), jnp.asarray(y)))
    got = getattr(TV, name)(_t(x), _t(y)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TV._lex_cmp(_t(x), _t(y)).numpy(),
        np.asarray(JV._lex_cmp(jnp.asarray(x), jnp.asarray(y))))


# ---------------------------------------------------------------------------
# exotic types and tuning: copies of numpy modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int8, np.uint8,
                                   np.float64])
def test_vector_packed_blobs_are_byte_identical(rng, dtype):
    v = (rng.standard_normal(37) * 50).astype(dtype)
    jb, tb = JE.VectorPacked.pack(v), TE.VectorPacked.pack(v)
    assert jb == tb
    for unpack in (JE.VectorPacked.unpack, TE.VectorPacked.unpack):
        np.testing.assert_array_equal(unpack(tb), JE.VectorPacked.unpack(jb))
    assert TE.VectorPacked.fingerprint(jb) == JE.VectorPacked.fingerprint(tb)
    bad = tb[:-1] + bytes([tb[-1] ^ 1])
    with pytest.raises(ValueError, match="checksum"):
        TE.VectorPacked.unpack(bad)
    swapped = tb[:4][::-1] + tb[4:]
    with pytest.raises(ValueError, match="foreign endianness"):
        TE.VectorPacked.unpack(swapped)


def test_retrievable_text_matches_jax():
    text = "alpha beta  gamma\ndelta epsilon zeta eta"
    j = JE.RetrievableText.from_text(text, section_breaks=[12, 25])
    t = TE.RetrievableText.from_text(text, section_breaks=[12, 25])
    assert (t.token_offsets, t.section_ids) == (j.token_offsets, j.section_ids)
    assert [t.section_text(s) for s in range(3)] == \
        [j.section_text(s) for s in range(3)]
    assert t.span_for_tokens(1, 4) == j.span_for_tokens(1, 4)
    assert t.token(3) == j.token(3) and t.num_tokens == j.num_tokens == 7


def test_tuning_heuristics_match_jax():
    for n in (10, 5000, 20000, 20001, 1_000_000, 10 ** 9):
        for rec in (0.9, 0.95, 0.99):
            assert TT.recommend_hnsw_params(n, 128, target_recall=rec) == \
                JT.recommend_hnsw_params(n, 128, target_recall=rec)
            assert TT.recommend_ivf_params(n, target_recall=rec) == \
                JT.recommend_ivf_params(n, target_recall=rec)
        for kw in ({}, {"write_heavy": True}, {"batch_queries": False},
                   {"memory_budget_bytes": 1 << 20}):
            assert TT.select_index_kind(n, 96, **kw) == \
                JT.select_index_kind(n, 96, **kw)
    ja, ta = JT.QueryPatternAnalyzer(window=5), TT.QueryPatternAnalyzer(window=5)
    assert ta.suggest(10 ** 6, 128) == ja.suggest(10 ** 6, 128)
    for i in range(8):
        for a in (ja, ta):
            a.observe(10 + i, 1 if i % 3 else 64, 0.001 * (i + 1))
    assert ta.summary() == ja.summary()
    assert ta.suggest(10 ** 6, 128) == ja.suggest(10 ** 6, 128)
    assert ta.suggest(10 ** 3, 128) == ja.suggest(10 ** 3, 128)


# ---------------------------------------------------------------------------
# VectorStore
# ---------------------------------------------------------------------------

def _store_pair(x, ids=None, dtype="float32", metric="l2", batches=2):
    js = JS.VectorStore(x.shape[1], dtype=dtype, metric=metric)
    ts = TS.VectorStore(x.shape[1], dtype=dtype, metric=metric, device="cpu")
    for part, pid in zip(np.array_split(x, batches),
                         np.array_split(ids, batches) if ids is not None
                         else [None] * batches):
        a, b = js.add(part, ids=pid), ts.add(part, ids=pid)
        np.testing.assert_array_equal(a, b)
    return js, ts


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_store_search_matches_jax(rng, metric):
    x = rng.standard_normal((1500, 24)).astype(np.float32)
    q = rng.standard_normal((9, 24)).astype(np.float32)
    js, ts = _store_pair(x, metric=metric)
    assert (ts.capacity, ts.size, len(ts)) == (js.capacity, js.size, len(js))
    assert ts.capacity == 2048
    jd, ji = js.search(q, k=7)
    td, ti = ts.search(q, k=7)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    td1, ti1 = ts.search(q[0], k=3)
    assert td1.shape == (3,) and np.array_equal(ti1, ji[0, :3])


def test_store_delete_compact_get_match_jax(rng):
    # the search tests' shapes, so that the JAX store's compiles are shared
    x = rng.standard_normal((1500, 24)).astype(np.float32)
    ids = rng.permutation(5000)[:1500].astype(np.int64)
    js, ts = _store_pair(x, ids=ids)
    drop = np.concatenate([ids[::7], [999999]])
    assert ts.delete(drop) == js.delete(drop) == len(ids[::7])
    assert ts.delete(drop) == js.delete(drop) == 0      # already gone
    q = x[:9] + 0.01
    for s in (js, ts):
        _, got = s.search(q, k=7)
        assert not np.isin(got, drop).any()
    np.testing.assert_array_equal(ts.search(q, k=7)[1], js.search(q, k=7)[1])
    want = ids[[3, 100, 1499]]
    np.testing.assert_array_equal(ts.get(want), js.get(want))
    with pytest.raises(KeyError):
        ts.get([123456789])
    js.compact()
    ts.compact()
    assert (len(ts), ts.size, ts.capacity) == (len(js), js.size, js.capacity)
    np.testing.assert_array_equal(ts.ids[: ts.size], js.ids[: js.size])
    np.testing.assert_array_equal(ts.search(q, k=7)[1], js.search(q, k=7)[1])
    # ids continue after the largest survivor, as in the JAX store
    np.testing.assert_array_equal(ts.add(x[:2]), js.add(x[:2]))


def test_store_bf16_rows_and_compact_keep_source_norms(rng):
    # the search tests' shapes, so that the JAX store's compiles are shared
    x = rng.standard_normal((1500, 24)).astype(np.float32)
    js, ts = _store_pair(x, dtype="bfloat16")
    assert ts.vectors.dtype == torch.bfloat16
    # the stored rows are the bf16 roundings, returned as f32
    np.testing.assert_array_equal(ts.get([5, 9]),
                                  np.asarray(js.get([5, 9]), np.float32))
    # f32 sums of squares in another order
    np.testing.assert_allclose(ts.sqnorms[:1500].numpy(),
                               np.asarray(js.sqnorms[:1500]), rtol=1e-6)
    ts.delete(np.arange(0, 1500, 3))
    ts.compact()
    fresh = TS.VectorStore(24, dtype="bfloat16", device="cpu")
    keep = np.setdiff1d(np.arange(1500), np.arange(0, 1500, 3))
    fresh.add(x[keep], ids=keep)
    assert torch.equal(ts.sqnorms, fresh.sqnorms)
    assert torch.equal(ts.vectors, fresh.vectors)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    for a, b in zip(ts.search(q, k=4), fresh.search(q, k=4)):
        np.testing.assert_array_equal(a, b)


def test_store_grows_by_doubling_and_writes_in_place(rng):
    ts = TS.VectorStore(8, device="cpu")
    held = ts.valid
    ts.add(rng.standard_normal((1000, 8)).astype(np.float32))
    assert ts.valid is held and ts.capacity == 1024   # written in place
    ts.add(rng.standard_normal((100, 8)).astype(np.float32))
    assert ts.capacity == 2048 and len(ts) == 1100
    with pytest.raises(ValueError, match="expected dim"):
        ts.add(np.zeros((2, 9), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        TS.VectorStore(0, device="cpu")


def test_store_quantized_is_quantize_of_the_live_prefix(rng):
    """``quantized`` is ``quantize`` of the first ``size`` stored rows, as
    in the JAX store (``quantize`` itself is held to the JAX package bit
    for bit in test_torch_quantized.py)."""
    from neurondb_tpu_torch.types.quantized import quantize
    x = rng.standard_normal((300, 16)).astype(np.float32)
    ts = TS.VectorStore(16, dtype="bfloat16", device="cpu")
    ts.add(x)
    for fmt in ("int8", "binary"):
        got, want = ts.quantized(fmt), quantize(ts.vectors[:300].float(), fmt)
        assert torch.equal(got.codes, want.codes)
        assert torch.equal(got.scale, want.scale)
