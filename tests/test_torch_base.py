"""Query wires and the checkpoint format: the torch port against the JAX
package, and saves that cross between the two."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import neurondb_tpu.index.base as JB
import neurondb_tpu_torch.index.base as TB
from neurondb_tpu.index.flat import FlatIndex as JFlat
from neurondb_tpu.index.ivf import IVFFlatIndex as JIVF
from neurondb_tpu_torch.index.flat import FlatIndex as TFlat
from neurondb_tpu_torch.index.ivf import IVFFlatIndex as TIVF


def _q(rng, b=12, d=32):
    return (rng.standard_normal((b, d)) * 3).astype(np.float32)


@pytest.mark.parametrize("wire", ["f32", "float16", "bfloat16", "int8",
                                  "int12", "int4"])
def test_wires_decode_like_jax(rng, wire):
    """Every wire decodes to the same f32 bits in both packages."""
    q = _q(rng)
    if wire == "f32":
        w = q
    elif wire == "float16":
        w = q.astype(np.float16)
    elif wire == "bfloat16":
        w = q.astype(ml_dtypes.bfloat16)
    else:
        w = getattr(TB, f"quantize_queries_{wire}")(q)
    jq, js = JB.as_batch(w)
    tq, ts = TB.as_batch(w)
    assert tq.dtype == torch.float32 and js == ts is False
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    # one query, and the wire handed over as torch tensors
    jq1, _ = JB.as_batch(q[0])
    tq1, single = TB.as_batch(torch.from_numpy(q[0]))
    assert single and tq1.shape == (1, q.shape[1])
    np.testing.assert_array_equal(tq1.numpy(), np.asarray(jq1))
    if isinstance(w, tuple):
        tq2, _ = TB.as_batch(tuple(torch.from_numpy(p) for p in w))
        np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq))


@pytest.mark.parametrize("wire", ["int8", "int12", "int4"])
def test_quantize_helpers_identical(rng, wire):
    q = _q(rng)
    got = getattr(TB, f"quantize_queries_{wire}")(q)
    want = getattr(JB, f"quantize_queries_{wire}")(q)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_odd_dimension_wires_raise(rng):
    q = _q(rng, d=7)
    for wire in ("int4", "int12"):
        with pytest.raises(ValueError, match="even dimension"):
            getattr(TB, f"quantize_queries_{wire}")(q)


@pytest.fixture(scope="module")
def corpus(rng_mod):
    c = rng_mod.standard_normal((8, 16)).astype(np.float32) * 3
    x = c[rng_mod.integers(0, 8, 1500)] + \
        rng_mod.standard_normal((1500, 16)).astype(np.float32)
    q = x[:40] + 0.05
    return x.astype(np.float32), q.astype(np.float32)


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def test_jax_ivf_save_loads_in_port(tmp_path, corpus):
    x, q = corpus
    j = JIVF(x, nlists=8, seed=0)
    j.save(str(tmp_path))
    t = TIVF.load(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(t.centroids.numpy(), np.asarray(j.centroids))
    np.testing.assert_array_equal(t._x, j._x)
    np.testing.assert_array_equal(t._counts_np, np.asarray(j._counts))
    _, jids = j.search(q, k=10, nprobe=2)
    _, tids = t.search(q, k=10, nprobe=2)
    assert _agree(tids, jids) >= 0.99


def test_port_ivf_save_loads_in_jax(tmp_path, corpus):
    x, q = corpus
    t = TIVF(x, nlists=8, seed=0, device="cpu")
    t.save(str(tmp_path))
    j = JIVF.load(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(j.centroids), t.centroids.numpy())
    np.testing.assert_array_equal(np.asarray(j._counts), t._counts_np)
    _, jids = j.search(q, k=10, nprobe=2)
    _, tids = t.search(q, k=10, nprobe=2)
    assert _agree(tids, jids) >= 0.99


def test_flat_save_crosses_both_ways(tmp_path, corpus):
    x, q = corpus
    ids = np.arange(len(x)) * 3 + 5
    JFlat(x, ids=ids).save(str(tmp_path / "j"))
    TFlat(x, ids=ids, device="cpu").save(str(tmp_path / "t"))
    t = TFlat.load(str(tmp_path / "j"), device="cpu")
    j = JFlat.load(str(tmp_path / "t"))
    jd, jids = j.search(q, k=5)
    td, tids = t.search(q, k=5)
    np.testing.assert_array_equal(tids, jids)
    # near-duplicates: sqrt(|q|^2 + |x|^2 - 2 q.x) cancels in f32 on both
    # sides, so hold the squares to an absolute bound scaled by |q|^2
    qn2 = float((q * q).sum(1).max())
    np.testing.assert_allclose(td ** 2, jd ** 2, rtol=1e-5, atol=1e-6 * qn2)
