"""The port's pre-LN encoder, embedders and cross-encoders against the
JAX package's, on carried parameters."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import neurondb_tpu.ops.pallas.flash_attention as JFA
from neurondb_tpu.ml import bert as JB
from neurondb_tpu.ml import transformer as JT
from neurondb_tpu.search import bm25 as JBM
from neurondb_tpu_torch.ml import transformer as TT
from neurondb_tpu_torch.ml.params import params_from_jax
from neurondb_tpu_torch.ops.kernels import flash_attention as FA
from neurondb_tpu_torch.search import bm25 as TBM

TEXTS = ["The quick brown fox", "flash attention parity, again!",
         "Ünïcode wörds and 42 numbers", "", "a " * 300]
DOCS = [f"word{i} alpha beta gamma {i} " + "delta " * (i % 7)
        for i in range(21)]
CFG = dict(vocab_size=300, hidden=64, layers=2, heads=4, ff=128, max_len=64)


@pytest.mark.parametrize("stem", [True, False])
@pytest.mark.parametrize("stopwords", [True, False])
def test_bm25_tokenize_equals_jax(stem, stopwords):
    for text in TEXTS + ["Running studies flies happily tested wanted"]:
        assert (TBM.tokenize(text, stem=stem, stopwords=stopwords)
                == JBM.tokenize(text, stem=stem, stopwords=stopwords))


@pytest.mark.parametrize("vocab_size", [30522, 300])
def test_hash_tokenizer_ids_equal_jax(vocab_size):
    j, t = JT.HashTokenizer(vocab_size), TT.HashTokenizer(vocab_size)
    for a in TEXTS:
        np.testing.assert_array_equal(t.encode(a, 32), j.encode(a, 32))
        for b in TEXTS:
            np.testing.assert_array_equal(t.encode_pair(a, b, 48),
                                          j.encode_pair(a, b, 48))


@pytest.fixture(scope="module")
def carried():
    jp = JT.init_encoder_params(jax.random.PRNGKey(1), **CFG)
    rng = np.random.default_rng(0)
    # non-trivial LayerNorm gains and shifts
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), jp)
    return jp, params_from_jax(jp)


@pytest.mark.parametrize("use_flash", [False, True])
def test_encode_matches_jax(carried, monkeypatch, use_flash):
    """The tanh-GELU pre-LN encoder; the flash path against the Pallas
    kernel in interpret mode at the port's KV tile."""
    jp, tp = carried
    tok = JT.HashTokenizer(CFG["vocab_size"])
    ids = np.stack([tok.encode(t, 48) for t in TEXTS])
    if use_flash:
        orig = JFA.flash_attention
        monkeypatch.setattr(JFA, "flash_attention",
                            lambda q, k, v, mask=None: orig(
                                q, k, v, mask, interpret=True,
                                tiles=(FA.KV_TILE, FA.KV_TILE)))
    jo = JT.encode(jp, jnp.asarray(ids), heads=4, use_flash=use_flash)
    to = TT.encode(tp, torch.from_numpy(ids), heads=4, use_flash=use_flash)
    tol = 1e-3 if use_flash else 2e-5
    for key in ("pooled", "score"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   rtol=tol, atol=tol)
    live = ids > 0
    np.testing.assert_allclose(to["hidden"].numpy()[live],
                               np.asarray(jo["hidden"])[live],
                               rtol=tol, atol=tol)


def test_gelu_is_the_tanh_form(carried):
    """jax.nn.gelu's default is the tanh approximation; torch's is erf."""
    x = torch.linspace(-4, 4, 101)
    j = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(torch.nn.functional.gelu(
        x, approximate="tanh").numpy(), j, rtol=1e-6, atol=1e-6)
    assert not np.allclose(torch.nn.functional.gelu(x).numpy(), j,
                           rtol=1e-6, atol=1e-6)


def test_text_embedder_matches_jax(carried):
    jp, tp = carried
    j = JT.TextEmbedder(jp, heads=4, max_len=32, use_flash=False)(TEXTS)
    emb = TT.TextEmbedder(tp, heads=4, max_len=32, device="cpu")
    assert emb.use_flash is False and emb.dim == CFG["hidden"]
    t = emb(TEXTS)
    np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, rtol=1e-5)
    assert emb([]).shape == (0, CFG["hidden"])


@pytest.mark.parametrize("batch", [0, 8, 64])
def test_cross_encoder_matches_jax(carried, batch):
    jp, tp = carried
    j = JT.CrossEncoder(jp, heads=4, max_len=32, use_flash=False)(
        "alpha query", DOCS, batch=batch)
    t = TT.CrossEncoder(tp, heads=4, max_len=32, device="cpu")(
        "alpha query", DOCS, batch=batch)
    assert t.dtype == np.float32 and t.shape == (len(DOCS),)
    np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5)


def test_cross_encoder_pipelined_batches_match_single_shot():
    """tests/test_search.py:171 for the port: sub-batches (the tail not
    padded) score as the one-shot path does."""
    ce = TT.CrossEncoder(dim=64, max_len=32, seed=0, use_flash=False,
                         device="cpu")
    one = ce("alpha query", DOCS, batch=0)
    sub = ce("alpha query", DOCS, batch=8)          # 8 + 8 + 5
    np.testing.assert_allclose(one, sub, rtol=1e-5, atol=1e-6)
    flash = TT.CrossEncoder(dim=64, max_len=32, seed=0, use_flash=True,
                            device="cpu")
    np.testing.assert_allclose(flash("alpha query", DOCS, batch=8),
                               flash("alpha query", DOCS, batch=0),
                               rtol=1e-5, atol=1e-6)


def _export(tmp_path, seed=0):
    jp = JB.init_bert_params(jax.random.PRNGKey(seed), vocab_size=104,
                             hidden=32, layers=2, heads=4, ff=64, max_len=40)
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), jp)
    state = {"embeddings.word_embeddings.weight": jp["tok_emb"],
             "embeddings.position_embeddings.weight": jp["pos_emb"],
             "embeddings.token_type_embeddings.weight": jp["type_emb"],
             "embeddings.LayerNorm.weight": jp["emb_ln"]["g"],
             "embeddings.LayerNorm.bias": jp["emb_ln"]["b"],
             "pooler.dense.weight": jp["pooler"]["w"].T,
             "pooler.dense.bias": jp["pooler"]["b"],
             "classifier.weight": jp["cls_head"]["w"].T,
             "classifier.bias": jp["cls_head"]["b"]}
    names = {"wq": "attention.self.query", "wk": "attention.self.key",
             "wv": "attention.self.value", "wo": "attention.output.dense",
             "w1": "intermediate.dense", "w2": "output.dense"}
    for i, lyr in enumerate(jp["layers"]):
        pre = f"bert.encoder.layer.{i}."
        for w, hf in names.items():
            state[pre + hf + ".weight"] = lyr[w].T
            state[pre + hf + ".bias"] = lyr["b" + w[1:]]
        for ln, hf in (("ln1", "attention.output.LayerNorm"),
                       ("ln2", "output.LayerNorm")):
            state[pre + hf + ".weight"] = lyr[ln]["g"]
            state[pre + hf + ".bias"] = lyr[ln]["b"]
    np.savez(tmp_path / "weights.npz", **state)
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
        + [f"w{i}" for i in range(90)] + [f"##s{i}" for i in range(10)]))
    (tmp_path / "config.json").write_text(json.dumps(
        {"hidden": 32, "heads": 4, "layers": 2, "max_len": 40}))
    return str(tmp_path)


@pytest.mark.parametrize("batch", [0, 4, 64])
def test_pretrained_cross_encoder_matches_jax(tmp_path, batch):
    wdir = _export(tmp_path)
    docs = [" ".join(f"w{(i * 7 + j) % 90}" for j in range(3 + i))
            + " w5s3" for i in range(11)]
    j = JT.PretrainedCrossEncoder(wdir, max_len=40, use_flash=False)(
        "w1 w2 w3", docs, batch=batch)
    ce = TT.PretrainedCrossEncoder(wdir, max_len=40, device="cpu")
    t = ce("w1 w2 w3", docs, batch=batch)
    np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5)
    if batch:
        np.testing.assert_allclose(t, ce("w1 w2 w3", docs, batch=0),
                                   rtol=1e-5, atol=1e-6)


def test_pretrained_embedder_matches_jax(tmp_path):
    wdir = _export(tmp_path, seed=2)
    texts = ["w1 w2", "w3 w40 w41 w42", "w77s1 unknown", ""]
    j = JT.PretrainedEmbedder(wdir, use_flash=False)(texts)
    t = TT.PretrainedEmbedder(wdir, device="cpu")(texts)
    np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5)


def test_empty_docs_give_an_empty_array(tmp_path):
    """The JAX PretrainedCrossEncoder fails on an empty doc list; the port
    returns an empty array (ROADMAP queue 3, a deliberate divergence)."""
    wdir = _export(tmp_path)
    for ce in (TT.PretrainedCrossEncoder(wdir, device="cpu"),
               TT.CrossEncoder(dim=32, max_len=16, device="cpu")):
        out = ce("query", [])
        assert out.shape == (0,) and out.dtype == np.float32
    assert TT.PretrainedEmbedder(wdir, device="cpu")([]).shape == (0, 32)
    with pytest.raises((ValueError, ZeroDivisionError, TypeError)):
        JT.PretrainedCrossEncoder(wdir, use_flash=False)("query", [])


def test_defaults_and_env_knobs(tmp_path, monkeypatch):
    monkeypatch.delenv("NEURONDB_TORCH_WEIGHTS", raising=False)
    monkeypatch.delenv("NEURONDB_TORCH_CROSS_WEIGHTS", raising=False)
    emb = TT.default_embedder(dim=32, device="cpu")
    ce = TT.default_cross_encoder(dim=32, device="cpu")
    assert isinstance(emb, TT.TextEmbedder) and emb.dim == 32
    assert isinstance(ce, TT.CrossEncoder) and ce.use_flash is False
    wdir = _export(tmp_path)
    # the JAX package's knob names do not reach the port
    monkeypatch.setenv("NEURONDB_TPU_WEIGHTS", wdir)
    assert isinstance(TT.default_embedder(device="cpu"), TT.TextEmbedder)
    monkeypatch.setenv("NEURONDB_TORCH_WEIGHTS", wdir)
    monkeypatch.setenv("NEURONDB_TORCH_CROSS_WEIGHTS", wdir)
    assert isinstance(TT.default_embedder(device="cpu"),
                      TT.PretrainedEmbedder)
    assert isinstance(TT.default_cross_encoder(device="cpu"),
                      TT.PretrainedCrossEncoder)


def test_load_params_npz_in_both_packages(carried, tmp_path):
    jp, _ = carried
    flat = {}
    for k, v in jp.items():
        if k == "layers":
            for i, lyr in enumerate(v):
                for n, a in lyr.items():
                    if isinstance(a, dict):
                        for s, b in a.items():
                            flat[f"layers.{i}.{n}.{s}"] = b
                    else:
                        flat[f"layers.{i}.{n}"] = a
        elif isinstance(v, dict):
            for s, b in v.items():
                flat[f"{k}.{s}"] = b
        else:
            flat[k] = v
    np.savez(tmp_path / "enc.npz", **flat)
    j = JT.load_params_npz(str(tmp_path / "enc.npz"))
    t = TT.load_params_npz(str(tmp_path / "enc.npz"))
    ids = np.stack([JT.HashTokenizer(CFG["vocab_size"]).encode(x, 24)
                    for x in TEXTS])
    np.testing.assert_allclose(
        TT.encode(t, torch.from_numpy(ids), heads=4)["score"].numpy(),
        np.asarray(JT.encode(j, jnp.asarray(ids), heads=4)["score"]),
        rtol=2e-5, atol=2e-5)
