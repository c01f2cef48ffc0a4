"""The port's WordPiece tokenizer and BERT encoder against the JAX
package's, on the same vocab, the same inputs and carried parameters."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import neurondb_tpu.ops.pallas.flash_attention as JFA
from neurondb_tpu.ml import bert as JB
from neurondb_tpu.ml.tokenizer import WordPieceTokenizer as JWordPiece
from neurondb_tpu_torch.ml import bert as TB
from neurondb_tpu_torch.ml.params import params_from_jax
from neurondb_tpu_torch.ml.tokenizer import WordPieceTokenizer
from neurondb_tpu_torch.ops.kernels import flash_attention as FA

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "quick", "brown", "fox", "jump", "##ed", "##ing",
         "over", "lazy", "dog", "un", "##break", "##able", ",", ".",
         "cafe", "naive", "中", "文", "!", "##s", "a", "b", "c"]

TEXTS = [
    "The quick brown fox jumped over the lazy dog.",
    "unbreakable, JUMPING dogs!",
    "Café naïve résumé",                       # accents stripped
    "中文 text, mixed\twith\ttabs\nand lines",   # CJK isolated
    "ctrl\x00chars\x07join\x1fwords",           # control chars vanish
    "zzz qqq " * 30,                            # [UNK]s, long
    "",
    "a" * 150,                                  # longer than max_word_chars
    " non-breaking spaces​zero-width",
]


@pytest.fixture(scope="module")
def toks():
    vocab = {t: i for i, t in enumerate(VOCAB)}
    return JWordPiece(vocab), WordPieceTokenizer(vocab)


@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_wordpiece_ids_equal_jax(i, lowercase):
    vocab = {t: j for j, t in enumerate(VOCAB)}
    j, t = (cls(vocab, lowercase=lowercase)
            for cls in (JWordPiece, WordPieceTokenizer))
    text = TEXTS[i]
    assert t.tokenize(text) == j.tokenize(text)
    for max_len in (8, 32):
        for a, b in zip(t.encode(text, max_len), j.encode(text, max_len)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_len", [8, 16, 40, 128])
def test_encode_pair_truncation_equals_jax(toks, max_len):
    j, t = toks
    for a in TEXTS[:6]:
        for b in TEXTS[:6]:
            ji, jt = j.encode_pair(a, b, max_len)
            ti, tt = t.encode_pair(a, b, max_len)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tt, jt)
    ji, jt = j.encode_batch(TEXTS, 24)
    ti, tt = t.encode_batch(TEXTS, 24)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tt, jt)


def test_vocab_file_and_size(tmp_path, toks):
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    t = WordPieceTokenizer.from_file(str(p))
    j = JWordPiece.from_file(str(p))
    assert t.vocab_size == j.vocab_size == len(VOCAB)
    assert t.tokenize("jumped unbreakable") == ["jump", "##ed", "un",
                                                "##break", "##able"]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=120, hidden=64, layers=2, heads=4, ff=128, max_len=64)


@pytest.fixture(scope="module")
def carried():
    jp = JB.init_bert_params(jax.random.PRNGKey(3), **CFG)
    # non-trivial LayerNorm parameters and biases, so every term counts
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), jp)
    return jp, params_from_jax(jp)


def _inputs(B=3, S=48, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, CFG["vocab_size"], (B, S)).astype(np.int32)
    ids[0, 30:] = 0                      # ragged lengths
    ids[1, 9:] = 0
    types = (rng.random((B, S)) < 0.5).astype(np.int32)
    return ids, types


def _jax_flash_interpret(monkeypatch, tiles):
    orig = JFA.flash_attention
    monkeypatch.setattr(JFA, "flash_attention",
                        lambda q, k, v, mask=None: orig(
                            q, k, v, mask, interpret=True, tiles=tiles))


@pytest.mark.parametrize("use_flash", [False, True])
def test_bert_encode_matches_jax(carried, monkeypatch, use_flash):
    """Reference attention at ~1e-5; the flash path (the plain version on
    the CPU, the Pallas kernel in interpret mode at the same KV tile) at
    the bf16 tile-rounding tolerance of test_torch_flash_attention.py."""
    jp, tp = carried
    ids, types = _inputs()
    if use_flash:
        _jax_flash_interpret(monkeypatch, (FA.KV_TILE, FA.KV_TILE))
    jo = JB.bert_encode(jp, jnp.asarray(ids), jnp.asarray(types),
                        heads=CFG["heads"], use_flash=use_flash)
    to = TB.bert_encode(tp, torch.from_numpy(ids), torch.from_numpy(types),
                        heads=CFG["heads"], use_flash=use_flash)
    tol = 1e-3 if use_flash else 2e-5
    live = ids > 0
    np.testing.assert_allclose(to["hidden"].numpy()[live],
                               np.asarray(jo["hidden"])[live],
                               rtol=tol, atol=tol)
    for key in ("pooled", "mean_pooled", "score"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   rtol=tol, atol=tol)


def test_flash_path_near_reference_path(carried):
    _, tp = carried
    ids, types = (torch.from_numpy(a) for a in _inputs(seed=1))
    ref = TB.bert_encode(tp, ids, types, heads=4, use_flash=False)
    fl = TB.bert_encode(tp, ids, types, heads=4, use_flash=True)
    torch.testing.assert_close(fl["pooled"], ref["pooled"], rtol=5e-3,
                               atol=5e-3)


def test_bert_model_module(carried):
    _, tp = carried
    model = TB.BertModel(tp, heads=4)
    assert not any(p.requires_grad for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.prod(np.shape(a)) for a in jax.tree_util.tree_leaves(carried[0]))
    ids, types = (torch.from_numpy(a) for a in _inputs())
    a = model(ids, types)["score"]
    b = TB.bert_encode(tp, ids, types, heads=4)["score"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def hf_state():
    from transformers import BertConfig, BertForSequenceClassification
    cfg = BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=40, num_labels=1,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    model = BertForSequenceClassification(cfg).eval()
    state = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    return model, state


def test_bert_matches_hf(hf_state):
    """The port against transformers' own BERT on one random-init state
    dict (hidden states, pooler, classifier logit)."""
    model, state = hf_state
    p = TB.params_from_hf_state_dict(state)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 100, (3, 12)).astype(np.int64)
    ids[0, 9:] = 0
    types = (rng.random((3, 12)) < 0.5).astype(np.int64)
    out = TB.bert_encode(p, torch.from_numpy(ids), torch.from_numpy(types),
                         heads=4)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids),
                   token_type_ids=torch.from_numpy(types),
                   attention_mask=torch.from_numpy((ids > 0).astype(np.int64)),
                   output_hidden_states=True)
    live = ids > 0
    np.testing.assert_allclose(out["hidden"].numpy()[live],
                               hf.hidden_states[-1].numpy()[live],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out["score"].numpy(), hf.logits[:, 0].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_load_bert_npz_in_both_packages(hf_state, tmp_path):
    """One export (a flat npz under the HF names) loads to the same
    function in both packages."""
    _, state = hf_state
    path = tmp_path / "weights.npz"
    np.savez(path, **state)
    jp = JB.load_bert_npz(str(path))
    tp = TB.load_bert_npz(str(path))
    carried_tp = params_from_jax(jp)
    for a, b in zip(jax.tree_util.tree_leaves(carried_tp),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        lambda t: t.numpy(), tp))):
        np.testing.assert_array_equal(np.asarray(a), b)
    ids = np.arange(5, 17, dtype=np.int32).reshape(1, 12)
    jo = JB.bert_encode(jp, jnp.asarray(ids), heads=4)
    to = TB.bert_encode(tp, torch.from_numpy(ids), heads=4)
    np.testing.assert_allclose(to["score"].numpy(), np.asarray(jo["score"]),
                               rtol=1e-5, atol=1e-5)


def test_init_bert_params_shapes_match_jax():
    jp = JB.init_bert_params(jax.random.PRNGKey(0), **CFG)
    tp = TB.init_bert_params(0, **CFG)
    js = jax.tree_util.tree_map(np.shape, jp)
    ts = jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    assert js == ts
    again = TB.init_bert_params(0, **CFG)
    assert torch.equal(tp["layers"][1]["w2"], again["layers"][1]["w2"])
    assert abs(float(tp["tok_emb"].std()) - 0.02) < 0.002


def test_pretrained_export_dir_roundtrip(hf_state, tmp_path):
    """An export dir (weights.npz, vocab.txt, config.json) written once is
    read the same by both packages' embedders."""
    from neurondb_tpu.ml.transformer import PretrainedEmbedder as JPE
    from neurondb_tpu_torch.ml.transformer import PretrainedEmbedder
    _, state = hf_state
    np.savez(tmp_path / "weights.npz", **state)
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
        + [f"tok{i}" for i in range(96)]) + "\n")
    (tmp_path / "config.json").write_text(json.dumps(
        {"hidden": 32, "heads": 4, "layers": 2, "max_len": 40,
         "lowercase": True}))
    texts = ["tok1 tok2", "tok3 tok77 unknown", "tok5"]
    t = PretrainedEmbedder(str(tmp_path), device="cpu")(texts)
    j = JPE(str(tmp_path), use_flash=False)(texts)
    assert t.shape == (3, 32)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
