"""GPT-2 decode and the byte-level BPE tokenizer: the torch port against
the JAX package on the same inputs (CPU).

Parameters come from one HF ``GPT2LMHeadModel`` random init (no
download) through each package's ``params_from_hf_state_dict``, or from
the JAX ``init_gpt_params`` carried with ``params_from_jax``. f32 paths
are held at atol 1e-5, greedy tokens and int8 codes exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neurondb_tpu.ml.gpt as JG
from neurondb_tpu.ml.bpe import BPETokenizer as JBPE
from neurondb_tpu_torch.ml import gpt as TG
from neurondb_tpu_torch.ml.bpe import BPETokenizer, bytes_to_unicode
from neurondb_tpu_torch.ml.params import params_from_jax

ATOL = 1e-5
HEADS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several workers share the machine's cores: one intra-op thread
    keeps this module's small torch ops from contending."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# BPE tokenizer
# ---------------------------------------------------------------------------

def _toy_assets(tmp_path):
    """A byte-level base vocab, a few real merges and an eos, in HF's
    file format."""
    b2u = bytes_to_unicode()
    merges = [("h", "e"), ("Ġ", "t"), ("Ġt", "he"), ("l", "l"),
              ("he", "ll"), ("hell", "o")]
    vocab = {b2u[b]: i for i, b in enumerate(range(256))}
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vp, mp = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vp.write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    mp.write_text("#version: 0.2\n"
                  + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
                  encoding="utf-8")
    return str(vp), str(mp)


SAMPLES = ["hello the world", " the he hello", "hello,  hello!",
           "don't they're", "tabs\tand\nnewlines  ", "naïve café 日本語",
           "123 abc456", "'s 'll x", "trailing space ", ""]


def test_bpe_ids_and_text_equal_jax_and_hf(tmp_path):
    vp, mp = _toy_assets(tmp_path)
    port, ref = BPETokenizer.from_files(vp, mp), JBPE.from_files(vp, mp)
    hf = pytest.importorskip("transformers").GPT2Tokenizer(
        vocab_file=vp, merges_file=mp)
    for s in SAMPLES:
        ids = port.encode(s)
        assert ids == ref.encode(s) == hf.encode(s), s
        assert port.tokenize(s) == hf.tokenize(s), s
        assert port.decode(ids + [port.eos_id] + ids) == ref.decode(
            ids + [ref.eos_id] + ids) == s
    assert port.tokenize("hello") == ["hello"]
    assert port.tokenize(" the") == ["Ġthe"]


def test_bpe_byte_fallback_equals_jax():
    port, ref = BPETokenizer.byte_fallback(), JBPE.byte_fallback()
    s = "any text — ünïcode\n"
    assert port.encode(s) == ref.encode(s)
    assert port.decode(port.encode(s)) == s
    assert len(port) == len(ref) == 257 and port.eos_id == 256


# ---------------------------------------------------------------------------
# the model, from one HF random init
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    from transformers import GPT2Config, GPT2LMHeadModel
    cfg = GPT2Config(vocab_size=160, n_positions=64, n_embd=32, n_layer=2,
                     n_head=HEADS, attn_pdrop=0.0, embd_pdrop=0.0,
                     resid_pdrop=0.0)
    torch.manual_seed(0)
    model = GPT2LMHeadModel(cfg).eval()
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return (JG.params_from_hf_state_dict(state),
            TG.params_from_hf_state_dict(state, device="cpu"), cfg)


def _left_padded(rng, lens, S, vocab):
    ids = np.zeros((len(lens), S), np.int32)
    for b, n in enumerate(lens):
        ids[b, S - n:] = rng.integers(0, vocab, n)
    return ids, np.asarray(lens, np.int32)


def test_gpt_logits_equal_jax(pair):
    jp, tp, cfg = pair
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (3, 17)).astype(np.int32)
    want = np.asarray(JG.gpt_logits(jp, jnp.asarray(ids), heads=HEADS))
    got = TG.gpt_logits(tp, torch.from_numpy(ids), heads=HEADS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # left padding: the same rows with pads and lens
    pids, lens = _left_padded(rng, [5, 17, 11], 17, cfg.vocab_size)
    want = np.asarray(JG.gpt_logits(jp, jnp.asarray(pids), heads=HEADS,
                                    lens=jnp.asarray(lens)))
    got = TG.gpt_logits(tp, pids, heads=HEADS, lens=lens).numpy()
    live = np.arange(17)[None, :] >= (17 - lens)[:, None]
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=ATOL)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_prefill_and_decode_steps_equal_jax(pair, kv_int8):
    """Prefill logits and caches, then three decode steps on the same
    tokens: f32 caches at atol 1e-5; int8 codes within one step of the
    JAX codes (the f32 keys they quantize differ in the last bits) and
    the decode logits within the int8 rounding."""
    jp, tp, cfg = pair
    rng = np.random.default_rng(1)
    S, P = 12, 24
    ids, lens = _left_padded(rng, [4, 12, 9], S, cfg.vocab_size)
    jl, jc = JG._prefill(jp, jnp.asarray(ids), jnp.asarray(lens), HEADS, P,
                         kv_int8=kv_int8)
    tl, tc = TG._prefill(tp, torch.from_numpy(ids).long(),
                         torch.from_numpy(lens).long(), HEADS, P,
                         kv_int8=kv_int8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    for je, te in zip(jc["k"] + jc["v"], tc["k"] + tc["v"]):
        if kv_int8:
            codes = te[0].numpy().astype(int) - np.asarray(je[0]).astype(int)
            assert np.abs(codes).max() <= 1 and (codes == 0).mean() > 0.99
            np.testing.assert_allclose(te[1].numpy(), np.asarray(je[1]),
                                       rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                                       atol=ATOL)
    tol = 2e-3 if kv_int8 else ATOL
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
        jl, jc = JG._decode_step(jp, jc, jnp.asarray(tok), step, S,
                                 jnp.asarray(lens), HEADS)
        tl, tc = TG._decode_step(tp, tc, torch.from_numpy(tok).long(),
                                 torch.tensor(step), S,
                                 torch.from_numpy(lens).long(), HEADS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol)


def _gen(package, params, ids, lens, **kw):
    if package is JG:
        t, n = JG.generate_ids(params, jnp.asarray(ids), jnp.asarray(lens),
                               jax.random.PRNGKey(0), heads=HEADS, **kw)
        return np.asarray(t), np.asarray(n)
    t, n = TG.generate_ids(params, ids, lens, 0, heads=HEADS, **kw)
    return t.numpy(), n.numpy()


def test_greedy_tokens_equal_jax(pair):
    """Greedy generate over a left-padded batch: the same tokens outright,
    and each row equal to the no-cache argmax oracle."""
    jp, tp, cfg = pair
    rng = np.random.default_rng(2)
    ids, lens = _left_padded(rng, [3, 9, 7, 1], 9, cfg.vocab_size)
    kw = dict(max_new=10, cache_len=32, temperature=0.0)
    jt, jn = _gen(JG, jp, ids, lens, **kw)
    tt, tn = _gen(TG, tp, ids, lens, **kw)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tn, jn)
    for b in range(len(lens)):
        seq = list(ids[b, 9 - lens[b]:])
        for t in tt[b]:
            lg = TG.gpt_logits(tp, np.asarray([seq]), heads=HEADS)
            assert int(lg[0, -1].argmax()) == t
            seq.append(int(t))


def test_int8_cache_and_int8_dot_decode(pair):
    """The JAX test's tolerances (tests/test_gpt.py): the int8 cache
    dequantizes within half a quantization step plus the bf16 rounding of
    codes x scales, and greedy decode with the int8 cache, and with
    int8_dot, gives the exact cache's tokens, here and in JAX."""
    jp, tp, cfg = pair
    rng = np.random.default_rng(4)
    ids, lens = _left_padded(rng, [9], 9, cfg.vocab_size)
    _, exact = TG._prefill(tp, torch.from_numpy(ids).long(),
                           torch.from_numpy(lens).long(), HEADS, 16)
    _, quant = TG._prefill(tp, torch.from_numpy(ids).long(),
                           torch.from_numpy(lens).long(), HEADS, 16,
                           kv_int8=True)
    for e, qe in zip(exact["k"] + exact["v"], quant["k"] + quant["v"]):
        e = e.numpy()
        dq = TG._dequant_kv(qe).float().numpy()
        step = np.abs(e).max(-1, keepdims=True) / 127.0
        assert np.all(np.abs(dq - e) <= 0.5 * step + np.abs(e) * 2 ** -7
                      + 1e-6)
    kw = dict(max_new=8, cache_len=32, temperature=0.0)
    want, _ = _gen(TG, tp, ids, lens, **kw)
    for extra in (dict(kv_int8=True), dict(int8_dot=True)):
        got, _ = _gen(TG, tp, ids, lens, **kw, **extra)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _gen(JG, jp, ids, lens, **kw,
                                                **extra)[0])


def test_int8_dot_products_are_exact():
    """The f32 code products equal int64 sums, across the chunk edge."""
    g = torch.Generator().manual_seed(0)
    qq = torch.randint(-127, 128, (2, 3, 64), generator=g).to(torch.int8)
    kc = torch.randint(-127, 128, (2, 3, 1100, 64), generator=g).to(torch.int8)
    aq = torch.full((2, 3, 1100), 127, dtype=torch.int8)
    vc = torch.full((2, 3, 1100, 64), -127, dtype=torch.int8)
    want = torch.einsum("bhd,bhkd->bhk", qq.long(), kc.long())
    assert torch.equal(TG._int8_scores(qq, kc).long(), want)
    got = TG._int8_mix(aq, vc).long()
    assert torch.equal(got, torch.full_like(got, -127 * 127 * 1100))


# ---------------------------------------------------------------------------
# W8A8
# ---------------------------------------------------------------------------

def test_quantize_codes_and_w8a8_equal_jax(pair):
    """Weight codes and scales bit for bit; the int32 accumulate equal to
    ``lax.dot_general``'s; ``_mm`` at atol 1e-6; int8 logits at 1e-5."""
    jp, tp, cfg = pair
    jq = JG.quantize_gpt_params(jp)
    tq = TG.quantize_gpt_params(tp)
    for jb, tb in zip(jq["blocks"], tq["blocks"]):
        for name in ("w_qkv", "w_o", "w_fc", "w_pr"):
            np.testing.assert_array_equal(tb[name][0].numpy(),
                                          np.asarray(jb[name][0]))
            np.testing.assert_array_equal(tb[name][1].numpy(),
                                          np.asarray(jb[name][1]))
    np.testing.assert_array_equal(tq["lm_head"][0].numpy(),
                                  np.asarray(jq["lm_head"][0]))
    rng = np.random.default_rng(5)
    for shape in ((1, 32), (4, 7, 32)):
        x = rng.standard_normal(shape).astype(np.float32)
        x[0, ..., 3] = 0.0
        w = jq["blocks"][0]["w_qkv"]
        sx = jnp.maximum(jnp.max(jnp.abs(x), -1, keepdims=True) / 127.0,
                         1e-12)
        xq = jnp.clip(jnp.round(x / sx), -127, 127).astype(jnp.int8)
        acc = jax.lax.dot_general(xq, w[0], (((x.ndim - 1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        tacc, tsx = TG.w8a8_accumulate(torch.from_numpy(x),
                                       tq["blocks"][0]["w_qkv"][0])
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(acc))
        np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))
        np.testing.assert_allclose(
            TG._mm(torch.from_numpy(x), tq["blocks"][0]["w_qkv"]).numpy(),
            np.asarray(JG._mm(jnp.asarray(x), w)), rtol=0, atol=1e-6)
    ids = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        TG.gpt_logits(tq, ids, heads=HEADS).numpy(),
        np.asarray(JG.gpt_logits(jq, jnp.asarray(ids), heads=HEADS)),
        rtol=0, atol=ATOL)


def test_int8_matmul_plain_is_exact():
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-127, 128, (5, 3072), generator=g).to(torch.int8)
    b = torch.randint(-127, 128, (3072, 9), generator=g).to(torch.int8)
    a[0] = 127
    b[:, 0] = 127
    got = TG.int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ b.long())


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k,top_p,temp", [(5, 1.0, 1.0), (5, 0.6, 0.7),
                                              (0, 0.6, 1.3), (0, 1.0, 0.5),
                                              (50, 0.9, 1.0)])
def test_filtered_logits_equal_jax(monkeypatch, top_k, top_p, temp):
    """The logits ``_sample`` hands to the draw, bit for bit with those
    JAX hands to ``jax.random.categorical`` (caught), ties included; the
    top-k ids as ``lax.top_k`` gives them."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 160)).astype(np.float32)
    logits[1, 10:40] = logits[1].max()              # a tie across top-k
    caught = {}

    def categorical(key, lg, axis=-1):
        caught["lg"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jtok = JG._sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                      jnp.float32(temp), top_k, jnp.float32(top_p), True)
    lg, idxs = TG._filter_logits(torch.from_numpy(logits), temp, top_k, top_p)
    np.testing.assert_array_equal(lg.numpy(), caught["lg"])
    if top_k:
        got = torch.gather(idxs, -1, lg.argmax(-1, keepdim=True))[:, 0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtok))


def test_sampling_draws_kept_set_and_repeats_with_seed(pair):
    _, tp, cfg = pair
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((64, 160)).astype(np.float32))
    lg, idxs = TG._filter_logits(logits, 1.0, 20, 0.8)
    kept = [set(idxs[b][lg[b] > TG._NEG].tolist()) for b in range(64)]
    gen = torch.Generator().manual_seed(3)
    draws = [TG._sample(logits, gen, 1.0, 20, 0.8, True) for _ in range(20)]
    for d in draws:
        assert all(int(d[b]) in kept[b] for b in range(64))
    assert len({tuple(d.tolist()) for d in draws}) > 1
    ids, lens = _left_padded(rng, [4, 6], 6, cfg.vocab_size)
    kw = dict(max_new=6, cache_len=16, temperature=1.2, top_k=20, top_p=0.9)
    a, _ = TG.generate_ids(tp, ids, lens, 11, heads=HEADS, **kw)
    b, _ = TG.generate_ids(tp, ids, lens, 11, heads=HEADS, **kw)
    c, _ = TG.generate_ids(tp, ids, lens, 12, heads=HEADS, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # top_k 1 and top_p ~ 0 collapse to greedy at any temperature
    g, _ = TG.generate_ids(tp, ids, lens, 0, heads=HEADS, max_new=6,
                           cache_len=16)
    for extra in (dict(top_k=1), dict(top_p=1e-6)):
        s, _ = TG.generate_ids(tp, ids, lens, 5, heads=HEADS, max_new=6,
                               cache_len=16, temperature=1.5, **extra)
        assert torch.equal(s, g)


def test_eos_latches(pair):
    jp, tp, cfg = pair
    ids, lens = np.asarray([[1, 2, 3]], np.int32), np.asarray([3], np.int32)
    kw = dict(max_new=5, cache_len=16, temperature=0.0)
    toks, _ = _gen(TG, tp, ids, lens, **kw)
    first = int(toks[0, 0])
    t2, n2 = _gen(TG, tp, ids, lens, eos_id=first, **kw)
    assert t2[0].tolist() == [first] * 5 and int(n2[0]) == 1
    j2, jn2 = _gen(JG, jp, ids, lens, eos_id=first, **kw)
    np.testing.assert_array_equal(t2, j2)
    np.testing.assert_array_equal(n2, jn2)


def test_positions_past_the_table_raise(pair):
    """JAX clamps the wpe gather and the cache update; the port raises."""
    _, tp, cfg = pair
    ids = np.ones((1, 60), np.int32)
    with pytest.raises(ValueError, match="position table"):
        TG.generate_ids(tp, ids, [60], 0, heads=HEADS, max_new=8,
                        cache_len=80)
    with pytest.raises(ValueError, match="cache_len"):
        TG.generate_ids(tp, ids[:, :8], [8], 0, heads=HEADS, max_new=8,
                        cache_len=12)


# ---------------------------------------------------------------------------
# GPT2LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lms():
    """The JAX GPT2LM and the port's on one carried f32 tree (byte
    tokenizer, 2 layers, hidden 32, 64 positions)."""
    jp = JG.init_gpt_params(jax.random.PRNGKey(0), vocab_size=257,
                            hidden=32, layers=2, heads=HEADS, max_len=64)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    jlm = JG.GPT2LM(jp, JBPE.byte_fallback(), heads=HEADS)
    tlm = TG.GPT2LM(params_from_jax(jp), BPETokenizer.byte_fallback(),
                    heads=HEADS, device="cpu")
    return jlm, tlm


def test_complete_batch_equals_jax(lms):
    jlm, tlm = lms
    prompts = [tlm.tok.encode(s) for s in ("ab", "hello there", "x" * 40)]
    assert tlm.complete_batch(prompts, max_tokens=6) == \
        jlm.complete_batch(prompts, max_tokens=6)
    assert tlm.complete("ab", max_tokens=5) == jlm.complete("ab", max_tokens=5)
    # the tail of an over-long prompt, and max_tokens past the context
    long_ids = tlm.tok.encode("y" * 500)
    assert tlm.complete_batch([long_ids], max_tokens=8) == \
        tlm.complete_batch([long_ids[-(tlm.max_len - 8):]], max_tokens=8) == \
        jlm.complete_batch([long_ids], max_tokens=8)
    out = tlm.complete("ab", max_tokens=tlm.max_len + 10)
    assert out == jlm.complete("ab", max_tokens=jlm.max_len + 10)


def test_dtypes_and_kv_auto(lms):
    jlm, tlm = lms
    assert TG._cache_dtype(tlm.params) == torch.float32
    for dtype in ("bfloat16", "int8"):
        lm = TG.GPT2LM(tlm.params, tlm.tok, heads=HEADS, dtype=dtype,
                       device="cpu")
        assert TG._cache_dtype(lm.params) == torch.bfloat16
        assert isinstance(lm.complete("ab", max_tokens=4), str)
    lm = TG.GPT2LM(tlm.params, tlm.tok, heads=HEADS, kv_dtype="auto",
                   device="cpu")
    assert [lm._kv_for_batch(b) for b in (8, 63, 64, 128)] == \
        [False, False, True, True]
    assert lm.complete("ab", max_tokens=4) == tlm.complete("ab", max_tokens=4)
    pinned = TG.GPT2LM(tlm.params, tlm.tok, heads=HEADS, kv_dtype="int8",
                       device="cpu")
    assert pinned._kv_for_batch(1) and not tlm._kv_for_batch(1024)
    with pytest.raises(ValueError, match="kv_dtype"):
        TG.GPT2LM(tlm.params, tlm.tok, heads=HEADS, kv_dtype="fp8",
                  device="cpu")
    names = [n for n, _ in TG.GPT2LM(tlm.params, tlm.tok, heads=HEADS,
                                     dtype="int8", device="cpu")
             .model.named_parameters()]
    assert "blocks.0.w_qkv.0" in names and "lm_head.1" in names
