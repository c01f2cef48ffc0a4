"""The LLM router, the embedding service, the RAG pipeline and the
client's services: the torch port against the JAX package (CPU).

No test reaches the network: the router runs scripted providers, the
HTTP providers a transport callable, the generative path a tiny export
written to ``tmp_path``.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

import neurondb_tpu.ml.vision as JV
from neurondb_tpu.search import rag as JR
from neurondb_tpu.service import embeddings as JE
from neurondb_tpu.service import llm as JL
from neurondb_tpu_torch.client import Client
from neurondb_tpu_torch.ml import gpt as TG
from neurondb_tpu_torch.ml import vision as TV
from neurondb_tpu_torch.ml.bpe import BPETokenizer
from neurondb_tpu_torch.ml.params import params_from_jax
from neurondb_tpu_torch.search import rag as TR
from neurondb_tpu_torch.service import embeddings as TE
from neurondb_tpu_torch.service import llm as TL

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scripted(pkg):
    """tests/test_services.py's ScriptedProvider over either package's
    ``service.llm``."""
    class Scripted(pkg.BaseProvider):
        name = "scripted"

        def __init__(self, responses=None, fail=False, dim=4):
            self.responses = list(responses or [])
            self.fail = fail
            self.dim = dim
            self.calls = 0

        def complete(self, prompt, **kw):
            self.calls += 1
            if self.fail:
                raise pkg.ProviderError("scripted failure")
            return self.responses.pop(0) if self.responses else "ok"

        def embed(self, texts):
            self.calls += 1
            if self.fail:
                raise pkg.ProviderError("scripted failure")
            return np.ones((len(texts), self.dim), np.float32)

        def rerank(self, query, docs):
            return np.arange(len(docs), 0, -1).astype(np.float32)
    return Scripted


@pytest.mark.parametrize("pkg", [JL, TL], ids=["jax", "torch"])
def test_router_fail_open_closed_and_cache(pkg):
    S = _scripted(pkg)
    assert pkg.LLMRouter([S(fail=True), S(["fallback"])],
                         fail_open=True).complete("hi") == "fallback"
    with pytest.raises(pkg.ProviderError):
        pkg.LLMRouter([S(fail=True), S()], fail_open=False).complete("hi")
    with pytest.raises(pkg.ProviderError, match="all providers failed"):
        pkg.LLMRouter([S(fail=True)], fail_open=True).complete("hi")
    p = S(["a", "b"])
    r = pkg.LLMRouter([p])
    assert r.complete("q") == r.complete("q") == "a" and p.calls == 1
    np.testing.assert_array_equal(r.embed(["x", "y"]), np.ones((2, 4)))
    np.testing.assert_array_equal(r.rerank("q", ["d1", "d2"]), [2.0, 1.0])
    c = pkg.LLMCache(ttl_s=0.05)
    c.put("op", "x", 42)
    assert c.get("op", "x") == 42
    time.sleep(0.08)
    assert c.get("op", "x") is None


def test_router_complete_batch_caches_and_batches():
    """Uncached prompts go to a provider that batches natively as one
    batch, each answer cached under its prompt; the answers equal the
    JAX router's."""
    class Batched(_scripted(TL)):
        def native_batch(self):
            return True

        def complete_batch(self, prompts, **kw):
            self.batches = getattr(self, "batches", []) + [list(prompts)]
            return [p.upper() for p in prompts]

    p = Batched()
    r = TL.LLMRouter([p])
    assert r.complete("b") == "ok"
    assert r.complete_batch(["a", "b", "c"]) == ["A", "ok", "C"]
    assert p.batches == [["a", "c"]]
    assert r.complete_batch(["a", "c"]) == ["A", "C"] and len(p.batches) == 1
    S, JS = _scripted(TL), _scripted(JL)
    assert TL.LLMRouter([S(["x", "y"])]).complete_batch(["1", "2"]) == \
        JL.LLMRouter([JS(["x", "y"])]).complete_batch(["1", "2"])


def _picky(pkg, bad):
    """A scripted provider that fails on the prompts in ``bad``."""
    class Picky(_scripted(pkg)):
        def complete(self, prompt, **kw):
            self.calls += 1
            if prompt in bad:
                raise pkg.ProviderError(f"no answer to {prompt}")
            return f"{self.name}:{prompt}"
    return Picky


@pytest.mark.parametrize("native", [False, True],
                         ids=["one_at_a_time", "native_batch"])
def test_router_complete_batch_rate_limits_each_prompt(native):
    """The rate limit counts prompts, not batches: one acquire for each
    uncached prompt, whether the provider loops over them or decodes them
    in one call."""
    class P(_scripted(TL)):
        def native_batch(self):
            return native

    r = TL.LLMRouter([P()])
    taken = []
    r._limiter.acquire = lambda: taken.append(1)
    assert r.complete("c") == "ok" and len(taken) == 1
    assert r.complete_batch(["a", "b", "c", "d"]) == ["ok"] * 4
    assert len(taken) == 4                # a, b and d; c came from the cache


def test_router_complete_batch_fails_over_each_prompt():
    """Fail-open moves only the prompts that failed to the next provider,
    as the JAX router does; a natively batched call that fails sends each
    of its prompts on, one at a time."""
    prompts = ["p1", "p2", "p3"]
    got = {}
    for name, pkg in (("jax", JL), ("torch", TL)):
        first, second = _picky(pkg, {"p2"})(), _picky(pkg, set())()
        first.name, second.name = "first", "second"
        got[name] = pkg.LLMRouter([first, second]).complete_batch(prompts)
        assert (first.calls, second.calls) == (3, 1)
    assert got["torch"] == got["jax"] == ["first:p1", "second:p2", "first:p3"]

    class Broken(_scripted(TL)):
        def native_batch(self):
            return True

        def complete_batch(self, prompts, **kw):
            raise TL.ProviderError("batch failed")

    second = _picky(TL, set())()
    second.name = "second"
    r = TL.LLMRouter([Broken(), second])
    assert r.complete_batch(prompts) == ["second:p1", "second:p2", "second:p3"]
    assert second.calls == 3
    with pytest.raises(TL.ProviderError, match="all providers failed"):
        TL.LLMRouter([Broken()]).complete_batch(prompts)
    with pytest.raises(TL.ProviderError, match="batch failed"):
        TL.LLMRouter([Broken(), second], fail_open=False).complete_batch(
            prompts)


def test_router_async_jobs():
    r = TL.LLMRouter([_scripted(TL)(["async-result"])])
    jid = r.enqueue("complete", {"prompt": "hello"})
    bad = r.enqueue("translate", {})
    deadline = time.time() + 10
    while time.time() < deadline and (
            r.job_status(jid).status != "done"
            or r.job_status(bad).status != "failed"):
        time.sleep(0.02)
    assert r.job_status(jid).status == "done"
    assert r.job_status(jid).result == "async-result"
    assert r.job_status(bad).status == "failed"
    assert "unknown op" in r.job_status(bad).error
    r.shutdown()
    r._worker.join(timeout=5)
    assert not r._worker.is_alive()


def test_http_providers_through_a_transport():
    def transport(path, payload):
        if path == "/chat/completions":
            return {"choices": [{"message": {"content": "7 mocked"}}]}
        if path == "/embeddings":
            return {"data": [{"embedding": [1.0, 2.0]}
                             for _ in payload["input"]]}
        return [{"generated_text": "hf says " + payload["inputs"]}]
    p = TL.OpenAIProvider(api_key="k", transport=transport)
    assert p.complete("x") == "7 mocked" and p.available()
    assert p.embed(["a", "b"]).shape == (2, 2)
    np.testing.assert_array_equal(p.rerank("q", ["d", "e"]), [7.0, 7.0])
    h = TL.HFProvider(api_key="k", model="m", transport=transport)
    assert h.complete("hi") == "hf says hi" and h.available()
    assert not TL.HFProvider().available()
    assert not TL.OpenAIProvider().available()


def test_router_from_config_chains(monkeypatch):
    from neurondb_tpu_torch import config as C
    for provider, kinds in (("local", ["local"]),
                            ("auto", ["local", "openai"]),
                            ("huggingface", ["huggingface"]),
                            ("none", ["local"])):
        monkeypatch.setattr(C, "_config", C.NDBConfig(llm_provider=provider,
                                                      device="cpu"))
        r = TL.router_from_config()
        assert [p.name for p in r.providers] == kinds, provider
        assert r.providers[-1 if provider != "auto" else 0].name in kinds


# ---------------------------------------------------------------------------
# LocalProvider
# ---------------------------------------------------------------------------

def write_gpt_export(path, seed=0, vocab=257, hidden=32, layers=2,
                     max_len=64, heads=2):
    """A tiny export dir as scripts/export_hf.py --gpt writes it: the HF
    state dict's names in weights.npz, vocab.json, merges.txt (byte
    vocab, no merges) and config.json."""
    rng = np.random.default_rng(seed)
    h = hidden

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    st = {"transformer.wte.weight": rnd(vocab, h),
          "transformer.wpe.weight": rnd(max_len, h),
          "transformer.ln_f.weight": np.ones(h, np.float32),
          "transformer.ln_f.bias": np.zeros(h, np.float32)}
    for i in range(layers):
        pre = f"transformer.h.{i}."
        for name, shape in (("attn.c_attn", (h, 3 * h)),
                            ("attn.c_proj", (h, h)), ("mlp.c_fc", (h, 4 * h)),
                            ("mlp.c_proj", (4 * h, h))):
            st[pre + name + ".weight"] = rnd(*shape)
            st[pre + name + ".bias"] = rnd(shape[1])
        for name in ("ln_1", "ln_2"):
            st[pre + name + ".weight"] = 1.0 + rnd(h)
            st[pre + name + ".bias"] = rnd(h)
    np.savez(path / "weights.npz", **st)
    tok = BPETokenizer.byte_fallback()
    (path / "vocab.json").write_text(json.dumps(tok.vocab, ensure_ascii=False),
                                     encoding="utf-8")
    (path / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    (path / "config.json").write_text(json.dumps({"heads": heads,
                                                  "layers": layers}))


def test_gpt_from_dir_equals_jax(tmp_path):
    import neurondb_tpu.ml.gpt as JG
    write_gpt_export(tmp_path)
    tlm = TG.GPT2LM.from_dir(str(tmp_path), dtype=None, device="cpu")
    jlm = JG.GPT2LM.from_dir(str(tmp_path), dtype=None)
    assert tlm.max_len == jlm.max_len == 64
    assert tlm.complete("the prompt", max_tokens=6) == \
        jlm.complete("the prompt", max_tokens=6)
    bf = TG.GPT2LM.from_dir(str(tmp_path), device="cpu")      # bf16 default
    assert bf.params["wte"].dtype == torch.bfloat16
    assert isinstance(bf.complete("the prompt", max_tokens=4), str)


def test_local_provider_generative_path(tmp_path, monkeypatch):
    """Under NEURONDB_TORCH_GPT_WEIGHTS the provider completes with the
    export's GPT2LM (bf16, as the JAX provider loads it), batched
    through the router as well; without it the extractive answer equals
    the JAX provider's."""
    prompt = "first. second. third. fourth."
    assert TL.LocalProvider(device="cpu").complete(prompt) == \
        JL.LocalProvider().complete(prompt)
    write_gpt_export(tmp_path)
    monkeypatch.setenv("NEURONDB_TORCH_GPT_WEIGHTS", str(tmp_path))
    prov = TL.LocalProvider(device="cpu")
    lm = TG.GPT2LM.from_dir(str(tmp_path), device="cpu")
    out = prov.complete("hi there", max_tokens=5)
    assert out == lm.complete("hi there", max_tokens=5)
    assert not out.startswith("[extractive-local]")
    prompts = ["hi there", "another prompt", "x"]
    assert TL.LLMRouter([prov]).complete_batch(prompts, max_tokens=5) == \
        lm.complete_batch([lm.tok.encode(p) for p in prompts], max_tokens=5)
    given = TL.LocalProvider(lm=lm, device="cpu")
    assert given.complete("hi there", max_tokens=5) == out


def test_local_provider_embed_rerank():
    p = TL.LocalProvider(dim=64, device="cpu")
    e = p.embed(["hello world", "goodbye"])
    assert e.shape == (2, 64)
    np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, rtol=1e-4)
    assert p.rerank("hello", ["hello world", "unrelated"]).shape == (2,)
    assert p._embedder.device.type == "cpu"


def _write_bert_export(path, hidden=32, layers=2, heads=2, ff=64,
                       max_len=64):
    """A tiny BERT export (HF names, Linear weights [out, in]) with a
    WordPiece vocabulary of w0..w99."""
    rng = np.random.default_rng(1)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [f"w{i}" for i in range(100)]
    h = hidden

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    st = {"embeddings.word_embeddings.weight": rnd(len(vocab), h),
          "embeddings.position_embeddings.weight": rnd(max_len, h),
          "embeddings.token_type_embeddings.weight": rnd(2, h),
          "embeddings.LayerNorm.weight": np.ones(h, np.float32),
          "embeddings.LayerNorm.bias": np.zeros(h, np.float32)}
    for i in range(layers):
        pre = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)),
                            ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)),
                            ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (ff, h)),
                            ("output.dense", (h, ff))):
            st[pre + name + ".weight"] = rnd(*shape)
            st[pre + name + ".bias"] = rnd(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            st[pre + name + ".weight"] = np.ones(h, np.float32)
            st[pre + name + ".bias"] = np.zeros(h, np.float32)
    np.savez(path / "weights.npz", **st)
    (path / "vocab.txt").write_text("\n".join(vocab))
    (path / "config.json").write_text(json.dumps(
        {"hidden": h, "heads": heads, "layers": layers, "max_len": max_len,
         "lowercase": True}))


def test_pretrained_embedder_sub_batches_equal_one_shot(tmp_path):
    """The RAG embedder encodes in pipelined sub-batches: the embeddings
    equal the one-shot call's, and the JAX embedder's, within 1e-5."""
    from neurondb_tpu.ml.transformer import PretrainedEmbedder as JPE
    from neurondb_tpu_torch.ml.transformer import PretrainedEmbedder
    _write_bert_export(tmp_path)
    rng = np.random.default_rng(2)
    texts = [" ".join(f"w{int(i)}" for i in rng.integers(0, 100, n))
             for n in rng.integers(1, 40, 11)]
    sub = PretrainedEmbedder(str(tmp_path), batch=3, device="cpu")
    whole = PretrainedEmbedder(str(tmp_path), batch=0, device="cpu")
    assert sub.batch == 3 and not sub.use_flash
    got = sub(texts)
    np.testing.assert_allclose(got, whole(texts), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got, JPE(str(tmp_path))(texts), rtol=ATOL,
                               atol=ATOL)
    assert sub([]).shape == (0, 32)


# ---------------------------------------------------------------------------
# embedding service
# ---------------------------------------------------------------------------

def test_embedding_service_equals_jax():
    """Text through the router, cached; the histogram image projection
    and the multimodal mean bit for bit with JAX's; a carried ViT within
    1e-5; model-config CRUD."""
    svc = TE.EmbeddingService(TL.LLMRouter([_scripted(TL)()]))
    jsvc = JE.EmbeddingService(JL.LLMRouter([_scripted(JL)()]))
    np.testing.assert_array_equal(svc.embed_batch(["a", "b"]),
                                  jsvc.embed_batch(["a", "b"]))
    np.testing.assert_array_equal(svc.embed_cached("same"),
                                  svc.embed_cached("same"))
    blob = bytes(range(256)) * 3 + b"\x00\x01\x02" * 100
    np.testing.assert_array_equal(svc.embed_image(blob),
                                  jsvc.embed_image(blob))
    with pytest.raises(ValueError):
        svc.delete_model("default")
    svc.add_model(TE.EmbeddingModelConfig("small", dim=4))
    assert svc.list_models() == ["default", "small"]
    assert svc.embed_image(blob, "small").shape == (4,)
    svc.delete_model("small")
    with pytest.raises(KeyError):
        svc.get_model("small")
    jp = JV.init_vit_params(jax.random.PRNGKey(1))
    svc.set_vision_encoder(TV.VisionEncoder(params_from_jax(
        jax.tree_util.tree_map(lambda a: a if isinstance(a, int)
                               else np.asarray(a), jp)), heads=4,
        device="cpu"))
    jsvc.set_vision_encoder(JV.VisionEncoder(jp, heads=4))
    raw = np.random.default_rng(4).integers(0, 255, (16, 16, 3),
                                            dtype=np.uint8).tobytes()
    v = svc.embed_image(raw)
    assert v.shape == (256,) and abs(float(np.linalg.norm(v)) - 1) < 1e-5
    np.testing.assert_allclose(v, jsvc.embed_image(raw), rtol=ATOL, atol=ATOL)
    svc.router.providers[0].dim = jsvc.router.providers[0].dim = 256
    m = svc.embed_multimodal("a caption", raw)
    np.testing.assert_allclose(m, jsvc.embed_multimodal("a caption", raw),
                               rtol=ATOL, atol=ATOL)
    np.testing.assert_array_equal(svc.embed_multimodal("t", None),
                                  svc.embed_text("t"))


# ---------------------------------------------------------------------------
# RAG
# ---------------------------------------------------------------------------

WORDS = [f"w{i}" for i in range(300)]


def _docs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sents = [" ".join(rng.choice(WORDS, int(rng.integers(6, 14))))
                 + "." for _ in range(int(rng.integers(8, 20)))]
        out.append(" ".join(sents))
    return out


def _embed(texts):
    """A deterministic bag-of-words embedder, numpy only, shared by both
    pipelines."""
    proj = np.random.default_rng(42).standard_normal((len(WORDS) + 1, 48))
    out = np.zeros((len(texts), 48))
    for i, t in enumerate(texts):
        for w in t.replace(".", " ").split():
            out[i] += proj[int(w[1:]) if w[1:].isdigit() else -1]
    return out.astype(np.float32)


@pytest.mark.parametrize("by", ["chars", "sentences"])
def test_chunk_text_equals_jax(by):
    for text in _docs(1, 5) + ["", "short", "a. b! c? " * 50]:
        for size, overlap in ((512, 64), (100, 0), (37, 10)):
            assert TR.chunk_text(text, chunk_size=size, overlap=overlap,
                                 by=by) == JR.chunk_text(
                text, chunk_size=size, overlap=overlap, by=by)


def test_rag_pipeline_equals_jax():
    """One embed callable: the same chunks, the same retrieved chunk ids
    apart from score ties, scores within 1e-5, hybrid and dense."""
    docs = _docs(2, 120)
    tp = TR.RAGPipeline(embed=_embed, chunk_size=256, device="cpu")
    jp = JR.RAGPipeline(embed=_embed, chunk_size=256)
    tp.add_documents(docs[:80])
    jp.add_documents(docs[:80])
    tp.add_documents(docs[80:])
    jp.add_documents(docs[80:])
    assert tp.chunks == jp.chunks and tp.chunk_doc == jp.chunk_doc
    assert set(tp.build_seconds) == {"chunk", "embed", "index", "bm25"}
    rng = np.random.default_rng(3)
    for qi in rng.choice(len(docs), 12, replace=False):
        sents = docs[qi].split(". ")
        query = sents[int(rng.integers(len(sents)))]
        for kw in (dict(hybrid=True), dict(hybrid=True, weight=0.0),
                   dict(hybrid=False)):
            got = tp.retrieve(query, k=5, **kw)
            want = jp.retrieve(query, k=5, **kw)
            gs = np.asarray([r["score"] for r in got])
            ws = np.asarray([r["score"] for r in want])
            np.testing.assert_allclose(gs, ws, rtol=ATOL, atol=ATOL)
            for g, w in zip(got, want):
                if g["chunk_id"] != w["chunk_id"]:    # a tie may swap
                    assert abs(g["score"] - w["score"]) <= ATOL
                    continue
                assert (g["chunk"], g["doc_id"]) == (w["chunk"], w["doc_id"])
            if kw.get("weight") == 0.0:              # text only: self-hit
                assert got[0]["doc_id"] == qi
    assert tp.context(query, k=2) == jp.context(query, k=2)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

def test_client_services_on_the_cpu():
    c = Client(device="cpu")
    assert c.llm is c.llm and [p.name for p in c.llm.providers] == ["local"]
    assert c.embeddings is c.embeddings and c.embeddings.router is c.llm
    v = c.embeddings.embed_text("hello world")
    assert v.shape == (256,) and abs(float(np.linalg.norm(v)) - 1) < 1e-4
    assert c.llm.complete("one. two.").startswith("[extractive-local]")
    rag = c.rag(chunk_size=128)
    assert rag.device == c.device
    docs = _docs(5, 12)
    rag.add_documents(docs)
    assert rag._index.device.type == rag._bm25.device.type == "cpu"
    hits = rag.retrieve(docs[3].split(". ")[2], k=3, weight=0.0)
    assert hits[0]["doc_id"] == 3 and len(hits) == 3
    assert isinstance(rag.context("w1 w2", k=2), str)
