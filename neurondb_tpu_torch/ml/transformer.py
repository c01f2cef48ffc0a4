"""Transformer encoders: local embedding and cross-encoder inference.

Counterpart of ``neurondb_tpu/ml/transformer.py``:

- ``HashTokenizer``: token ids by FNV-1a hashing (no vocab file), over
  ``search/bm25.py``'s ``tokenize``; 0 = pad, 1 = cls, 2 = sep;
- ``init_encoder_params`` / ``encode`` / ``Encoder``: the compact pre-LN
  encoder (no biases, LayerNorm eps 1e-6, tanh-approximate GELU, masked
  mean pool then ``tanh(. @ pooler)``);
- ``TextEmbedder`` and ``CrossEncoder`` over it; ``PretrainedEmbedder``
  and ``PretrainedCrossEncoder`` over an export directory (weights.npz,
  vocab.txt, config.json) with WordPiece and the BERT encoder;
- ``default_embedder`` / ``default_cross_encoder``: the pretrained
  models when ``NEURONDB_TORCH_WEIGHTS`` / ``NEURONDB_TORCH_CROSS_WEIGHTS``
  name an export directory, else the offline test doubles.

Every model takes a ``device`` (default from ``config.device``: the card
when one is present) and ``use_flash`` (default: on when that device is
CUDA, where attention runs the hand-written kernel; the JAX package's
default is on for a TPU). The cross-encoders score long doc lists, and
``PretrainedEmbedder`` embeds long text lists (one shot in the JAX
package), in sub-batches without a host sync between them: ids go up from pinned host
buffers with ``non_blocking`` copies, so tokenizing sub-batch i + 1
overlaps the device's encode of sub-batch i, and the results come back
once at the end. Unlike the JAX package, the tail sub-batch is not
padded (eager PyTorch compiles nothing per shape), and an empty doc or
text list gives an empty result instead of an error.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from neurondb_tpu_torch.config import ENV_PREFIX, resolve_device
from neurondb_tpu_torch.ml.bert import (BertModel, _attention, _ln,
                                       load_bert_npz)
from neurondb_tpu_torch.ml.params import ParamTree, tree_map
from neurondb_tpu_torch.ml.tokenizer import WordPieceTokenizer
from neurondb_tpu_torch.search.bm25 import tokenize


# --------------------------------------------------------------------------
# tokenizer (word-piece-free, hash-vocab)
# --------------------------------------------------------------------------

def _stable_token_hash(token: str) -> int:
    """FNV-1a over utf-8: the same in every process (Python's hash() is
    salted per process)."""
    h = 1469598103934665603
    for b in token.encode("utf-8", "ignore"):
        h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    """Deterministic token ids by hashing into a fixed id space,
    reserving 0 = pad, 1 = cls, 2 = sep."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def _tid(self, token: str) -> int:
        return 3 + (_stable_token_hash(token) % (self.vocab_size - 3))

    def encode(self, text: str, max_len: int = 128) -> np.ndarray:
        toks = tokenize(text, stem=False, stopwords=False)[: max_len - 2]
        ids = [1] + [self._tid(t) for t in toks] + [2]
        out = np.zeros(max_len, np.int32)
        out[: len(ids)] = ids
        return out

    def encode_pair(self, a: str, b: str, max_len: int = 256) -> np.ndarray:
        ta = tokenize(a, stem=False, stopwords=False)
        tb = tokenize(b, stem=False, stopwords=False)
        ids = [1] + [self._tid(t) for t in ta] + [2]
        ids += [self._tid(t) for t in tb] + [2]
        ids = ids[:max_len]
        out = np.zeros(max_len, np.int32)
        out[: len(ids)] = ids
        return out


# --------------------------------------------------------------------------
# pre-LN encoder
# --------------------------------------------------------------------------

def init_encoder_params(seed: int = 0, *, vocab_size=30522, hidden=256,
                        layers=4, heads=4, ff=1024, max_len=512,
                        device=None) -> Dict:
    """Random init (N(0, 0.02), unit LayerNorm gains) from ``seed``; the
    JAX package's layout and shapes, not its numbers."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    def ln():
        return {"g": torch.ones(hidden), "b": torch.zeros(hidden)}

    p = {
        "tok_emb": rnd(vocab_size, hidden),
        "pos_emb": rnd(max_len, hidden),
        "ln_f": ln(),
        "pooler": rnd(hidden, hidden),
        "cls_head": rnd(hidden, 1),
        "layers": [],
    }
    for _ in range(layers):
        p["layers"].append({
            "wq": rnd(hidden, hidden), "wk": rnd(hidden, hidden),
            "wv": rnd(hidden, hidden), "wo": rnd(hidden, hidden),
            "w1": rnd(hidden, ff), "w2": rnd(ff, hidden),
            "ln1": ln(), "ln2": ln(),
        })
    return tree_map(lambda t: t.to(device), p)


_EPS = 1e-6           # the pre-LN encoder's LayerNorm eps


def encode(params: Dict, ids: torch.Tensor, *, heads: int = 4,
           use_flash: bool = False) -> Dict:
    """ids [B, S] -> {'hidden' [B, S, H], 'pooled' [B, H], 'score' [B]}."""
    ids = ids.long()
    B, S = ids.shape
    mask = ids > 0
    x = params["tok_emb"][ids] + params["pos_emb"][None, :S, :]
    for lyr in params["layers"]:
        h = _ln(x, lyr["ln1"]["g"], lyr["ln1"]["b"], _EPS)
        att = _attention(h @ lyr["wq"], h @ lyr["wk"], h @ lyr["wv"], mask,
                         heads=heads, use_flash=use_flash)
        x = x + att @ lyr["wo"]
        h = _ln(x, lyr["ln2"]["g"], lyr["ln2"]["b"], _EPS)
        x = x + F.gelu(h @ lyr["w1"], approximate="tanh") @ lyr["w2"]
    x = _ln(x, params["ln_f"]["g"], params["ln_f"]["b"], _EPS)
    # masked mean pool + tanh pooler (sentence-transformers style)
    w = mask[:, :, None].to(x.dtype)
    pooled = (x * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    pooled = torch.tanh(pooled @ params["pooler"])
    score = (pooled @ params["cls_head"])[:, 0]
    return {"hidden": x, "pooled": pooled, "score": score}


class Encoder(ParamTree):
    """``encode`` as an ``nn.Module`` over a parameter tree."""

    def __init__(self, params: Dict, *, heads: int):
        super().__init__(params)
        self.heads = heads

    def forward(self, ids, *, use_flash: bool = False) -> Dict:
        return encode(self.tree(), ids, heads=self.heads, use_flash=use_flash)


# --------------------------------------------------------------------------
# embedders and cross-encoders
# --------------------------------------------------------------------------

def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host int32 array on ``device``: to a card from a pinned buffer
    with a non-blocking copy (a pageable copy may wait on the stream)."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _normalize(emb: torch.Tensor) -> np.ndarray:
    """L2 rows on the host with a 1e-12 floor."""
    e = emb.cpu().numpy()
    return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)


def _pipelined(model, inputs: Callable[[int, int], tuple], n: int, bs: int,
               device: torch.device, use_flash: bool, key: str
               ) -> torch.Tensor:
    """The model's output ``key`` for items 0..n-1 (n > 0) in sub-batches
    of ``bs`` (one shot when ``bs`` is 0 or n <= bs), concatenated on the
    device. ``inputs(lo, hi)`` tokenizes items lo..hi-1 into host arrays;
    no sub-batch waits for the device."""
    step = bs if bs and n > bs else n
    outs = []
    for lo in range(0, n, step):
        arrays = inputs(lo, min(lo + step, n))
        out = model(*(_upload(a, device) for a in arrays), use_flash=use_flash)
        outs.append(out[key])              # queued on the device, no sync
    return torch.cat(outs)


def _pipelined_scores(model, inputs: Callable[[int, int], tuple], n: int,
                      bs: int, device: torch.device, use_flash: bool
                      ) -> np.ndarray:
    """Scores of docs 0..n-1 (``_pipelined``'s sub-batches) on the host."""
    if n == 0:
        return np.zeros(0, np.float32)
    return _pipelined(model, inputs, n, bs, device, use_flash,
                      "score").cpu().numpy()


def _use_flash(use_flash: Optional[bool], device: torch.device) -> bool:
    return device.type == "cuda" if use_flash is None else use_flash


class TextEmbedder:
    """Sentence embedder over the pre-LN encoder (embed_text parity)."""

    def __init__(self, params: Optional[Dict] = None, *, dim: int = 256,
                 heads: int = 4, max_len: int = 128, seed: int = 0,
                 use_flash: Optional[bool] = None, device=None):
        self.device = resolve_device(device)
        if params is None:
            params = init_encoder_params(seed, hidden=dim)
        self.model = Encoder(params, heads=heads).to(self.device)
        self.heads = heads
        self.max_len = max_len
        self.tok = HashTokenizer(params["tok_emb"].shape[0])
        self.use_flash = _use_flash(use_flash, self.device)

    @property
    def params(self) -> Dict:
        return self.model.tree()

    @property
    def dim(self) -> int:
        return self.model.tok_emb.shape[1]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dim), np.float32)
        ids = np.stack([self.tok.encode(t, self.max_len) for t in texts])
        out = self.model(_upload(ids, self.device), use_flash=self.use_flash)
        return _normalize(out["pooled"])


class CrossEncoder:
    """(query, doc) pair scorer over the pre-LN encoder: the
    rerank_cross_encoder / rerank_flash backend. Sub-batches of ``batch``
    docs are pipelined against the device (module docstring)."""

    def __init__(self, params: Optional[Dict] = None, *, dim: int = 256,
                 heads: int = 4, max_len: int = 256, seed: int = 0,
                 use_flash: Optional[bool] = None, batch: int = 64,
                 device=None):
        self.device = resolve_device(device)
        if params is None:
            params = init_encoder_params(seed, hidden=dim)
        self.model = Encoder(params, heads=heads).to(self.device)
        self.heads = heads
        self.max_len = max_len
        self.batch = batch
        self.tok = HashTokenizer(params["tok_emb"].shape[0])
        self.use_flash = _use_flash(use_flash, self.device)

    @property
    def params(self) -> Dict:
        return self.model.tree()

    def __call__(self, query: str, docs: Sequence[str],
                 batch: Optional[int] = None) -> np.ndarray:
        def inputs(lo, hi):
            return (np.stack([self.tok.encode_pair(query, d, self.max_len)
                              for d in docs[lo:hi]]),)
        return _pipelined_scores(self.model, inputs, len(docs),
                                 self.batch if batch is None else batch,
                                 self.device, self.use_flash)


def _load_export(weights_dir: str, max_len: int, device):
    """(BertModel, WordPieceTokenizer, max_len) of an export directory."""
    with open(os.path.join(weights_dir, "config.json")) as f:
        cfg = json.load(f)
    params = load_bert_npz(os.path.join(weights_dir, "weights.npz"))
    model = BertModel(params, heads=int(cfg["heads"])).to(device)
    tok = WordPieceTokenizer.from_file(os.path.join(weights_dir, "vocab.txt"),
                                       lowercase=cfg.get("lowercase", True))
    return model, tok, min(max_len, int(cfg.get("max_len", 512)))


class PretrainedEmbedder:
    """Sentence embedder over exported weights (``scripts/export_hf.py``
    output dir: weights.npz + vocab.txt + config.json): WordPiece, the
    BERT encoder, masked mean pooling and an L2 norm. Texts are encoded
    in sub-batches of ``batch`` (pipelined like the cross-encoders'; a
    RAG corpus's tens of thousands of chunks in one shot would not fit a
    card), where the JAX embedder encodes every text in one call; the
    embeddings equal the one-shot ones within 1e-5."""

    def __init__(self, weights_dir: str, *, max_len: int = 128,
                 use_flash: Optional[bool] = None, batch: int = 1024,
                 device=None):
        self.device = resolve_device(device)
        self.model, self.tok, self.max_len = _load_export(
            weights_dir, max_len, self.device)
        self.heads = self.model.heads
        self.batch = batch
        self.use_flash = _use_flash(use_flash, self.device)

    @property
    def params(self) -> Dict:
        return self.model.tree()

    @property
    def dim(self) -> int:
        return self.model.tok_emb.shape[1]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dim), np.float32)
        def inputs(lo, hi):
            return self.tok.encode_batch(list(texts[lo:hi]), self.max_len)
        return _normalize(_pipelined(self.model, inputs, len(texts),
                                     self.batch, self.device, self.use_flash,
                                     "mean_pooled"))


class PretrainedCrossEncoder:
    """(query, doc) scorer over exported sequence-classification weights
    (``export_hf.py --cross-encoder``), pipelined like ``CrossEncoder``."""

    def __init__(self, weights_dir: str, *, max_len: int = 256,
                 use_flash: Optional[bool] = None, batch: int = 64,
                 device=None):
        self.device = resolve_device(device)
        self.model, self.tok, self.max_len = _load_export(
            weights_dir, max_len, self.device)
        self.heads = self.model.heads
        self.batch = batch
        self.use_flash = _use_flash(use_flash, self.device)

    @property
    def params(self) -> Dict:
        return self.model.tree()

    def __call__(self, query: str, docs: Sequence[str],
                 batch: Optional[int] = None) -> np.ndarray:
        def inputs(lo, hi):
            enc = [self.tok.encode_pair(query, d, self.max_len)
                   for d in docs[lo:hi]]
            return (np.stack([e[0] for e in enc]),
                    np.stack([e[1] for e in enc]))
        return _pipelined_scores(self.model, inputs, len(docs),
                                 self.batch if batch is None else batch,
                                 self.device, self.use_flash)


def _export_dir(knob: str) -> Optional[str]:
    """The export directory named by ``NEURONDB_TORCH_<knob>``, if it
    holds weights.npz."""
    wdir = os.environ.get(ENV_PREFIX + knob)
    if wdir and os.path.isfile(os.path.join(wdir, "weights.npz")):
        return wdir
    return None


def default_embedder(*, dim: int = 256, seed: int = 0, device=None):
    """PretrainedEmbedder when NEURONDB_TORCH_WEIGHTS names an export dir;
    otherwise the deterministic offline TextEmbedder."""
    wdir = _export_dir("WEIGHTS")
    if wdir:
        return PretrainedEmbedder(wdir, device=device)
    return TextEmbedder(dim=dim, seed=seed, device=device)


def default_cross_encoder(*, dim: int = 256, seed: int = 0, device=None):
    """PretrainedCrossEncoder when NEURONDB_TORCH_CROSS_WEIGHTS names an
    export dir; otherwise the offline CrossEncoder (the choice the JAX
    package's local LLM provider makes)."""
    wdir = _export_dir("CROSS_WEIGHTS")
    if wdir:
        return PretrainedCrossEncoder(wdir, device=device)
    return CrossEncoder(dim=dim, seed=seed, device=device)


def load_params_npz(path: str, device=None) -> Dict:
    """Encoder params exported as a flat npz (layer keys
    'layers.<i>.<name>') -> the parameter tree."""
    p: Dict = {"layers": []}
    layer_keys: Dict[int, Dict] = {}
    with np.load(path) as data:
        for k in data.files:
            a = torch.tensor(np.array(data[k], np.float32), device=device)
            if k.startswith("layers."):
                _, i, rest = k.split(".", 2)
                layer_keys.setdefault(int(i), {})[rest] = a
            elif "." in k:
                top, sub = k.split(".", 1)
                p.setdefault(top, {})[sub] = a
            else:
                p[k] = a
    for i in sorted(layer_keys):
        lyr: Dict = {}
        for kk, vv in layer_keys[i].items():
            if "." in kk:
                top, sub = kk.split(".", 1)
                lyr.setdefault(top, {})[sub] = vv
            else:
                lyr[kk] = vv
        p["layers"].append(lyr)
    return p
