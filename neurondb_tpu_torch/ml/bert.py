"""BERT-architecture encoder, compatible with HF ``BertModel`` weights.

Counterpart of ``neurondb_tpu/ml/bert.py``: post-LN layers with q/k/v/o
and FFN biases, token-type embeddings, an embedding LayerNorm (eps
1e-12, population variance), exact (erf) GELU, a CLS pooler and a
one-logit classifier head. Parameters are the JAX package's tree (see
``ml/params.py``), so a tree carried across computes the same function.

- ``bert_encode(params, ids, type_ids, *, heads, use_flash)``: the
  functional encoder; ``use_flash`` runs attention through
  ``ops/kernels/flash_attention.py`` (the CUDA kernel on a card tensor),
  else ``attention_reference`` (masked logits at -1e30 where the JAX
  package's inline softmax takes ``finfo(f32).min``: the same f32
  softmax, fully masked rows included);
- ``BertModel``: the same as an ``nn.Module`` over a parameter tree;
- ``init_bert_params`` (random init from a seed, ``torch.Generator``),
  ``params_from_hf_state_dict``, ``load_bert_npz`` (an export of
  ``scripts/export_hf.py``: a flat npz under the HF names).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from neurondb_tpu_torch.ml.params import ParamTree, tree_map
from neurondb_tpu_torch.ops.kernels.flash_attention import (
    attention_reference, flash_attention)


_EPS = 1e-12          # HF BertLayerNorm eps


def init_bert_params(seed: int = 0, *, vocab_size=30522, hidden=256,
                     layers=4, heads=4, ff=1024, max_len=512, type_vocab=2,
                     device=None) -> Dict:
    """Random init (N(0, 0.02) weights, zero biases, unit LayerNorm
    gains) from ``seed``; the JAX package's layout and shapes, not its
    numbers."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    def ln():
        return {"g": torch.ones(hidden), "b": torch.zeros(hidden)}

    p = {
        "tok_emb": rnd(vocab_size, hidden),
        "pos_emb": rnd(max_len, hidden),
        "type_emb": rnd(type_vocab, hidden),
        "emb_ln": ln(),
        "pooler": {"w": rnd(hidden, hidden), "b": torch.zeros(hidden)},
        "cls_head": {"w": rnd(hidden, 1), "b": torch.zeros(1)},
        "layers": [],
    }
    for _ in range(layers):
        p["layers"].append({
            "wq": rnd(hidden, hidden), "bq": torch.zeros(hidden),
            "wk": rnd(hidden, hidden), "bk": torch.zeros(hidden),
            "wv": rnd(hidden, hidden), "bv": torch.zeros(hidden),
            "wo": rnd(hidden, hidden), "bo": torch.zeros(hidden),
            "ln1": ln(),
            "w1": rnd(hidden, ff), "b1": torch.zeros(ff),
            "w2": rnd(ff, hidden), "b2": torch.zeros(hidden),
            "ln2": ln(),
        })
    return tree_map(lambda t: t.to(device), p)


def _ln(x, g, b, eps):
    """LayerNorm over the last axis with the population variance."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, correction=0, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _attention(q, k, v, mask, *, heads: int, use_flash: bool):
    """Multi-head attention of [B, S, heads * Dh] projections, key mask
    [B, S]: the flash kernel's wrapper or the full-matrix reference."""
    B, S, Hd = q.shape
    dh = Hd // heads
    qh, kh, vh = (t.reshape(B, S, heads, dh).transpose(1, 2)
                  for t in (q, k, v))
    attend = flash_attention if use_flash else attention_reference
    return attend(qh, kh, vh, mask).transpose(1, 2).reshape(B, S, Hd)


def bert_encode(params: Dict, ids: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None, *,
                heads: int = 4, use_flash: bool = False) -> Dict:
    """ids [B, S] (0 = pad) -> {'hidden', 'pooled' (CLS + tanh),
    'mean_pooled' (masked mean, sentence-transformers style), 'score'}."""
    B, S = ids.shape
    ids = ids.long()
    mask = ids > 0
    type_ids = torch.zeros_like(ids) if type_ids is None else type_ids.long()
    x = (params["tok_emb"][ids] + params["pos_emb"][None, :S, :]
         + params["type_emb"][type_ids])
    x = _ln(x, params["emb_ln"]["g"], params["emb_ln"]["b"], _EPS)
    for lyr in params["layers"]:
        att = _attention(x @ lyr["wq"] + lyr["bq"], x @ lyr["wk"] + lyr["bk"],
                         x @ lyr["wv"] + lyr["bv"], mask, heads=heads,
                         use_flash=use_flash)
        x = _ln(x + att @ lyr["wo"] + lyr["bo"],
                lyr["ln1"]["g"], lyr["ln1"]["b"], _EPS)
        ffn = F.gelu(x @ lyr["w1"] + lyr["b1"]) @ lyr["w2"] + lyr["b2"]
        x = _ln(x + ffn, lyr["ln2"]["g"], lyr["ln2"]["b"], _EPS)
    w = mask[:, :, None].to(x.dtype)
    mean_pooled = (x * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    pooled = torch.tanh(x[:, 0] @ params["pooler"]["w"]
                        + params["pooler"]["b"])
    score = (pooled @ params["cls_head"]["w"] + params["cls_head"]["b"])[:, 0]
    return {"hidden": x, "pooled": pooled, "mean_pooled": mean_pooled,
            "score": score}


class BertModel(ParamTree):
    """``bert_encode`` as an ``nn.Module`` over a parameter tree."""

    def __init__(self, params: Dict, *, heads: int):
        super().__init__(params)
        self.heads = heads

    def forward(self, ids, type_ids=None, *, use_flash: bool = False) -> Dict:
        return bert_encode(self.tree(), ids, type_ids, heads=self.heads,
                           use_flash=use_flash)


# --------------------------------------------------------------------------
# HF state-dict mapping (scripts/export_hf.py writes, this loads)
# --------------------------------------------------------------------------

_HF_MAP = {
    "embeddings.word_embeddings.weight": ("tok_emb", False),
    "embeddings.position_embeddings.weight": ("pos_emb", False),
    "embeddings.token_type_embeddings.weight": ("type_emb", False),
    "embeddings.LayerNorm.weight": ("emb_ln.g", False),
    "embeddings.LayerNorm.bias": ("emb_ln.b", False),
    "pooler.dense.weight": ("pooler.w", True),
    "pooler.dense.bias": ("pooler.b", False),
}

_HF_LAYER_MAP = {
    "attention.self.query.weight": ("wq", True),
    "attention.self.query.bias": ("bq", False),
    "attention.self.key.weight": ("wk", True),
    "attention.self.key.bias": ("bk", False),
    "attention.self.value.weight": ("wv", True),
    "attention.self.value.bias": ("bv", False),
    "attention.output.dense.weight": ("wo", True),
    "attention.output.dense.bias": ("bo", False),
    "attention.output.LayerNorm.weight": ("ln1.g", False),
    "attention.output.LayerNorm.bias": ("ln1.b", False),
    "intermediate.dense.weight": ("w1", True),
    "intermediate.dense.bias": ("b1", False),
    "output.dense.weight": ("w2", True),
    "output.dense.bias": ("b2", False),
    "output.LayerNorm.weight": ("ln2.g", False),
    "output.LayerNorm.bias": ("ln2.b", False),
}


def params_from_hf_state_dict(state: Dict[str, np.ndarray],
                              device=None) -> Dict:
    """Map an HF BertModel state dict (name -> array; torch Linear
    weights are [out, in] and get transposed) to the parameter tree.
    Keys may carry a leading 'bert.'; the cross-encoder classifier head
    ('classifier.weight/bias') maps to cls_head when present."""
    flat: Dict[str, np.ndarray] = {}
    nlayers = 0
    for name, arr in state.items():
        if name.startswith("bert."):
            name = name[5:]
        a = np.asarray(arr)
        if name in _HF_MAP:
            tgt, transpose = _HF_MAP[name]
            flat[tgt] = a.T if transpose else a
        elif name.startswith("encoder.layer."):
            _, _, i, rest = name.split(".", 3)
            if rest in _HF_LAYER_MAP:
                tgt, transpose = _HF_LAYER_MAP[rest]
                flat[f"layers.{i}.{tgt}"] = a.T if transpose else a
                nlayers = max(nlayers, int(i) + 1)
        elif name == "classifier.weight":
            flat["cls_head.w"] = a.T
        elif name == "classifier.bias":
            flat["cls_head.b"] = a
    hidden = flat["tok_emb"].shape[1]
    flat.setdefault("pooler.w", np.eye(hidden, dtype=np.float32))
    flat.setdefault("pooler.b", np.zeros(hidden, np.float32))
    flat.setdefault("cls_head.w", np.zeros((hidden, 1), np.float32))
    flat.setdefault("cls_head.b", np.zeros(1, np.float32))

    def t(key):
        return torch.tensor(np.array(flat[key], np.float32), device=device)

    def pair(prefix, a="g", b="b"):
        return {a: t(f"{prefix}.{a}"), b: t(f"{prefix}.{b}")}

    p: Dict = {
        "tok_emb": t("tok_emb"), "pos_emb": t("pos_emb"),
        "type_emb": t("type_emb"), "emb_ln": pair("emb_ln"),
        "pooler": pair("pooler", "w", "b"),
        "cls_head": pair("cls_head", "w", "b"), "layers": [],
    }
    for i in range(nlayers):
        lyr = {n: t(f"layers.{i}.{n}")
               for n in "wq bq wk bk wv bv wo bo w1 b1 w2 b2".split()}
        lyr["ln1"] = pair(f"layers.{i}.ln1")
        lyr["ln2"] = pair(f"layers.{i}.ln2")
        p["layers"].append(lyr)
    return p


def load_bert_npz(path: str, device=None) -> Dict:
    """Load params exported by scripts/export_hf.py (flat npz with the
    HF names, straight from the state dict)."""
    with np.load(path) as data:
        return params_from_hf_state_dict({k: data[k] for k in data.files},
                                         device=device)
