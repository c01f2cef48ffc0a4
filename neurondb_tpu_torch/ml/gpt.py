"""GPT-2 causal LM (HF ``GPT2LMHeadModel`` weights): prefill, KV-cache
decode, W8A8 weights, an int8 KV cache and sampling on the device.

Counterpart of ``neurondb_tpu/ml/gpt.py``, the local completion engine
of the LLM router's ``LocalProvider``. Parameters are the JAX package's
tree (``wte``, ``wpe``, ``ln_f``, ``blocks`` of ``ln1`` / ``w_qkv`` /
``b_qkv`` / ``w_o`` / ``b_o`` / ``ln2`` / ``w_fc`` / ``b_fc`` / ``w_pr`` /
``b_pr``, weights [in, out] as HF's Conv1D stores them), so a tree
carried across with ``ml.params.params_from_jax`` computes the same
function; int8 weights are ``(codes int8 [in, out], scale f32 [out])``
tuples, as there. ``GPT2LM`` holds its tree in a ``ParamTree`` on its
``device``.

- **Prefill** (``_prefill``, ``gpt_logits``): one batched causal forward
  over LEFT-padded prompts (``lens`` valid suffix lengths; position ids
  count valid tokens only), attention as f32 einsum + softmax, as the JAX
  package computes it (no Pallas kernel there, no kernel here: the flash
  kernel has no causal mask).
- **Decode** (``generate_ids``): the JAX ``lax.scan`` becomes a Python
  loop whose state stays on the device: the sampled tokens, the eos
  latch ``done`` and the step index are device tensors, the KV cache
  ``[B, heads, P, dh]`` per layer is written in place at ``S + step``
  (``index_copy_``; the JAX package's update is functional), no step
  copies from the host (the attention scale is a host float, the
  sampling constants 0-d tensors filled on the card), and nothing reads
  the device until the one device-to-host copy of the tokens at the end
  (``GPT2LM.complete_batch``): the host never waits for the card inside
  the loop. The last step's forward, whose logits no token uses, is not
  run.
- **W8A8** (``_mm`` on a ``(codes, scale)`` weight): activations are
  quantized per row (max-abs / 127, round half to even) and the int32
  accumulate comes from ``int8_matmul``: on a card ``torch._int_mm``,
  which takes more than 16 rows and a depth and width that are multiples
  of 8, so the operands are padded with zero rows and columns (decode at
  B <= 16, the lm head's 50,257 columns) and the result sliced; on the
  CPU ``int8_matmul_plain``, the same sums in f64 (exact: every partial
  sum is far below 2^53). Never a float GEMM on the codes: an f32 sum of
  127^2-sized products loses integers past 2^24, which the MLP's
  K = 3,072 passes (127^2 x 3,072 ~ 4.96e7).
- **int8 KV cache** (``kv_int8``; per-token, per-head max-abs codes and
  f32 scales) and **``int8_dot``** (both decode attention products on
  the raw codes, scales folded as rank-1 rescales): torch has no int8
  batched GEMM, so the code products run as f32 einsums whose every
  partial sum is an exact integer: q . k sums dh <= 1,040 products of at
  most 127^2 (below 2^24), and a . v sums over the cache positions in
  chunks of ``INT8_DOT_CHUNK`` = 1,024 (127^2 x 1,024 < 2^24; P reaches
  1,056 at GPT-2's context), each chunk's sum converted to int32 and the
  chunks added in int32. Exact in TF32 too: int8 values fit its mantissa.
- **Dtypes** follow JAX's promotion: an f32 x bf16 product is taken in
  f32 (``torch.matmul`` refuses mixed operands, so the narrower side is
  cast), ``preferred_element_type=f32`` einsums take f32 operands, the
  int8 cache dequantizes as a bf16 product of codes and scales, and the
  residual stream turns f32 after the first attention block as in the
  JAX package.
- **Sampling** (``_sample``): greedy is ``argmax`` (first maximum);
  otherwise ``_filter_logits`` gives the temperature-scaled, top-k
  (``topk_largest``: ties to the lowest index, as ``lax.top_k``) and
  top-p filtered logits, bit for bit with the JAX package's, and a
  Gumbel-max draw from a ``torch.Generator`` picks among them (the
  algorithm of ``jax.random.categorical``, not its random bits).

Divergences from the JAX package, recorded:

- the random draws: the same seed gives the same tokens in each package,
  not the same tokens in both;
- a direct ``generate_ids`` whose positions pass ``max_len`` (the wpe
  table) or whose cache writes pass ``cache_len`` raises ``ValueError``
  (JAX clamps the gather and the update); ``GPT2LM.complete_batch``
  keeps every position in range, as in JAX;
- ``init_gpt_params`` draws from ``torch.Generator``: the layout and
  shapes of the JAX init, not its numbers.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from neurondb_tpu_torch.config import resolve_device
from neurondb_tpu_torch.ml.params import ParamTree, tree_map
from neurondb_tpu_torch.ops.topk import topk_largest

_NEG = float(torch.finfo(torch.float32).min)
INT8_DOT_CHUNK = 1024      # cache positions per exact f32 chunk (< 2^24)
_EPS = 1e-5                # GPT-2 LayerNorm eps


def init_gpt_params(seed: int = 0, *, vocab_size=50257, hidden=768,
                    layers=12, heads=12, max_len=1024,
                    ff: Optional[int] = None, device=None) -> Dict:
    """Random init (N(0, 0.02) weights, zero biases, unit LayerNorm
    gains) from ``seed``; the JAX package's layout and shapes, not its
    numbers. ``heads`` is accepted for parity (the tree has no head axis)."""
    ff = 4 * hidden if ff is None else ff
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    def ln():
        return {"g": torch.ones(hidden), "b": torch.zeros(hidden)}

    p: Dict = {"wte": rnd(vocab_size, hidden), "wpe": rnd(max_len, hidden),
               "ln_f": ln(), "blocks": []}
    for _ in range(layers):
        p["blocks"].append({
            "ln1": ln(),
            "w_qkv": rnd(hidden, 3 * hidden), "b_qkv": torch.zeros(3 * hidden),
            "w_o": rnd(hidden, hidden), "b_o": torch.zeros(hidden),
            "ln2": ln(),
            "w_fc": rnd(hidden, ff), "b_fc": torch.zeros(ff),
            "w_pr": rnd(ff, hidden), "b_pr": torch.zeros(hidden),
        })
    return tree_map(lambda t: t.to(device), p)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b correctly rounded on every device (CUDA turns a division by
    a Python scalar into a product with its reciprocal)."""
    return a / torch.full_like(a, b)


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype (JAX: f32 x bf16 -> f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> the exact int32 sums, through f64."""
    return (xq.double() @ wq.double()).to(torch.int32)


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N]: ``_int_mm_padded`` on a
    card, ``int8_matmul_plain`` on the CPU."""
    if xq.device.type == "cuda":
        return _int_mm_padded(xq, wq)
    return int8_matmul_plain(xq, wq)


def _int_mm_padded(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` (int32 accumulation) on operands padded with
    zeros to more than 16 rows and to a depth and width that are
    multiples of 8, which it requires on a card (zero rows and columns
    add nothing), then sliced."""
    M, K = xq.shape
    N = wq.shape[1]
    Mp = M if M > 16 else 32
    Kp, Np = _pad_to(K, 8), _pad_to(N, 8)
    if (Mp, Kp) != (M, K):
        xq = F.pad(xq, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        wq = F.pad(wq, (0, Np - N, 0, Kp - K))
    out = torch._int_mm(xq.contiguous(), wq.contiguous())
    return out[:M, :N] if (Mp, Np) != (M, N) else out


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (codes [..., K], f32 scales [..., 1])."""
    sx = torch.clamp(_div(x.abs().amax(-1, keepdim=True), 127.0).float(),
                     min=1e-12)
    xq = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return xq, sx


def w8a8_accumulate(x: torch.Tensor, wq: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W8A8 product's integer part: (int32 accumulate [..., N], the
    activations' f32 row scales [..., 1])."""
    xq, sx = _quant_rows(x)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq)
    return acc.reshape(*x.shape[:-1], wq.shape[1]), sx


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a float weight, or W8A8 against an int8
    ``(codes [in, out], scale f32 [out])`` pair: the int32 accumulate
    rescaled by the row scale times the column scale."""
    if isinstance(w, tuple):
        wq, sw = w
        acc, sx = w8a8_accumulate(x, wq)
        return acc.float() * sx * sw
    return _matmul(x, w)


def _lm_head(x: torch.Tensor, params: Dict) -> torch.Tensor:
    lm = params.get("lm_head")
    if lm is not None:
        return _mm(x, lm)
    return _matmul(x, params["wte"].T)           # tied lm head


def _quant_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    w = w.float()
    s = torch.clamp(_div(w.abs().amax(0), 127.0), min=1e-12)
    wq = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return wq.contiguous(), s


def quantize_gpt_params(params: Dict, *, lm_head: bool = True) -> Dict:
    """Symmetric per-output-channel int8 weights for W8A8 (``_mm``): the
    block matmul weights and, by default, a detached int8 copy of the
    tied lm head become ``(int8 codes, f32 scale)`` pairs; embeddings,
    biases and LayerNorm parameters keep their float dtype."""
    out = dict(params)
    out["blocks"] = [
        {**blk, **{t: _quant_cols(blk[t])
                   for t in ("w_qkv", "w_o", "w_fc", "w_pr")}}
        for blk in params["blocks"]]
    if lm_head:
        out["lm_head"] = _quant_cols(params["wte"].T)
    return out


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def _cache_dtype(params: Dict) -> torch.dtype:
    """bf16 for serving weights (bf16, f16 or int8), else the weights'
    dtype (f32 keeps the research path exact against the no-cache
    forward)."""
    w = params["blocks"][0]["w_qkv"]
    if isinstance(w, tuple) or w.dtype in (torch.bfloat16, torch.float16):
        return torch.bfloat16
    return w.dtype


def _quant_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token, per-head symmetric int8: t [..., dh] -> (codes int8
    [..., dh], f32 scales [...])."""
    t = t.float()
    s = torch.clamp(_div(t.abs().amax(-1), 127.0), min=1e-12)
    return torch.round(t / s[..., None]).to(torch.int8), s


def _dequant_kv(entry):
    """A cache entry as values: an int8 pair dequantizes as the bf16
    product of codes and scales."""
    if isinstance(entry, tuple):
        codes, s = entry
        return codes.to(torch.bfloat16) * s.to(torch.bfloat16)[..., None]
    return entry


def _cache_update(entry, t: torch.Tensor, pos):
    """Write one token's [B, H, 1, dh] KV at sequence index ``pos`` (an
    int or a 0-d device tensor) into a cache entry, in place; returns
    the entry."""
    idx = torch.as_tensor(pos, device=t.device).reshape(1).long()
    if isinstance(entry, tuple):
        codes, sc = entry
        tc, ts = _quant_kv(t)
        codes.index_copy_(2, idx, tc)
        sc.index_copy_(2, idx, ts)
        return entry
    entry.index_copy_(2, idx, t.to(entry.dtype))
    return entry


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ln(x, g, b, eps=_EPS):
    """LayerNorm with the population variance as ``jnp.var`` takes it
    (the mean of the squared deviations)."""
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g + b


def _gelu(x):                                   # HF "gelu_new" (tanh)
    return F.gelu(x, approximate="tanh")


def _scale(dh: int) -> float:
    """1 / sqrt(dh) in f32, as the JAX package computes it, as a Python
    float: a product with it is the f32 product on every device, and
    nothing is copied to the card (a copy from the host waits for it)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _split_heads(x, heads):
    B, S, H = x.shape
    return x.reshape(B, S, heads, H // heads).transpose(1, 2)


def _mlp(x, blk):
    h = _ln(x, blk["ln2"]["g"], blk["ln2"]["b"])
    return x + _mm(_gelu(_mm(h, blk["w_fc"]) + blk["b_fc"]),
                   blk["w_pr"]) + blk["b_pr"]


def _forward(params: Dict, ids: torch.Tensor, lens: Optional[torch.Tensor],
             heads: int, kv=None) -> torch.Tensor:
    """Causal forward of LEFT-padded ids [B, S] -> final-LN hidden
    [B, S, H]; ``kv(layer_k, layer_v)`` receives each layer's [B, heads,
    S, dh] keys and values."""
    ids = ids.long()
    B, S = ids.shape
    dev = ids.device
    if lens is None:
        valid = torch.ones((B, S), dtype=torch.bool, device=dev)
        pos = torch.arange(S, device=dev).expand(B, S)
    else:
        valid = torch.arange(S, device=dev)[None, :] >= \
            (S - lens.long())[:, None]
        pos = torch.clamp(torch.cumsum(valid, 1) - 1, min=0)
    x = params["wte"][ids] + params["wpe"][pos]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=dev))
    mask = causal[None, None] & valid[:, None, None, :]
    dh = x.shape[-1] // heads
    scale = _scale(dh)
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"]["g"], blk["ln1"]["b"])
        qkv = _mm(h, blk["w_qkv"]) + blk["b_qkv"]
        qh, kh, vh = (_split_heads(t, heads)
                      for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
        if kv is not None:
            kv(kh, vh)
        s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
        a = torch.softmax(torch.where(mask, s, _NEG), dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", a, vh.float())
        att = o.transpose(1, 2).reshape(B, S, heads * dh)
        x = x + _mm(att, blk["w_o"]) + blk["b_o"]
        x = _mlp(x, blk)
    return _ln(x, params["ln_f"]["g"], params["ln_f"]["b"])


@torch.no_grad()
def gpt_logits(params: Dict, ids, *, heads: int,
               lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full causal forward: ids [B, S] -> logits [B, S, V]. ``lens``
    marks LEFT-padded prompts (row b's valid tokens occupy [S - lens[b],
    S)); pads are masked out of attention and position ids count valid
    tokens only, HF's attention_mask + position_ids convention."""
    dev = params["wte"].device
    ids = torch.as_tensor(ids, device=dev)
    if lens is not None:
        lens = torch.as_tensor(lens, device=dev)
    return _lm_head(_forward(params, ids, lens, heads), params)


def _prefill(params, ids, lens, heads, cache_len, kv_int8=False):
    """Forward over the prompt -> (the last position's logits [B, V],
    {"k": [...], "v": [...]}: per-layer caches padded to ``cache_len``,
    int8 ``(codes, scales)`` pairs with ``kv_int8``)."""
    S = ids.shape[1]
    cdt = _cache_dtype(params)
    ks, vs = [], []

    def keep(kh, vh):
        for out, t in ((ks, kh), (vs, vh)):
            t = F.pad(t, (0, 0, 0, cache_len - S))
            out.append(_quant_kv(t) if kv_int8 else t.to(cdt))

    x = _forward(params, ids, lens, heads, kv=keep)
    return _lm_head(x[:, -1], params), {"k": ks, "v": vs}


def _int8_scores(qq: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """int8 q [B, H, dh] . int8 k [B, H, P, dh] -> int32 [B, H, P]: f32
    sums of at most dh products of 127^2, exact for dh <= 1,040."""
    return torch.einsum("bhd,bhkd->bhk", qq.float(), kc.float()).to(torch.int32)


def _int8_mix(aq: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """int8 a [B, H, P] . int8 v [B, H, P, dh] -> int32 [B, H, dh]: f32
    sums over ``INT8_DOT_CHUNK`` positions (exact), added in int32."""
    out = None
    for c in range(0, aq.shape[-1], INT8_DOT_CHUNK):
        part = torch.einsum("bhk,bhkd->bhd",
                            aq[..., c:c + INT8_DOT_CHUNK].float(),
                            vc[:, :, c:c + INT8_DOT_CHUNK].float()
                            ).to(torch.int32)
        out = part if out is None else out + part
    return out


def _decode_step(params, cache, token, step, S, lens, heads,
                 int8_dot=False):
    """One-token forward attending to the cache. ``step`` (an int or a
    0-d device tensor) counts decoded tokens: the new KV lands at index
    S + step, and key j is visible iff j >= S - len (the left-padded
    prompt region) or S <= j <= S + step. The cache is updated in place
    and returned with the logits.

    ``int8_dot`` (int8 caches): both attention products on the raw cache
    codes; the per-token key scales rescale the scores, the value scales
    fold into the attention weights before those are quantized, so the
    added rounding is q's and the weights' int8 rounding."""
    B = token.shape[0]
    dev = token.device
    pos = lens + step
    x = params["wte"][token] + params["wpe"][pos]
    H = x.shape[-1]
    dh = H // heads
    scale = _scale(dh)
    e0 = cache["k"][0]
    P = (e0[0] if isinstance(e0, tuple) else e0).shape[2]
    j = torch.arange(P, device=dev)
    at = S + torch.as_tensor(step, device=dev)
    visible = (j[None, :] >= (S - lens)[:, None]) & (j[None, :] <= at)
    for li, blk in enumerate(params["blocks"]):
        h = _ln(x, blk["ln1"]["g"], blk["ln1"]["b"])
        qkv = _mm(h, blk["w_qkv"]) + blk["b_qkv"]
        q, k, v = qkv.split(H, dim=-1)
        qh = q.reshape(B, heads, dh)
        ck = _cache_update(cache["k"][li], k.reshape(B, heads, 1, dh), at)
        cv = _cache_update(cache["v"][li], v.reshape(B, heads, 1, dh), at)
        if int8_dot and isinstance(ck, tuple):
            kc, ksc = ck
            sq = torch.clamp(_div(qh.abs().amax(-1), 127.0), min=1e-12)
            qq = torch.round(qh / sq[..., None]).to(torch.int8)
            s = _int8_scores(qq, kc).float() * (sq[..., None] * ksc) * scale
        else:
            s = torch.einsum("bhd,bhkd->bhk", qh.float(),
                             _dequant_kv(ck).float()) * scale
        a = torch.softmax(torch.where(visible[:, None, :], s, _NEG), dim=-1)
        if int8_dot and isinstance(cv, tuple):
            vc, vsc = cv
            aw = a * vsc
            sa = torch.clamp(_div(aw.abs().amax(-1), 127.0), min=1e-12)
            aq = torch.round(aw / sa[..., None]).to(torch.int8)
            o = _int8_mix(aq, vc).float() * sa[..., None]
        else:
            o = torch.einsum("bhk,bhkd->bhd", a, _dequant_kv(cv).float())
        x = x + _mm(o.reshape(B, H), blk["w_o"]) + blk["b_o"]
        x = _mlp(x, blk)
    x = _ln(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return _lm_head(x, params), cache


# ---------------------------------------------------------------------------
# sampling and the decode loop
# ---------------------------------------------------------------------------

def _filter_logits(logits: torch.Tensor, temperature: float, top_k: int,
                   top_p: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The logits a sampled draw picks from: scaled by the temperature
    (floor 1e-6), with ``top_k`` the k largest (sorted, ties to the
    lowest index) and their vocabulary ids, else the whole vocabulary;
    entries past the top-p mass (the smallest sorted prefix whose mass
    reaches ``top_p``, at least one token) at f32's minimum."""
    # 0-d device tensors filled on the card: a division by a host scalar
    # would become a product with its reciprocal, and a copy from the
    # host would wait for the card at every step
    f32 = dict(dtype=torch.float32, device=logits.device)
    t = torch.full((), float(max(np.float32(temperature), np.float32(1e-6))),
                   **f32)
    p = torch.full((), float(top_p), **f32)
    if top_k:
        vals, idxs = topk_largest(logits, top_k)
        lg = vals / t
        pr = torch.softmax(lg, dim=-1)
        keep = (torch.cumsum(pr, dim=-1) - pr) < p
        return torch.where(keep, lg, _NEG), idxs
    lg = logits / t
    srt = torch.sort(lg, dim=-1, descending=True).values
    pr = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(pr, dim=-1) - pr) < p
    cutoff = torch.where(keep, srt, torch.inf).amin(-1, keepdim=True)
    return torch.where(lg < cutoff, _NEG, lg), None


def _categorical(gen: torch.Generator, lg: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(lg), by Gumbel-max (the algorithm
    of ``jax.random.categorical``) on ``gen``'s uniform bits."""
    u = torch.rand(lg.shape, generator=gen, device=lg.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)


def _sample(logits, gen, temperature, top_k, top_p, do_sample):
    """Greedy (``argmax``, the first maximum) without ``do_sample``;
    otherwise a draw among ``_filter_logits``."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    lg, idxs = _filter_logits(logits, temperature, top_k, top_p)
    choice = _categorical(gen, lg)
    if idxs is None:
        return choice
    return torch.gather(idxs, -1, choice[..., None])[..., 0]


def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


@torch.no_grad()
def generate_ids(params: Dict, ids, lens, seed: Union[int, torch.Generator]
                 = 0, *, heads: int, max_new: int, cache_len: int,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: int = -1,
                 kv_int8: bool = False, int8_dot: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids [B, S] LEFT-padded prompts (lens [B] valid suffix lengths) ->
    (tokens [B, max_new], n_valid [B]) on the parameters' device. One
    prefill, then one decode step a token with no host sync: rows that
    emit ``eos_id`` keep emitting it (n_valid counts through the first
    eos). ``temperature <= 0`` is greedy; ``seed`` (or a generator on the
    parameters' device) drives the draws otherwise. ``kv_int8`` stores
    the cache as int8 codes and per-token f32 scales; ``int8_dot``
    (implies it) runs both attention products on the codes."""
    dev = params["wte"].device
    lens_h = np.asarray(lens.cpu() if isinstance(lens, torch.Tensor)
                        else lens).reshape(-1)
    ids = torch.as_tensor(np.asarray(ids) if not isinstance(ids, torch.Tensor)
                          else ids, device=dev).long()
    B, S = ids.shape
    max_len = params["wpe"].shape[0]
    last_pos = int(lens_h.max()) - 1 + max(max_new - 1, 0)
    if last_pos >= max_len:
        raise ValueError(f"positions reach {last_pos}, past the {max_len}-"
                         f"entry position table (keep len + max_new <= "
                         f"{max_len})")
    if cache_len < S + max(max_new - 1, 0):
        raise ValueError(f"cache_len {cache_len} < prompt width {S} + "
                         f"{max(max_new - 1, 0)} decoded positions")
    lens = torch.as_tensor(lens_h, device=dev).long()
    gen = _generator(seed, dev)
    kv_int8 = bool(kv_int8) or bool(int8_dot)
    do_sample = float(temperature) > 0.0
    logits, cache = _prefill(params, ids, lens, heads, cache_len,
                             kv_int8=kv_int8)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    toks = torch.empty((B, max_new), dtype=torch.long, device=dev)
    step = torch.zeros((), dtype=torch.long, device=dev)
    for i in range(max_new):
        tok = _sample(logits, gen, temperature, top_k, top_p, do_sample)
        tok = torch.where(done, eos_id, tok)
        done |= tok == eos_id
        toks[:, i] = tok
        if i + 1 < max_new:
            logits, cache = _decode_step(params, cache, tok, step, S, lens,
                                         heads, int8_dot=bool(int8_dot))
            step += 1
    if eos_id >= 0:
        before_eos = torch.cumsum((toks == eos_id).int(), dim=1) <= 1
        n_valid = before_eos.sum(1)
    else:
        n_valid = torch.full((B,), max_new, dtype=torch.long, device=dev)
    return toks, n_valid


# ---------------------------------------------------------------------------
# HF weight mapping (GPT2LMHeadModel / GPT2Model state dicts)
# ---------------------------------------------------------------------------

_HF_BLOCK = {
    "ln_1.weight": "ln1.g", "ln_1.bias": "ln1.b",
    "ln_2.weight": "ln2.g", "ln_2.bias": "ln2.b",
    "attn.c_attn.weight": "w_qkv", "attn.c_attn.bias": "b_qkv",
    "attn.c_proj.weight": "w_o", "attn.c_proj.bias": "b_o",
    "mlp.c_fc.weight": "w_fc", "mlp.c_fc.bias": "b_fc",
    "mlp.c_proj.weight": "w_pr", "mlp.c_proj.bias": "b_pr",
}


def params_from_hf_state_dict(state: Dict[str, np.ndarray],
                              device=None) -> Dict:
    """HF Conv1D weights are stored [in, out] and load untransposed;
    ``lm_head.weight`` is tied to wte and skipped; the causal-mask
    buffers drop out through the key map. f32 tensors on ``device``."""
    flat: Dict[str, np.ndarray] = {}
    nblk = 0
    for name, arr in state.items():
        if name.startswith("transformer."):
            name = name[len("transformer."):]
        if name == "lm_head.weight":
            continue
        a = np.asarray(arr)
        if name in ("wte.weight", "wpe.weight"):
            flat[name.split(".")[0]] = a
        elif name.startswith("ln_f."):
            flat["ln_f." + ("g" if name.endswith("weight") else "b")] = a
        elif name.startswith("h."):
            _, i, rest = name.split(".", 2)
            nblk = max(nblk, int(i) + 1)
            key = _HF_BLOCK.get(rest)
            if key is not None:
                flat[f"h.{i}.{key}"] = a

    def t(key):
        return torch.tensor(np.array(flat[key], np.float32), device=device)

    p: Dict = {"wte": t("wte"), "wpe": t("wpe"),
               "ln_f": {"g": t("ln_f.g"), "b": t("ln_f.b")}, "blocks": []}
    for i in range(nblk):
        blk = {n: t(f"h.{i}.{n}")
               for n in "w_qkv b_qkv w_o b_o w_fc b_fc w_pr b_pr".split()}
        for ln in ("ln1", "ln2"):
            blk[ln] = {"g": t(f"h.{i}.{ln}.g"), "b": t(f"h.{i}.{ln}.b")}
        p["blocks"].append(blk)
    return p


def load_gpt_npz(path: str, device=None) -> Dict:
    with np.load(path) as data:
        return params_from_hf_state_dict({k: data[k] for k in data.files},
                                         device=device)


# ---------------------------------------------------------------------------
# service-facing wrapper
# ---------------------------------------------------------------------------

def _pow2_at_least(n: int, floor: int = 64) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


KV_INT8_MIN_BATCH = 64     # kv_dtype="auto": the JAX package's crossover


class GPT2LM:
    """Tokenizer + parameters + generate on ``device``: the local
    ``complete`` engine. ``from_dir`` loads a ``scripts/export_hf.py
    --gpt`` export (weights.npz, vocab.json, merges.txt, config.json).

    ``dtype``: None keeps f32 (an f32 KV cache, exact against the
    no-cache forward); ``"bfloat16"`` / ``"float16"`` cast the float
    parameters (bf16 cache); ``"int8"`` quantizes the matmul weights for
    W8A8 (bf16 cache). ``kv_dtype``: None, ``"int8"`` (an int8 cache) or
    ``"auto"`` (int8 from batch ``KV_INT8_MIN_BATCH`` = 64 up, the JAX
    package's crossover, kept as it is)."""

    def __init__(self, params: Dict, tokenizer, heads: int,
                 eos_id: Optional[int] = None, dtype=None,
                 kv_dtype: Optional[str] = None, device=None):
        if kv_dtype not in (None, "auto", "int8"):
            raise ValueError(f"kv_dtype must be None/'auto'/'int8', "
                             f"got {kv_dtype!r}")
        self.kv_int8 = kv_dtype == "int8"
        self.kv_auto = kv_dtype == "auto"
        self.device = resolve_device(device)
        params = tree_map(lambda t: t.to(self.device), params)
        if dtype == "int8":
            params = quantize_gpt_params(params)
        elif dtype is not None:
            dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
            params = tree_map(lambda a: a.to(dt) if a.dtype == torch.float32
                              else a, params)
        self.model = ParamTree(params)
        self.params = self.model.tree()
        self.tok = tokenizer
        self.heads = heads
        self.eos_id = tokenizer.eos_id if eos_id is None else eos_id
        self.max_len = int(self.params["wpe"].shape[0])

    @classmethod
    def from_dir(cls, path: str, dtype="bfloat16",
                 kv_dtype: Optional[str] = None, device=None) -> "GPT2LM":
        """``dtype="bfloat16"`` (default) halves the weight bytes; pass
        None for exact f32."""
        from neurondb_tpu_torch.ml.bpe import BPETokenizer
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        tok = BPETokenizer.from_dir(path)
        params = load_gpt_npz(os.path.join(path, "weights.npz"))
        return cls(params, tok, heads=int(cfg["heads"]), dtype=dtype,
                   kv_dtype=kv_dtype, device=device)

    @classmethod
    def random_init(cls, *, vocab_size=257, hidden=64, layers=2, heads=2,
                    max_len=256, seed=0, dtype=None,
                    kv_dtype: Optional[str] = None, device=None) -> "GPT2LM":
        from neurondb_tpu_torch.ml.bpe import BPETokenizer
        tok = BPETokenizer.byte_fallback()
        params = init_gpt_params(seed, vocab_size=max(vocab_size, len(tok)),
                                 hidden=hidden, layers=layers, heads=heads,
                                 max_len=max_len)
        return cls(params, tok, heads=heads, dtype=dtype, kv_dtype=kv_dtype,
                   device=device)

    def _kv_for_batch(self, batch: int) -> bool:
        """int8 KV when pinned, and under "auto" from batch 64 up."""
        return self.kv_int8 or (self.kv_auto and batch >= KV_INT8_MIN_BATCH)

    def complete(self, prompt: str, *, max_tokens: int = 64,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0) -> str:
        return self.complete_batch(
            [self.tok.encode(prompt)], max_tokens=max_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed)[0]

    def complete_batch(self, id_lists: Sequence[List[int]], *,
                       max_tokens: int = 64, temperature: float = 0.0,
                       top_k: int = 0, top_p: float = 1.0,
                       seed: int = 0) -> List[str]:
        """Left-pads the prompts to a power of two (at least 64), keeps
        each prompt's tail so that decode positions stay inside the
        position table (``max_tokens`` clamped below ``max_len``), and
        copies the tokens to the host once."""
        max_tokens = min(int(max_tokens), self.max_len - 1)
        keep = max(self.max_len - max_tokens, 1)
        id_lists = [list(x)[-keep:] for x in id_lists]
        B = len(id_lists)
        lens = np.asarray([max(len(x), 1) for x in id_lists], np.int64)
        S = _pow2_at_least(int(lens.max()))
        pad_id = self.eos_id if self.eos_id is not None else 0
        ids = np.full((B, S), pad_id, np.int64)
        for b, row in enumerate(id_lists):
            row = row or [pad_id]
            ids[b, S - len(row):] = row
        cache_len = S + _pow2_at_least(max_tokens, 32)
        toks, n_valid = generate_ids(
            self.params, ids, lens, seed, heads=self.heads,
            max_new=max_tokens, cache_len=cache_len,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_id=-1 if self.eos_id is None else int(self.eos_id),
            kv_int8=self._kv_for_batch(B))
        out = torch.cat([toks, n_valid[:, None]], dim=1).cpu().numpy()
        return [self.tok.decode(out[b, :out[b, -1]]) for b in range(B)]
