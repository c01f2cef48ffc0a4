"""ViT image encoder, compatible with HF ``ViTModel`` weights.

Counterpart of ``neurondb_tpu/ml/vision.py``: patchify -> one [P*P*C, H]
projection GEMM (HF's stride-P Conv2d as a matmul) -> CLS + position
embeddings -> pre-LN transformer layers (LayerNorm eps 1e-12, exact erf
GELU, where GPT-2 takes 1e-5 and the tanh form) -> final LayerNorm and
the tanh pooler. Parameters are the JAX package's tree, weights [in,
out], with its int entries ``patch``, ``image_size`` and ``channels``.

- ``vit_encode(params, images, *, heads, use_flash)``: ``use_flash`` runs
  attention through ``ops/kernels/flash_attention.flash_attention`` (no
  mask: the CUDA kernel on a card tensor, its plain version on the CPU),
  else ``attention_reference``. The JAX module computes a plain softmax
  (no kernel); flash computes the same function with bf16 products;
- ``VisionEncoder``: the weights in a ``ParamTree`` on ``device``;
  ``use_flash=None`` means on when that device is CUDA (the encoders'
  rule);
- ``init_vit_params`` (``torch.Generator``: the JAX layout, not its
  numbers), ``params_from_hf_vit_state_dict``, ``load_vit_npz``,
  ``patchify``, ``preprocess_image`` (PIL imported lazily; raw square
  RGB bytes without it).
"""

from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from neurondb_tpu_torch.config import resolve_device
from neurondb_tpu_torch.ml.bert import _attention, _ln
from neurondb_tpu_torch.ml.params import ParamTree, tree_map
from neurondb_tpu_torch.ml.transformer import _use_flash

_EPS = 1e-12                                     # HF ViTLayerNorm eps
_META_KEYS = ("patch", "image_size", "channels")


def init_vit_params(seed: int = 0, *, hidden=256, layers=4, heads=4,
                    ff=1024, patch=16, image_size=64, channels=3,
                    device=None) -> Dict:
    """Random init (N(0, 0.02) weights, zero biases, unit LayerNorm
    gains) from ``seed``; ``heads`` is accepted for parity."""
    n_patches = (image_size // patch) ** 2
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    def ln():
        return {"g": torch.ones(hidden), "b": torch.zeros(hidden)}

    p: Dict = {
        "cls": rnd(1, 1, hidden), "pos_emb": rnd(1, n_patches + 1, hidden),
        "patch_w": rnd(patch * patch * channels, hidden),
        "patch_b": torch.zeros(hidden), "final_ln": ln(),
        "pooler": {"w": rnd(hidden, hidden), "b": torch.zeros(hidden)},
        "layers": [],
    }
    for _ in range(layers):
        p["layers"].append({
            "ln1": ln(),
            "wq": rnd(hidden, hidden), "bq": torch.zeros(hidden),
            "wk": rnd(hidden, hidden), "bk": torch.zeros(hidden),
            "wv": rnd(hidden, hidden), "bv": torch.zeros(hidden),
            "wo": rnd(hidden, hidden), "bo": torch.zeros(hidden),
            "ln2": ln(),
            "w1": rnd(hidden, ff), "b1": torch.zeros(ff),
            "w2": rnd(ff, hidden), "b2": torch.zeros(hidden),
        })
    p = tree_map(lambda t: t.to(device), p)
    p.update(patch=patch, image_size=image_size, channels=channels)
    return p


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N_patches, patch*patch*C]: rows row-major over
    the patch grid, pixel-row-major within a patch, channel-last within
    a pixel, as Conv2d(stride=patch) on [B, C, H, W] followed by
    flatten(2).transpose(1, 2) orders them."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def vit_encode(params: Dict, images, *, heads: int = 4,
               use_flash: bool = False) -> Dict:
    """images [B, H, W, C] float (already normalized), on the weights'
    device -> {'hidden' [B, N+1, D], 'pooled' (CLS tanh pooler), 'cls'
    (final-LN CLS), 'mean_pooled'}."""
    images = torch.as_tensor(images, dtype=torch.float32,
                             device=params["patch_w"].device)
    with torch.no_grad():
        x = patchify(images, int(params["patch"])) @ params["patch_w"] \
            + params["patch_b"]
        B, N, D = x.shape
        x = torch.cat([params["cls"].expand(B, 1, D), x], dim=1) \
            + params["pos_emb"][:, :N + 1]
        for lyr in params["layers"]:
            h = _ln(x, lyr["ln1"]["g"], lyr["ln1"]["b"], _EPS)   # pre-LN
            att = _attention(h @ lyr["wq"] + lyr["bq"],
                             h @ lyr["wk"] + lyr["bk"],
                             h @ lyr["wv"] + lyr["bv"], None, heads=heads,
                             use_flash=use_flash)
            x = x + att @ lyr["wo"] + lyr["bo"]
            h2 = _ln(x, lyr["ln2"]["g"], lyr["ln2"]["b"], _EPS)
            x = x + F.gelu(h2 @ lyr["w1"] + lyr["b1"]) @ lyr["w2"] + lyr["b2"]
        x = _ln(x, params["final_ln"]["g"], params["final_ln"]["b"], _EPS)
        pooled = torch.tanh(x[:, 0] @ params["pooler"]["w"]
                            + params["pooler"]["b"])
    return {"hidden": x, "pooled": pooled, "cls": x[:, 0],
            "mean_pooled": x[:, 1:].mean(1)}


# --------------------------------------------------------------------------
# HF state-dict mapping (ViTModel; scripts/export_hf.py --vision writes)
# --------------------------------------------------------------------------

_VIT_LAYER_MAP = {
    "layernorm_before.weight": ("ln1.g", False),
    "layernorm_before.bias": ("ln1.b", False),
    "attention.attention.query.weight": ("wq", True),
    "attention.attention.query.bias": ("bq", False),
    "attention.attention.key.weight": ("wk", True),
    "attention.attention.key.bias": ("bk", False),
    "attention.attention.value.weight": ("wv", True),
    "attention.attention.value.bias": ("bv", False),
    "attention.output.dense.weight": ("wo", True),
    "attention.output.dense.bias": ("bo", False),
    "layernorm_after.weight": ("ln2.g", False),
    "layernorm_after.bias": ("ln2.b", False),
    "intermediate.dense.weight": ("w1", True),
    "intermediate.dense.bias": ("b1", False),
    "output.dense.weight": ("w2", True),
    "output.dense.bias": ("b2", False),
}


def params_from_hf_vit_state_dict(state: Dict[str, np.ndarray],
                                  device=None) -> Dict:
    """Map an HF ViTModel state dict. The Conv2d projection [H, C, P, P]
    becomes the [P*P*C, H] patch GEMM ([P, P, C, H], patchify's row
    layout); Linear weights [out, in] are transposed."""
    flat: Dict[str, np.ndarray] = {}
    nlayers = 0
    meta = {"channels": 3}
    for name, arr in state.items():
        if name.startswith("vit."):
            name = name[4:]
        a = np.asarray(arr)
        if name == "embeddings.cls_token":
            flat["cls"] = a
        elif name == "embeddings.position_embeddings":
            flat["pos_emb"] = a
        elif name == "embeddings.patch_embeddings.projection.weight":
            h, c, p, _ = a.shape
            flat["patch_w"] = a.transpose(2, 3, 1, 0).reshape(p * p * c, h)
            meta.update(patch=int(p), channels=int(c))
        elif name == "embeddings.patch_embeddings.projection.bias":
            flat["patch_b"] = a
        elif name == "layernorm.weight":
            flat["final_ln.g"] = a
        elif name == "layernorm.bias":
            flat["final_ln.b"] = a
        elif name == "pooler.dense.weight":
            flat["pooler.w"] = a.T
        elif name == "pooler.dense.bias":
            flat["pooler.b"] = a
        elif name.startswith("encoder.layer."):
            _, _, i, rest = name.split(".", 3)
            if rest in _VIT_LAYER_MAP:
                tgt, transpose = _VIT_LAYER_MAP[rest]
                flat[f"layers.{i}.{tgt}"] = a.T if transpose else a
                nlayers = max(nlayers, int(i) + 1)
    hidden = flat["cls"].shape[-1]
    flat.setdefault("pooler.w", np.eye(hidden, dtype=np.float32))
    flat.setdefault("pooler.b", np.zeros(hidden, np.float32))
    n_patches = flat["pos_emb"].shape[1] - 1
    meta["image_size"] = int(round(n_patches ** 0.5)) * meta["patch"]

    def t(key):
        return torch.tensor(np.array(flat[key], np.float32), device=device)

    def pair(prefix, a="g", b="b"):
        return {a: t(f"{prefix}.{a}"), b: t(f"{prefix}.{b}")}

    p: Dict = {"cls": t("cls"), "pos_emb": t("pos_emb"),
               "patch_w": t("patch_w"), "patch_b": t("patch_b"),
               "final_ln": pair("final_ln"),
               "pooler": pair("pooler", "w", "b"), "layers": [], **meta}
    for i in range(nlayers):
        lyr = {n: t(f"layers.{i}.{n}")
               for n in "wq bq wk bk wv bv wo bo w1 b1 w2 b2".split()}
        lyr["ln1"] = pair(f"layers.{i}.ln1")
        lyr["ln2"] = pair(f"layers.{i}.ln2")
        p["layers"].append(lyr)
    return p


def load_vit_npz(path: str, device=None) -> Dict:
    with np.load(path) as data:
        return params_from_hf_vit_state_dict({k: data[k] for k in data.files},
                                             device=device)


# --------------------------------------------------------------------------
# image preprocessing and the embedder
# --------------------------------------------------------------------------

def _decode_pil(image_bytes: bytes, size: int) -> Optional[np.ndarray]:
    """[size, size, 3] in [0, 1] through PIL, or None where PIL is
    missing or the bytes are no image it reads."""
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        img = Image.open(io.BytesIO(image_bytes)).convert("RGB")
    except (OSError, ValueError):
        return None
    return np.asarray(img.resize((size, size)), np.float32) / 255.0


def preprocess_image(image_bytes: bytes, size: int, mean: float = 0.5,
                     std: float = 0.5) -> np.ndarray:
    """Decode (PIL when importable, raw square RGB bytes otherwise),
    resize to [size, size] (nearest neighbour without PIL), scale to
    [0, 1] and normalize: HF ViTImageProcessor's defaults (mean = std =
    0.5)."""
    arr = _decode_pil(image_bytes, size)
    if arr is None:
        flat = np.frombuffer(image_bytes, np.uint8)
        side = int((len(flat) // 3) ** 0.5)
        if side == 0:
            arr = np.zeros((size, size, 3), np.float32)
        else:
            arr = flat[: side * side * 3].reshape(
                side, side, 3).astype(np.float32) / 255.0
            ix = np.arange(size) * side // size
            arr = arr[ix][:, ix]
    return (arr - mean) / std


class VisionEncoder:
    """Image -> embedding (the final-LN CLS vector). With real ViT weights
    (``from_npz``) a semantic image embedding; without, a deterministic
    random-init ViT (hidden 256, 4 layers, 4 heads, 64-pixel images),
    structure-preserving but not semantic."""

    def __init__(self, params: Optional[Dict] = None, *, heads: int = 12,
                 seed: int = 0, use_flash: Optional[bool] = None,
                 device=None):
        self.device = resolve_device(device)
        if params is None:
            params = init_vit_params(seed)
            heads = 4
        self.meta = {k: int(params[k]) for k in _META_KEYS}
        self.model = ParamTree({k: v for k, v in params.items()
                                if k not in _META_KEYS}).to(self.device)
        self.heads = heads
        self.use_flash = _use_flash(use_flash, self.device)

    @classmethod
    def from_npz(cls, path: str, *, heads: Optional[int] = None,
                 use_flash: Optional[bool] = None,
                 device=None) -> "VisionEncoder":
        p = load_vit_npz(path)
        h = heads or max(1, p["cls"].shape[-1] // 64)
        return cls(p, heads=h, use_flash=use_flash, device=device)

    @property
    def params(self) -> Dict:
        return {**self.model.tree(), **self.meta}

    @property
    def image_size(self) -> int:
        return self.meta["image_size"]

    def embed_images(self, batches) -> np.ndarray:
        """[B, H, W, C] normalized float images -> [B, D] embeddings."""
        out = vit_encode(self.params, batches, heads=self.heads,
                         use_flash=self.use_flash)
        return out["cls"].cpu().numpy()

    def embed_bytes(self, image_bytes: bytes) -> np.ndarray:
        arr = preprocess_image(image_bytes, self.image_size)
        return self.embed_images(arr[None])[0]
