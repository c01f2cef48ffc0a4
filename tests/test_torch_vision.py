"""The ViT encoder: the torch port against the JAX package and HF
``ViTModel`` on the same inputs (CPU, random init, no download)."""

import jax
import numpy as np
import pytest
import torch

import neurondb_tpu.ml.vision as JV
from neurondb_tpu_torch.ml import vision as TV
from neurondb_tpu_torch.ml.params import params_from_jax
from neurondb_tpu_torch.ops.kernels import flash_attention as FA

ATOL = 1e-5
# the flash path (its plain version on the CPU: bf16 products at the
# kernel's KV tile) against the f32 softmax. q, k, v and p round to bf16
# (2^-8 relative); the pre-LN residual stream is not normalized, so
# hidden values reach ~3 and an attention output's rounding moves them
# by up to ~1.6e-3 here: 5e-3 (the JAX flash tests allow 5e-2 per
# attention call against the oracle)
FLASH_TOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hf():
    """The tiny HF ViT of tests/test_vision.py and both packages' trees."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.ViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, image_size=32, patch_size=8)
    torch.manual_seed(0)
    model = transformers.ViTModel(cfg).eval()
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return (model, JV.params_from_hf_vit_state_dict(state),
            TV.params_from_hf_vit_state_dict(state, device="cpu"))


def _images(seed, B, side):
    return np.random.default_rng(seed).standard_normal(
        (B, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [False, True])
def test_vit_encode_equals_jax(hf, use_flash):
    _, jp, tp = hf
    assert (tp["patch"], tp["image_size"], tp["channels"]) == (8, 32, 3)
    img = _images(0, 3, 32)
    want = JV.vit_encode(jp, img, heads=4)
    got = TV.vit_encode(tp, img, heads=4, use_flash=use_flash)
    tol = FLASH_TOL if use_flash else ATOL
    for key in ("hidden", "pooled", "cls", "mean_pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=tol, atol=tol, err_msg=key)


def test_vit_encode_equals_hf(hf):
    model, _, tp = hf
    img = _images(1, 2, 32)
    with torch.no_grad():
        ref = model(torch.from_numpy(img.transpose(0, 3, 1, 2)))
    got = TV.vit_encode(tp, img, heads=4)
    np.testing.assert_allclose(got["hidden"].numpy(),
                               ref.last_hidden_state.numpy(), rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got["pooled"].numpy(),
                               ref.pooler_output.numpy(), rtol=1e-4,
                               atol=2e-4)


def test_patchify_is_the_conv_layout():
    img = _images(2, 1, 16)
    w = np.random.default_rng(3).standard_normal((5, 3, 8, 8)).astype(
        np.float32)
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(img.transpose(0, 3, 1, 2)), torch.from_numpy(w),
        stride=8).flatten(2).transpose(1, 2)
    pt = TV.patchify(torch.from_numpy(img), 8)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(JV.patchify(img, 8)))
    torch.testing.assert_close(
        pt @ torch.from_numpy(w.transpose(2, 3, 1, 0).reshape(192, 5)), conv,
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("side", [0, 5, 24, 64])
def test_preprocess_raw_bytes_equals_jax(side):
    raw = np.random.default_rng(side).integers(
        0, 255, (side, side, 3), dtype=np.uint8).tobytes() + b"\x07"
    got = TV.preprocess_image(raw, 32)
    assert got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, JV.preprocess_image(raw, 32))


def test_vision_encoder_carried_from_jax():
    """A JAX random-init tree carried with params_from_jax: the encoder's
    embeddings equal JAX's; deterministic, per-image distinct."""
    jp = JV.init_vit_params(jax.random.PRNGKey(3))
    jenc = JV.VisionEncoder(jp, heads=4)
    tenc = TV.VisionEncoder(params_from_jax(jax.tree_util.tree_map(
        lambda a: a if isinstance(a, int) else np.asarray(a), jp)), heads=4,
        device="cpu")
    assert tenc.image_size == 64 and not tenc.use_flash
    img = _images(4, 3, 64)
    e1 = tenc.embed_images(img)
    np.testing.assert_allclose(e1, jenc.embed_images(img), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_array_equal(e1, tenc.embed_images(img))
    assert e1.shape == (3, 256) and not np.allclose(e1[0], e1[1])
    raw = np.random.default_rng(5).integers(0, 255, (16, 16, 3),
                                            dtype=np.uint8).tobytes()
    np.testing.assert_allclose(tenc.embed_bytes(raw), jenc.embed_bytes(raw),
                               rtol=ATOL, atol=ATOL)


def test_vision_encoder_flash_and_npz(tmp_path, hf):
    """use_flash routes through flash_attention (the plain version on CPU
    tensors: no launch); from_npz loads an HF-named export."""
    model, jp, _ = hf
    np.savez(tmp_path / "vit.npz", **{k: v.detach().numpy()
                                      for k, v in model.state_dict().items()})
    enc = TV.VisionEncoder.from_npz(str(tmp_path / "vit.npz"), heads=4,
                                    use_flash=True, device="cpu")
    before = dict(FA.LAUNCHES)
    img = _images(6, 2, 32)
    got = enc.embed_images(img)
    assert FA.LAUNCHES == before
    np.testing.assert_allclose(got, np.asarray(JV.vit_encode(
        jp, img, heads=4)["cls"]), rtol=FLASH_TOL, atol=FLASH_TOL)
    assert TV.VisionEncoder(seed=0, device="cpu").embed_images(
        _images(7, 1, 64)).shape == (1, 256)
