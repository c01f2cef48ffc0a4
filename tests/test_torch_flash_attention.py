"""The port's flash attention against the JAX package's.

``flash_attention_plain`` does the CUDA kernel's arithmetic tile by tile
with the KV tile as an argument; here it is held to the Pallas kernel in
interpret mode at the same KV tile, and to the full-matrix oracle at the
JAX tests' tolerances (tests/test_flash_attention.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neurondb_tpu.ops.pallas import flash_attention as JFA
from neurondb_tpu_torch.ops.kernels import flash_attention as FA

# plain vs Pallas at the same KV tile: f32 sums in another order. With
# bf16 products both round p at the same places, but a p within f32 noise
# of a bf16 rounding boundary may round one step (2^-8 relative) apart,
# which moves an output by up to 2^-8 * (p / l) * |v_j|: seen at 1.2e-4
# on these inputs, so bf16 allows 1e-3 (the bf16 error against the
# oracle is ~5e-3).
TOL = {False: 1e-5, True: 1e-3}
# vs the oracle: the JAX tests' tolerances (f32 2e-3, bf16 5e-2)
REF_TOL = {False: 2e-3, True: 5e-2}


def _qkv(seed, B, H, S, Dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, S, Dh)).astype(np.float32)
                 for _ in range(3))


def _ragged_mask(B, S, lens):
    mask = np.ones((B, S), np.int32)
    for b, n in enumerate(lens):
        mask[b, n:] = 0
    return mask


def _pallas(q, k, v, mask, *, bf16, tiles):
    return np.asarray(JFA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), interpret=True,
        bf16=bf16, tiles=tiles))


def _plain(q, k, v, mask, *, bf16, kv_tile):
    return FA.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), bf16=bf16,
        kv_tile=kv_tile).numpy()


def _reference(q, k, v, mask):
    return FA.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,H,S,Dh,tile,lens", [
    (2, 2, 256, 64, 64, (100, 50)),       # ragged lengths across KV tiles
    (2, 2, 256, 64, 128, None),           # no mask: the specialisation
    (1, 2, 200, 32, 64, None),            # S not a tile multiple
    (2, 1, 130, 128, 64, (130, 65)),      # one key past a tile boundary
    (1, 3, 1, 64, 64, None),              # a single token
])
def test_plain_matches_pallas_at_the_same_tile(bf16, B, H, S, Dh, tile, lens):
    q, k, v = _qkv(S + Dh + tile, B, H, S, Dh)
    mask = None if lens is None else _ragged_mask(B, S, lens)
    want = _pallas(q, k, v, mask, bf16=bf16, tiles=(tile, tile))
    got = _plain(q, k, v, mask, bf16=bf16, kv_tile=tile)
    np.testing.assert_allclose(got, want, rtol=TOL[bf16], atol=TOL[bf16])
    np.testing.assert_allclose(got, _reference(q, k, v, mask),
                               rtol=REF_TOL[bf16], atol=REF_TOL[bf16])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("S,tiles,masked", [
    (2560, (512, 2048), True),    # the large measured tiles, mask at 1900
    (640, (512, 512), False),     # S between tile sizes (the JAX default)
])
def test_plain_matches_pallas_large_and_between_tiles(bf16, S, tiles, masked):
    """tests/test_flash_attention.py:97-129: multi-tile accumulation with
    a ragged mask crossing KV tiles, and S between the tile sizes."""
    q, k, v = _qkv(S, 1, 1, S, 64)
    mask = _ragged_mask(1, S, (1900,)) if masked else None
    want = _pallas(q, k, v, mask, bf16=bf16, tiles=tiles)
    got = _plain(q, k, v, mask, bf16=bf16, kv_tile=tiles[1])
    np.testing.assert_allclose(got, want, rtol=TOL[bf16], atol=TOL[bf16])
    np.testing.assert_allclose(got, _reference(q, k, v, mask),
                               rtol=REF_TOL[bf16], atol=REF_TOL[bf16])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("S,kv_tile", [(100, 64), (256, 64), (77, 32)])
def test_fully_masked_row_is_the_mean_of_v(bf16, S, kv_tile):
    """A batch row whose every key is masked averages v over its S real
    keys, as attention_reference gives; the Pallas kernel averages over
    its padded length instead (ROADMAP queue 3), so the oracle is the
    reference."""
    q, k, v = _qkv(S, 2, 2, S, 32)
    mask = _ragged_mask(2, S, (0, S // 3))
    got = _plain(q, k, v, mask, bf16=bf16, kv_tile=kv_tile)
    ref = _reference(q, k, v, mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=REF_TOL[bf16],
                               atol=REF_TOL[bf16])
    vr = v.astype(np.float32)
    if bf16:
        vr = torch.from_numpy(v).bfloat16().float().numpy()
    np.testing.assert_allclose(got[0], np.broadcast_to(
        vr[0].mean(1, keepdims=True), got[0].shape), rtol=1e-5, atol=1e-5)


def test_pallas_fully_masked_row_averages_its_padding():
    """The reference-side quirk itself: with S = 100 padded to 128, the
    Pallas kernel's fully masked row is sum(v) / 128, not the mean."""
    q, k, v = _qkv(1, 1, 1, 100, 64)
    mask = np.zeros((1, 100), np.int32)
    got = _pallas(q, k, v, mask, bf16=False, tiles=(128, 128))
    np.testing.assert_allclose(got[0, 0, 0], v[0, 0].sum(0) / 128,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("chunk", [128, 64, 1])
def test_query_tile_does_not_change_the_numbers(bf16, chunk):
    """At the kernel's KV tile the plain version over query rows in
    chunks (the kernel's 128-row query tile, a 64-row tile, one row)
    gives the output of the whole: only the KV tile fixes the rounding of
    p, so the query tile is free. q and k lie on a grid of quarters in
    [-1, 1], so Q K^T is exact in f32 and the CPU matmul's order for a
    single row cannot move a p across a bf16 rounding step."""
    S = 300                               # a ragged last chunk at 128, 64
    q, k, v = _qkv(11, 2, 2, S, 64)
    q, k = (np.clip(np.round(a * 2) / 4, -1, 1).astype(np.float32)
            for a in (q, k))
    mask = _ragged_mask(2, S, (S, 130))
    whole = _plain(q, k, v, mask, bf16=bf16, kv_tile=FA.KV_TILE)
    parts = np.concatenate(
        [_plain(np.ascontiguousarray(q[:, :, i:i + chunk]), k, v, mask,
                bf16=bf16, kv_tile=FA.KV_TILE) for i in range(0, S, chunk)],
        axis=2)
    np.testing.assert_allclose(parts, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_cpu_dispatch_is_the_plain_version_at_the_kernel_tile(bf16):
    q, k, v = _qkv(7, 2, 3, 150, 64)
    mask = _ragged_mask(2, 150, (150, 70))
    before = dict(FA.LAUNCHES)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = FA.flash_attention(tq, tk, tv, torch.from_numpy(mask), bf16=bf16)
    assert FA.LAUNCHES == before
    tile = FA.KV_TILE if bf16 else FA.KV_TILE_F32
    np.testing.assert_array_equal(
        got.numpy(), _plain(q, k, v, mask, bf16=bf16, kv_tile=tile))
    want = _pallas(q, k, v, mask, bf16=bf16, tiles=(tile, tile))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[bf16],
                               atol=TOL[bf16])


def test_bool_and_float_masks_follow_int32_cast():
    """Mask semantics are the JAX wrapper's: int32(mask) > 0 attends, so a
    float mask of 0.5 masks."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 1, 40, 32))
    m = torch.ones(1, 40)
    m[0, 20:] = 0.5
    a = FA.flash_attention(q, k, v, m)
    b = FA.flash_attention(q, k, v, torch.arange(40)[None] < 20)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _tf32(x):
    """What an mma.sync reads of an f32 operand as TF32: its top 19 bits
    (the low 13 mantissa bits cleared)."""
    return (x.view(torch.int32) & ~0x1fff).view(torch.float32)


def _matmul_3xtf32(a, b):
    """a @ b as the f32 kernel makes it: each operand split into hi (its
    TF32 part) and lo = x - hi, then lo.hi + hi.lo and hi.hi added to
    it, lo truncated to TF32 as the mma reads it."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = a - ah, b - bh
    assert torch.equal(ah + al, a) and torch.equal(bh + bl, b)
    return (_tf32(al) @ bh + ah @ _tf32(bl)) + ah @ bh


@pytest.mark.parametrize("scale", [1.0, 30.0])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_3xtf32_products_keep_f32_accuracy(Dh, scale):
    """The f32 kernel's numeric design on the CPU: both products of every
    KV tile by the 3xTF32 split, run through the plain version's tile
    loop, stay within a tenth of the card check's f32 tolerance
    (chip_smoke.FLASH_TOL[False] = 1e-4) of exact-f32 products. q is
    scaled up by ``scale`` and k down by it, so the logits keep their
    size while the split sees large and small exponents; v is scaled up,
    and the tolerance with it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(Dh, 2, 2, 300, Dh))
    q, k, v = q * scale, k / scale, v * scale
    mask = torch.from_numpy(_ragged_mask(2, 300, (300, 0)))  # a full row
    want = FA.flash_attention_plain(q, k, v, mask, bf16=False,
                                    kv_tile=FA.KV_TILE_F32)
    got = FA.flash_attention_plain(q, k, v, mask, bf16=False,
                                   kv_tile=FA.KV_TILE_F32,
                                   matmul=_matmul_3xtf32)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose((got / scale).numpy(), (want / scale).numpy(),
                               rtol=1e-5, atol=1e-5)
