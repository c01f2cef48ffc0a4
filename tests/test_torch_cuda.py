"""The CUDA kernels on a card, against their plain torch versions.

Skips without a card. This file imports neither jax nor the JAX package
and uses no conftest fixture, so on a machine with a card and no JAX it
runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from neurondb_tpu_torch import configure, get_config
from neurondb_tpu_torch.index.hnsw import HNSWIndex
from neurondb_tpu_torch.index.ivf import IVFFlatIndex
from neurondb_tpu_torch.index.ivfpq import IVFPQIndex
from neurondb_tpu_torch.ml import bert as TB
from neurondb_tpu_torch.ml.params import tree_map
from neurondb_tpu_torch.ops.kernels import flash_attention as FA
from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS

pytestmark = pytest.mark.cuda

# f32 sums in another order than the plain version's
RTOL = ATOL = 1e-4


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layout(rng, lens, dim):
    aligned = [(-(-n // 32)) * 32 for n in lens]
    offsets = np.cumsum([0] + aligned[:-1]).astype(np.int32)
    npad = -(-sum(aligned) // 1024) * 1024 + 1024
    vecs = rng.standard_normal((npad, dim)).astype(np.float32)
    return vecs, offsets, np.asarray(lens, np.int32)


def _tiles(rng, dev, counts, offsets, b, npad, qt, dim):
    nl = len(counts)
    probes = np.argsort(rng.random((b, nl)), axis=1)[:, :npad].astype(np.int32)
    probes[:, npad // 2 + 1:] = nl                    # some sentinel columns
    t_max = G.tiles_for(b, npad, nl, qt)
    toff, tcnt, pos = G.group_probes(
        torch.from_numpy(probes).to(dev), torch.from_numpy(offsets).to(dev),
        torch.from_numpy(counts).to(dev), qt=qt, t_max=t_max)
    q = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32))
    qpad = G._scatter_tuples(q.to(dev), pos, npad=npad, qt=qt, t_max=t_max)
    return qpad, toff, tcnt


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("kp,qt,dim", [(10, 64, 128), (100, 32, 128),
                                       (1024, 16, 128), (8, 16, 200),
                                       (10, 64, 768), (1024, 16, 1024)])
def test_kernel_matches_plain(dev, store, metric, kp, qt, dim):
    rng = np.random.default_rng(kp + qt + dim)
    vecs, offsets, counts = _layout(rng, [0, 3, 31, 1024, 1025, 2500, 77], dim)
    vd = torch.from_numpy(vecs).to(dev, getattr(torch, store))
    qpad, toff, tcnt = _tiles(rng, dev, counts, offsets, 3 * qt, 6, qt, dim)
    before = G.LAUNCHES
    kd, ki = G.grouped_probe_scan(qpad, vd, toff, tcnt, kp=kp, qt=qt,
                                  metric=metric)
    # one extra plain column: a near-tie across the kp boundary shows too
    pd, pi = G.grouped_scan_plain(qpad, vd, toff, tcnt, kp=kp + 1, qt=qt,
                                  metric=metric)
    torch.cuda.synchronize()
    assert G.LAUNCHES == before + 1
    torch.testing.assert_close(kd, pd[..., :kp], rtol=RTOL, atol=ATOL)
    # rows equal away from near-ties (f32 rounding, 1e-5 relative)
    close = (pd[..., 1:] - pd[..., :-1]).abs() <= \
        1e-5 * pd[..., 1:].abs().clamp(min=1)
    tie = torch.zeros_like(pi, dtype=torch.bool)
    tie[..., 1:] |= close
    tie[..., :-1] |= close
    ok = (ki == pi[..., :kp]) | tie[..., :kp]
    bad = ok.logical_not().nonzero()[:3].tolist()
    assert not bad, [(b, kd[tuple(b)].item(), pd[tuple(b)].item(),
                      ki[tuple(b)].item(), pi[tuple(b)].item()) for b in bad]


def test_index_on_card_matches_cpu(dev):
    """One index state on the card (kernel, f32 store) and on the CPU
    (plain scan): the same ids."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 64)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 16, 4000)]
         + rng.standard_normal((4000, 64))).astype(np.float32)
    q = x[:200] + 0.3 * rng.standard_normal((200, 64)).astype(np.float32)
    cpu = IVFFlatIndex(x, nlists=32, seed=0, device="cpu")
    arrays, meta = cpu._state()
    meta = dict(meta, metric="l2", dim=64)
    old = get_config().store_dtype
    configure(store_dtype="float32")
    try:
        gpu = IVFFlatIndex.from_state(arrays, meta, device="cuda")
    finally:
        configure(store_dtype=old)
    before = G.LAUNCHES
    gd, gi = gpu.search(q, k=10, nprobe=4, select="exact")
    cd, ci = cpu.search(q, k=10, nprobe=4, select="exact")
    assert G.LAUNCHES == before + 1
    assert float((gi == ci).mean()) >= 0.99
    np.testing.assert_allclose(gd, cd, rtol=RTOL, atol=ATOL)


def test_bf16_store_on_card(dev):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3000, 128)).astype(np.float32)
    idx = IVFFlatIndex(x, nlists=16, seed=0, device="cuda")
    assert idx._vecs.dtype == torch.bfloat16 and idx._vecs.is_cuda
    d, i = idx.search(x[:100], k=5, nprobe=16)        # exact route
    assert (i[:, 0] == np.arange(100)).all()
    dv, iv = idx.search(x[:100], k=5, nprobe=4, out="device")
    assert iv.is_cuda and dv.dtype == torch.float32


@pytest.mark.parametrize("block_min", [False, True])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("kp,qt", [(10, 64), (100, 32), (1024, 16)])
def test_kernel_packed_modes_match_plain(dev, kp, qt, metric, block_min):
    """Packed and blockmin keys: the kernel's f32 sums run in another
    order, so a key may round one step (2**(pb-24) relative) apart. Sorted
    values allclose at rtol 1e-3 + 2 * step (tests/test_pallas_kernels.py),
    and every kernel row carries its own distance to the key rounding."""
    rng = np.random.default_rng(kp + qt + block_min)
    vecs, offsets, counts = _layout(rng, [0, 3, 31, 1024, 1025, 2500, 77], 128)
    vd = torch.from_numpy(vecs).to(dev, torch.bfloat16)
    qpad, toff, tcnt = _tiles(rng, dev, counts, offsets, 3 * qt, 6, qt, 128)
    pb = 12
    kw = dict(kp=kp, qt=qt, metric=metric, pos_bits=pb, block_min=block_min)
    before = G.LAUNCHES
    kd, ki = G.grouped_probe_scan(qpad, vd, toff, tcnt, **kw)
    pd, pi = G.grouped_scan_plain(qpad, vd, toff, tcnt, **kw)
    torch.cuda.synchronize()
    assert G.LAUNCHES == before + 1
    step = 2.0 ** (pb - 24)
    live = pd < 1e30
    assert torch.equal(kd < 1e30, live)
    torch.testing.assert_close(kd[live], pd[live], rtol=1e-3 + 2 * step,
                               atol=ATOL)
    T = toff.shape[0]
    q = qpad.reshape(T, qt, 1, -1).expand(-1, -1, kp, -1)[ki >= 0]
    x = vd[ki[ki >= 0].long()].float()
    dots = (x * q.to(torch.bfloat16).float()).sum(-1)
    own = -dots if metric == "ip" else torch.clamp(
        (q * q).sum(-1) + (x * x).sum(-1) - 2 * dots, min=0)
    torch.testing.assert_close(kd[ki >= 0], own, rtol=RTOL + 2 * step,
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["exact", "packed", "blockmin"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("dim", [128, 200, 13, 384, 768, 1024])
@pytest.mark.parametrize("kp,qt", [(10, 64), (100, 32), (1024, 16)])
def test_kernel_integer_data_matches_plain_bitwise(dev, kp, qt, dim, metric,
                                                   mode):
    """Integer-valued bf16 rows and queries: every product and sum is
    exact on the tensor cores and in the plain version, so the kernel
    equals grouped_scan_plain bit for bit, ties (many) included. D 13
    takes the element copies and the zero padding to 16; D 200 and up
    stage rows in 128-dim slabs, and D 384 and up fit fewer queries a
    block."""
    rng = np.random.default_rng(kp + qt + dim)
    vecs, offsets, counts = _layout(rng, [0, 3, 31, 1024, 1025, 2500, 77], dim)
    vecs = np.round(vecs * 1.5).clip(-4, 4)
    vd = torch.from_numpy(vecs).to(dev, torch.bfloat16)
    qpad, toff, tcnt = _tiles(rng, dev, counts, offsets, 3 * qt, 6, qt, dim)
    qpad = (qpad * 1.5).round().clamp(-3, 3)
    kw = dict(kp=kp, qt=qt, metric=metric, pos_bits=0 if mode == "exact"
              else 12, block_min=mode == "blockmin")
    before = G.LAUNCHES
    kd, ki = G.grouped_probe_scan(qpad, vd, toff, tcnt, **kw)
    pd, pi = G.grouped_scan_plain(qpad, vd, toff, tcnt, **kw)
    torch.cuda.synchronize()
    assert G.LAUNCHES == before + 1
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.parametrize("mode", ["exact", "packed", "blockmin"])
@pytest.mark.parametrize("kp,qt", [(10, 64), (16, 16)])
def test_kernel_top_rows_in_one_warp_bitwise(dev, kp, qt, mode):
    """Every query's nearest rows sit at chunk rows 0-7 (the first n-tile
    of one warp, half in each of its two lanes) and tie; integer data, so
    the kernel equals grouped_scan_plain bit for bit."""
    rng = np.random.default_rng(kp + qt)
    n, dim = 1500, 128
    v = rng.integers(-6, 7, dim)
    far = rng.choice([-6, -5, -4, 4, 5, 6], (n, dim))
    rows = np.where((np.arange(n) % 64 < 8)[:, None], v, v + far)
    vd = torch.from_numpy(np.concatenate([rows, np.zeros((1024, dim))])
                          .astype(np.float32)).to(dev, torch.bfloat16)
    qpad = torch.from_numpy((v + rng.integers(-1, 2, (3 * qt, dim)))
                            .astype(np.float32)).to(dev)
    toff = torch.zeros(3, dtype=torch.int32, device=dev)
    tcnt = torch.tensor([n, 700, 9], dtype=torch.int32, device=dev)
    kw = dict(kp=kp, qt=qt, pos_bits=0 if mode == "exact" else 11,
              block_min=mode == "blockmin")
    kd, ki = G.grouped_probe_scan(qpad, vd, toff, tcnt, **kw)
    pd, pi = G.grouped_scan_plain(qpad, vd, toff, tcnt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def _pq_layout(rng, lens, ns):
    aligned = [(-(-n // 128)) * 128 for n in lens]
    offsets = np.cumsum([0] + aligned[:-1]).astype(np.int32)
    npad = -(-sum(aligned) // 1024) * 1024 + 1024
    codes_t = rng.integers(0, 256, (ns, npad)).astype(np.uint8)
    return codes_t, offsets, np.asarray(lens, np.int32)


@pytest.mark.parametrize("pos_bits", [0, 12])
@pytest.mark.parametrize("ns", [16, 32])
@pytest.mark.parametrize("kp,qt", [(10, 64), (80, 16), (256, 32)])
def test_pq_kernel_matches_plain_bitwise(dev, ns, pos_bits, kp, qt):
    """The kernel and its plain version sum the same f32 table entries in
    the same order: identical outputs, ties included."""
    rng = np.random.default_rng(ns + kp + pos_bits)
    codes_t, offsets, counts = _pq_layout(
        rng, [0, 3, 127, 128, 1024, 1025, 2500, 300], ns)
    nl = len(counts)
    b = 3 * qt
    probes = np.argsort(rng.random((b, nl)), axis=1)[:, :6].astype(np.int32)
    probes[:, 4:] = nl
    t_max = PQS.tiles_for(b, 6, nl, qt)
    toff, tcnt, _ = PQS.group_probes(
        torch.from_numpy(probes).to(dev), torch.from_numpy(offsets).to(dev),
        torch.from_numpy(counts).to(dev), qt=qt, t_max=t_max)
    lut = torch.randn((t_max * qt, ns * 256), device=dev)
    codes = torch.from_numpy(codes_t).to(dev)
    before = PQS.LAUNCHES
    kd, ki = PQS.grouped_pq_scan(lut, codes, toff, tcnt, kp=kp, qt=qt,
                                 pos_bits=pos_bits)
    pd, pi = PQS.grouped_pq_scan_plain(lut, codes, toff, tcnt, kp=kp, qt=qt,
                                       pos_bits=pos_bits)
    torch.cuda.synchronize()
    assert PQS.LAUNCHES == before + 1
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("pos_bits", [0, 12])
@pytest.mark.parametrize("ns", [16, 32])
@pytest.mark.parametrize("kp,qt", [(10, 64), (80, 16), (256, 32)])
def test_pq_fused_kernel_matches_plain_bitwise(dev, ns, pos_bits, kp, qt,
                                               metric):
    """The fused kernel builds the same tables as ``adc_tables`` (one
    rounding per product and sum, in order) and sums the same entries in
    the same order: identical outputs, ties included, with empty slots
    (ragged tiles, sentinel probes) and an OPQ rotation for sq-L2."""
    rng = np.random.default_rng(ns + kp + pos_bits + len(metric))
    codes_t, offsets, counts = _pq_layout(
        rng, [0, 3, 127, 128, 1024, 1025, 2500, 300], ns)
    nl, dim = len(counts), 64
    b = 3 * qt - 5                                  # ragged last tiles
    probes = np.argsort(rng.random((b, nl)), axis=1)[:, :6].astype(np.int32)
    probes[:, 4:] = nl
    t_max = PQS.tiles_for(b, 6, nl, qt)
    toff, tcnt, pos = PQS.group_probes(
        torch.from_numpy(probes).to(dev), torch.from_numpy(offsets).to(dev),
        torch.from_numpy(counts).to(dev), qt=qt, t_max=t_max)
    cents = torch.from_numpy(rng.standard_normal((nl, dim)).astype(np.float32))
    cb = torch.from_numpy(
        (0.5 * rng.standard_normal((ns, 256, dim // ns))).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32))
    R = None
    if metric == "sqeuclidean":
        R = torch.from_numpy(np.linalg.qr(
            rng.standard_normal((dim, dim)))[0].astype(np.float32)).to(dev)
    qc, cn, sq, scale, st = PQS.pq_tuple_inputs(
        q.to(dev), torch.from_numpy(probes).to(dev), cents.to(dev),
        cb.to(dev), pos, R, npad=6, qt=qt, t_max=t_max, metric=metric)
    assert bool((st < 0).any())                     # some slots are empty
    codes = torch.from_numpy(codes_t).to(dev)
    args = (qc, cn, cb.to(dev), sq, scale, st, codes, toff, tcnt)
    before = PQS.LAUNCHES
    kd, ki = PQS.grouped_pq_scan_fused(*args, kp=kp, qt=qt, pos_bits=pos_bits)
    pd, pi = PQS.grouped_pq_scan_fused_plain(*args, kp=kp, qt=qt,
                                             pos_bits=pos_bits)
    torch.cuda.synchronize()
    assert PQS.LAUNCHES == before + 1
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_pq_fused_kernel_occupancy(dev):
    """At the IVF-PQ headline (n_sub 32, kp 80, qt 64), both modes: two
    blocks of 3 slots x 4 warps share an SM, 24 resident warps."""
    for packed in (False, True):
        qs, warps = PQS.resident_warps(64, 32, 4, 80, packed)
        assert qs == 3 and warps >= 16, (packed, qs, warps)


def test_ivfpq_index_on_card_matches_cpu(dev):
    """One IVF-PQ state at 20k rows on the card (kernel) and on the CPU
    (plain scan), exact selection: the same ids to near-ties; the card's
    reranked search reaches the exact neighbours."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((32, 64)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 32, 20000)]
         + rng.standard_normal((20000, 64))).astype(np.float32)
    q = x[:256] + 0.05 * rng.standard_normal((256, 64)).astype(np.float32)
    cpu = IVFPQIndex(x, nlists=64, n_sub=16, seed=0, keep_originals=True,
                     device="cpu")
    arrays, meta = cpu._state()
    gpu = IVFPQIndex.from_state(arrays, dict(meta, metric="l2", dim=64),
                                device="cuda")
    configure(ivf_select="exact")
    try:
        before = PQS.LAUNCHES
        gd, gi = gpu.search(q, k=10, nprobe=8)
        cd, ci = cpu.search(q, k=10, nprobe=8)
        assert PQS.LAUNCHES == before + 1
    finally:
        get_config().reset("ivf_select")
    assert float((gi == ci).mean()) >= 0.99
    np.testing.assert_allclose(gd, cd, rtol=RTOL, atol=ATOL)
    _, ids = gpu.search(q, k=10, nprobe=8, rerank=8)
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)]) >= 0.95


# flash kernel vs its plain version at the kernel's KV tile: f32 sums in
# another order (the tensor cores' accumulation; in f32, 3xTF32 products
# within ~2^-21 of exact ones); with bf16
# products a p within f32 noise of a rounding boundary may round one bf16
# step apart, moving an output by up to 2^-8 * (p / l) * |v|
FLASH_TOL = {False: 1e-4, True: 2e-3}


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("S,masking", [(1, "none"), (100, "ragged"),
                                       (128, "none"), (300, "ragged"),
                                       (513, "full_row"), (1900, "ragged"),
                                       # the 128-row query tile's edges
                                       (127, "ragged"), (129, "full_row"),
                                       (257, "none"), (640, "ragged")])
def test_flash_kernel_matches_plain(dev, bf16, dh, S, masking):
    gen = torch.Generator(device=dev).manual_seed(S + dh)
    B, H = 3, 2
    # the dense layers' layout: [B, S, H, Dh] viewed as [B, H, S, Dh]
    q, k, v = (torch.randn((B, S, H, dh), generator=gen, device=dev)
               .transpose(1, 2) for _ in range(3))
    mask = None
    if masking != "none":
        lens = torch.tensor([S, max(1, S // 3), max(1, S - 65)], device=dev)
        mask = (torch.arange(S, device=dev)[None] < lens[:, None]).int()
        if masking == "full_row":
            mask[1] = 0
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention(q, k, v, mask, bf16=bf16)
    tile = FA.KV_TILE if bf16 else FA.KV_TILE_F32
    want = FA.flash_attention_plain(q, k, v, mask, bf16=bf16, kv_tile=tile)
    torch.cuda.synchronize()
    mode = "bf16" if bf16 else "f32"
    assert FA.LAUNCHES == {**before, mode: before[mode] + 1}
    assert got.shape == (B, H, S, dh) and bool(torch.isfinite(got).all())
    tol = FLASH_TOL[bf16]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_flash_kernel_tiles_match_the_wrapper(dev):
    lib = FA._lib()
    assert lib.flash_attention_kv_tile(1) == FA.KV_TILE
    assert lib.flash_attention_kv_tile(0) == FA.KV_TILE_F32
    # resident blocks per SM, both modes: two up to Dh 64, one at Dh 128
    for bf16 in (1, 0):
        for masked in (1, 0):
            for dh in FA.HEAD_DIMS:
                want = 1 if dh == 128 else 2
                assert lib.flash_attention_occupancy(dh, masked, bf16) == want
        assert lib.flash_attention_occupancy(48, 1, bf16) == -1


def test_default_device_is_the_card(dev):
    """An entry point given no device runs on the card."""
    x = np.random.default_rng(0).standard_normal((2000, 32)).astype(np.float32)
    index = IVFFlatIndex(x, nlists=8)
    assert index.device.type == "cuda"
    assert index.search(x[:4], k=1, nprobe=8)[1][:, 0].tolist() == [0, 1, 2, 3]


def test_tiny_bert_on_card_matches_cpu(dev):
    """One parameter tree on the card (flash kernel) and on the CPU
    (reference attention): the same scores to bf16 attention rounding."""
    p = TB.init_bert_params(0, vocab_size=200, hidden=128, layers=2,
                            heads=2, ff=256, max_len=96)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 200, (5, 96)).astype(np.int32)
    for i, n in enumerate((96, 40, 1, 65, 70)):
        ids[i, n:] = 0
    types = (rng.random((5, 96)) < 0.5).astype(np.int32)
    cpu = TB.bert_encode(p, torch.from_numpy(ids), torch.from_numpy(types),
                         heads=2)
    pd = tree_map(lambda t: t.to(dev), p)
    before = dict(FA.LAUNCHES)
    card = TB.bert_encode(pd, torch.from_numpy(ids).to(dev),
                          torch.from_numpy(types).to(dev), heads=2,
                          use_flash=True)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"bf16": before["bf16"] + 2, "f32": before["f32"]}
    for key in ("score", "pooled", "mean_pooled"):
        torch.testing.assert_close(card[key].cpu(), cpu[key], rtol=5e-3,
                                   atol=5e-3)


PROBE_LENS = [0, 3, 31, 511, 512, 513, 1024, 1025, 2500]


def _probe_inputs(rng, dev, b, nprobe, dim):
    vecs, offsets, counts = _layout(rng, PROBE_LENS, dim)
    lists = np.argsort(rng.random((b, len(PROBE_LENS))), axis=1)[:, :nprobe]
    poff = torch.from_numpy(offsets[lists]).to(dev)
    pcnt = torch.from_numpy(counts[lists]).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32))
    return vecs, q.to(dev), poff, pcnt


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("k,nprobe,dim", [(1, 4, 128), (10, 6, 128),
                                          (100, 3, 128), (512, 5, 128),
                                          (1000, 1, 128), (1000, 3, 128),
                                          (10, 4, 100), (10, 4, 384),
                                          (512, 3, 384), (10, 4, 768),
                                          (512, 3, 768), (10, 4, 1024),
                                          (512, 3, 1024), (10, 4, 2048),
                                          (512, 3, 2048)])
def test_probe_kernel_matches_plain(dev, store, metric, k, nprobe, dim):
    """The probe kernel against probe_scan_plain on ragged lists, B = 37
    (no multiple of 16); dim 100 takes the scalar loads, dims 384-2048
    stage their rows in 128-dim slabs. Partials allclose
    and rows equal away from near-ties; the merged top-k too, with the
    per-probe cap and the padding past nprobe * kp."""
    rng = np.random.default_rng(k + nprobe + dim)
    vecs, q, poff, pcnt = _probe_inputs(rng, dev, 37, nprobe, dim)
    vd = torch.from_numpy(vecs).to(dev, getattr(torch, store))
    kp = PS.kp_for(k)
    before = PS.LAUNCHES
    kd, ki = PS.probe_scan(q, vd, poff, pcnt, kp=kp, max_segs=8, metric=metric)
    pd, pi = PS.probe_scan_plain(q, vd, poff, pcnt, kp=kp + 1, max_segs=8,
                                 metric=metric)
    torch.cuda.synchronize()
    assert PS.LAUNCHES == before + 1
    torch.testing.assert_close(kd, pd[..., :kp], rtol=RTOL, atol=ATOL)
    close = (pd[..., 1:] - pd[..., :-1]).abs() <= \
        1e-5 * pd[..., 1:].abs().clamp(min=1)
    tie = torch.zeros_like(pi, dtype=torch.bool)
    tie[..., 1:] |= close
    tie[..., :-1] |= close
    ok = (ki == pi[..., :kp]) | tie[..., :kp]
    assert bool(ok.all()), ok.logical_not().nonzero()[:3].tolist()
    md, mi = PS.merge_probes(kd, ki, k=k)
    wd, wi = PS.merge_probes(pd[..., :kp].contiguous(),
                             pi[..., :kp].contiguous(), k=k)
    assert md.shape == (37, k)
    torch.testing.assert_close(md, wd, rtol=RTOL, atol=ATOL)
    assert torch.equal(mi < 0, wi < 0)
    if k > nprobe * kp:
        assert bool((mi[:, nprobe * kp:] == -1).all())


# the widest D whose 4-query tile fits SMEM_MAX at kp 512, by the kernel's
# shared-memory layout: full-width f32 queries, a ring of 128-dim slabs
PROBE_WIDEST = {True: 9940, False: 8980}


@pytest.mark.parametrize("bf16", [True, False])
def test_probe_pick_tile_wide_d(dev, bf16):
    """pick_tile finds a tile at D 2048 and a 4-query tile at the widest D
    at kp 512, and one dim past it raises, as the wrapper does there
    before any launch."""
    lib = PS._lib()
    widest = PROBE_WIDEST[bf16]
    assert PS.pick_tile(lib, 2048, 512, bf16) in PS.TILES
    assert PS.pick_tile(lib, widest, 512, bf16) == 4
    with pytest.raises(ValueError, match="do not fit"):
        PS.pick_tile(lib, widest + 1, 512, bf16)
    store = torch.bfloat16 if bf16 else torch.float32
    q = torch.zeros((2, widest + 1), device=dev)
    vecs = torch.zeros((64, widest + 1), device=dev, dtype=store)
    off = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    cnt = torch.full((2, 1), 64, dtype=torch.int32, device=dev)
    before = PS.LAUNCHES
    with pytest.raises(ValueError, match="do not fit"):
        PS.probe_scan(q, vecs, off, cnt, kp=512, max_segs=1,
                      metric="sqeuclidean")
    assert PS.LAUNCHES == before


def test_probe_kernel_empty_probes(dev):
    rng = np.random.default_rng(5)
    vecs, q, poff, _ = _probe_inputs(rng, dev, 20, 3, 128)
    vd = torch.from_numpy(vecs).to(dev, torch.bfloat16)
    d, i = PS.ivf_probe_scan(q, None, vd, poff, torch.zeros_like(poff), k=10,
                             max_segs=8)
    torch.cuda.synchronize()
    assert bool((i == -1).all()) and bool((d == PS.NEG_FILL).all())


def test_probe_route_on_card_matches_cpu(dev):
    """One index state on the card (probe kernel, f32 store) and on the
    CPU (plain scan), ivf_kernel = "probe": the same ids; the card's
    search launches the probe kernel once and the grouped kernel never."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, 64)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 16, 4000)]
         + rng.standard_normal((4000, 64))).astype(np.float32)
    q = x[:200] + 0.3 * rng.standard_normal((200, 64)).astype(np.float32)
    cpu = IVFFlatIndex(x, nlists=32, seed=0, device="cpu")
    arrays, meta = cpu._state()
    meta = dict(meta, metric="l2", dim=64)
    configure(store_dtype="float32", ivf_kernel="probe")
    try:
        gpu = IVFFlatIndex.from_state(arrays, meta, device="cuda")
        before, g_before = PS.LAUNCHES, G.LAUNCHES
        gd, gi = gpu.search(q, k=10, nprobe=4)
        cd, ci = cpu.search(q, k=10, nprobe=4)
        assert PS.LAUNCHES == before + 1 and G.LAUNCHES == g_before
    finally:
        get_config().reset("store_dtype")
        get_config().reset("ivf_kernel")
    assert float((gi == ci).mean()) >= 0.99
    np.testing.assert_allclose(gd, cd, rtol=RTOL, atol=ATOL)


PROBE_LENS_EMPTY = [0, 0, 40, 0, 700, 0, 0, 3, 1100]


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("k", [10, 512])
@pytest.mark.parametrize("b", [70, 4500])
def test_probe_kernel_hot_and_empty_lists(dev, store, metric, k, b):
    """Hot lists: all b queries probe the same 3 lists, so each list's
    tuples split into several items (b 70: query tiles of 4 and 8, b 4500:
    of 16 and 32); adjacent empty lists share their offset with the next
    list. Small integers make every product and sum exact, so the kernel
    equals the plain version bit for bit, ties (many here) going to the
    smaller row."""
    rng = np.random.default_rng(k)
    vecs, offsets, counts = _layout(rng, PROBE_LENS_EMPTY, 128)
    vecs = np.round(vecs * 1.5).clip(-4, 4).astype(np.float32)
    vd = torch.from_numpy(vecs).to(dev, getattr(torch, store))
    q = torch.from_numpy(rng.integers(-3, 4, (b, 128)).astype(np.float32))
    q = q.to(dev)
    hot = np.stack([rng.permutation([2, 4, 8]) for _ in range(b)])
    spread = np.argsort(rng.random((b, len(PROBE_LENS_EMPTY))), axis=1)[:, :4]
    kp = PS.kp_for(k)
    for lists in (hot, spread):
        poff = torch.from_numpy(offsets[lists]).to(dev)
        pcnt = torch.from_numpy(counts[lists]).to(dev)
        kw = dict(kp=kp, max_segs=4, metric=metric)
        kd, ki = PS.probe_scan(q, vd, poff, pcnt, **kw)
        pd, pi = PS.probe_scan_plain(q, vd, poff, pcnt, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_probe_work_table_on_card_matches_cpu(dev):
    """The work table built on the card is the CPU's, and neither its
    build nor a probe scan makes a host synchronisation."""
    rng = np.random.default_rng(2)
    vecs, offsets, counts = _layout(rng, PROBE_LENS, 16)
    lists = np.argsort(rng.random((300, len(PROBE_LENS))), axis=1)[:, :5]
    poff, pcnt = torch.from_numpy(offsets[lists]), torch.from_numpy(
        counts[lists])
    want = PS.work_table(poff, pcnt, n_rows=vecs.shape[0], max_segs=2)
    poff, pcnt = poff.to(dev), pcnt.to(dev)
    vd = torch.from_numpy(vecs).to(dev, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
    q = q.to(dev)
    PS.probe_scan(q, vd, poff, pcnt, kp=10, max_segs=2)   # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = PS.work_table(poff, pcnt, n_rows=vecs.shape[0], max_segs=2)
        PS.probe_scan(q, vd, poff, pcnt, kp=10, max_segs=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_hnsw_search_on_card_matches_cpu(dev, metric):
    """One HNSW state (a bulk build on the CPU, carried with from_state)
    searched on the card and on the CPU, f32 store on both: ids equal on
    >= 0.99 of entries; the incremental state's descent route too."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((24, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 24, 5000)]
         + rng.standard_normal((5000, 32))).astype(np.float32)
    q = x[:300] + 0.1 * rng.standard_normal((300, 32)).astype(np.float32)
    bulk = HNSWIndex(x, m=16, metric=metric, seed=0, build_mode="bulk",
                     device="cpu")
    incr = HNSWIndex(x[:1500], m=8, ef_construction=64, metric=metric,
                     seed=0, build_mode="incremental", device="cpu")
    configure(store_dtype="float32")
    try:
        for cpu in (bulk, incr):
            arrays, meta = cpu._state()
            arrays = {k: (v.numpy() if torch.is_tensor(v) else v)
                      for k, v in arrays.items()}
            meta = dict(meta, metric=metric, dim=32)
            gpu = HNSWIndex.from_state(arrays, meta, device="cuda")
            assert gpu._nbr0.device.type == "cuda"
            for ef in (16, 64):
                gd, gi = gpu.search(q, k=10, ef=ef)
                cd, ci = cpu.search(q, k=10, ef=ef)
                assert float((gi == ci).mean()) >= 0.99, (ef, metric)
    finally:
        get_config().reset("store_dtype")


def test_hnsw_bulk_build_on_card_runs_grouped_kernel(dev, monkeypatch):
    """The bulk build's IVF bootstrap (threshold moved below the corpus)
    launches the grouped scan kernel on the card; the built index finds
    the corpus rows' own ids."""
    import neurondb_tpu_torch.index.hnsw as TH
    monkeypatch.setattr(TH, "EXACT_KNN_MAX_ROWS", 5000)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8000, 64)).astype(np.float32)
    before = G.LAUNCHES
    idx = HNSWIndex(x, m=16, seed=0, build_mode="bulk", device="cuda")
    assert G.LAUNCHES > before
    assert idx._vecs.dtype == torch.bfloat16
    _, ids = idx.search(x[:500], k=1, ef=64)
    assert float((ids[:, 0] == np.arange(500)).mean()) >= 0.99


# ---- the quantized-flat and BM25 / hybrid slice on the card ----

@pytest.mark.parametrize("shape,k", [((64, 5000), 10), ((16384, 1024), 16),
                                     ((8, 3000), 700), ((4096, 65536), 5),
                                     ((8, 70001), 300)])
def test_topk_ties_on_card_follow_a_stable_sort(dev, shape, k):
    from neurondb_tpu_torch.ops.topk import topk_largest, topk_smallest
    gen = torch.Generator(device="cpu").manual_seed(3)
    s = torch.randint(0, 4, shape, generator=gen).float().to(dev)
    v, i = topk_smallest(s, k)
    sv, si = torch.sort(s, dim=-1, stable=True)
    assert torch.equal(i, si[:, :k]) and torch.equal(v, sv[:, :k])
    v, i = topk_largest(s, k)
    sv, si = torch.sort(-s, dim=-1, stable=True)
    assert torch.equal(i, si[:, :k]) and torch.equal(v, -sv[:, :k])


# the sort, two-pass and grouped ways
@pytest.mark.parametrize("n", [300, 5000, 20000])
def test_signed_zeros_on_card_match_cpu(dev, n):
    """-0.0 and 0.0 are one value on the card as on the CPU (index
    order among them), in both selections."""
    from neurondb_tpu_torch.ops.topk import topk_largest, topk_smallest
    s = torch.zeros(2, n)
    s[:, ::3] = -0.0
    s[1, 1::4] = -1.0
    for fn in (topk_smallest, topk_largest):
        cv, ci = fn(s, 40)
        gv, gi = fn(s.to(dev), 40)
        assert torch.equal(gi.cpu(), ci), fn.__name__
        assert torch.equal(gv.cpu().view(torch.int32), cv.view(torch.int32))


@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "ip", "cosine",
                                    "l1", "chebyshev", "minkowski",
                                    "hamming", "jaccard", "dice"])
def test_metrics_on_card_match_cpu(dev, metric):
    from neurondb_tpu_torch.ops import distance as TD
    rng = np.random.default_rng(4)
    q = np.round(rng.standard_normal((37, 65)) * 2).astype(np.float32)
    x = np.round(rng.standard_normal((900, 65)) * 2).astype(np.float32)
    cpu = TD.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), metric)
    gpu = TD.pairwise_distance(torch.from_numpy(q).to(dev),
                               torch.from_numpy(x).to(dev), metric).cpu()
    assert gpu.dtype == cpu.dtype
    if metric in ("hamming", "jaccard", "dice", "l1", "chebyshev"):
        assert torch.equal(gpu, cpu)       # integer data: exact sums
    else:
        np.testing.assert_allclose(gpu.numpy(), cpu.numpy(), rtol=RTOL,
                                   atol=ATOL)
    qc = rng.integers(0, 256, (37, 48)).astype(np.uint8)   # 384 bits
    xc = rng.integers(0, 256, (900, 48)).astype(np.uint8)
    assert torch.equal(
        TD.pairwise_distance(torch.from_numpy(qc).to(dev),
                             torch.from_numpy(xc).to(dev), "hamming").cpu(),
        TD.pairwise_distance(torch.from_numpy(qc), torch.from_numpy(xc),
                             "hamming"))


def test_quantize_bits_on_card_match_cpu(dev):
    from neurondb_tpu_torch.types import quantized as TQ
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4096, 131)) * 3).astype(np.float32)
    x[0] = 0.0
    x[1] = 2.5
    for fmt in TQ.FORMATS:
        c = TQ.quantize(x, fmt, device="cpu")
        g = TQ.quantize(x, fmt, device=dev)
        for a, b in ((c.codes, g.codes), (c.scale, g.scale),
                     (c.offset, g.offset),
                     (TQ.dequantize(c), TQ.dequantize(g))):
            assert b.device.type == dev.type and a.dtype == b.dtype, fmt
            assert torch.equal(a.view(torch.uint8), b.cpu().view(torch.uint8)), fmt


@pytest.mark.parametrize("build", ["python", "hashed"])
def test_bm25_scores_batch_on_card_equal_the_oracle(dev, build):
    from neurondb_tpu_torch.search.bm25 import BM25Index
    rng = np.random.default_rng(6)
    vocab = [f"w{i}" for i in range(300)]
    docs = [" ".join(rng.choice(vocab, rng.integers(3, 30)))
            for _ in range(6000)]
    bm = BM25Index(docs, use_native=build == "hashed", device=dev)
    queries = [" ".join(rng.choice(vocab, 4)) for _ in range(40)]
    queries += ["w1 w1 w2", "", " ".join(vocab[:100])]
    got = bm.scores_batch(queries, device=True, return_device=True)
    assert got.device.type == dev.type
    want = np.stack([bm.scores(q) for q in queries[:-1]])
    assert np.array_equal(got[:-1].cpu().numpy().view(np.int32),
                          want.view(np.int32))
    inv = {bm._term_index(w): w for w in vocab}
    capped = " ".join(inv[t] for t in bm.capped_terms(queries[-1]))
    assert np.array_equal(got[-1].cpu().numpy().view(np.int32),
                          bm.scores(capped).view(np.int32))


def test_text_search_on_a_card_index_scores_on_the_card(dev, monkeypatch):
    """With no ``device`` argument, BM25 search, both hybrid searches
    and a card Collection's fts and hybrid routes score on the card:
    the host oracle is never called. The card's search equals the host
    search's scores bit for bit."""
    from neurondb_tpu_torch.client import Collection
    from neurondb_tpu_torch.index.flat import FlatIndex
    from neurondb_tpu_torch.search.bm25 import BM25Index
    from neurondb_tpu_torch.search.hybrid import (hybrid_search,
                                                  hybrid_search_batch)
    from neurondb_tpu_torch.search.planner import (QueryPlanner,
                                                   planned_search)
    rng = np.random.default_rng(8)
    n = 3000
    x = rng.standard_normal((n, 32)).astype(np.float32)
    docs = [f"topic{i % 64} item {i} cluster word{i % 64}" for i in range(n)]
    bm = BM25Index(docs, device=dev)
    flat = FlatIndex(x, device=dev)
    col = Collection("t", 32, index="flat", device=dev)
    col.add(x, documents=docs)
    col._ensure_index()
    host = {}
    for name, obj in (("bm", bm), ("col", col._bm25)):
        host[name] = obj.scores
        monkeypatch.setattr(obj, "scores", lambda q: pytest.fail(
            "the host oracle scored a query of a card index"))
    got = bm.scores_batch(["topic3 item 3"], return_device=True)
    assert got.device.type == dev.type
    ds, di = bm.search("topic3 item 3", k=20)
    _, ids = hybrid_search(flat, bm, x[3], "topic3 item 3", k=10)
    assert ids[0] == 3
    _, ids = hybrid_search_batch(flat, bm, x[3:4], ["topic3 item 3"], k=10)
    assert ids[0, 0] == 3
    planner = QueryPlanner()
    for kw in ({"text": "topic3 item 3"},
               {"vector": x[3], "text": "topic3 item 3"}):
        res = planned_search(col, planner, k=10, **kw)
        assert 3 in [r["id"] for r in res["results"]], res["plan"].mode
    monkeypatch.setattr(bm, "scores", host["bm"])
    hs, _ = bm.search("topic3 item 3", k=20, device=False)
    assert np.array_equal(ds.view(np.int32), hs.view(np.int32))
    assert np.array_equal(ds.view(np.int32),
                          bm.scores("topic3 item 3")[di].view(np.int32))


def test_hybrid_device_fusion_on_card_matches_host(dev):
    from neurondb_tpu_torch.index.flat import FlatIndex
    from neurondb_tpu_torch.index.ivf import IVFFlatIndex
    from neurondb_tpu_torch.search.bm25 import BM25Index
    from neurondb_tpu_torch.search.hybrid import (HybridSearcher,
                                                  hybrid_search_batch)
    rng = np.random.default_rng(7)
    n = 20000
    x = rng.standard_normal((n, 32)).astype(np.float32)
    ext = np.arange(n, dtype=np.int64) * 3 + 1
    docs = [f"topic{i % 64} item {i} cluster word{i % 64}" for i in range(n)]
    bm = BM25Index(docs, ids=ext, device=dev)
    qis = rng.integers(0, n, 96)
    q = x[qis]
    texts = [f"topic{qi % 64} item {qi}" for qi in qis]
    flat = FlatIndex(x, ids=ext, device=dev)
    s_h, i_h = hybrid_search_batch(flat, bm, q, texts, k=10, device=False)
    s_d, i_d = hybrid_search_batch(flat, bm, q, texts, k=10, device=True)
    for b in range(len(q)):
        diff = set(i_d[b]) ^ set(i_h[b])
        # host sums in Python floats, the card in f32: near-ties may swap
        assert not diff or abs(s_h[b, -1] - s_d[b, -1]) <= 1e-6, b
    assert float(np.mean([ext[qi] in row for qi, row in zip(qis, i_d)])) >= 0.99
    ivf = IVFFlatIndex(x, nlists=64, ids=ext, device=dev)
    s_p, i_p = HybridSearcher(ivf, bm).search_batch(q, texts, k=10, batch=40,
                                                    nprobe=8)
    s_b, i_b = hybrid_search_batch(ivf, bm, q, texts, k=10, nprobe=8)
    for b in range(len(q)):
        assert set(i_p[b]) == set(i_b[b]), b


@pytest.mark.parametrize("fmt,metric", [("int8", "ip"), ("f16", "ip"),
                                        ("binary", "l2"), ("int4", "cosine")])
def test_quantized_flat_on_card_matches_cpu(dev, fmt, metric):
    from neurondb_tpu_torch.index.flat import QuantizedFlatIndex
    rng = np.random.default_rng(9)
    x = rng.standard_normal((20000, 64)).astype(np.float32)
    q = x[:300] + 0.1 * rng.standard_normal((300, 64)).astype(np.float32)
    cpu = QuantizedFlatIndex(x, fmt=fmt, metric=metric, device="cpu")
    gpu = QuantizedFlatIndex(x, fmt=fmt, metric=metric, device=dev)
    assert gpu.q.codes.device.type == dev.type
    assert gpu.compression_bytes == cpu.compression_bytes
    for rerank in (0, 8):
        cd, ci = cpu.search(q, k=10, rerank=rerank)
        gd, gi = gpu.search(q, k=10, rerank=rerank)
        assert float((gi == ci).mean()) >= 0.999, rerank
        np.testing.assert_allclose(gd, cd, rtol=1e-4, atol=1e-4)


# ---- the sharded indexes on the card ----

def _shard_clustered(seed, n, d):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((32, d)).astype(np.float32) * 2.0
    x = (c[rng.integers(0, 32, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = (x[:256] + 0.05 * rng.standard_normal((256, d))).astype(np.float32)
    return x, q


def test_sharded_ivf_on_card_runs_the_probe_kernel(dev):
    """Four logical shards on one card: every search launches the probe
    kernel once a shard, and the same state on a CPU mesh (the plain
    version) returns the same ids."""
    from neurondb_tpu_torch.parallel import ShardedIVFIndex, make_mesh
    x, q = _shard_clustered(12, 40000, 64)
    idx = ShardedIVFIndex(x, nlists=128, mesh=make_mesh(4, device="cuda"))
    assert all(sh.vecs.is_cuda and sh.vecs.dtype == torch.float32
               for sh in idx._shards)
    before = PS.LAUNCHES
    d, ids = idx.search(q, k=10, nprobe=8)
    assert PS.LAUNCHES == before + 4
    idx.search(q, k=10, nprobe=16)
    assert PS.LAUNCHES == before + 8
    assert (ids[:, 0] == np.arange(256)).mean() >= 0.99
    S, cap = 4, max(sh.vecs.shape[0] for sh in idx._shards)
    vecs = np.zeros((S, cap, 64), np.float32)
    rows = np.full((S, cap), -1, np.int32)
    for s, sh in enumerate(idx._shards):
        vecs[s, :sh.vecs.shape[0]] = sh.vecs.cpu().numpy()
        rows[s, :sh.rows.shape[0]] = sh.rows.cpu().numpy()
    cpu = ShardedIVFIndex.from_arrays(
        make_mesh(4, device="cpu"), centroids=idx.centroids, vecs=vecs,
        rows=rows, off=np.stack([sh.off.cpu().numpy() for sh in idx._shards]),
        cnt=np.stack([sh.cnt.cpu().numpy() for sh in idx._shards]),
        ids=idx._ids_np)
    cd, ci = cpu.search(q, k=10, nprobe=8)
    assert float((ci == ids).mean()) >= 0.999
    np.testing.assert_allclose(d, cd, rtol=1e-4, atol=2e-3)


def test_sharded_ivfpq_on_card_runs_the_fused_kernel(dev):
    from neurondb_tpu_torch.parallel import ShardedIVFPQIndex, make_mesh
    x, q = _shard_clustered(13, 40000, 64)
    idx = ShardedIVFPQIndex(x, nlists=64, n_sub=16, mesh=make_mesh(
        4, device="cuda"), seed=0)
    assert all(sh.codes_t.is_cuda and sh.orig.dtype == torch.int8
               for sh in idx._shards)
    before = PQS.LAUNCHES
    _, ids = idx.search(q, k=10, nprobe=8)
    assert PQS.LAUNCHES == before + 4
    assert (ids[:, 0] == np.arange(256)).mean() >= 0.99


@pytest.mark.parametrize("M,K,N", [(1, 768, 2304), (16, 768, 50257),
                                   (17, 3072, 768), (128, 768, 50257),
                                   (3, 20, 13)])
def test_gpt_int8_matmul_on_card_is_exact(dev, M, K, N):
    """The W8A8 int32 accumulate (``torch._int_mm`` on padded operands)
    equals the exact f64 sums bit for bit, at decode shapes below its
    17-row floor and at the lm head's 50,257 columns."""
    from neurondb_tpu_torch.ml import gpt as TG
    g = torch.Generator(device=dev).manual_seed(M)
    xq = torch.randint(-127, 128, (M, K), generator=g, device=dev).to(torch.int8)
    wq = torch.randint(-127, 128, (K, N), generator=g, device=dev).to(torch.int8)
    xq[0] = 127
    wq[:, 0] = -127
    got = TG.int8_matmul(xq, wq)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, TG.int8_matmul_plain(xq, wq))


def test_tiny_gpt_on_card_matches_cpu(dev):
    """One f32 tree on the card and the CPU: the same greedy tokens, each
    the no-cache argmax on the card; int8 weights and an int8 cache run."""
    from neurondb_tpu_torch.ml import gpt as TG
    from neurondb_tpu_torch.ml.bpe import BPETokenizer
    p = TG.init_gpt_params(0, vocab_size=300, hidden=64, layers=2, heads=2,
                           max_len=128)
    rng = np.random.default_rng(0)
    ids = np.zeros((3, 16), np.int64)
    lens = np.asarray([16, 5, 9])
    for b, n in enumerate(lens):
        ids[b, 16 - n:] = rng.integers(0, 300, n)
    kw = dict(heads=2, max_new=12, cache_len=32)
    cpu, _ = TG.generate_ids(p, ids, lens, 0, **kw)
    pd = tree_map(lambda t: t.to(dev), p)
    card, n_valid = TG.generate_ids(pd, ids, lens, 0, **kw)
    assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu)
    for b in range(3):
        seq = torch.cat([torch.from_numpy(ids[b, 16 - lens[b]:]), cpu[b]])
        lg = TG.gpt_logits(pd, seq[None].to(dev), heads=2)[0]
        assert torch.equal(lg[lens[b] - 1:-1].argmax(-1).cpu(), cpu[b])
    lm = TG.GPT2LM(pd, BPETokenizer.byte_fallback(), heads=2, dtype="int8",
                   kv_dtype="int8", device=dev)
    assert lm.params["blocks"][0]["w_qkv"][0].device.type == "cuda"
    out = lm.complete_batch([[1, 2, 3], [4] * 20], max_tokens=6)
    assert len(out) == 2 and all(isinstance(t, str) for t in out)


def _host_waits(fn):
    """How often ``fn`` makes the host wait for the card, counted by the
    sync debug mode's warnings."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


@pytest.mark.parametrize("kw", [{}, dict(temperature=0.8, top_k=50, top_p=0.9),
                                dict(temperature=1.0, top_p=0.9),
                                dict(int8_dot=True)],
                         ids=["greedy", "top_k_top_p", "top_p", "int8_dot"])
def test_gpt_decode_steps_never_wait_for_the_card(dev, kw):
    """generate_ids waits for the card only in its set-up: 12 decoded
    tokens make as many host waits as 2."""
    from neurondb_tpu_torch.ml import gpt as TG
    p = tree_map(lambda t: t.to(dev), TG.init_gpt_params(
        0, vocab_size=300, hidden=64, layers=2, heads=2, max_len=128))
    ids = np.random.default_rng(0).integers(0, 300, (3, 16))
    lens = np.asarray([16, 5, 9])

    def run(n):
        return lambda: TG.generate_ids(p, ids, lens, 0, heads=2, max_new=n,
                                       cache_len=32, eos_id=7, **kw)
    run(12)()
    torch.cuda.synchronize()
    assert _host_waits(lambda: torch.ones(1, device=dev).item()) >= 1
    assert _host_waits(run(12)) == _host_waits(run(2))


def test_vit_on_card_runs_the_flash_kernel(dev):
    """ViT attention (no mask, S = 17 patches + CLS: a ragged KV tile)
    through the flash kernel, one launch a layer, against the reference
    attention on the CPU."""
    from neurondb_tpu_torch.ml import vision as TV
    p = TV.init_vit_params(0, hidden=128, layers=2, heads=2, ff=256,
                           patch=8, image_size=32)
    img = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    cpu = TV.VisionEncoder(p, heads=2, device="cpu").embed_images(img)
    enc = TV.VisionEncoder(p, heads=2, device=dev)
    assert enc.use_flash
    before = dict(FA.LAUNCHES)
    card = enc.embed_images(img)
    assert FA.LAUNCHES == {"bf16": before["bf16"] + 2, "f32": before["f32"]}
    np.testing.assert_allclose(card, cpu, rtol=5e-3, atol=5e-3)


def test_client_rag_on_card(dev):
    from neurondb_tpu_torch.client import Client
    c = Client(device=dev)
    rag = c.rag(chunk_size=64)
    rag.add_documents(["alpha beta gamma. delta epsilon.", "zeta eta theta."])
    assert rag._index._vecs.device.type == "cuda"
    assert rag.retrieve("zeta eta", k=1, weight=0.0)[0]["doc_id"] == 1
    assert c.embeddings.embed_text("x").shape == (256,)
