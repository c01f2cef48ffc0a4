"""The CUDA kernel on a card, against its plain torch version.

Skips without a card. This file imports neither jax nor the JAX package
and uses no conftest fixture, so on a machine with a card and no JAX it
runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from neurondb_tpu_torch import configure, get_config
from neurondb_tpu_torch.index.ivf import IVFFlatIndex
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G

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
                                       (1024, 16, 128), (8, 16, 200)])
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
    gd, gi = gpu.search(q, k=10, nprobe=4)
    cd, ci = cpu.search(q, k=10, nprobe=4)
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
