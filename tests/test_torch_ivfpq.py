"""IVF-PQ as a whole: the torch port against the JAX package on the CPU.

A JAX index is built once per configuration and carried across with
``IVFPQIndex.from_state``, so both packages hold the same centroids,
codebooks, rotation and codes. On the CPU the JAX package searches
through its segment route (decode + GEMM); the port takes its grouped
route (tables + the plain scan) unless deletes are outstanding. The two
score the same asymmetric distances in another association, so ids agree
but for near-ties and distances to f32 rounding.
"""

import numpy as np
import pytest
import torch

from neurondb_tpu.index.ivfpq import IVFPQIndex as JIVFPQ
from neurondb_tpu_torch import configure, get_config
from neurondb_tpu_torch.index.ivfpq import IVFPQIndex as TIVFPQ
from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS

# distances of ~1-100: sums in another association (1e-4 relative), and
# atol for values near 0 (ip, cosine)
RTOL = ATOL = 1e-4
# the fused rerank expands |q|^2 + |x|^2 - 2 q.x (as the JAX package's
# fused rerank does on a TPU); the JAX CPU route sums (q - x)^2. Near a
# duplicate row the expansion cancels ~1e-7 * |q|^2 ~ 3e-5 of a squared
# distance, ~1e-4 once the square root of a distance of ~0.25 is taken
RERANK_ATOL = 1e-3
STEP = 2.0 ** (11 - 24)          # packed-key rounding at pb 11, relative


def _clustered(rng, n=3000, d=32, ncl=24, nq=48):
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, ncl, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = x[rng.choice(n, nq, replace=False)] + \
        0.05 * rng.standard_normal((nq, d)).astype(np.float32)
    return x, q.astype(np.float32)


def _carry(j, metric):
    arrays, meta = j._state()
    arrays = {k: np.array(v) for k, v in arrays.items()}
    return TIVFPQ.from_state(arrays, dict(meta, metric=metric, dim=j.dim),
                             device="cpu")


@pytest.fixture()
def exact_select():
    configure(ivf_select="exact")
    yield
    get_config().reset("ivf_select")


@pytest.fixture(scope="module")
def data(rng_mod):
    return _clustered(rng_mod)


CONFIGS = [("l2", "f32", False), ("l2", "int8", True), ("ip", "f32", False),
           ("cosine", "int8", False)]


@pytest.fixture(scope="module", params=CONFIGS,
                ids=["-".join(map(str, c)) for c in CONFIGS])
def pair(request, data):
    metric, odt, opq = request.param
    x, _ = data
    j = JIVFPQ(x, nlists=16, n_sub=8, metric=metric, seed=0,
               keep_originals=True, orig_dtype=odt, opq=opq)
    return j, _carry(j, metric), metric


def test_from_state_same_layout(pair):
    j, t, _ = pair
    for name in ("_row_ids", "_offsets", "_counts"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t._codes_t.T.numpy(), np.asarray(j._codes))
    assert t.stats() == j.stats() and t.code_bytes == j.code_bytes
    assert t.orig_dtype == ("int8" if j.orig_dtype == "int8" else "float32")


@pytest.mark.parametrize("rerank", [0, 8])
def test_search_parity(pair, data, exact_select, rerank):
    j, t, _ = pair
    _, q = data
    before = PQS.LAUNCHES
    jd, ji = j.search(q, k=10, nprobe=4, rerank=rerank)
    td, ti = t.search(q, k=10, nprobe=4, rerank=rerank)
    assert PQS.LAUNCHES == before                  # CPU tensors: plain scan
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ti, ji)])
    assert overlap >= 0.98, overlap
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=RTOL,
                               atol=RERANK_ATOL if rerank else ATOL)


def test_packed_default_within_key_rounding(pair, data):
    """The packed default (pb 11) rounds ADC distances by 2**(pb-24)
    relative before the merge; ids agree but for near-ties."""
    j, t, metric = pair
    _, q = data
    assert get_config().ivf_select == "packed"
    jd, ji = j.search(q, k=10, nprobe=4)
    td, ti = t.search(q, k=10, nprobe=4)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ti, ji)])
    assert overlap >= 0.95, overlap
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1),
                               rtol=RTOL + 2 * STEP, atol=ATOL)


def test_own_build_recall(data):
    """The port's own build (its own k-means streams) against exact
    neighbours, beside the JAX build's recall."""
    x, q = data
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])

    kw = dict(nlists=16, n_sub=8, seed=0, keep_originals=True)
    jr = recall(JIVFPQ(x, **kw).search(q, k=10, nprobe=8, rerank=8)[1])
    t = TIVFPQ(x, device="cpu", **kw)
    tr = recall(t.search(q, k=10, nprobe=8, rerank=8)[1])
    assert tr >= min(0.95, jr - 0.03), (tr, jr)
    assert t.orig_dtype == "float32" and t._codes_t.dtype == torch.uint8
    with pytest.raises(ValueError, match="divisible"):
        TIVFPQ(x[:100, :30], nlists=2, n_sub=8, device="cpu")
    with pytest.raises(ValueError, match="opq"):
        TIVFPQ(x[:300], nlists=4, n_sub=8, metric="ip", opq=True,
               device="cpu")


def test_delete_takes_the_segment_route(data, monkeypatch):
    x, q = data
    j = JIVFPQ(x, nlists=16, n_sub=8, seed=0, keep_originals=True)
    t = _carry(j, "l2")
    _, before = t.search(q, k=10, nprobe=4)
    victims = np.unique(before[before >= 0])[:40]
    assert t.delete(victims) == j.delete(victims) == len(victims)
    calls = []
    for entry in ("grouped_pq_scan", "grouped_pq_scan_fused"):
        monkeypatch.setattr(PQS, entry, lambda *a, **k: calls.append(1))
    for rerank in (0, 4):
        jd, ji = j.search(q, k=10, nprobe=4, rerank=rerank)
        td, ti = t.search(q, k=10, nprobe=4, rerank=rerank)
        assert not calls and not np.isin(ti, victims).any()
        assert (ti == ji).mean() >= 0.98
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="deletes"):
        t.search(q, k=10, nprobe=4, out="device")


def test_device_output(pair, data):
    _, t, _ = pair
    _, q = data
    dv, rows = t.search(q, k=10, nprobe=4, rerank=2, out="device")
    assert isinstance(dv, torch.Tensor) and rows.shape == (len(q), 10)
    _, ids = t.search(q, k=10, nprobe=4, rerank=2)
    np.testing.assert_array_equal(rows.numpy(), ids)
    with pytest.raises(ValueError, match="batch query"):
        t.search(q[0], k=10, out="device")
    with pytest.raises(ValueError, match="keep_originals"):
        TIVFPQ(data[0][:500], nlists=4, n_sub=8, device="cpu").search(
            q, rerank=2)


def test_save_load_both_ways(pair, data, tmp_path):
    j, t, metric = pair
    _, q = data
    t.save(str(tmp_path / "t"))
    back = JIVFPQ.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(back.search(q, k=5, nprobe=4, rerank=2)[1],
                                  j.search(q, k=5, nprobe=4, rerank=2)[1])
    j.save(str(tmp_path / "j"))
    again = TIVFPQ.load(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(again.search(q, k=5, nprobe=4, rerank=2)[1],
                                  t.search(q, k=5, nprobe=4, rerank=2)[1])
    assert (again.R is None) == (j.R is None)


def test_int8_checkpoint_without_scales_is_refused(data, tmp_path):
    """Format 2: int8 originals are meaningless without their per-row
    scales, so a checkpoint that lost them does not load."""
    x, _ = data
    t = TIVFPQ(x[:1500], nlists=8, n_sub=8, seed=0, keep_originals=True,
               orig_dtype="int8", device="cpu")
    path = str(tmp_path / "i8")
    t.save(path)
    import json
    with open(f"{path}/manifest.json") as f:
        meta = json.load(f)
    assert meta["format_version"] == 2 and meta["orig_dtype"] == "int8"
    with np.load(f"{path}/arrays.npz") as z:
        arrays = {k: z[k] for k in z.files if k != "orig_scale"}
    np.savez_compressed(f"{path}/arrays.npz", **arrays)
    with pytest.raises(ValueError, match="orig_scale"):
        TIVFPQ.load(path, device="cpu")
    with pytest.raises(ValueError, match="orig_scale"):
        JIVFPQ.load(path)
