#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --kernels-only   # device, build, kernel checks

Drives ``neurondb_tpu_torch`` (never JAX, never ``neurondb_tpu``) through
its IVFFlat main path at the headline size, in phases that each print
their own lines:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``neurondb_tpu_torch/csrc``;
3. kernel against plain: ``grouped_probe_scan``'s CUDA kernel against its
   plain torch version on the same card tensors, on a ragged bf16 CSR
   layout (list lengths 0, 3, 31, 1024, 1025, 2500, ...), for qt in
   {16, 32, 64}, k in {10, 100, 1024}, sqeuclidean and ip, and an
   all-sentinel tile set; then both timed at the headline shapes
   (16,384 queries, nprobe 8, nlists 1024, 1M rows);
4. main path: the 1M x 128 clustered corpus of ``bench.py``; exact
   neighbours from ``FlatIndex`` on the card, held against float64 on the
   host and set beside the committed ground truth
   (``bench_cache/gt_clustered_1000000_1000.npz``); an
   ``IVFFlatIndex(nlists=1024)`` built on the card; recall@10 against
   the committed ground truth (and the exact neighbours) over nprobe in
   (1, 2, 4, 8, 12, 16) at batch 16,384 (f32, and the int8 wire), QPS at
   the smallest nprobe whose recall@10 reaches 0.95, one probe-everything
   search (the exact route), and the kernel's launch count;
5. profile: one search at that nprobe under ``torch.profiler`` (device
   time by kernel, device busy share);
6. save/load: a round trip that must return identical ids.

Any failed check ends the run with a non-zero exit. The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = ATOL = 1e-4      # kernel vs plain: f32 sums taken in another order
N_ROWS, DIM, NLISTS, K = 1_000_000, 128, 1024, 10
BATCH, NQ = 16384, 1000
NPROBES = (1, 2, 4, 8, 12, 16)
RECALL_BAR = 0.95


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    # reference comparisons in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build():
    from neurondb_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.load_library("ivf_scan_grouped")
    secs = time.perf_counter() - t0
    for line in _build.BUILD_LOG.get("ivf_scan_grouped", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] nvcc: {line.strip()}")
    log(f"[build] ivf_scan_grouped built and loaded in {secs:.2f} s")


def _layout(rng, lens, dim, dtype, device):
    """Aligned CSR (32-row list starts, 1024-row tail) with random rows."""
    import torch
    from neurondb_tpu_torch.index.ivf import PAD_SEG
    lens = np.asarray(lens, np.int64)
    aligned = (lens + 31) // 32 * 32
    offsets = np.zeros(len(lens), np.int64)
    np.cumsum(aligned[:-1], out=offsets[1:])
    npad = max(1, -(-int(aligned.sum()) // PAD_SEG) * PAD_SEG) + PAD_SEG
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 31)))
    vecs = torch.randn((npad, dim), generator=gen, device=device).to(dtype)
    return (vecs, torch.as_tensor(offsets, dtype=torch.int32, device=device),
            torch.as_tensor(lens, dtype=torch.int32, device=device))


def _probes(rng, b, nprobe, npad, nlists, device):
    """Distinct random lists per query, columns >= nprobe -> sentinel."""
    import torch
    pr = np.argsort(rng.random((b, nlists)), axis=1)[:, :npad].astype(np.int32)
    pr[:, nprobe:] = nlists
    return torch.as_tensor(pr, device=device)


def _tiles(q, probes, offsets, counts, qt):
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    b, npad = probes.shape
    t_max = G.tiles_for(b, npad, counts.shape[0], qt)
    tile_off, tile_cnt, pos = G.group_probes(probes, offsets, counts, qt=qt,
                                             t_max=t_max)
    qpad = G._scatter_tuples(q, pos, npad=npad, qt=qt, t_max=t_max)
    return qpad, tile_off, tile_cnt


def _compare(kd, ki, pd, pi, label):
    """Distances allclose; rows equal wherever the plain distance is more
    than the tolerance away from both neighbours (pd/pi carry one extra
    column, so the last kept entry has a right neighbour too)."""
    import torch
    kp = kd.shape[-1]
    live = pd[..., :kp] < 1e30
    if not torch.equal(kd < 1e30, live):
        fail(f"{label}: kernel and plain disagree on which slots are filled")
    kd_l, pd_l = kd[live], pd[..., :kp][live]
    if not torch.allclose(kd_l, pd_l, rtol=RTOL, atol=ATOL):
        bad = (kd_l - pd_l).abs().max().item()
        fail(f"{label}: distances differ by up to {bad}")
    tol = ATOL + RTOL * pd.abs()
    gap = pd[..., 1:] - pd[..., :-1]                 # [..., kp]
    left = torch.ones_like(live)
    left[..., 1:] = gap[..., :kp - 1] > tol[..., 1:kp]
    right = gap[..., :kp] > tol[..., :kp]
    check = live & left & right
    if not torch.equal(ki[check], pi[..., :kp][check]):
        n = int((ki[check] != pi[..., :kp][check]).sum())
        fail(f"{label}: {n} rows differ at well-separated distances")
    if not torch.equal(ki[~live], torch.full_like(ki[~live], -1)):
        fail(f"{label}: empty slots must hold row -1")
    return float((kd_l - pd_l).abs().max()) if kd_l.numel() else 0.0


def _cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel():
    import torch
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    lens = [0, 3, 31, 1024, 1025, 2500, 700, 64, 1, 333]
    vecs, offsets, counts = _layout(rng, lens, DIM, torch.bfloat16, dev)
    nl = len(lens)
    max_err = 0.0
    n_cases = 0
    for qt in (16, 32, 64):
        for k in (10, 100, 1024):
            for metric in ("sqeuclidean", "ip"):
                b = 3 * qt
                q = torch.randn((b, DIM), device=dev) * 0.5
                probes = _probes(rng, b, 4, 6, nl, dev)
                qpad, toff, tcnt = _tiles(q, probes, offsets, counts, qt)
                kp = max(8, min(k, G.SEG))
                kd, ki = G.grouped_probe_scan(qpad, vecs, toff, tcnt, kp=kp,
                                              metric=metric, qt=qt)
                pd, pi = G.grouped_scan_plain(qpad, vecs, toff, tcnt,
                                              kp=kp + 1, qt=qt, metric=metric)
                torch.cuda.synchronize()
                err = _compare(kd, ki, pd, pi, f"qt={qt} k={k} {metric}")
                max_err = max(max_err, err)
                n_cases += 1
    # a tile set that is all sentinels
    q = torch.randn((32, DIM), device=dev)
    probes = torch.full((32, 4), nl, dtype=torch.int32, device=dev)
    qpad, toff, tcnt = _tiles(q, probes, offsets, counts, 16)
    kd, ki = G.grouped_probe_scan(qpad, vecs, toff, tcnt, kp=10, qt=16)
    torch.cuda.synchronize()
    if not (bool((ki == -1).all()) and bool((kd == G.NEG_FILL).all())):
        fail("all-sentinel tiles must hold (NEG_FILL, -1) only")
    n_cases += 1
    log(f"[kernel] {n_cases} cases match the plain version "
        f"(rtol {RTOL}, atol {ATOL}); max |kernel - plain| = {max_err:.3e}")

    # headline shapes: 1M bf16 rows in 1024 lists, 16,384 queries, nprobe 8
    # padded to 16 (the index's bucket), k = 10
    lens = rng.multinomial(N_ROWS, np.full(NLISTS, 1.0 / NLISTS))
    vecs, offsets, counts = _layout(rng, lens, DIM, torch.bfloat16, dev)
    q = torch.randn((BATCH, DIM), device=dev)
    probes = _probes(rng, BATCH, 8, 16, NLISTS, dev)
    qt = G.auto_qt(BATCH, 16, NLISTS)
    qpad, toff, tcnt = _tiles(q, probes, offsets, counts, qt)
    kp = max(8, K)
    kd, ki = G.grouped_probe_scan(qpad, vecs, toff, tcnt, kp=kp, qt=qt)
    pd, pi = G.grouped_scan_plain(qpad, vecs, toff, tcnt, kp=kp + 1, qt=qt)
    torch.cuda.synchronize()
    max_err = max(max_err, _compare(kd, ki, pd, pi, "headline"))
    ms = _cuda_ms(lambda: G.grouped_probe_scan(qpad, vecs, toff, tcnt, kp=kp,
                                               qt=qt), 20)
    plain_ms = _cuda_ms(lambda: G.grouped_scan_plain(qpad, vecs, toff, tcnt,
                                                     kp=kp, qt=qt), 3)
    live_tiles = int((tcnt > 0).sum())
    log(f"[kernel] headline shapes: {toff.shape[0]} tiles ({live_tiles} live) "
        f"x qt {qt}, kp {kp}, bf16 store {tuple(vecs.shape)}: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per scan")
    del vecs, qpad, pd, pi
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _load_bench_inputs():
    sys.path.insert(0, ROOT)
    from bench import make_corpus          # numpy and the stdlib only
    x = make_corpus(N_ROWS, DIM, corpus="clustered")
    rng = np.random.default_rng(1)         # bench.py:100-103
    q = x[rng.choice(N_ROWS, NQ, replace=False)] + \
        0.05 * rng.standard_normal((NQ, DIM)).astype(np.float32)
    gt = np.load(os.path.join(ROOT, "bench_cache",
                              f"gt_clustered_{N_ROWS}_{NQ}.npz"))["gt_ids"]
    return x, q.astype(np.float32), gt


def phase_main():
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch.ml.metrics import recall_at_k
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G

    t0 = time.perf_counter()
    x, q, gt = _load_bench_inputs()
    log(f"[main] corpus {x.shape} + {q.shape[0]} queries generated in "
        f"{time.perf_counter() - t0:.2f} s")

    # exact neighbours: the port's FlatIndex (f32, no TF32) on the card,
    # held against float64 on the host for 64 queries
    flat = nt.FlatIndex(x, metric="l2", device="cuda")
    _, exact = flat.search(q, k=K)
    del flat
    torch.cuda.empty_cache()
    q64 = q[:64].astype(np.float64)
    d64 = ((x.astype(np.float64) ** 2).sum(1)[None, :]
           - 2.0 * (q64 @ x.T.astype(np.float64)))
    f64 = np.argsort(d64, axis=1)[:, :K]
    r_flat = recall_at_k(exact[:64], f64)
    r_gt = recall_at_k(gt[:64], f64)
    log(f"[main] FlatIndex vs float64 neighbours, 64 queries: recall@10 "
        f"{r_flat:.4f}; committed ground truth vs float64: {r_gt:.4f}; "
        f"committed vs FlatIndex, {NQ} queries: {recall_at_k(gt, exact):.4f}")
    if r_flat < 0.99:
        fail(f"FlatIndex recall@10 {r_flat} < 0.99 against float64")

    G.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = nt.IVFFlatIndex(x, nlists=NLISTS, metric="l2", seed=0,
                            device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = index.stats()
    log(f"[main] IVFFlatIndex built in {build_s:.2f} s: store "
        f"{tuple(index._vecs.shape)} {index._vecs.dtype} on "
        f"{index._vecs.device}, lists {st['list_len_min']}..{st['list_len_max']} "
        f"(mean {st['list_len_mean']:.1f}), k-means inertia "
        f"{st['train_inertia']:.6g}")
    if index._vecs.device.type != "cuda" or index._vecs.dtype != torch.bfloat16:
        fail("the posting store must be bf16 on CUDA")

    qb = np.concatenate([q] * (BATCH // NQ + 1))[:BATCH]
    chosen = None
    for nprobe in NPROBES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ids = index.search(qb, k=K, nprobe=nprobe)
        wall = time.perf_counter() - t0
        r = recall_at_k(ids[:NQ], gt)
        log(f"[main] nprobe {nprobe:>2} f32 wire: recall@10 {r:.4f} "
            f"(vs exact {recall_at_k(ids[:NQ], exact):.4f}), "
            f"batch {BATCH} in {wall * 1e3:.1f} ms")
        if r >= RECALL_BAR and chosen is None:
            chosen = nprobe
    if chosen is None:
        fail(f"recall@10 below {RECALL_BAR} at every nprobe <= {NPROBES[-1]}")
    wire = nt.quantize_queries_int8(qb)
    _, ids = index.search(wire, k=K, nprobe=chosen)
    log(f"[main] nprobe {chosen:>2} int8 wire: recall@10 "
        f"{recall_at_k(ids[:NQ], gt):.4f} "
        f"(vs exact {recall_at_k(ids[:NQ], exact):.4f})")

    def rep():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            index.search(qb, k=K, nprobe=chosen)
        torch.cuda.synchronize()
        return 4 * BATCH / (time.perf_counter() - t0)

    rep()
    reps = [rep() for _ in range(3)]
    qps = float(np.median(reps))
    log(f"[main] QPS at nprobe {chosen} (f32 queries, batch {BATCH}, "
        f"4 batches/rep): median {qps:.0f} of {[round(r) for r in reps]}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ids = index.search(qb[:2048], k=K, nprobe=NLISTS)
    torch.cuda.synchronize()
    r_exact = recall_at_k(ids[:NQ], gt)
    log(f"[main] nprobe {NLISTS} (exact route), batch 2048: recall@10 "
        f"{r_exact:.4f} (vs exact {recall_at_k(ids[:NQ], exact):.4f}) in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    if r_exact < RECALL_BAR:
        fail(f"exact route recall@10 {r_exact} < {RECALL_BAR}")
    launches = G.LAUNCHES
    log(f"[main] grouped-scan kernel launches during the main path: {launches}")
    if launches < len(NPROBES) + 1 + 4 * 4:
        fail(f"the grouped searches did not all go through the kernel "
             f"({launches} launches)")
    return index, qb, chosen, launches


def phase_save_load(index, qb, nprobe):
    import neurondb_tpu_torch as nt
    _, before = index.search(qb, k=K, nprobe=nprobe)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        index.save(tmp)
        loaded = nt.IVFFlatIndex.load(tmp, device="cuda")
        secs = time.perf_counter() - t0
    _, after = loaded.search(qb, k=K, nprobe=nprobe)
    if not np.array_equal(before, after):
        fail(f"save/load changed {int((before != after).sum())} ids")
    log(f"[save_load] round trip in {secs:.2f} s; ids identical")


def phase_profile(index, qb, nprobe):
    """One search under torch.profiler: device time by kernel, and the
    share of the search's wall time the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    index.search(qb, k=K, nprobe=nprobe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.search(qb, k=K, nprobe=nprobe)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] one search at nprobe {nprobe}, batch {BATCH}: wall "
        f"{wall_ms:.2f} ms under the profiler, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.0f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3} "
            f"{e.key[:100]}")


def main(argv):
    import torch
    kernels_only = "--kernels-only" in argv
    phase_device()
    phase_build()
    kstats = phase_kernel()
    launches = None
    if not kernels_only:
        index, qb, chosen, launches = phase_main()
        phase_profile(index, qb, chosen)
        phase_save_load(index, qb, chosen)
    record = {"kernels": [{
        "name": "ivf_grouped_scan", "route": "cuda",
        "source": "neurondb_tpu_torch/csrc/ivf_scan_grouped.cu",
        "replaces": "neurondb_tpu/ops/pallas/ivf_scan_grouped.py:101",
        "launches": launches, **kstats}]}
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
