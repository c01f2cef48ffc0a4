#!/usr/bin/env python3
"""IVF-PQ search parity between two trees of the port, on one card and
one index state.

    python3 scripts/ivfpq_parity.py prepare STATE_DIR
    (cd TREE && python3 $PWD/scripts/ivfpq_parity.py search STATE_DIR OUT TAG)
    python3 scripts/ivfpq_parity.py compare OUT TAG_A TAG_B

``prepare`` builds ``chip_smoke.py``'s IVF-PQ index (the 1M x 128
clustered corpus of ``bench.py``, nlists 1024, n_sub 32 + OPQ, bf16
originals) with the ``neurondb_tpu_torch`` of the working directory,
writes its state arrays (``IVFPQIndex._state``, uncompressed ``.npy``),
the 1,024 queries and their exact top-10 from ``FlatIndex``.

``search`` loads that state with ``IVFPQIndex.from_state`` into the
``neurondb_tpu_torch`` of the working directory (so two trees search the
same index), then at (nprobe, rerank) in (8, 8), (8, 16), (16, 16),
(16, 24), batch 8,192 over the bf16 wire: recall@10 and the pipelined QPS
(median of 3 reps of 4 batches after a warm rep, ``chip_smoke.py``'s
protocol); writes them and the ids at (8, 8) to ``OUT/TAG.npz``.

``compare`` prints both tags' numbers and fails unless recall@10 agrees
within 0.002 at every point and the ids at (8, 8) agree on >= 0.999 of
the slots.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N_ROWS, DIM, NLISTS, K = 1_000_000, 128, 1024, 10
BATCH, NQ = 8192, 1024
SWEEP = ((8, 8), (8, 16), (16, 16), (16, 24))
RECALL_TOL, IDS_BAR = 0.002, 0.999


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _package():
    sys.path.insert(0, os.getcwd())
    import neurondb_tpu_torch as nt
    return nt


def prepare(state_dir: str) -> None:
    import torch
    nt = _package()
    from bench import make_corpus              # numpy and the stdlib only
    x = make_corpus(N_ROWS, DIM, corpus="clustered")
    rng = np.random.default_rng(1)             # chip_smoke.py phase 8
    q = (x[rng.choice(N_ROWS, NQ, replace=False)]
         + 0.02 * rng.standard_normal((NQ, DIM)).astype(np.float32))
    _, gt = nt.FlatIndex(x, metric="l2", device="cuda").search(q, k=K)
    torch.cuda.empty_cache()
    idx = nt.IVFPQIndex(x, nlists=NLISTS, n_sub=32, seed=0,
                        keep_originals=True, opq=True, orig_dtype="bf16",
                        device="cuda")
    arrays, meta = idx._state()
    os.makedirs(state_dir, exist_ok=True)
    for name, a in arrays.items():
        if isinstance(a, torch.Tensor):
            a = a.float() if a.dtype == torch.bfloat16 else a
            a = a.cpu().numpy()
        np.save(os.path.join(state_dir, f"{name}.npy"), np.asarray(a))
    meta = dict(meta, metric="l2", dim=DIM)
    with open(os.path.join(state_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    np.savez(os.path.join(state_dir, "queries.npz"), q=q, gt=gt)
    print(f"[parity] prepared {N_ROWS} x {DIM} IVF-PQ state in {state_dir}")


def search(state_dir: str, out_dir: str, tag: str) -> None:
    import torch
    nt = _package()
    from neurondb_tpu_torch.ml.metrics import recall_at_k
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS
    names = [f[:-4] for f in os.listdir(state_dir) if f.endswith(".npy")]
    arrays = {n: np.load(os.path.join(state_dir, f"{n}.npy")) for n in names}
    with open(os.path.join(state_dir, "meta.json")) as f:
        meta = json.load(f)
    qg = np.load(os.path.join(state_dir, "queries.npz"))
    q, gt = qg["q"], qg["gt"]
    idx = nt.IVFPQIndex.from_state(arrays, meta, device="cuda")
    qb = torch.from_numpy(
        np.concatenate([q] * (BATCH // NQ + 1))[:BATCH]).to(torch.bfloat16)

    def rep(nprobe, rerank):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            idx.search(qb, k=K, nprobe=nprobe, rerank=rerank, out="device")
        torch.cuda.synchronize()
        return 4 * BATCH / (time.perf_counter() - t0)

    recall, qps, ids88 = [], [], None
    PQS.LAUNCHES = 0
    for nprobe, rerank in SWEEP:
        _, ids = idx.search(qb, k=K, nprobe=nprobe, rerank=rerank)
        if (nprobe, rerank) == (8, 8):
            ids88 = ids[:NQ]
        recall.append(recall_at_k(ids[:NQ], gt))
        rep(nprobe, rerank)
        qps.append(float(np.median([rep(nprobe, rerank) for _ in range(3)])))
        print(f"[parity] {tag} nprobe {nprobe:>2} rerank {rerank:>2}: "
              f"recall@10 {recall[-1]:.4f}, QPS {qps[-1]:.0f}")
    print(f"[parity] {tag}: {PQS.LAUNCHES} PQ kernel launches; {_smi()}")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{tag}.npz"), recall=np.array(recall),
             qps=np.array(qps), ids88=ids88)


def compare(out_dir: str, tag_a: str, tag_b: str) -> None:
    a = np.load(os.path.join(out_dir, f"{tag_a}.npz"))
    b = np.load(os.path.join(out_dir, f"{tag_b}.npz"))
    worst = 0.0
    for i, (nprobe, rerank) in enumerate(SWEEP):
        ra, rb = float(a["recall"][i]), float(b["recall"][i])
        worst = max(worst, abs(ra - rb))
        print(f"[parity] nprobe {nprobe:>2} rerank {rerank:>2}: recall@10 "
              f"{tag_a} {ra:.4f} / {tag_b} {rb:.4f}; QPS {a['qps'][i]:.0f} "
              f"/ {b['qps'][i]:.0f}")
    agree = float((a["ids88"] == b["ids88"]).mean())
    print(f"[parity] ids at (8, 8) agree on {agree:.5f} of "
          f"{a['ids88'].size} slots; largest recall@10 gap {worst:.4f}")
    if worst > RECALL_TOL or agree < IDS_BAR:
        raise SystemExit("ivfpq_parity: FAILED: the two trees disagree")


def main(argv):
    cmd, args = argv[0], argv[1:]
    {"prepare": prepare, "search": search, "compare": compare}[cmd](*args)


if __name__ == "__main__":
    main(sys.argv[1:])
