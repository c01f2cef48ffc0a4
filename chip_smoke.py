#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --kernels-only   # device, build, kernel checks

Drives ``neurondb_tpu_torch`` (never JAX, never ``neurondb_tpu``) through
its IVFFlat and IVF-PQ main paths at the headline sizes, in phases that
each print their own lines:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``neurondb_tpu_torch/csrc``, one
   nvcc per source, all started together; prints ptxas registers and
   spills, kept beside each library, so a cached build prints them too;
3. flat kernel against plain: the ptxas registers and spills of each
   instantiation of ``csrc/ivf_scan_grouped.cu`` (bf16 store, tensor
   cores: a spill fails the run) and ``csrc/ivf_scan_grouped_f32.cu`` (f32
   store, FMA: its blockmin spill is printed, an open item of the
   roadmap); ``grouped_probe_scan``'s CUDA kernel
   against its plain torch version on the same card tensors, on a ragged
   bf16 CSR layout (list lengths 0, 3, 31, 1024, 1025, 2500, ...), for qt
   in {16, 32, 64}, k in {10, 100, 1024}, sqeuclidean and ip, in the
   exact, packed and blockmin selection modes, and an all-sentinel tile
   set; bit for bit on integer-valued rows and queries (every mode, kp
   10, 100, 1024 at D 128, 200, 13; kp 10 and 1024 at D 384, 768, 1024,
   which stage 128-dim slabs); then each mode timed at the headline
   shapes (16,384 queries, nprobe 8, nlists 1024, 1M rows) beside its
   bound;
4. PQ kernel against plain: both entries of ``csrc/ivfpq_scan.cu``, the
   fused one (``grouped_pq_scan_fused``: tables built in shared memory,
   live slots only) and the table-fed one (``grouped_pq_scan``), against
   their plain torch versions, bit for bit: list lengths 0, 3, 127, 128,
   1024, 1025, 2500, ..., n_sub in {16, 32}, k in {10, 80, 256}, exact
   and packed, ip, sq-L2 and sq-L2 with an OPQ rotation, ragged tiles
   (empty slots), and an all-sentinel tile set; ptxas registers and
   spills of the four instantiations; then both modes of the fused kernel
   timed at the IVF-PQ headline shapes (8,192 queries, nprobe 8, n_sub
   32, 1M rows) in alternating turns with ``build_luts`` + the table-fed
   kernel, beside the bound (bytes and operations printed), the
   shared-memory lookup floor and the resident warps per SM;
5. IVFFlat main path: the 1M x 128 clustered corpus of ``bench.py``;
   exact neighbours from ``FlatIndex`` on the card, held against float64
   on the host and set beside the committed ground truth
   (``bench_cache/gt_clustered_1000000_1000.npz``); an
   ``IVFFlatIndex(nlists=1024)`` built on the card; recall@10 over nprobe
   in (1, 2, 4, 8, 12, 16) at batch 16,384 with the default (packed)
   selection, QPS at the smallest nprobe whose recall@10 reaches 0.95,
   the int8 wire, one probe-everything search (the exact route); then
   recall@10, QPS (the three modes timed in turns) and kernel launches
   for each selection mode (exact, packed, blockmin) at that nprobe;
6. profile: one IVFFlat search at that nprobe under ``torch.profiler``;
7. save/load: an IVFFlat round trip that must return identical ids;
8. IVF-PQ main path, the protocol of ``scripts/bench_ivfpq.py``: 1,024
   queries near corpus rows, exact ground truth from ``FlatIndex``;
   ``IVFPQIndex(nlists=1024, n_sub=32, opq=True, keep_originals=True)``
   with bf16 originals; (nprobe, rerank) in (8, 8), (8, 16), (16, 16),
   (16, 24) at batch 8,192 over the 2-byte query wire: recall@10 and the
   pipelined QPS (median of 3 reps of 4 batches); exact selection at the
   first point that reaches recall@10 0.95 (it must exist); one search
   profiled (device time by kernel, busy share, the fill and scatter
   kernels' time); one search's peak device memory, which must stay below
   the table buffer the table-fed route would allocate; fused launches per
   search; a save/load round trip
   of a 100k-row index (nlists 128, n_sub 32, OPQ: the 1M index's took
   105-124 s of host compression);
   one search with a delete outstanding (the segment route); then the
   n_sub = 16 index (no OPQ) at nprobe 4, rerank 0 and 8;
9. HNSW main path (after 7, on 5's corpus and exact neighbours):
   ``bench.py``'s secondary configuration, ``HNSWIndex(x, m=16, seed=0,
   build_mode="bulk")``: build seconds per phase, peak device memory and
   the grouped kernel's launches during the build (its IVF bootstrap:
   nlists 2,000, k 33, nprobe 16, batches of 16,384), which must be more
   than 0; the grouped kernel at the bootstrap's first batch against its
   plain version, timed beside its bound; recall@10 (against the exact
   f32 neighbours, which must reach 0.95 at some ef <= 128, and against
   the committed ground truth) and QPS at batch 16,384 for ef in 16, 24,
   32, 48, 64, 96, 128, with no duplicate id in a row and every returned
   distance its row's own; a profile of one 4,096-query sub-batch; 10,000
   rows added (each must find itself first on >= 0.9), 1% of ids deleted
   (none returned), one compact, and a save/load round trip of a
   100k-row index that must return identical ids;
10. flash kernel against plain: ``flash_attention``'s CUDA kernel against
   ``flash_attention_plain`` at the kernel's KV tile, for Dh in {32, 64,
   128}, S in {1, 100, 127, 128, 129, 257, 300, 512, 513, 640, 1900} (the
   128-row query tile's edges among them), ragged masks, a fully masked
   row and no mask, bf16 and f32 products; every instantiation's ptxas
   registers, spills and resident blocks per SM; then both modes timed at
   (64, 12, 512, 64) with a ragged mask, (1, 8, 8192, 128) and (1, 2,
   8192, 64) beside the bound, the plain version and
   ``scaled_dot_product_attention`` on the same inputs (bf16: on bf16
   casts made inside the timed call), kernel and SDPA in alternating
   turns, medians and their ratio; SDPA's kernels named once per mode
   from a profile;
11. cross-encoder main path: a BERT-base export (random weights from a
   numpy seed) in a temp dir; ``rerank_cross_encoder`` over 256 docs of
   512 tokens through ``PretrainedCrossEncoder(max_len=512, batch=64)``
   with the flash launches of that call counted per mode; docs/s
   pipelined, serial and encode-bound, the tokenizer's share; scores
   against ``use_flash=False``; one call profiled, with the flash
   kernel's share of its device time; ``PretrainedEmbedder``
   self-retrieval through a cosine ``FlatIndex``; the default
   ``CrossEncoder()`` and ``TextEmbedder()`` through the kernel;
12. generation, ViT and RAG (``phase_generate``, with transformers, PIL
   and regex blocked from import): GPT-2 small at the published ``gpt2``
   widths (vocab 50,257, hidden 768, 12 layers, 12 heads, 1,024
   positions), random N(0, 0.02) weights, the byte tokenizer: (a) f32
   greedy decode of 8 left-padded prompts of 5-64 tokens, 32 new, each
   token the argmax of ``gpt_logits`` over prompt + generated prefix (a
   top-2 gap under ``GPT_TIE_TOL`` excepted); (b) the W8A8 int32
   accumulate (``torch._int_mm`` on padded operands) bit for bit with f64
   sums at every decode and prefill GEMM shape of the int8 model
   (``GPT_MM_ROWS``), the lm head at B 1, 16, 64, 128; (c) the int8 cache
   within the JAX test's dequant bound, int8 KV and int8_dot
   teacher-forced against the bf16 cache's logits (max and mean |diff|,
   ``GPT_KV_TOL`` / ``GPT_KV_MEAN``; argmax agreement, ``GPT_KV_AGREE``;
   free-running greedy tokens equal up to a near-tie), int8_dot's code
   products exact at P 1,056; (d) sampling at top_k 50 / top_p 0.9: every
   draw in the kept set, seeded, eos latched; no host wait inside the
   decode loop (sync debug mode: 32 tokens wait as often as 2, greedy,
   sampled and int8_dot); (e) decode tokens/s, ms a step, prefill ms and peak
   memory for B 1, 16, 64, 128 x f32 / bf16 / int8 weights x bf16 / int8
   KV (prompt 64, 64 new), the int8-KV crossover beside the JAX
   package's 64, one B 128 decode profiled. ViT-base (224 px, patch 16)
   on 64 raw RGB images: the flash kernel at (64, 12, 197, 64), no mask,
   against its plain version, ``embed_images`` with 12 flash launches
   counted, images/s, against ``use_flash=False`` (``VIT_FLASH_TOL``),
   ``EmbeddingService.embed_image``, the kernel's share of a profile.
   RAG through ``Client().rag()`` on an all-MiniLM-L6-v2-geometry export
   (``NEURONDB_TORCH_WEIGHTS``): 10,000 documents, ~39k chunks, the
   stages' seconds and the embed's flash launches (layers x sub-batches),
   the kernel on the first sub-batch's own inputs (1,024, 12, 128, 32,
   ragged key mask) against its plain version, that sub-batch's vectors
   against ``use_flash=False`` (``RAG_EMB_TOL``),
   256 queries at weight 0 (self-hit >= 0.99) and 0.5, queries/s, the
   dense top-5 of 32 against float64, then 64 context + question prompts
   through ``Client().llm.complete_batch`` -> ``LocalProvider`` ->
   ``GPT2LM`` (bf16, 32 new tokens): seconds and tokens/s.

Between 10 and 11, the probe kernel against plain: ``probe_scan``'s CUDA
kernel (work table + kernel) against ``probe_scan_plain``; ptxas
registers and spills of both instantiations (a spill fails the run), the
query tile and resident blocks per SM at kp 10, 100, 512; ragged lists
0-2500 rows at B 37, k 1 to 1000, nprobe 1 to 6, both metrics; hot lists
(every query probes the same 3, so items split) and adjacent empty lists
at k 10 and 512; D 384, 768 and 1024 (rows staged in 128-dim slabs) in
both stores at k 10 and 512; an all-empty probe set; then two
headlines, 16,384 x
nprobe 8 and 1,024 x nprobe 4 on the 1M-row layout: the wrapper, the
kernel alone and the work table in turns, beside the bound and the rows
the kernel reads. After 5, on its index, the probe route
(``ivf_kernel="probe"``): recall over NPROBES, QPS beside the grouped
route at batch 16,384 and 1,024, launches, a profile at both batches and
one of the grouped route at batch 1,024.

After 8 (IVF-PQ) and before 11, on 5's corpus, two phases:

- quantized flat (``BASELINE.json`` config 3): ``topk_smallest`` and
  ``topk_largest`` on the card against a stable sort on tied integer
  rows; ``quantize`` on the card against the CPU's, every bit, in all ten
  formats on 4,096 rows; the IVF coarse top-k ([16,384, 1,024], n 4 and
  16) before (``torch.topk``) and after the tie repair, in turns;
  ``QuantizedFlatIndex(x, fmt, metric="ip")`` for int8 and f16 (and
  binary with l2, printed without a bar), originals kept, k 10, rerank 8,
  on 1,024 queries: build seconds, ``compression_bytes`` and the device
  memory held, recall@10 against exact ip from ``FlatIndex`` (fails under
  0.95 int8 / 0.99 f16), QPS (median of 3 reps after a warm one); fails
  on an id twice in a row or a distance off -q.x of its stored row by
  more than 1e-5 of |q||x|;
- hybrid (``BASELINE.json`` config 4 as ``bench.py:204-224`` runs it):
  200,000 documents ``topic{i % 64} item {i} cluster word{i % 64}``,
  ``IVFFlatIndex(x[:200000], nlists=512)`` and ``BM25Index`` (the hashed
  build; tokenizer and postings seconds), 512 queries from
  ``default_rng(3)``; ``hybrid_search_batch`` and ``HybridSearcher`` at
  k 10, nprobe 8, candidates 100: QPS (median of 3), self-hit (fails
  under 0.99), peak memory, the grouped kernel's launches; fails when the
  two searchers' id sets differ, when ``scores_batch`` on the card
  differs in any bit from the host oracle on 64 queries, or when host
  fusion (``device=False``) and the card's differ past a near-tie (fused
  scores within 1e-6 of the k-th; each case printed); one served batch
  profiled, and its ANN, BM25 and fusion stages one by one; then a
  ``Collection(index="ivfflat")`` of 20,000 rows on the card through
  ``planned_search`` (ann, fts and hybrid routes; the ann route returns
  the query's own id first).

Then, before 11, the sharded phase (``BASELINE.json`` config 5, the
``neurondb_tpu_torch.parallel`` indexes on ``make_mesh(4, device="cuda")``:
four logical shards of one card, or one shard a card where four are
visible):

- config 5 cut to one card: ``bench.make_corpus(10_000_000, 96, seed=5,
  corpus="clustered")``, 4,096 queries (corpus rows plus noise, their own
  seed); exact neighbours from ``FlatIndex``, which ``ShardedFlatIndex``
  must return apart from distance ties; ``ShardedIVFIndex(nlists=4096)``:
  build seconds by stage and peak device memory, then at nprobe 8, 16,
  32, 64 recall@10, QPS (median of 3 one-search reps after a warm one)
  and the probe kernel's launches per search (one a shard); fails unless
  some nprobe reaches 0.95 or on an id twice in a row; one search
  profiled (the probe kernel's share, the busy share); the probe kernel
  against ``probe_scan_plain`` at shard 0's CSR (caught from one more
  search; held to a share of |q|^2 + |x|^2, ``SH_TERMS_TOL``);
  ``sharded_kmeans_step`` against one Lloyd step of ``ml/kmeans`` on 4M
  rows and the index's centroids (fails past 1e-4);
  ``MultiHostIVFIndex.from_chunks`` over a factory of ten 1M-row chunks
  on a 2 x 2 mesh: build seconds, recall@10 at the same nprobes (fails
  under 0.95 at nprobe 64);
- on 5's corpus: ``ShardedHNSWIndex(x, m=16)`` (build seconds, the
  grouped kernel's launches in the shards' bootstraps, which must be
  more than 0, recall@10 at ef 16, 32, 64, 128, which must reach 0.95);
  ``ShardedIVFPQIndex(nlists=1024, n_sub=32)`` with int8 originals at
  (nprobe, rerank) (8, 8) and (16, 16) (rerank_k = rerank x k): recall@10
  (must reach 0.95), QPS and fused launches per search (one a shard);
  the grouped kernel against its plain version at shard 0's first
  bootstrap batch, the fused PQ kernel against its plain version at shard
  0's tiles (bit for bit);
- the phase's launches join the kernels line's rows (probe exact, PQ
  exact, grouped in the bootstrap's mode), and its wall seconds print.

The store, specialty, validate, graph and ML checks (no kernel of their
own; ROADMAP items 14 and 15):

- after 7, ``validate_index`` on 5's 1M ``IVFFlatIndex`` (bf16 store): the
  sampled rows' recomputed labels that differ and those within the bf16
  rounding bound; a list count off by one must turn it invalid;
- between 7 and 9, on 5's corpus, 1,024 queries, k 10 (``phase_store``):
  ``VectorStore(128)`` f32 and bf16 filled in ``add`` batches of 65,536 to
  capacity 1,048,576 (rows/s, memory held), l2 and cosine against
  ``FlatIndex`` (the f32 store's ids equal apart from distance ties), QPS;
  1% of ids deleted (none returned), ``compact``, equal to a fresh store of
  the survivors byte for byte; ``RerankReadyIndex(x, k=32)``: ``warm``, then
  1,024 lookups that must all hit with no device event under
  ``torch.profiler``, and 64 misses after the cache is emptied that return
  the hits' ids; ``ConsistentIndex``: pin, 10,000 rows added, 1% deleted,
  pin again: the first pin's results byte-identical before and after, each
  pin's searches byte-identical;
- in 9, after the ef sweep: ``validate_index`` on the 1M ``HNSWIndex`` (its
  reachable fraction; a planted self loop must turn it invalid), then its
  level-0 adjacency (1M x 32) as a ``VectorGraph`` on the card: ``bfs`` from
  the entry (its reachable share must equal validate's exactly),
  ``connected_components`` (passes, seconds), ``pagerank`` (50
  iterations, sums to 1 within 1e-4), ``community_labels`` (20 iterations,
  equal to the CPU's on the 20,000-node induced subgraph);
- after the hybrid phase, the ML runtime (``phase_ml``) through
  ``Client(device="cuda").train / predict / evaluate`` on the 1M x 128
  table with seeded targets (``y = X w + 0.1 e``, ``X w > median``, the
  argmax of ``X W + e`` over 10 classes): every ported algorithm at its
  JAX defaults (k-means and mini-batch k-means at k 256, GMM at k 64, PCA
  at 32 components with and without whitening, the dual SVM at its
  default sample_cap 8,192; DBSCAN and agglomerative clustering on the
  first 10,000 rows), each line its train seconds, predict rows/s on
  16,384 rows and its metrics, each model persisted and reloaded to
  predict bit for bit; held to: the f64 normal equations (linear, ridge),
  f64 ``numpy.linalg.eigh`` (PCA eigenvalues), f64 class moments (naive
  Bayes), the f64 inertia of the returned centroids (k-means), votes and
  weights from ``FlatIndex``'s exact neighbours on 1,024 rows (kNN), the
  labels' Bayes-optimal accuracy less ``ACC_MARGIN``, counted from
  ``client.predict`` on the whole table (logistic, SVM), a
  log-likelihood above the k-means++ start (GMM); the JAX-format models
  in ``tests/data/jax_registry`` load on the card and predict as the JAX
  package did on the CPU; the phase's seconds and peak memory.

Any failed check ends the run with a non-zero exit. The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = ATOL = 1e-4      # flat kernel vs plain: f32 sums in another order
SEL_RTOL = 1e-3         # packed modes: the tolerance of the JAX kernel tests
PQ_TOL = 1e-6           # PQ kernel vs plain: the same f32 sums, same order
N_ROWS, DIM, NLISTS, K = 1_000_000, 128, 1024, 10
BATCH, NQ = 16384, 1000
NPROBES = (1, 2, 4, 8, 12, 16)
RECALL_BAR = 0.95
PQ_BATCH, PQ_NQ = 8192, 1024
PQ_SWEEP = ((8, 8), (8, 16), (16, 16), (16, 24))
SAVE_ROWS = 100_000       # the IVF-PQ save/load round trip's index
KERNELS = ("ivf_scan_grouped", "ivf_scan_grouped_f32", "ivfpq_scan",
           "flash_attention", "ivf_probe_scan", "ml_recurrence")
# flash kernel vs plain: f32 sums in another order; with bf16 products a
# p within f32 noise of a rounding boundary may round one bf16 step
# (2^-8) apart, moving an output by up to 2^-8 * (p / l) * |v|
FLASH_TOL = {True: 2e-3, False: 1e-4}
REF_TOL = {True: 5e-2, False: 2e-3}     # vs attention_reference (JAX tests)
FLASH_SHAPES = ((64, 12, 512, 64, True), (1, 8, 8192, 128, False),
                (1, 2, 8192, 64, False),  # (B, H, S, Dh, ragged mask)
                (64, 12, 197, 64, False),  # ViT-base, 64 images
                (1024, 12, 128, 32, True))  # the RAG embed's sub-batch
# the grid's sequence lengths, the 128-row query tile's edges among them
FLASH_S = (1, 100, 127, 128, 129, 257, 300, 512, 513, 640, 1900)
FLASH_TURNS, FLASH_REPS = 7, 10    # alternating turns of kernel and SDPA
RR_DOCS, RR_BATCH, RR_LEN, RR_K = 256, 64, 512, 10
BERT_BASE = dict(vocab=30522, hidden=768, layers=12, heads=12, ff=3072,
                 max_len=512)
# scores with the kernel vs use_flash=False: bf16 attention rounding
# through 12 layers (the plain version on the CPU moved scores by 1.4e-5
# at 2 layers and 1.6e-5 at 4, BERT-base width, S 512)
SCORE_TOL = 1e-3
SELF_HIT_BAR = 0.99
# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, and FLOP/s by the
# type of the products: bf16 x bf16 -> f32 on the tensor cores, f32
# outside them, and f32-accurate products made of three TF32 tensor-core
# products each (the f32 flash mode) at a third of the 495 TFLOP/s TF32 rate
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16 tensor core": 989e12, "f32": 67e12,
              "f32 as 3 TF32 tensor-core passes": 495e12 / 3}
SOURCES = {
    "ivf_grouped_scan": ("neurondb_tpu_torch/csrc/ivf_scan_grouped.cu",
                         "neurondb_tpu/ops/pallas/ivf_scan_grouped.py:101"),
    "ivfpq_grouped_scan": ("neurondb_tpu_torch/csrc/ivfpq_scan.cu",
                           "neurondb_tpu/ops/pallas/ivfpq_scan.py:60"),
    "flash_attention": ("neurondb_tpu_torch/csrc/flash_attention.cu",
                        "neurondb_tpu/ops/pallas/flash_attention.py:68"),
    "ivf_probe_scan": ("neurondb_tpu_torch/csrc/ivf_probe_scan.cu",
                       "neurondb_tpu/ops/pallas/ivf_scan.py:36"),
    # no TPU kernel: the lax.scan loops the kernel replaces
    "ml_recurrence": ("neurondb_tpu_torch/csrc/ml_recurrence.cu", {
        "q_learning": "neurondb_tpu/ml/rl.py:33",
        "holt_winters": "neurondb_tpu/ml/timeseries.py:62"}),
}
# the probe kernel's ragged layout: list lengths around its 512-row segment
PROBE_LENS = (0, 3, 31, 511, 512, 513, 1024, 1025, 2500)
PROBE_B = 37              # queries per case: no multiple of 16
PROBE_CASES = tuple((k, npb) for k in (1, 10, 100, 512) for npb in (3, 6)) + \
    ((1000, 1), (1000, 3))  # (k, nprobe): 1000 caps per probe and pads
PROBE_HOT = (8, 6, 5)      # lists every query probes: 2500, 1024, 513 rows
PROBE_WIDE = (384, 768, 1024)   # widths staged in 128-dim slabs
PROBE_WIDE_ROWS = 100_000       # the wide widths' timed layout
# adjacent empty lists, each starting where the next list starts
PROBE_LENS_EMPTY = (0, 0, 40, 0, 700, 0, 0, 3, 1100)
ROUTE_AGREE_BAR = 0.99    # probe route ids vs the grouped exact mode's
# HNSW: bench.py's secondary configuration on the main path's corpus
HNSW_M = 16
HNSW_EFS = (16, 24, 32, 48, 64, 96, 128)
HNSW_ADD = 10_000          # rows added to the built index
HNSW_DELETE = 0.01         # share of ids deleted
HNSW_SELF_BAR = 0.9        # added rows that find themselves first
HNSW_DIST_RTOL = 1e-3      # returned distance vs its row's own distance
# ... plus this share of |q|^2 + |x|^2, where the f32 expansion rounds:
# 3.4x the largest reading, 2.9e-7 (NVIDIA H100 80GB HBM3, 700 W)
HNSW_TERMS_TOL = 1e-6
# the grouped scan vs plain where the queries are corpus rows (the HNSW
# bootstrap, the hybrid ANN), absolute: 4.1x the largest reading at the
# bootstrap's self-hits (d ~ 0 beside terms ~ 2,000), 7.3e-4 (the same
# card)
SELF_QUERY_ATOL = 3e-3

# quantized flat (BASELINE.json config 3) on the main path's corpus
QF_NQ, QF_RERANK = 1024, 8
QF_SAMPLE = 4096          # rows of the quantize bit check
# a returned ip distance against -q.x of its stored row, in f64 on the
# host: a share of |q||x| (f32 GEMMs of 128 products)
QF_DIST_TOL = 1e-5
# hybrid (BASELINE.json config 4) as bench.py:204-224 runs it
HYBRID_DOCS, HYBRID_NLISTS, HYBRID_NQ = 200_000, 512, 512
HYBRID_NPROBE, HYBRID_C = 8, 100
# host fusion sums in Python floats, the card's in f32: documents within
# this of the k-th fused score may swap between the two
HYBRID_TIE_TOL = 1e-6
COLLECTION_ROWS = 20_000
# BASELINE.json config 5 (DEEP-100M, 96-d) cut to one card: 10M rows of
# bench.py's clustered corpus at DEEP's width over 4 logical shards
SH_ROWS, SH_DIM, SH_SEED, SH_NQ = 10_000_000, 96, 5, 4096
SH_SHARDS, SH_NLISTS = 4, 4096
SH_NPROBES = (8, 16, 32, 64)
SH_CHUNK = 1_000_000        # the 2-D index's streaming chunks
SH_KMEANS_ROWS = 4 << 20    # whole 16,384-row assignment chunks per shard
SH_KMEANS_TOL = 1e-4        # sharded k-means step vs one Lloyd step
SH_FLAT_TIE_RTOL = 1e-5     # ShardedFlatIndex vs FlatIndex: ties may swap
# the probe kernel vs plain at shard 0's CSR, a share of |q|^2 + |x|^2:
# 4x the first reading, 1.0e-6 (9.8e-4 at terms ~1,000; NVIDIA H100 80GB
# HBM3, 700 W)
SH_TERMS_TOL = 4e-6
SH_EFS = (16, 32, 64, 128)
SH_PQ_SWEEP = ((8, 8), (16, 16))   # (nprobe, rerank): rerank_k = rerank * k
# generation, ViT and RAG (phase_generate): the published gpt2 config
GPT2_SMALL = dict(vocab=50257, hidden=768, layers=12, heads=12, max_len=1024)
GPT_B, GPT_PROMPT, GPT_NEW = 8, 64, 32     # (a): left-padded prompts 5-64
# a token may differ from the no-cache argmax only where the two logits
# lie this close (f32 sums in another order)
GPT_TIE_TOL = 1e-4
GPT_TP_BATCHES = (1, 16, 64, 128)          # throughput: prompt 64, 64 new
GPT_TP_PROMPT = GPT_TP_NEW = 64
# the W8A8 rows that the int8 model meets (only (e) runs it): decode B,
# prefill B x prompt; the lm head at decode B (prefill takes the last row)
GPT_MM_ROWS = tuple(sorted(set(GPT_TP_BATCHES)
                           | {B * GPT_TP_PROMPT for B in GPT_TP_BATCHES}))
GPT_TOP_K, GPT_TOP_P = 50, 0.9
# int8 KV and int8_dot against the bf16 cache, teacher-forced logits (std
# 0.553 at these weights): max and mean |diff| at ~2x the readings (max
# 0.0138 / 0.2034, mean 0.00153 / 0.01396) and the share of steps whose
# argmax agrees (readings 0.992 / 0.957). Planted faults, by
# scripts/gpt_kv_faults.py: int8_dot without its value or key scales
# moves the max past 3 and the agreement under 0.06; int8 codes
# truncated, not rounded, the int8 KV mean to 0.0037 (NVIDIA H100 80GB
# HBM3, 700 W)
GPT_KV_TOL = {"int8 KV": 0.03, "int8 KV + int8_dot": 0.4}
GPT_KV_MEAN = {"int8 KV": 0.003, "int8 KV + int8_dot": 0.028}
GPT_KV_AGREE = {"int8 KV": 0.9, "int8 KV + int8_dot": 0.9}
# google/vit-base-patch16-224's geometry
VIT_BASE = dict(hidden=768, layers=12, heads=12, ff=3072, patch=16,
                image_size=224)
VIT_IMAGES = 64
# vit_encode with the flash kernel vs use_flash=False, final-LN CLS (|cls|
# up to ~4): the JAX flash tests' bf16 tolerance, 8.3x the reading 6.0e-3
# (NVIDIA H100 80GB HBM3, 700 W)
VIT_FLASH_TOL = 5e-2
# all-MiniLM-L6-v2's geometry (vocab 30,522, 512 positions, max_len 128)
MINILM = dict(vocab=30522, hidden=384, layers=6, heads=12, ff=1536,
              max_len=512)
RAG_DOCS, RAG_SENTS = 10_000, 27            # ~1,500 characters a document
RAG_QUERIES, RAG_DENSE, RAG_GEN, RAG_GEN_NEW = 256, 32, 64, 32
RAG_SELF_HIT_BAR = 0.99
RAG_TIE_TOL = 1e-5        # cosine: f32 card products vs f64 on the host
# the embed's unit vectors, flash vs use_flash=False: 6.4x the reading
# 7.8e-5 (NVIDIA H100 80GB HBM3, 700 W)
RAG_EMB_TOL = 5e-4
# store, specialty and validate (phase_store on the main path's corpus; the
# validate and graph checks beside phase_main's IVF and phase_hnsw's graph)
STORE_BATCH = 65_536        # VectorStore.add batch
STORE_NQ = 1024             # queries of the store and specialty checks
STORE_DELETE = 0.01         # share of ids deleted
RRI_K = 32                  # RerankReadyIndex candidates a query
RRI_MISSES = 64             # lookups after the cache is emptied
CQ_ADD = 10_000             # rows added between the two pins
GRAPH_SUB = 20_000          # community_labels held to the CPU on this subgraph
GRAPH_PR_ITERS, GRAPH_CL_ITERS = 50, 20
PR_SUM_TOL = 1e-4
# the ML runtime (phase_ml) on config 1's corpus
ML_LABEL_SEED = 7
ML_PREDICT_ROWS = 16_384
ML_SMALL_ROWS = 10_000      # DBSCAN and agglomerative: the module's scale
ML_KNN_CHECK = 1024
ML_PHASE_S = 150
# about 10x the readings of PR 15's chip runs 4-5 (NVIDIA H100 80GB HBM3,
# 700 W): linear / ridge 4.97e-6, PCA 3.47e-5, naive Bayes 6.1e-7; a TF32
# Gram, covariance or moment GEMM moves them by ~1e-4 to 1e-3
LIN_RTOL = 5e-5
PCA_RTOL = 3.5e-4
NB_RTOL = 6e-6
INERTIA_RTOL = 1e-4
KNN_RTOL = 1e-4
# accuracy bars: the labels' Bayes-optimal accuracy (1.0 for the noiseless
# binary label) less a margin for the fixed step budgets of the JAX
# defaults (50 Newton steps; 500 and 300 gradient steps sized by the mean
# squared row norm; 256 random features). On the card they read 0.9991,
# 0.5826 (Bayes-optimal 0.6557), 0.9310, 0.9757 and 0.7907 (NVIDIA H100
# 80GB HBM3, 700 W); a broken fit reads ~0.5 (binary) or ~0.1 (10 classes).
ACC_MARGIN = {"logistic binary": 0.02, "logistic 10-class": 0.12,
              "svm primal": 0.1, "svm dual": 0.05, "svm rff": 0.3}
# the port's accuracy (an f32 mean of 0 / 1 over 1M rows: exact sums, one
# rounding in the division) against the host's count
ACC_AGREE = 1e-6
FIXTURE_TIE = 1e-4
FIXTURE_TOL = 1e-4
# the families ported last (trees, boosting, time series, ALS, the MLP,
# Q-learning, GCN, LDA, drift, automl, mlops): their own time budget
ML2_PHASE_S = 150
# rows each tree family trains on (config 1's 1M corpus unless cut)
TREE_ROWS = {"decision_tree": 1_000_000, "random_forest": 1_000_000,
             "gradient_boosting": 1_000_000, "xgboost": 1_000_000,
             "lightgbm": 250_000, "catboost": 1_000_000}
TREE_PLAIN_ROWS = 100_000   # the first tree on the CPU and the card
# the chosen split's f64 gain below the best f64 gain of its root
TREE_GAIN_RTOL = 1e-5
TS_POINTS = 1_051_200       # two years of minute readings
TS_SEASON = 12
HW_CHECK_STEPS = 20_000     # the kernel against the plain loop
TS_AR_RTOL = 1e-3           # AR(4) / ARIMA coefficients vs f64 least squares
HW_RTOL = 1e-4              # fitted values vs the f64 recurrence / max |y|
ML1M = dict(users=6040, items=3706, ratings=1_000_209, rank=16,
            min_per_user=20)                 # GroupLens ML-1M README
ALS_HOLDOUT = 0.05
ALS_RTOL = 1e-4             # last half-step rows' f64 normal-equation residual
MLP_CHECK_STEPS = 5
MLP_RTOL = 1e-4             # Adam steps vs an f64 recomputation
Q_SIDE = 32                 # gridworld 32 x 32, goal at the far corner
Q_TRANSITIONS = 1_000_000
Q_CHECK = 100_000           # the kernel against the plain loop, 1 epoch
GCN_TRAIN_FRAC = 0.1
GCN_PROP_ROWS = 100_000     # rows of the f64 scipy.sparse reference
GCN_PROP_RTOL = 1e-5
LDA_SUM_TOL = 1e-5
DRIFT_ROWS = 500_000
DRIFT_SHIFTED = 8           # features shifted by +0.5 in the live rows
DRIFT_CHECK = 16            # features held to f64 numpy / scipy
PSI_ATOL = 1e-4
AUTOML_ROWS = 100_000
AUTOML_TOL = 1e-3           # leaderboard score vs the trainers called directly
SMEM_ROUND_TRIP_NS = 15     # ~30 cycles at 1.98 GHz: the recurrence's step
HNSW_LEVEL0 = None          # the HNSW phase's 1M x 32 level-0 graph (host)
ML2_OWN_S = {}              # each family's own train + predict seconds
ML2_PEAK = [0]              # the largest allocation peak seen before a reset

def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _zero_launches():
    """Every kernel wrapper's launch count to 0 (flash: per mode)."""
    from neurondb_tpu_torch.ops.kernels import flash_attention as FA
    from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS
    from neurondb_tpu_torch.ops.kernels import ml_recurrence as MREC
    G.LAUNCHES = PQS.LAUNCHES = PS.LAUNCHES = 0
    FA.LAUNCHES = dict.fromkeys(FA.LAUNCHES, 0)
    MREC.LAUNCHES = dict.fromkeys(MREC.LAUNCHES, 0)


def _smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    smi = _smi()
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
    _build.build(KERNELS)
    for name in KERNELS:
        _build.load_library(name)
    secs = time.perf_counter() - t0
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            kernel = re.search(
                r"((?:grouped|pq|probe)_scan(?:_mma)?_kernel|"
                r"flash_(?:bf16|f32)_kernel)"
                r"I(.*?)EEv", line)
            if kernel and "Function properties" in line:
                # the kernel's template arguments: store type, mode
                line = f"{kernel.group(1)}<{kernel.group(2)}> (mangled)"
            elif kernel or not ("registers" in line or "spill" in line
                                or "error" in line):
                continue
            log(f"[build] {name}: {line.strip()}")
    log(f"[build] {', '.join(KERNELS)} built together and loaded in "
        f"{secs:.2f} s")


def _layout(rng, lens, dim, dtype, device, align=32):
    """Aligned CSR (``align``-row list starts, 1024-row tail) with random
    rows."""
    import torch
    from neurondb_tpu_torch.index.ivf import PAD_SEG
    lens = np.asarray(lens, np.int64)
    aligned = (lens + align - 1) // align * align
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
    return qpad, tile_off, tile_cnt, pos


def _compare(kd, ki, pd, pi, label, rtol=RTOL, atol=ATOL):
    """Distances allclose (``atol`` a number or one per plain entry); rows
    equal wherever the plain distance is more than the tolerance away
    from both neighbours (pd/pi carry one extra
    column, so the last kept entry has a right neighbour too)."""
    import torch
    kp = kd.shape[-1]
    live = pd[..., :kp] < 1e30
    if not torch.equal(kd < 1e30, live):
        fail(f"{label}: kernel and plain disagree on which slots are filled")
    kd_l, pd_l = kd[live], pd[..., :kp][live]
    # atol: a number, or one per plain entry (pd's shape)
    at = torch.as_tensor(atol, dtype=pd.dtype, device=pd.device).expand_as(pd)
    if not ((kd_l - pd_l).abs() <= at[..., :kp][live]
            + rtol * pd_l.abs()).all():
        bad = (kd_l - pd_l).abs().max().item()
        fail(f"{label}: distances differ by up to {bad}")
    tol = at + rtol * pd.abs()
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


def _row_dists(qpad, vecs, rows, metric, qt):
    """The plain version's distance of every live output row (q rounded to
    the store type, f32 products), in output order."""
    import torch
    T, _, kp = rows.shape
    qf = qpad.float().reshape(T, qt, 1, -1).expand(-1, -1, kp, -1)
    live = rows >= 0
    q = qf[live]
    x = vecs[rows[live].long()].float()
    dots = (x * q.to(vecs.dtype).float()).sum(-1)
    if metric == "ip":
        return -dots
    return torch.clamp(((q * q).sum(-1) + (x * x).sum(-1)) - 2.0 * dots,
                       min=0.0)


def _compare_packed(kd, ki, pd, pi, qpad, vecs, metric, qt, pb, label,
                    positional, atol=ATOL):
    """Packed keys: sorted values allclose at rtol 1e-3 + 2 * 2**(pb-24)
    (tests/test_pallas_kernels.py:159-246); every kernel row decodes to
    its own distance within the key rounding; with ``positional`` (packed,
    not blockmin) rows equal away from near-ties."""
    import torch
    step = 2.0 ** (pb - 24)
    err = _compare(kd, ki, pd, pi, label, rtol=SEL_RTOL + 2 * step,
                   atol=atol) if positional else None
    kp = kd.shape[-1]
    live = pd[..., :kp] < 1e30
    if not torch.equal(kd < 1e30, live):
        fail(f"{label}: kernel and plain disagree on which slots are filled")
    kd_l, pd_l = kd[live], pd[..., :kp][live]
    if not torch.allclose(kd_l, pd_l, rtol=SEL_RTOL + 2 * step, atol=atol):
        fail(f"{label}: sorted distances differ by up to "
             f"{(kd_l - pd_l).abs().max().item()}")
    own = _row_dists(qpad, vecs, ki, metric, qt)
    if not torch.allclose(kd_l, own, rtol=RTOL + 2 * step, atol=atol):
        fail(f"{label}: kernel rows do not carry their own distances "
             f"(off by up to {(kd_l - own).abs().max().item()})")
    return err if err is not None else \
        (float((kd_l - pd_l).abs().max()) if kd_l.numel() else 0.0)


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


def _turns_ms(fns, reps, turns):
    """Each of ``fns`` (name -> call) timed in alternating turns, the
    order reversed every other turn (a, b, b, a, ...), each turn a
    CUDA-event mean over ``reps`` calls; the median over turns by name."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for turn in range(turns):
        for name in order if turn % 2 == 0 else order[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {name: float(np.median(t)) for name, t in times.items()}


def _bound(nbytes, flops, rate):
    """Least time the card could take: the larger of the bytes over HBM's
    rate and the operations over the card's peak for their type
    (``PEAK_FLOPS[rate]``)."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _probe_work(probes, counts, nlists):
    """(real tuples, their rows summed, rows of the distinct probed
    lists) for probes [B, npad] with sentinel nlists."""
    p = probes.reshape(-1).long()
    real = p < nlists
    lens = counts.long()
    rows = int(lens[p[real]].sum())
    uniq = int(lens[p[real].unique()].sum())
    return int(real.sum()), rows, uniq


MODES = {"exact": (False, False), "packed": (True, False),
         "blockmin": (True, True)}


def _grouped_ptxas(log):
    """{(store, mode, lists): (registers, spill store + load bytes)} of the
    grouped scan's instantiations, from ptxas's lines in its build log:
    bf16, the tensor-core kernel (lists in registers or in shared memory);
    f32, the FMA kernel."""
    names = list(MODES)
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"grouped_scan_mma_kernelILi(\d)ELb([01])E", line)
            f = re.search(r"grouped_scan_kernelIfLi(\d)E", line)
            cur = (("bf16", names[int(m[1])],
                    "registers" if m[2] == "1" else "shared") if m else
                   ("f32", names[int(f[1])], "shared") if f else None)
            if cur:
                out[cur] = [None, 0]
        elif cur and "spill" in line:
            out[cur][1] = sum(int(n) for n in
                              re.findall(r"(\d+) bytes spill", line))
        elif cur and "registers" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers", line)[1])
    return out


def _integer_cases(rng, dev):
    """Integer-valued bf16 rows and queries: every product and sum is
    exact on the tensor cores and in the plain version, so the kernel must
    equal ``grouped_scan_plain`` bit for bit, ties (many) included: each
    mode at kp 10, 100, 1024 and D 128, 200, 13 (element copies, D padded
    to 16), and at kp 10 and 1024 and D 384, 768, 1024 (rows staged in
    128-dim slabs, fewer queries a block), both metrics."""
    import torch
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    lens = [0, 3, 31, 1024, 1025, 2500, 700, 64, 1, 333]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    n = 0
    narrow, wide = ((10, 64), (100, 32), (1024, 16)), ((10, 64), (1024, 16))
    for dim, kps in ((DIM, narrow), (200, narrow), (13, narrow), (384, wide),
                     (768, wide), (1024, wide)):
        vecs, offsets, counts = _layout(rng, lens, dim, torch.float32, dev)
        vecs = (vecs * 1.5).round().clamp(-4, 4).to(torch.bfloat16)
        for mode, (packed, bmin) in MODES.items():
            for kp, qt in kps:
                for metric in ("sqeuclidean", "ip"):
                    q = torch.randint(-3, 4, (3 * qt, dim), device=dev,
                                      generator=gen).float()
                    probes = _probes(rng, 3 * qt, 4, 6, len(lens), dev)
                    qpad, toff, tcnt, _ = _tiles(q, probes, offsets, counts,
                                                 qt)
                    kw = dict(kp=kp, qt=qt, metric=metric,
                              pos_bits=12 if packed else 0, block_min=bmin)
                    kd, ki = G.grouped_probe_scan(qpad, vecs, toff, tcnt, **kw)
                    pd, pi = G.grouped_scan_plain(qpad, vecs, toff, tcnt, **kw)
                    torch.cuda.synchronize()
                    if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
                        bad = int(((kd != pd) | (ki != pi)).sum())
                        fail(f"integer data, {mode} kp={kp} D={dim} {metric}: "
                             f"{bad} entries differ from the plain version")
                    n += 1
    return n


def phase_kernel():
    import torch
    from neurondb_tpu_torch.ops.kernels import _build
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ptxas = _grouped_ptxas(_build.build_log("ivf_scan_grouped") +
                           _build.build_log("ivf_scan_grouped_f32"))
    if len(ptxas) != 9:
        fail(f"flat: ptxas lines for {len(ptxas)} of 9 kernels in the log")
    for (store, mode, lists), (regs, spill) in sorted(ptxas.items()):
        log(f"[kernel] ptxas flat {store} {mode}, lists in {lists}: {regs} "
            f"registers, {spill} bytes spilled")
        if store == "bf16" and spill:
            fail(f"the tensor-core kernel ({mode}, lists in {lists}) spills "
                 f"{spill} bytes")
    lib = G._lib()
    for dim in (DIM, 1024):
        for kp in (10, 100, 1024):
            for mode in range(3):
                qs = G._pick_qs(lib, 64, dim, kp, mode, True)
                log(f"[kernel] flat bf16 {list(MODES)[mode]} kp {kp}: {qs} "
                    f"queries a block, "
                    f"{lib.ivf_grouped_scan_smem_bytes(qs, dim, kp, mode, 1)} "
                    f"B of shared memory (D {dim})")
    lens = [0, 3, 31, 1024, 1025, 2500, 700, 64, 1, 333]
    vecs, offsets, counts = _layout(rng, lens, DIM, torch.bfloat16, dev)
    pb_small = max(11, (max(lens) - 1).bit_length())
    nl = len(lens)
    errs = {m: 0.0 for m in MODES}
    n_cases = 0
    for mode, (packed, bmin) in MODES.items():
        pb = pb_small if packed else 0
        for qt in (16, 32, 64):
            for k in (10, 100, 1024):
                for metric in ("sqeuclidean", "ip"):
                    b = 3 * qt
                    q = torch.randn((b, DIM), device=dev) * 0.5
                    probes = _probes(rng, b, 4, 6, nl, dev)
                    qpad, toff, tcnt, _ = _tiles(q, probes, offsets, counts, qt)
                    kp = max(8, min(k, G.SEG))
                    kw = dict(qt=qt, metric=metric, pos_bits=pb, block_min=bmin)
                    kd, ki = G.grouped_probe_scan(qpad, vecs, toff, tcnt,
                                                  kp=kp, **kw)
                    pd, pi = G.grouped_scan_plain(qpad, vecs, toff, tcnt,
                                                  kp=kp + 1, **kw)
                    torch.cuda.synchronize()
                    label = f"{mode} qt={qt} k={k} {metric}"
                    err = (_compare(kd, ki, pd, pi, label) if not packed else
                           _compare_packed(kd, ki, pd, pi, qpad, vecs, metric,
                                           qt, pb, label, positional=not bmin))
                    errs[mode] = max(errs[mode], err)
                    n_cases += 1
        # a tile set that is all sentinels
        q = torch.randn((32, DIM), device=dev)
        probes = torch.full((32, 4), nl, dtype=torch.int32, device=dev)
        qpad, toff, tcnt, _ = _tiles(q, probes, offsets, counts, 16)
        kd, ki = G.grouped_probe_scan(qpad, vecs, toff, tcnt, kp=10, qt=16,
                                      pos_bits=pb, block_min=bmin)
        torch.cuda.synchronize()
        if not (bool((ki == -1).all()) and bool((kd == G.NEG_FILL).all())):
            fail(f"{mode}: all-sentinel tiles must hold (NEG_FILL, -1) only")
        n_cases += 1
    log(f"[kernel] flat: {n_cases} cases match the plain version (exact: "
        f"rtol {RTOL}, atol {ATOL}; packed/blockmin at pb {pb_small}: sorted "
        f"values rtol {SEL_RTOL} + 2*2^(pb-24), rows carry their distances); "
        f"max |kernel - plain| exact {errs['exact']:.3e}, packed "
        f"{errs['packed']:.3e}, blockmin {errs['blockmin']:.3e}")
    n_int = _integer_cases(rng, dev)
    log(f"[kernel] flat: {n_int} integer-data cases (every mode, kp 10, "
        f"100, 1024 at D {DIM}, 200 and 13; kp 10 and 1024 at D 384, 768 "
        f"and 1024; both metrics) equal the plain version bit for bit")

    # headline shapes: 1M bf16 rows in 1024 lists, 16,384 queries, nprobe 8
    # padded to 16 (the index's bucket), k = 10
    lens = rng.multinomial(N_ROWS, np.full(NLISTS, 1.0 / NLISTS))
    vecs, offsets, counts = _layout(rng, lens, DIM, torch.bfloat16, dev)
    q = torch.randn((BATCH, DIM), device=dev)
    probes = _probes(rng, BATCH, 8, 16, NLISTS, dev)
    qt = G.auto_qt(BATCH, 16, NLISTS)
    qpad, toff, tcnt, _ = _tiles(q, probes, offsets, counts, qt)
    kp = max(8, K)
    pb = max(11, int(lens.max() - 1).bit_length())
    tuples, rows, uniq = _probe_work(probes, counts, NLISTS)
    # bytes: the distinct probed rows (bf16) and the real tuples' queries
    # read once, their top-kp written once; operations: the real tuples'
    # products, bf16 x bf16 (q is rounded to the store type) summed in
    # f32, which the tensor cores compute exactly
    nbytes = uniq * DIM * 2 + tuples * DIM * 4 + tuples * kp * 8
    rate = "bf16 tensor core" if vecs.dtype == torch.bfloat16 else "f32"
    bound_ms, bound_by = _bound(nbytes, 2.0 * rows * DIM, rate)
    live_tiles = int((tcnt > 0).sum())
    stats = {}
    for mode, (packed, bmin) in MODES.items():
        kw = dict(kp=kp, qt=qt, pos_bits=pb if packed else 0, block_min=bmin)
        kd, ki = G.grouped_probe_scan(qpad, vecs, toff, tcnt, **kw)
        pd, pi = G.grouped_scan_plain(qpad, vecs, toff, tcnt,
                                      **dict(kw, kp=kp + 1))
        torch.cuda.synchronize()
        err = (_compare(kd, ki, pd, pi, f"headline {mode}") if not packed else
               _compare_packed(kd, ki, pd, pi, qpad, vecs, "sqeuclidean", qt,
                               pb, f"headline {mode}", positional=not bmin))
        del kd, ki, pd, pi
        ms = _cuda_ms(lambda: G.grouped_probe_scan(qpad, vecs, toff, tcnt,
                                                   **kw), 20)
        plain_ms = _cuda_ms(lambda: G.grouped_scan_plain(qpad, vecs, toff,
                                                         tcnt, **kw), 3)
        stats[mode] = {"max_abs_err": max(errs[mode], err), "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": None}
        log(f"[kernel] flat {mode:8s} headline: {toff.shape[0]} tiles "
            f"({live_tiles} live) x qt {qt}, kp {kp}, pb {kw['pos_bits']}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}; {nbytes / 1e9:.3f} GB, "
            f"{2.0 * rows * DIM / 1e9:.1f} GFLOP at the {rate} peak over "
            f"{tuples} tuples)")
    log("[kernel] flat: no single PyTorch call computes the grouped scan "
        "with its selection; library_ms is null")
    del vecs, qpad
    torch.cuda.empty_cache()
    return stats


def _pq_layout(rng, lens, ns, device):
    """Codes [ns, Npad] uint8 on 128-column list starts with a 1024
    column tail, random codes; random centroids and codebooks (D = 128)."""
    import torch
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS
    lens = np.asarray(lens, np.int64)
    A = PQS.LIST_ALIGN
    aligned = (lens + A - 1) // A * A
    offsets = np.zeros(len(lens), np.int64)
    np.cumsum(aligned[:-1], out=offsets[1:])
    npad = max(1, -(-int(aligned.sum()) // PQS.SEG) * PQS.SEG) + PQS.SEG
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 31)))
    codes_t = torch.randint(0, 256, (ns, npad), generator=gen, device=device,
                            dtype=torch.uint8)
    cents = torch.randn((len(lens), DIM), generator=gen, device=device)
    cb = torch.randn((ns, 256, DIM // ns), generator=gen, device=device) * 0.5
    return (codes_t, cents, cb,
            torch.as_tensor(offsets, dtype=torch.int32, device=device),
            torch.as_tensor(lens, dtype=torch.int32, device=device))


def _pq_case(q, probes, cents, cb, offsets, counts, qt, metric, R=None):
    """One case's grouping and tuple inputs: (tile_off, tile_cnt, pos,
    t_max, (qc, cn, sq, scale, slot_tuple))."""
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS
    b, npad = probes.shape
    t_max = PQS.tiles_for(b, npad, counts.shape[0], qt)
    toff, tcnt, pos = PQS.group_probes(probes, offsets, counts, qt=qt,
                                       t_max=t_max)
    ins = PQS.pq_tuple_inputs(q, probes, cents, cb, pos, R, npad=npad, qt=qt,
                              t_max=t_max, metric=metric)
    return toff, tcnt, pos, t_max, ins


def _orthogonal(gen, d, device):
    import torch
    a = torch.randn((d, d), generator=gen, device=device, dtype=torch.float64)
    return torch.linalg.qr(a)[0].float()


def _pq_ptxas(log):
    """{(mode, entry): (registers, spill store + load bytes)} of the four
    PQ kernel instantiations, from ptxas's lines in a build's log."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"pq_scan_kernelILi([01])ELi([01])E", line)
            cur = (("exact", "packed")[int(m.group(1))],
                   ("table-fed", "fused")[int(m.group(2))]) if m else None
            if cur:
                out[cur] = [None, 0]
        elif cur and "spill" in line:
            out[cur][1] = sum(int(n) for n in
                              re.findall(r"(\d+) bytes spill", line))
        elif cur and "registers" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers", line)[1])
    return out


def _max_bank_load(trials=20000, seed=0):
    """Mean of the most lookups that fall on one of 32 banks when 32
    lanes read 32 random table entries: the wavefronts one warp-wide
    lookup takes."""
    rng = np.random.default_rng(seed)
    banks = rng.integers(0, 32, (trials, 32))
    return float(np.mean([np.bincount(b, minlength=32).max() for b in banks]))


def phase_pq_kernel(smi):
    import torch
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    lens = [0, 3, 127, 128, 1024, 1025, 2500, 1, 300, 700]
    pb_small = max(11, (max(lens) - 1).bit_length())
    errs = {"exact": 0.0, "packed": 0.0}
    identical = {"fused": True, "table-fed": True}
    n_cases = n_empty = 0
    for ns in (16, 32):
        codes_t, cents, cb, offsets, counts = _pq_layout(rng, lens, ns, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(ns)
        R = _orthogonal(gen, DIM, dev)
        nl = len(lens)
        for mode in ("exact", "packed"):
            pb = pb_small if mode == "packed" else 0
            for i, k in enumerate((10, 80, 256)):
                for metric, rot in (("sqeuclidean", None), ("sqeuclidean", R),
                                    ("ip", None)):
                    qt = (16, 64, 32)[i]
                    b = 3 * qt - 5                 # ragged: empty slots
                    q = torch.randn((b, DIM), device=dev)
                    probes = _probes(rng, b, 5, 8, nl, dev)
                    toff, tcnt, pos, t_max, ins = _pq_case(
                        q, probes, cents, cb, offsets, counts, qt, metric,
                        rot)
                    n_empty += int((ins[4] < 0).sum())
                    kp = max(8, min(k, PQS.KP_MAX))
                    label = (f"pq {mode} n_sub={ns} qt={qt} k={k} {metric}"
                             f"{' R' if rot is not None else ''}")
                    fargs = (ins[0], ins[1], cb, ins[2], ins[3], ins[4],
                             codes_t, toff, tcnt)
                    lut = PQS.build_luts(q, probes, cents, cb, pos, rot,
                                         npad=8, qt=qt, t_max=t_max,
                                         metric=metric)
                    targs = (lut, codes_t, toff, tcnt)
                    for entry, kern, plain, args in (
                            ("fused", PQS.grouped_pq_scan_fused,
                             PQS.grouped_pq_scan_fused_plain, fargs),
                            ("table-fed", PQS.grouped_pq_scan,
                             PQS.grouped_pq_scan_plain, targs)):
                        kd, ki = kern(*args, kp=kp, qt=qt, pos_bits=pb)
                        pd, pi = plain(*args, kp=kp + 1, qt=qt, pos_bits=pb)
                        torch.cuda.synchronize()
                        err = _compare(kd, ki, pd, pi, f"{label} {entry}",
                                       rtol=PQ_TOL, atol=PQ_TOL)
                        identical[entry] &= (torch.equal(kd, pd[..., :kp])
                                             and torch.equal(ki, pi[..., :kp]))
                        errs[mode] = max(errs[mode], err)
                        n_cases += 1
        # a tile set that is all sentinels
        q = torch.randn((32, DIM), device=dev)
        probes = torch.full((32, 4), len(lens), dtype=torch.int32, device=dev)
        toff, tcnt, pos, t_max, ins = _pq_case(q, probes, cents, cb, offsets,
                                               counts, 16, "sqeuclidean")
        lut = PQS.build_luts(q, probes, cents, cb, pos, None, npad=4, qt=16,
                             t_max=t_max, metric="sqeuclidean")
        for pb in (0, pb_small):
            for kd, ki in (
                    PQS.grouped_pq_scan_fused(
                        ins[0], ins[1], cb, ins[2], ins[3], ins[4], codes_t,
                        toff, tcnt, kp=10, qt=16, pos_bits=pb),
                    PQS.grouped_pq_scan(lut, codes_t, toff, tcnt, kp=10,
                                        qt=16, pos_bits=pb)):
                torch.cuda.synchronize()
                if not (bool((ki == -1).all())
                        and bool((kd == PQS.NEG_FILL).all())):
                    fail("pq: all-sentinel tiles must hold (NEG_FILL, -1) "
                         "only")
                n_cases += 1
    log(f"[kernel] pq: {n_cases} cases (fused and table-fed entries; "
        f"{n_empty} empty slots) match the plain version (rtol = atol = "
        f"{PQ_TOL}; bit-identical outputs: fused {identical['fused']}, "
        f"table-fed {identical['table-fed']}); max |kernel - plain| exact "
        f"{errs['exact']:.3e}, packed {errs['packed']:.3e}")
    if not all(identical.values()):
        fail("pq: the kernel must equal its plain version bit for bit")
    from neurondb_tpu_torch.ops.kernels import _build
    ptxas = _pq_ptxas(_build.build_log("ivfpq_scan"))
    for (mode, entry), (regs, spill) in sorted(ptxas.items()):
        log(f"[kernel] pq ptxas {mode:6s} {entry:9s}: {regs} registers, "
            f"{spill} bytes spilled")

    # IVF-PQ headline shapes: 1M rows in 1024 lists, n_sub 32, 8,192
    # queries, nprobe 8 (the index's pow-2 bucket is 8), k 10 x rerank 8
    ns = 32
    ds = DIM // ns
    lens = rng.multinomial(N_ROWS, np.full(NLISTS, 1.0 / NLISTS))
    codes_t, cents, cb, offsets, counts = _pq_layout(rng, lens, ns, dev)
    q = torch.randn((PQ_BATCH, DIM), device=dev)
    probes = _probes(rng, PQ_BATCH, 8, 8, NLISTS, dev)
    qt = PQS.auto_qt(PQ_BATCH, 8, NLISTS)
    toff, tcnt, pos, t_max, ins = _pq_case(q, probes, cents, cb, offsets,
                                           counts, qt, "sqeuclidean")
    fargs = (ins[0], ins[1], cb, ins[2], ins[3], ins[4], codes_t, toff, tcnt)
    kp = max(8, min(K * 8, PQS.KP_MAX))
    pb = max(11, int(lens.max() - 1).bit_length())
    tuples, rows, uniq = _probe_work(probes, counts, NLISTS)
    live_slots = int((ins[4] >= 0).sum())
    # the fused function's bytes: the real tuples' residual queries and
    # constants, the codebooks and their norms, the distinct probed lists'
    # codes read once, the real tuples' top-kp written once; operations:
    # one f32 add per table lookup, 2 ds + 2 per table entry built
    lookups, entries = float(rows) * ns, float(tuples) * ns * 256
    nbytes = (tuples * (DIM * 4 + 4) + (cb.numel() + ins[2].numel()) * 4
              + uniq * ns + tuples * kp * 8)
    flops = lookups + entries * (2 * ds + 2)
    bound_ms, bound_by = _bound(nbytes, flops, "f32")
    # shared memory: one 32-lane wavefront per SM and clock; a lookup at
    # random banks takes the most lanes on one bank, a table store one
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    conflict = _max_bank_load()
    per_ms = sms * mhz * 1e3                       # wavefronts per ms
    floor_free = (lookups + entries) / 32 / per_ms
    floor_rand = (lookups * conflict + entries) / 32 / per_ms
    log(f"[kernel] pq headline: {toff.shape[0]} tiles ({int((tcnt > 0).sum())}"
        f" live) x qt {qt}, {live_slots} live slots, kp {kp}; bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.4f} GB at "
        f"{HBM_BPS / 1e12:.2f} TB/s = {nbytes / HBM_BPS * 1e3:.4f} ms; "
        f"{flops / 1e9:.3f} GFLOP = {lookups / 1e9:.3f} G lookup adds + "
        f"{entries * (2 * ds + 2) / 1e9:.3f} G table build at the f32 peak "
        f"= {flops / PEAK_FLOPS['f32'] * 1e3:.4f} ms); shared-memory lookup "
        f"floor {floor_free:.4f} ms conflict-free, {floor_rand:.4f} ms at "
        f"{conflict:.3f}-way random-bank conflicts ({lookups / 1e9:.3f} G "
        f"lookups + {entries / 1e9:.3f} G table stores, {sms} SMs at "
        f"{mhz:.0f} MHz, one wavefront per SM and clock; information)")
    stats = {}
    for mode in ("exact", "packed"):
        kw = dict(kp=kp, qt=qt, pos_bits=pb if mode == "packed" else 0)
        kd, ki = PQS.grouped_pq_scan_fused(*fargs, **kw)
        pd, pi = PQS.grouped_pq_scan_fused_plain(*fargs, **dict(kw, kp=kp + 1))
        torch.cuda.synchronize()
        err = _compare(kd, ki, pd, pi, f"pq headline {mode}", rtol=PQ_TOL,
                       atol=PQ_TOL)
        same = torch.equal(kd, pd[..., :kp]) and torch.equal(ki, pi[..., :kp])
        if not same:
            fail(f"pq headline {mode}: fused kernel and plain differ")
        del kd, ki, pd, pi
        lut = PQS.build_luts(q, probes, cents, cb, pos, None, npad=8, qt=qt,
                             t_max=t_max, metric="sqeuclidean")

        def luts():
            return PQS.build_luts(q, probes, cents, cb, pos, None, npad=8,
                                  qt=qt, t_max=t_max, metric="sqeuclidean")

        t = _turns_ms({
            "fused": lambda: PQS.grouped_pq_scan_fused(*fargs, **kw),
            "table-fed": lambda: PQS.grouped_pq_scan(lut, codes_t, toff,
                                                     tcnt, **kw),
            "build_luts": luts,
            "build_luts + table-fed": lambda: PQS.grouped_pq_scan(
                luts(), codes_t, toff, tcnt, **kw)}, reps=5, turns=5)
        del lut
        torch.cuda.empty_cache()
        plain_ms = _cuda_ms(lambda: PQS.grouped_pq_scan_fused_plain(
            *fargs, **kw), 2)
        qs, warps = PQS.resident_warps(qt, ns, ds, kp, mode == "packed")
        _, warps_t = PQS.resident_warps(qt, ns, 0, kp, mode == "packed")
        # the record holds measured numbers only (and the bound); the
        # lookup floor, a model, and the resident warps stay in the log
        stats[mode] = {"entry": "fused", "max_abs_err": max(errs[mode], err),
                       "ms": t["fused"], "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": None,
                       "build_luts_plus_table_fed_ms":
                           t["build_luts + table-fed"]}
        log(f"[kernel] pq {mode:6s} headline ({smi}): fused {t['fused']:.3f} "
            f"ms; build_luts + table-fed {t['build_luts + table-fed']:.3f} "
            f"ms (build_luts {t['build_luts']:.3f}, table-fed kernel "
            f"{t['table-fed']:.3f}), medians of 5 alternating turns of 5 "
            f"calls; fused plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms; "
            f"fused / bound {t['fused'] / bound_ms:.1f}x, / conflict-free "
            f"lookup floor {t['fused'] / floor_free:.1f}x; {qs} slots x 4 "
            f"warps per block, resident warps per SM: fused {warps}, "
            f"table-fed {warps_t}; pb {kw['pos_bits']}")
    log("[kernel] pq: no single PyTorch call computes the grouped ADC scan "
        "with its selection; library_ms is null")
    del codes_t, fargs, ins
    torch.cuda.empty_cache()
    return stats


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


def _rep(search, batch, n_batches=4):
    """Pipelined QPS of ``n_batches`` searches with one barrier."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_batches):
        search()
    torch.cuda.synchronize()
    return n_batches * batch / (time.perf_counter() - t0)


def _qps(search, batch, reps=3, n_batches=4):
    """Median pipelined QPS of ``reps`` reps of ``n_batches`` searches,
    after one warm rep; and all reps."""
    _rep(search, batch, n_batches)
    reps_ = [_rep(search, batch, n_batches) for _ in range(reps)]
    return float(np.median(reps_)), reps_


def phase_main():
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch.ml.metrics import recall_at_k
    from neurondb_tpu_torch.ops.kernels import flash_attention as FA
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS

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

    _zero_launches()
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

    sel = nt.get_config().ivf_select
    qb = np.concatenate([q] * (BATCH // NQ + 1))[:BATCH]
    chosen = None
    n_grouped = 0
    for nprobe in NPROBES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ids = index.search(qb, k=K, nprobe=nprobe)
        wall = time.perf_counter() - t0
        n_grouped += 1
        r = recall_at_k(ids[:NQ], gt)
        log(f"[main] nprobe {nprobe:>2} f32 wire, select {sel}: recall@10 "
            f"{r:.4f} (vs exact {recall_at_k(ids[:NQ], exact):.4f}), "
            f"batch {BATCH} in {wall * 1e3:.1f} ms")
        if r >= RECALL_BAR and chosen is None:
            chosen = nprobe
    if chosen is None:
        fail(f"recall@10 below {RECALL_BAR} at every nprobe <= {NPROBES[-1]}")
    wire = nt.quantize_queries_int8(qb)
    _, ids = index.search(wire, k=K, nprobe=chosen)
    n_grouped += 1
    log(f"[main] nprobe {chosen:>2} int8 wire: recall@10 "
        f"{recall_at_k(ids[:NQ], gt):.4f} "
        f"(vs exact {recall_at_k(ids[:NQ], exact):.4f})")

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

    # the modes in turns (one rep each, the order reversed every round):
    # the search is host-bound, and host time drifts within a run
    per_mode = {m: 0 for m in MODES}
    reps = {m: [] for m in MODES}
    recalls = {}
    for rnd in range(4):                       # round 0 warms up
        for mode in (list(MODES) if rnd % 2 == 0 else list(MODES)[::-1]):
            before = G.LAUNCHES
            if rnd == 0:
                _, ids = index.search(qb, k=K, nprobe=chosen, select=mode)
                recalls[mode] = (recall_at_k(ids[:NQ], gt),
                                 recall_at_k(ids[:NQ], exact))
                n_grouped += 1
            qps = _rep(lambda: index.search(qb, k=K, nprobe=chosen,
                                            select=mode), BATCH)
            if rnd:
                reps[mode].append(qps)
            n_grouped += 4
            per_mode[mode] += G.LAUNCHES - before
    for mode in MODES:
        log(f"[main] select {mode:8s} nprobe {chosen}: recall@10 "
            f"{recalls[mode][0]:.4f} (vs exact {recalls[mode][1]:.4f}), QPS "
            f"median {np.median(reps[mode]):.0f} of "
            f"{[round(r) for r in reps[mode]]} (f32 queries, batch {BATCH}, "
            f"4 batches/rep, modes in turns), kernel launches "
            f"{per_mode[mode]}")
    launches = G.LAUNCHES
    log(f"[main] grouped-scan kernel launches during the IVFFlat path: "
        f"{launches} for {n_grouped} grouped searches; IVF-PQ kernel: "
        f"{PQS.LAUNCHES}; flash kernel: {FA.LAUNCHES}")
    if launches != n_grouped or min(per_mode.values()) == 0:
        fail(f"the grouped searches did not all go through the kernel "
             f"({launches} launches, {n_grouped} grouped searches)")
    return index, qb, chosen, per_mode, x, gt, exact


def phase_probe_route(index, qb, chosen, gt, exact):
    """IVFFlat's probe route (``ivf_kernel="probe"``) on the main path's
    index: recall over NPROBES, QPS beside the grouped route in turns,
    launches, one profiled search."""
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch.ml.metrics import recall_at_k
    from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G

    # the grouped exact mode's ids: the two routes meet only through recall
    _, g_exact = index.search(qb[:NQ], k=K, nprobe=chosen, select="exact")
    n = {"probe": 0, "grouped": 0}          # searches per route
    crossed = {"probe": 0, "grouped": 0}    # the other kernel's launches

    def search(route, qs, nprobe):
        nt.configure(ivf_kernel=route)
        other = G if route == "probe" else PS
        before = other.LAUNCHES
        out = index.search(qs, k=K, nprobe=nprobe)
        crossed[route] += other.LAUNCHES - before
        n[route] += 1
        return out

    qps = {}
    try:
        _zero_launches()
        recalls = {}
        for nprobe in NPROBES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, ids = search("probe", qb, nprobe)
            wall = time.perf_counter() - t0
            recalls[nprobe] = (recall_at_k(ids[:NQ], gt),
                               recall_at_k(ids[:NQ], exact),
                               recall_at_k(ids[:NQ], g_exact)
                               if nprobe == chosen else None)
            log(f"[probe_route] nprobe {nprobe:>2}: recall@10 "
                f"{recalls[nprobe][0]:.4f} (vs exact "
                f"{recalls[nprobe][1]:.4f}), batch {BATCH} in "
                f"{wall * 1e3:.1f} ms")
        # the routes in turns (one rep each, the order reversed every
        # round; round 0 warms up), grouped with its default selection
        for batch in (BATCH, 1024):
            qs = qb[:batch]
            for rnd in range(4):
                routes = ("probe", "grouped") if rnd % 2 == 0 else \
                    ("grouped", "probe")
                for route in routes:
                    v = _rep(lambda: search(route, qs, chosen), batch)
                    if rnd:
                        qps.setdefault((route, batch), []).append(v)
        for batch in (BATCH, 1024):
            _profile(f"probe route profile nprobe {chosen} batch {batch}",
                     lambda: search("probe", qb[:batch], chosen))
        _profile(f"grouped route profile nprobe {chosen} batch 1024",
                 lambda: search("grouped", qb[:1024], chosen))
        launches = PS.LAUNCHES
        g_launches = G.LAUNCHES
    finally:
        nt.get_config().reset("ivf_kernel")
    r_gt, r_exact, agree = recalls[chosen]
    for batch in (BATCH, 1024):
        p, g = qps[("probe", batch)], qps[("grouped", batch)]
        log(f"[probe_route] nprobe {chosen}, batch {batch}: QPS probe route "
            f"median {np.median(p):.0f} of {[round(v) for v in p]}, grouped "
            f"route ({nt.get_config().ivf_select}) median {np.median(g):.0f} "
            f"of {[round(v) for v in g]} (f32 queries, 4 batches/rep, "
            f"routes in turns)")
    log(f"[probe_route] nprobe {chosen}: recall@10 {r_gt:.4f} (bar "
        f"{RECALL_BAR}), vs exact {r_exact:.4f}, vs the grouped exact mode "
        f"{agree:.4f} (bar {ROUTE_AGREE_BAR}); probe-kernel launches "
        f"{launches} for {n['probe']} probe searches (grouped launches "
        f"during them {crossed['probe']}); grouped launches {g_launches} for "
        f"{n['grouped']} grouped searches (probe launches during them "
        f"{crossed['grouped']})")
    if launches != n["probe"] or crossed["probe"] or \
            g_launches != n["grouped"] or crossed["grouped"]:
        fail("the probe searches did not all go through the probe kernel "
             "alone, or the grouped searches through the grouped kernel")
    if r_gt < RECALL_BAR:
        fail(f"probe route recall@10 {r_gt} < {RECALL_BAR} at nprobe {chosen}")
    if agree < ROUTE_AGREE_BAR:
        fail(f"probe route ids agree with the grouped exact mode's on "
             f"{agree} < {ROUTE_AGREE_BAR} of recall@10")
    return launches


def _fails(check) -> bool:
    """True when ``check()`` fails: a control that must not pass."""
    try:
        check()
    except SystemExit:
        return True
    return False


def _hnsw_row_err(q, d, ids, index):
    """|d^2 - the row's own d^2|, that d^2 and |q|^2 + |x|^2 per returned
    slot [B, k], the row's as the index stores it (the bf16 row, |x|^2
    from the f32 source), recomputed in float64 on the host."""
    import torch
    order = np.argsort(index._ids_np, kind="stable")
    rows = order[np.searchsorted(index._ids_np[order], np.maximum(ids, 0))]
    rows_d = torch.from_numpy(rows).to(index.device)
    x = index._vecs[rows_d].double().cpu().numpy()          # [B, k, D]
    sq = index._sqnorms[rows_d].double().cpu().numpy()
    q64 = q.astype(np.float64)
    terms = (q64 * q64).sum(1)[:, None] + sq
    want = np.maximum(terms - 2.0 * np.einsum("bd,bkd->bk", q64, x), 0.0)
    return np.abs(d.astype(np.float64) ** 2 - want), want, terms


def _hnsw_check_rows(label, q, d, ids, index):
    """Rows without duplicate ids, each returned d^2 its row's own within
    HNSW_DIST_RTOL of it plus HNSW_TERMS_TOL of |q|^2 + |x|^2 (the search
    rounds the f32 expansion |q|^2 + |x|^2 - 2 q.x at the scale of its
    terms, ~1,300 beside a near row's d^2 ~ 0.3). A wrong-row control (each
    distance against the next slot's row) must fail the same test. Returns
    the largest |error| / terms."""
    for r, row in enumerate(ids):
        live = row[row >= 0]
        if len(np.unique(live)) != len(live):
            fail(f"{label}: duplicate ids in row {r}: {row}")
    ok = ids >= 0

    def check(rows):
        err, want, terms = _hnsw_row_err(q, d, rows, index)
        live = ok & (rows >= 0)
        if not (err <= HNSW_DIST_RTOL * want + HNSW_TERMS_TOL * terms)[live] \
                .all():
            fail(f"{label}: a returned distance is not its row's distance "
                 f"(d^2 off by up to {err[live].max()})")
        return float((err / terms)[live].max())

    worst = check(ids)
    if not _fails(lambda: check(np.roll(ids, 1, axis=1))):
        fail(f"{label}: the wrong-row control passed the distance check")
    return worst


def _check_self_query_scan(tag, label, qpad, vecs, toff, tcnt, kw):
    """The grouped kernel against its plain version on a scan whose
    queries are corpus rows, at the shape and arguments the path gave it
    (the HNSW bootstrap's, the hybrid ANN's): phase_kernel's relative
    tolerances with SELF_QUERY_ATOL as the absolute one; prints the
    readings first, and fails unless a wrong-row control fails too.
    Returns max |kernel - plain|."""
    import torch
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    kd, ki = G.grouped_probe_scan(qpad, vecs, toff, tcnt, **kw)
    pd, pi = G.grouped_scan_plain(qpad, vecs, toff, tcnt,
                                  **dict(kw, kp=kw["kp"] + 1))
    if kd.is_cuda:
        torch.cuda.synchronize()
    # the queries are corpus rows: slot 0 of each tuple of a query's own
    # list is its self-hit at d ~ 0, where the f32 rounding of
    # |q|^2 + |x|^2 - 2 q.x is relative to the terms, not to d; the
    # absolute tolerance there is SELF_QUERY_ATOL, a few times the reading
    kp = kw["kp"]
    qt = kw["qt"]
    qrows = qpad.reshape(kd.shape[0], qt, -1)
    self_hit = (pi[..., 0] >= 0) & (
        vecs[pi[..., 0].clamp(min=0).long()] == qrows.to(vecs.dtype)).all(-1)
    live = pd[..., :kp] < 1e30
    diff = (kd - pd[..., :kp]).abs()
    self_err = float(diff[..., 0][self_hit].max()) if self_hit.any() else 0.0
    rest = live.clone()
    rest[..., 0] &= ~self_hit
    # elsewhere the part of |kernel - plain| past the relative tolerance
    rtol = SEL_RTOL + 2.0 ** (kw["pos_bits"] - 23) if kw["pos_bits"] \
        else RTOL
    past = (diff - rtol * pd[..., :kp].abs())[rest]
    rest_err = max(float(past.max()), 0.0) if past.numel() else 0.0
    log(f"[{tag}] {label} vs plain: at the "
        f"{int(self_hit.sum())} self-hits max |kernel - plain| "
        f"{self_err:.3e}; at the other filled slots at most {rest_err:.3e} "
        f"past rtol {rtol:.3e} (atol {SELF_QUERY_ATOL:.0e})")
    if not self_hit.any():
        fail(f"{label}: no self-hit to hold the control to")
    if kw["pos_bits"]:
        def compare(ids):
            return _compare_packed(kd, ids, pd, pi, qpad, vecs, kw["metric"],
                                   qt, kw["pos_bits"], label,
                                   positional=not kw["block_min"],
                                   atol=SELF_QUERY_ATOL)
    else:
        def compare(ids):
            return _compare(kd, ids, pd, pi, label, atol=SELF_QUERY_ATOL)
    err = compare(ki)
    # wrong-row control: the self-hit and the next row trade places
    swapped = ki.clone()
    swapped[..., 0] = torch.where(self_hit, ki[..., 1], ki[..., 0])
    swapped[..., 1] = torch.where(self_hit, ki[..., 0], ki[..., 1])
    if not _fails(lambda: compare(swapped)):
        fail(f"{label}: the wrong-row control passed the comparison")
    return err


def phase_hnsw(x, qb, gt, exact, smi):
    """bench.py's secondary HNSW configuration on the main path's corpus:
    HNSWIndex(x, m=16, seed=0, build_mode="bulk") on the card, its
    grouped-kernel bootstrap held to the plain version at the bootstrap's
    shape, the ef sweep, a profile, mutation and a save/load round trip.
    Returns the grouped kernel's launches during the build."""
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch.ml.metrics import recall_at_k
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G

    # the bootstrap's first grouped scan: its tuples and its inputs
    seen = {}
    group_probes, scan = G.group_probes, G.grouped_probe_scan

    def grouping(probes, offsets, counts, **kw):
        seen.setdefault("probes", (probes, counts))
        return group_probes(probes, offsets, counts, **kw)

    def scanning(*a, **kw):
        seen.setdefault("scan", (a, kw))
        return scan(*a, **kw)

    G.group_probes, G.grouped_probe_scan = grouping, scanning
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _zero_launches()
    try:
        t0 = time.perf_counter()
        index = nt.HNSWIndex(x, m=HNSW_M, seed=0, build_mode="bulk",
                             device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        G.group_probes, G.grouped_probe_scan = group_probes, scan
    launches = G.LAUNCHES
    peak = torch.cuda.max_memory_allocated() - base_mem
    st = index.stats()
    phases = ", ".join(f"{k} {v:.2f} s"
                       for k, v in index.build_seconds.items())
    log(f"[hnsw] HNSWIndex({x.shape[0]} x {x.shape[1]}, m={HNSW_M}, seed=0, "
        f"bulk) built in {build_s:.2f} s on {smi}: {phases}; peak device "
        f"memory {peak / 1e9:.2f} GB above the {base_mem / 1e9:.2f} GB held "
        f"before; grouped-kernel launches {launches}; store "
        f"{index._vecs.dtype}, levels {st['level_histogram']}, degree mean "
        f"{st['degree_mean']:.2f} min {st['degree_min']}, isolated "
        f"{st['isolated_nodes']}, router {index._router['reps'].shape[0]} "
        f"cells")
    if launches == 0 or "scan" not in seen:
        fail("the HNSW bulk build did not launch the grouped scan kernel")
    if index._vecs.device.type != "cuda" or st["isolated_nodes"]:
        fail("the HNSW graph must live on the card, with no isolated node")

    # the grouped kernel at the bootstrap's shape against its plain version
    (qpad, vecs, toff, tcnt), kw = seen.pop("scan")
    probes, counts = seen.pop("probes")
    err = _check_self_query_scan("hnsw", "bootstrap grouped scan", qpad,
                                 vecs, toff, tcnt, kw)
    kp = kw["kp"]
    nlists = counts.shape[0]
    tuples, rows, uniq = _probe_work(probes, counts, nlists)
    nbytes = uniq * vecs.shape[1] * 2 + tuples * vecs.shape[1] * 4 + \
        tuples * kp * 8
    flops = 2.0 * rows * vecs.shape[1]
    bound_ms, bound_by = _bound(nbytes, flops, "bf16 tensor core")
    ms = _cuda_ms(lambda: G.grouped_probe_scan(qpad, vecs, toff, tcnt, **kw),
                  20)
    plain_ms = _cuda_ms(lambda: G.grouped_scan_plain(qpad, vecs, toff, tcnt,
                                                     **kw), 2)
    log(f"[hnsw] bootstrap grouped scan ({probes.shape[0]} queries x nprobe "
        f"{probes.shape[1]}, {nlists} lists, kp {kp}, qt {kw['qt']}, pb "
        f"{kw['pos_bits']}, {toff.shape[0]} tiles): max |kernel - plain| "
        f"{err:.3e}, the wrong-row control fails; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e9:.3f} GB, "
        f"{flops / 1e9:.1f} GFLOP over {tuples} tuples) on {smi}")
    del qpad, vecs, toff, tcnt, probes, counts
    torch.cuda.empty_cache()

    # the ef sweep at batch 16,384
    chosen, table = None, []
    for ef in HNSW_EFS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, ids = index.search(qb, k=K, ef=ef)
        wall = time.perf_counter() - t0
        worst = _hnsw_check_rows(f"hnsw ef {ef}", qb[:NQ], d[:NQ], ids[:NQ],
                                 index)
        r_ex, r_gt = recall_at_k(ids[:NQ], exact), recall_at_k(ids[:NQ], gt)
        qps, reps = _qps(lambda: index.search(qb, k=K, ef=ef), BATCH, reps=3,
                         n_batches=1)
        table.append((ef, r_ex, r_gt, qps))
        log(f"[hnsw] ef {ef:>3}: recall@10 {r_ex:.4f} vs exact f32, {r_gt:.4f}"
            f" vs the committed ground truth; QPS median {qps:.0f} of "
            f"{[round(v) for v in reps]} (batch {BATCH}, one search a rep, "
            f"after a warm rep; first search {wall * 1e3:.0f} ms) on {smi}; "
            f"d^2 within {worst:.3e} of |q|^2 + |x|^2 of its row's own, the "
            f"wrong-row control fails")
        if chosen is None and r_ex >= RECALL_BAR:
            chosen = ef
    if chosen is None:
        fail(f"HNSW recall@10 below {RECALL_BAR} against the exact f32 "
             f"neighbours at every ef <= {HNSW_EFS[-1]}")
    log(f"[hnsw] smallest ef with recall@10 >= {RECALL_BAR} vs exact: "
        f"{chosen}")
    sub = int(max(64, min(4096, (1 << 32) // index._ncap)))  # one sub-batch
    _profile(f"hnsw profile ef {chosen} batch {sub}",
             lambda: index.search(qb[:sub], k=K, ef=chosen))

    _hnsw_validate_and_graph(index, smi)

    # mutation: add, self-query, delete, compact
    rng = np.random.default_rng(7)
    new = x[rng.choice(x.shape[0], HNSW_ADD, replace=False)] + \
        0.5 * rng.standard_normal((HNSW_ADD, x.shape[1])).astype(np.float32)
    t0 = time.perf_counter()
    new_ids = index.add(new)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    _, ids = index.search(new, k=1)
    self_hit = float((ids[:, 0] == new_ids).mean())
    _, ids = index.search(new, k=1, ef=chosen)
    log(f"[hnsw] add {HNSW_ADD} rows in {add_s:.2f} s; self-query top-1 "
        f"{self_hit:.4f} at the index's ef_search {index.ef_search} (bar "
        f"{HNSW_SELF_BAR}), {float((ids[:, 0] == new_ids).mean()):.4f} at "
        f"ef {chosen}")
    if self_hit < HNSW_SELF_BAR:
        fail(f"added rows find themselves on {self_hit} < {HNSW_SELF_BAR}")
    drop = rng.choice(x.shape[0], int(HNSW_DELETE * x.shape[0]),
                      replace=False).astype(np.int64)
    removed = index.delete(drop)
    d, ids = index.search(qb, k=K, ef=chosen)
    r_del = recall_at_k(ids[:NQ], exact)
    if removed != len(drop) or np.isin(ids, drop).any():
        fail("a deleted id was returned (or the delete missed ids)")
    t0 = time.perf_counter()
    ndead = index.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    d, ids = index.search(qb, k=K, ef=chosen)
    if ndead != len(drop) or np.isin(ids, drop).any() or \
            index.n != x.shape[0] + HNSW_ADD - len(drop):
        fail("compact kept a deleted id or lost a live one")
    _hnsw_check_rows("hnsw after compact", qb[:NQ], d[:NQ], ids[:NQ], index)
    log(f"[hnsw] delete {removed} ids: none returned, recall@10 vs exact "
        f"{r_del:.4f} at ef {chosen} (deleted neighbours count as misses); "
        f"compact in {compact_s:.2f} s, {index.n} rows, recall@10 vs exact "
        f"{recall_at_k(ids[:NQ], exact):.4f}")
    del index
    torch.cuda.empty_cache()

    # save/load of a SAVE_ROWS-row index
    small = nt.HNSWIndex(x[:SAVE_ROWS], m=HNSW_M, seed=0, build_mode="bulk",
                         device="cuda")
    _, before = small.search(qb[:NQ], k=K, ef=chosen)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        small.save(tmp)
        loaded = nt.HNSWIndex.load(tmp, device="cuda")
        secs = time.perf_counter() - t0
    _, after = loaded.search(qb[:NQ], k=K, ef=chosen)
    if not np.array_equal(before, after):
        fail(f"HNSW save/load changed {int((before != after).sum())} ids")
    log(f"[hnsw] save/load of a {SAVE_ROWS}-row index in {secs:.2f} s; ids "
        f"identical")
    del small, loaded
    torch.cuda.empty_cache()
    mode = ("exact" if not kw["pos_bits"] else
            "blockmin" if kw["block_min"] else "packed")
    return launches, mode


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


def _profile(tag, search):
    """One call under torch.profiler: device time by kernel, and the
    share of the call's wall time the device was busy. Returns the busy
    ms and the profiler's device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    search()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[{tag}] wall {wall_ms:.2f} ms under the profiler, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"[{tag}] {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3} "
            f"{e.key[:100]}")
    return busy_ms, kernels


def phase_ivfpq(x):
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch.ml.metrics import recall_at_k
    from neurondb_tpu_torch.ops.kernels import flash_attention as FA
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS

    rng = np.random.default_rng(1)         # scripts/bench_ivfpq.py:82-84
    q = (x[rng.choice(N_ROWS, PQ_NQ, replace=False)]
         + 0.02 * rng.standard_normal((PQ_NQ, DIM)).astype(np.float32))
    flat = nt.FlatIndex(x, metric="l2", device="cuda")
    _, gt = flat.search(q, k=K)
    del flat
    torch.cuda.empty_cache()
    # the 2-byte query wire: a bf16 host tensor, upcast on the card
    qpad = torch.from_numpy(
        np.concatenate([q] * (PQ_BATCH // PQ_NQ + 1))[:PQ_BATCH]
    ).to(torch.bfloat16)

    _zero_launches()
    n_grouped = 0
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = nt.IVFPQIndex(x, nlists=NLISTS, n_sub=32, seed=0,
                        keep_originals=True, opq=True, orig_dtype="bf16",
                        device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - mem0
    st = idx.stats()
    log(f"[ivfpq] IVFPQIndex(nlists {NLISTS}, n_sub 32, OPQ, bf16 "
        f"originals) built in {build_s:.2f} s: code bytes {idx.code_bytes} "
        f"(compression {st['compression']}x), codes_t "
        f"{tuple(idx._codes_t.shape)}, max list {st['max_list']}; device "
        f"memory held {held / 1e6:.1f} MB (codes, originals, ids, "
        f"centroids, codebooks, R)")

    def search(nprobe, rerank, out="numpy"):
        nonlocal n_grouped
        n_grouped += 1
        return idx.search(qpad, k=K, nprobe=nprobe, rerank=rerank, out=out)

    def point(nprobe, rerank, tag):
        _, ids = search(nprobe, rerank)
        r = recall_at_k(ids[:PQ_NQ], gt)
        qps, reps = _qps(lambda: search(nprobe, rerank, out="device"),
                         PQ_BATCH)
        log(f"[ivfpq] {tag} nprobe {nprobe:>2} rerank {rerank:>2}: recall@10 "
            f"{r:.4f}, QPS median {qps:.0f} of {[round(v) for v in reps]} "
            f"(bf16 wire, batch {PQ_BATCH}, 4 batches/rep)")
        return r

    chosen = None
    for nprobe, rerank in PQ_SWEEP:
        r = point(nprobe, rerank, "n_sub 32 packed")
        if r >= RECALL_BAR and chosen is None:
            chosen = (nprobe, rerank)
    if chosen is None:
        fail(f"IVF-PQ recall@10 below {RECALL_BAR} at every sweep point")
    packed_launches = PQS.LAUNCHES
    nt.configure(ivf_select="exact")
    try:
        point(*chosen, "n_sub 32 exact ")
    finally:
        nt.get_config().reset("ivf_select")
    per_mode = {"packed": packed_launches,
                "exact": PQS.LAUNCHES - packed_launches}

    busy, kernels = _profile(
        f"ivfpq profile nprobe {chosen[0]} rerank {chosen[1]}",
        lambda: search(*chosen))
    pq_ms = sum(e.self_device_time_total for e in kernels
                if "pq_scan_kernel" in e.key) / 1e3
    fills = [e for e in kernels
             if re.search(r"fill|scatter|index_put", e.key, re.I)]
    log(f"[ivfpq] profiled search: PQ kernel {pq_ms:.3f} ms of {busy:.3f} ms "
        f"busy ({100 * pq_ms / busy:.0f}%); fill and scatter kernels "
        f"{sum(e.self_device_time_total for e in fills) / 1e3:.3f} ms in all "
        f"({', '.join(f'{e.key[:60]} x{e.count}' for e in fills) or 'none'})")
    # one search's peak device memory beside the [t_max * qt, n_sub * 256]
    # f32 table buffer the table-fed route allocates at this point
    npad = 4
    while npad < chosen[0]:
        npad *= 2
    qt = PQS.auto_qt(PQ_BATCH, npad, NLISTS)
    lut_bytes = PQS.tiles_for(PQ_BATCH, npad, NLISTS, qt) * qt * 32 * 256 * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    search(*chosen, out="device")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - mem0
    log(f"[ivfpq] one search at nprobe {chosen[0]} rerank {chosen[1]}: peak "
        f"device memory {peak / 1e6:.1f} MB above the index (the table-fed "
        f"route's table buffer alone: {lut_bytes / 1e6:.1f} MB)")
    if peak >= lut_bytes:
        fail("the IVF-PQ search allocated a table buffer")

    _, before = search(*chosen)
    # the round trip on a 100k-row index: the 1M index's took 105-124 s of
    # host compression, which the cross-encoder phase needs
    small = nt.IVFPQIndex(x[:SAVE_ROWS], nlists=128, n_sub=32, seed=0,
                          keep_originals=True, opq=True, orig_dtype="bf16",
                          device="cuda")
    kw = dict(k=K, nprobe=chosen[0], rerank=chosen[1])
    _, s_before = small.search(qpad[:PQ_NQ], **kw)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        small.save(tmp)
        loaded = nt.IVFPQIndex.load(tmp, device="cuda")
        secs = time.perf_counter() - t0
    n_grouped += 2
    _, after = loaded.search(qpad[:PQ_NQ], **kw)
    if not np.array_equal(s_before, after):
        fail(f"IVF-PQ save/load changed {int((s_before != after).sum())} ids")
    log(f"[ivfpq] save/load round trip of a {SAVE_ROWS}-row index (nlists "
        f"128, n_sub 32, OPQ, bf16 originals) in {secs:.2f} s; ids "
        f"identical")
    del loaded, small

    victims = np.unique(before[:PQ_NQ, 0])[:100]
    removed = idx.delete(victims)
    seg_before = PQS.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ids = idx.search(qpad[:PQ_NQ], k=K, nprobe=chosen[0], rerank=chosen[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if PQS.LAUNCHES != seg_before:
        fail("a search with deletes outstanding must take the segment route")
    if np.isin(ids, victims).any():
        fail("the segment route returned a deleted id")
    log(f"[ivfpq] {removed} deleted, segment route, {PQ_NQ} queries: "
        f"recall@10 {recall_at_k(ids, gt):.4f} (the deleted ids count as "
        f"misses) in {wall * 1e3:.1f} ms, no deleted id returned")
    del idx
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = nt.IVFPQIndex(x, nlists=NLISTS, n_sub=16, seed=0,
                        keep_originals=True, orig_dtype="bf16", device="cuda")
    torch.cuda.synchronize()
    log(f"[ivfpq] IVFPQIndex(n_sub 16, no OPQ) built in "
        f"{time.perf_counter() - t0:.2f} s, code bytes {idx.code_bytes}")
    for rerank in (0, 8):
        point(4, rerank, "n_sub 16 packed")
    del idx
    torch.cuda.empty_cache()
    launches = PQS.LAUNCHES
    log(f"[ivfpq] IVF-PQ kernel launches during the IVF-PQ path: {launches} "
        f"for {n_grouped} grouped searches ({launches / n_grouped:.2f} fused "
        f"launches per search; packed {per_mode['packed']} in "
        f"the sweep, exact {per_mode['exact']}); flat kernel: {G.LAUNCHES}; "
        f"flash kernel: {FA.LAUNCHES}")
    if launches != n_grouped or min(per_mode.values()) == 0:
        fail(f"the grouped IVF-PQ searches did not all go through the kernel "
             f"({launches} launches, {n_grouped} grouped searches)")
    return per_mode


def _tie_topk_times(smi):
    """The IVF coarse top-k at the main path's shape before and after the
    tie repair: ``torch.topk`` (the old ``topk_smallest``) against the
    tie-ruled ``topk_smallest`` (one stable sort at this width), in
    turns, at n 4 and 16."""
    import torch
    from neurondb_tpu_torch.ops import topk as TK
    gen = torch.Generator(device="cuda").manual_seed(0)
    s = torch.randn(BATCH, NLISTS, generator=gen, device="cuda")
    out = {}
    for n in (4, 16):
        t = _turns_ms({
            "torch.topk": lambda: torch.topk(s, n, dim=-1, largest=False,
                                             sorted=True),
            "topk_smallest": lambda: TK.topk_smallest(s, n)}, 20, 7)
        out[n] = t
        log(f"[quantized] coarse top-k [{BATCH}, {NLISTS}] n {n}: "
            f"torch.topk (before the tie repair) {t['torch.topk']:.4f} ms, "
            f"topk_smallest (after) {t['topk_smallest']:.4f} ms "
            f"(+{t['topk_smallest'] - t['torch.topk']:.4f}; medians of 7 "
            f"turns of 20 calls; {smi})")
    return out


def _check_tie_rule():
    """topk_smallest / topk_largest on the card against a stable sort, on
    integer rows full of ties."""
    import torch
    from neurondb_tpu_torch.ops import topk as TK
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape, k in (((BATCH, NLISTS), 16), ((64, 100_000), 100),
                     ((8, 5000), 1000)):
        s = torch.randint(0, 4, shape, generator=gen, device="cuda").float()
        v, i = TK.topk_smallest(s, k)
        sv, si = torch.sort(s, dim=-1, stable=True)
        lv, li = TK.topk_largest(s, k)
        nv, ni = torch.sort(-s, dim=-1, stable=True)
        if not (torch.equal(i, si[:, :k]) and torch.equal(v, sv[:, :k])
                and torch.equal(li, ni[:, :k])):
            fail(f"top-k on the card breaks ties unlike a stable sort at "
                 f"{shape}, k {k}")
    log("[quantized] topk_smallest / topk_largest on the card equal a "
        "stable sort on tied integer rows ([16384, 1024] k 16, [64, 100000] "
        "k 100, [8, 5000] k 1000)")


def _check_quantize_bits(x):
    """``quantize`` on the card against the port's CPU ``quantize``, every
    bit of codes, scales, offsets and dequantized rows, in all ten
    formats on a 4,096-row sample."""
    import torch
    from neurondb_tpu_torch.types import quantized as TQ
    sample = x[np.random.default_rng(2).choice(len(x), QF_SAMPLE,
                                               replace=False)]
    sample[0] = 0.0
    for fmt in TQ.FORMATS:
        c = TQ.quantize(sample, fmt, device="cpu")
        g = TQ.quantize(sample, fmt, device="cuda")
        for name, a, b in (("codes", c.codes, g.codes),
                           ("scale", c.scale, g.scale),
                           ("offset", c.offset, g.offset),
                           ("dequantize", TQ.dequantize(c), TQ.dequantize(g))):
            if b.device.type != "cuda" or not torch.equal(
                    a.view(torch.uint8), b.cpu().view(torch.uint8)):
                fail(f"quantize({fmt}) on the card differs from the CPU in "
                     f"its {name}")
    log(f"[quantized] quantize on the card = the CPU's, bit for bit, in all "
        f"{len(TQ.FORMATS)} formats on {QF_SAMPLE} rows")


def phase_quantized(x, qb, exact, smi):
    """BASELINE.json config 3 on the main path's corpus: QuantizedFlatIndex
    (int8 and f16, ip, originals kept, k 10, rerank 8) against exact ip;
    binary with l2 beside it, without a bar; the tie rule and quantize on
    the card; the coarse top-k before and after the tie repair."""
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch.ml.metrics import recall_at_k

    _check_tie_rule()
    _check_quantize_bits(x)
    topk_times = _tie_topk_times(smi)
    q = qb[:QF_NQ]
    flat = nt.FlatIndex(x, metric="ip", device="cuda")
    _, gt_ip = flat.search(q, k=K)
    del flat
    torch.cuda.empty_cache()
    qn = np.linalg.norm(q.astype(np.float64), axis=1)
    xn = np.linalg.norm(x.astype(np.float64), axis=1)
    out = {"topk_ms": topk_times}
    for fmt, metric, bar in (("int8", "ip", 0.95), ("f16", "ip", 0.99),
                             ("binary", "l2", None)):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        idx = nt.QuantizedFlatIndex(x, fmt=fmt, metric=metric,
                                    device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated() - mem0
        d, ids = idx.search(q, k=K, rerank=QF_RERANK)
        truth = gt_ip if metric == "ip" else exact
        r = recall_at_k(ids[:len(truth)], truth)
        qps, reps = _qps(lambda: idx.search(q, k=K, rerank=QF_RERANK),
                         QF_NQ, n_batches=1)
        log(f"[quantized] {fmt} {metric}: built in {build_s:.3f} s; "
            f"compression_bytes {idx.compression_bytes}, device bytes held "
            f"{held} ({idx.device_bytes} by the index's count); recall@10 "
            f"{r:.4f} vs exact {metric} at rerank {QF_RERANK}; QPS median "
            f"{qps:.0f} of {[round(v) for v in reps]} (batch {QF_NQ}, one "
            f"search a rep, after a warm one; {smi})")
        if any(len(set(row)) != len(row) for row in ids):
            fail(f"QuantizedFlatIndex({fmt}) returned an id twice in a row")
        if metric == "ip":
            want = -np.einsum("bd,bkd->bk", q.astype(np.float64),
                              x[ids].astype(np.float64))
            err = np.abs(d - want) / (qn[:, None] * xn[ids])
            log(f"[quantized] {fmt}: max |d + q.x| / (|q||x|) {err.max():.3e}")
            if err.max() > QF_DIST_TOL:
                fail(f"QuantizedFlatIndex({fmt}) returned distances off "
                     f"-q.x by {err.max():.3e} of |q||x|")
        if bar is not None and r < bar:
            fail(f"QuantizedFlatIndex({fmt}) recall@10 {r:.4f} < {bar}")
        out[fmt] = dict(build_s=build_s, held=held, recall=r, qps=qps)
        del idx
        torch.cuda.empty_cache()
    return out


def _near_tie_ok(b, i_h, s_h, i_d, s_d):
    """Host and device fusion may swap documents whose fused scores are
    within HYBRID_TIE_TOL of the k-th: Python floats against f32 sums."""
    k = i_h.shape[1]
    only_h = [j for j in range(k) if i_h[b, j] not in set(i_d[b])]
    only_d = [j for j in range(k) if i_d[b, j] not in set(i_h[b])]
    ok = all(abs(s_h[b, j] - s_h[b, -1]) <= HYBRID_TIE_TOL for j in only_h) \
        and all(abs(s_d[b, j] - s_d[b, -1]) <= HYBRID_TIE_TOL for j in only_d)
    log(f"[hybrid] query {b}: host and device fusion differ by host "
        f"{[(int(i_h[b, j]), float(s_h[b, j])) for j in only_h]} / device "
        f"{[(int(i_d[b, j]), float(s_d[b, j])) for j in only_d]}, k-th "
        f"scores {float(s_h[b, -1]):.8f} / {float(s_d[b, -1]):.8f}: "
        f"{'a near-tie' if ok else 'NOT a near-tie'}")
    return ok


def _check_hybrid_scan(batch):
    """The grouped kernel at the shape the hybrid ANN gives it (its
    tuples, tiles, kp and selection mode, caught from one call of
    ``batch``) against its plain version; after the counted run."""
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    seen = {}
    scan = G.grouped_probe_scan

    def scanning(*a, **kw):
        seen.setdefault("scan", (a, kw))
        return scan(*a, **kw)

    G.grouped_probe_scan = scanning
    try:
        batch()
    finally:
        G.grouped_probe_scan = scan
    if "scan" not in seen:
        fail("the hybrid search did not launch the grouped scan kernel")
    (qpad, vecs, toff, tcnt), kw = seen.pop("scan")
    err = _check_self_query_scan("hybrid", "ANN grouped scan", qpad, vecs,
                                 toff, tcnt, kw)
    log(f"[hybrid] ANN grouped scan ({HYBRID_NQ} queries x nprobe "
        f"{HYBRID_NPROBE}, {HYBRID_NLISTS} lists, kp {kw['kp']}, qt "
        f"{kw['qt']}, pb {kw['pos_bits']}, block_min {kw['block_min']}, "
        f"{toff.shape[0]} tiles, store {vecs.dtype}): max |kernel - plain| "
        f"{err:.3e}, the wrong-row control fails")


def phase_hybrid(x, smi):
    """BASELINE.json config 4 as bench.py:204-224 runs it: 200,000
    documents, IVFFlat nlists 512, BM25 (hashed build), 512 queries,
    hybrid_search_batch and HybridSearcher at k 10, nprobe 8; then a
    Collection on the card through planned_search. Returns the grouped
    kernel's launches of the searches."""
    import torch
    from neurondb_tpu_torch.client import Collection
    from neurondb_tpu_torch.index.ivf import IVFFlatIndex
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    from neurondb_tpu_torch.search import hybrid as H
    from neurondb_tpu_torch.search.bm25 import BM25Index
    from neurondb_tpu_torch.search.planner import QueryPlanner, planned_search

    docs = [f"topic{i % 64} item {i} cluster word{i % 64}"
            for i in range(HYBRID_DOCS)]
    xd = x[:HYBRID_DOCS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = IVFFlatIndex(xd, nlists=HYBRID_NLISTS, metric="l2", seed=0,
                       device="cuda")
    torch.cuda.synchronize()
    ivf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bm = BM25Index(docs, device="cuda")
    bm._ensure_device()
    torch.cuda.synchronize()
    bm_s = time.perf_counter() - t0
    log(f"[hybrid] IVFFlatIndex({HYBRID_DOCS}, nlists {HYBRID_NLISTS}) built in "
        f"{ivf_s:.3f} s; BM25Index({HYBRID_DOCS} docs, hashed: "
        f"{bm._hash_vocab is not None}) in {bm_s:.3f} s: tokenizer "
        f"{bm.build_seconds['tokenize']:.3f} s, postings "
        f"{bm.build_seconds['postings']:.3f} s, the rest (weights, upload) "
        f"{bm_s - sum(bm.build_seconds.values()):.3f} s; "
        f"{len(bm.df)} terms, {len(bm._post_doc)} postings")
    if bm._hash_vocab is None:
        fail("BM25Index at 200,000 documents did not take the hashed build")
    rng = np.random.default_rng(3)                     # bench.py:214-216
    qis = rng.integers(0, HYBRID_DOCS, HYBRID_NQ)
    texts = [f"topic{int(qi) % 64} item {int(qi)}" for qi in qis]
    q = xd[qis]
    searcher = H.HybridSearcher(ivf, bm, candidates=HYBRID_C)

    def batch():
        return H.hybrid_search_batch(ivf, bm, q, texts, k=K,
                                     nprobe=HYBRID_NPROBE)

    def served():
        return searcher.search_batch(q, texts, k=K, nprobe=HYBRID_NPROBE)

    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s_d, i_d = batch()
    s_p, i_p = served()
    peak = torch.cuda.max_memory_allocated() - base
    rates = {}
    for name, fn in (("hybrid_search_batch", batch),
                     ("HybridSearcher", served)):
        rates[name] = _qps(fn, HYBRID_NQ, n_batches=1)
    launches = G.LAUNCHES
    n_searches = 2 + 2 * 4
    hit = {name: float(np.mean([int(qi) in row for qi, row in zip(qis, ids)]))
           for name, ids in (("hybrid_search_batch", i_d),
                             ("HybridSearcher", i_p))}
    for name, (qps, reps) in rates.items():
        log(f"[hybrid] {name}: QPS median {qps:.0f} of "
            f"{[round(v) for v in reps]} ({HYBRID_NQ} queries, k {K}, "
            f"nprobe {HYBRID_NPROBE}, candidates {HYBRID_C}, one call a "
            f"rep after a warm one); self-hit {hit[name]:.4f}; {smi}")
    log(f"[hybrid] peak device memory of one call of each searcher "
        f"{peak / 2**20:.1f} MiB above the indexes; grouped kernel launches "
        f"{launches} for {n_searches} ANN searches")
    if launches != n_searches:
        fail(f"the hybrid ANN searches did not all go through the grouped "
             f"kernel ({launches} launches, {n_searches} searches)")
    _check_hybrid_scan(batch)
    if min(hit.values()) < SELF_HIT_BAR:
        fail(f"hybrid self-hit {hit} < {SELF_HIT_BAR}")
    for b in range(HYBRID_NQ):
        if set(i_p[b]) != set(i_d[b]):
            fail(f"HybridSearcher and hybrid_search_batch differ on query "
                 f"{b}: {i_p[b]} vs {i_d[b]}")
    got = bm.scores_batch(texts[:64], device=True)
    want = np.stack([bm.scores(t) for t in texts[:64]])
    if not np.array_equal(got.view(np.int32), want.view(np.int32)):
        fail("BM25 scores_batch on the card differs from the host oracle")
    log("[hybrid] scores_batch on the card = the host oracle, bit for bit, "
        "on 64 queries")
    t0 = time.perf_counter()
    s_h, i_h = H.hybrid_search_batch(ivf, bm, q, texts, k=K,
                                     nprobe=HYBRID_NPROBE, device=False)
    host_s = time.perf_counter() - t0
    differ = [b for b in range(HYBRID_NQ) if set(i_h[b]) != set(i_d[b])]
    bad = [b for b in differ if not _near_tie_ok(b, i_h, s_h, i_d, s_d)]
    log(f"[hybrid] host fusion (device=False, {host_s:.2f} s) against the "
        f"card's: {HYBRID_NQ - len(differ)} of {HYBRID_NQ} id sets equal, "
        f"{len(differ) - len(bad)} near-ties, max |score diff| "
        f"{np.abs(np.sort(s_h, 1) - np.sort(s_d, 1)).max():.3e}")
    if bad:
        fail(f"host and device fusion disagree past a near-tie on {bad}")

    # one served batch profiled whole, then each stage alone
    prof = {"all": _profile("hybrid HybridSearcher batch 512", served)}
    vd, vids = ivf.search(q, k=HYBRID_C, nprobe=HYBRID_NPROBE, out="device")
    ts = bm.scores_batch(texts, device=True, return_device=True)
    stages = {
        "ann": lambda: ivf.search(q, k=HYBRID_C, nprobe=HYBRID_NPROBE,
                                  out="device"),
        "bm25": lambda: bm.scores_batch(texts, device=True,
                                        return_device=True),
        "fusion": lambda: H._join_fuse(vd, vids, ts, *searcher._tables,
                                       weight=searcher.weight, k=K,
                                       candidates=HYBRID_C)}
    for name, fn in stages.items():
        prof[name] = _profile(f"hybrid stage {name}", fn)
    log("[hybrid] device ms by stage (one call each, torch.profiler): " +
        ", ".join(f"{n} {prof[n][0]:.3f}" for n in stages) +
        f"; the whole served batch {prof['all'][0]:.3f}")
    del ivf, bm, searcher, vd, vids, ts
    torch.cuda.empty_cache()

    col = Collection("hybrid", DIM, index="ivfflat", device="cuda")
    col.add(x[:COLLECTION_ROWS], documents=docs[:COLLECTION_ROWS])
    col._ensure_index()
    host_calls = []
    oracle = col._bm25.scores
    col._bm25.scores = lambda text: host_calls.append(text) or oracle(text)
    planner = QueryPlanner()
    routes = {}
    for kw in ({"vector": x[7]}, {"text": "topic7 item 7"},
               {"vector": x[7], "text": "topic7 item 7"}):
        res = planned_search(col, planner, k=K, **kw)
        routes[res["plan"].mode] = [r["id"] for r in res["results"]]
    if host_calls:
        fail(f"the card Collection scored {host_calls} with the host oracle")
    log(f"[hybrid] Collection(ivfflat, {COLLECTION_ROWS} rows) through "
        f"planned_search: {routes}; planner stats {planner.stats()}")
    if set(routes) != {"ann", "fts", "hybrid"} or routes["ann"][0] != 7 \
            or 7 not in routes["fts"] or 7 not in routes["hybrid"]:
        fail(f"planned_search routed or answered wrongly: {routes}")
    return launches


def _dup_in_row(ids) -> bool:
    s = np.sort(ids, axis=1)
    return bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any())


def _catch(module, name, clone=False):
    """Wrap ``module.name`` to keep the arguments of its first call
    (``clone``: copies of its tensors, which later calls may overwrite);
    returns (calls dict, restore)."""
    seen = {}
    fn = getattr(module, name)

    def copy(x):
        return x.clone() if clone and hasattr(x, "clone") else x

    def catching(*a, **kw):
        if "args" not in seen:
            seen["args"] = (tuple(copy(x) for x in a),
                            {key: copy(x) for key, x in kw.items()})
        return fn(*a, **kw)

    setattr(module, name, catching)
    return seen, lambda: setattr(module, name, fn)


def phase_sharded(x, qb, exact, smi):
    """BASELINE.json config 5 cut to one card (10M x 96 over 4 logical
    shards: exact neighbours, the sharded flat index, the 1-D IVF on the
    probe kernel, the sharded k-means step, the 2-D IVF's streaming
    build), then the sharded HNSW and IVF-PQ on the main path's corpus;
    each kernel of the path against its plain version at a shard's own
    shapes, outside the counted windows. Returns the phase's launches:
    probe, fused PQ (exact) and grouped (with its mode)."""
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch import parallel as par
    from neurondb_tpu_torch.ml import kmeans as KM
    from neurondb_tpu_torch.ml.metrics import recall_at_k
    from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS
    from neurondb_tpu_torch.parallel import mesh as PM
    t_phase = time.perf_counter()
    sys.path.insert(0, ROOT)
    from bench import make_corpus          # numpy and the stdlib only
    t0 = time.perf_counter()
    x5 = make_corpus(SH_ROWS, SH_DIM, seed=SH_SEED, corpus="clustered")
    rng = np.random.default_rng(SH_SEED + 1)
    q5 = (x5[rng.choice(SH_ROWS, SH_NQ, replace=False)] + 0.05 *
          rng.standard_normal((SH_NQ, SH_DIM)).astype(np.float32))
    mesh = par.make_mesh(SH_SHARDS, device="cuda")
    log(f"[sharded] config 5 cut to one card: corpus {x5.shape} (seed "
        f"{SH_SEED}, clustered) + {SH_NQ} queries generated in "
        f"{time.perf_counter() - t0:.2f} s; {mesh} on {smi}")

    # exact neighbours: the single-card FlatIndex; then the sharded one
    t0 = time.perf_counter()
    flat = nt.FlatIndex(x5, metric="l2", device="cuda")
    fd, gt5 = flat.search(q5, k=K)
    flat_s = time.perf_counter() - t0
    del flat
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sflat = par.ShardedFlatIndex(x5, mesh=mesh)
    sd, si = sflat.search(q5, k=K)
    sflat_s = time.perf_counter() - t0
    del sflat
    torch.cuda.empty_cache()
    swap = si != gt5
    tie = np.abs(sd - fd) <= SH_FLAT_TIE_RTOL * np.abs(fd)
    log(f"[sharded] FlatIndex (exact, {flat_s:.2f} s with upload) vs "
        f"ShardedFlatIndex ({sflat_s:.2f} s): {int(swap.sum())} of "
        f"{swap.size} ids differ, all at distance ties within "
        f"{SH_FLAT_TIE_RTOL:.0e} relative: {bool(tie[swap].all())} on "
        f"{smi}")
    if not tie[swap].all():
        fail("ShardedFlatIndex disagrees with FlatIndex past a distance tie")

    # the 1-D sharded IVF on the probe kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _zero_launches()
    t0 = time.perf_counter()
    ivf = par.ShardedIVFIndex(x5, nlists=SH_NLISTS, mesh=mesh, seed=0)
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    stages = ", ".join(f"{k} {v:.2f} s" for k, v in ivf.build_seconds.items())
    log(f"[sharded] ShardedIVFIndex(nlists={SH_NLISTS}, {SH_SHARDS} shards) "
        f"built in {build_s:.2f} s ({stages}); shard rows "
        f"{[int(sh.vecs.shape[0]) for sh in ivf._shards]}, f32 store "
        f"{sum(sh.vecs.numel() * 4 for sh in ivf._shards) / 1e9:.2f} GB, "
        f"longest list slice {ivf.max_list}; peak device memory "
        f"{peak / 1e9:.2f} GB above {base_mem / 1e9:.2f} GB on {smi}")
    chosen = None
    for nprobe in SH_NPROBES:
        before = PS.LAUNCHES
        _, ids = ivf.search(q5, k=K, nprobe=nprobe)
        per_search = PS.LAUNCHES - before
        r = recall_at_k(ids, gt5)
        if _dup_in_row(ids):
            fail(f"sharded IVF nprobe {nprobe}: an id twice in a row")
        qps, reps = _qps(lambda: ivf.search(q5, k=K, nprobe=nprobe), SH_NQ,
                         reps=3, n_batches=1)
        log(f"[sharded] 1-D IVF nprobe {nprobe:>2}: recall@10 {r:.4f}, QPS "
            f"median {qps:.0f} of {[round(v) for v in reps]} (batch "
            f"{SH_NQ}, one search a rep, after a warm rep), probe-kernel "
            f"launches per search {per_search} on {smi}")
        if per_search != SH_SHARDS:
            fail(f"a sharded IVF search made {per_search} probe launches, "
                 f"not one per shard")
        if chosen is None and r >= RECALL_BAR:
            chosen = nprobe
    if chosen is None:
        fail(f"sharded IVF recall@10 below {RECALL_BAR} at every nprobe")
    busy_ms, events = _profile(f"sharded profile nprobe {chosen} batch "
                               f"{SH_NQ}", lambda: ivf.search(q5, k=K,
                                                              nprobe=chosen))
    probe_ms = sum(e.self_device_time_total for e in events
                   if "probe_scan_kernel" in e.key) / 1e3
    log(f"[sharded] profile: probe kernel {probe_ms:.3f} ms of "
        f"{busy_ms:.3f} ms busy ({probe_ms / SH_SHARDS:.3f} ms a shard), "
        f"the rest (coarse GEMM and top-nprobe, work tables, merges) "
        f"{busy_ms - probe_ms:.3f} ms on {smi}")
    n_probe = PS.LAUNCHES

    # the probe kernel against its plain version on shard 0's CSR
    seen, restore = _catch(PS, "probe_scan")
    try:
        ivf.search(q5, k=K, nprobe=chosen)
    finally:
        restore()
    (q, vecs, poff, pcnt), kw = seen["args"]
    kd, ki = PS.probe_scan(q, vecs, poff, pcnt, **kw)
    pd, pi = PS.probe_scan_plain(q, vecs, poff, pcnt,
                                 **dict(kw, kp=kw["kp"] + 1))
    torch.cuda.synchronize()
    # queries 0.05 sigma off corpus rows: d^2 ~ 0.24 beside terms
    # |q|^2 + |x|^2 ~ 1,000, so the f32 expansion's rounding is held to a
    # share of the terms, as HNSW's d^2 is (HNSW_TERMS_TOL)
    terms = (q * q).sum(1)[None, :, None] + torch.where(
        pi >= 0, (vecs * vecs).sum(1)[pi.clamp(min=0).long()], 0.0)
    live = pd[..., :kw["kp"]] < 1e30
    reading = float(((kd - pd[..., :kw["kp"]]).abs()
                     / terms[..., :kw["kp"]])[live].max())
    err = _compare(kd, ki, pd, pi, "sharded shard-0 probe scan", rtol=RTOL,
                   atol=SH_TERMS_TOL * terms)
    same = torch.equal(kd, pd[..., :kw["kp"]]) and \
        torch.equal(ki, pi[..., :kw["kp"]])
    ms = _cuda_ms(lambda: PS.probe_scan(q, vecs, poff, pcnt, **kw), 10)
    plain_ms = _cuda_ms(lambda: PS.probe_scan_plain(q, vecs, poff, pcnt,
                                                    **kw), 1)
    log(f"[sharded] probe kernel vs plain at shard 0's CSR ({q.shape[0]} "
        f"queries x nprobe {chosen}, {vecs.shape[0]} f32 rows, kp "
        f"{kw['kp']}, max_segs {kw['max_segs']}): max |kernel - plain| "
        f"{err:.3e}, at most {reading:.3e} of |q|^2 + |x|^2 (limit "
        f"{SH_TERMS_TOL:.0e} of it + rtol {RTOL:.0e}), rows equal away "
        f"from near-ties, bit-identical {same}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms on {smi}")
    del q, vecs, poff, pcnt, kd, ki, pd, pi, terms, seen

    # sharded k-means step vs one Lloyd step of ml/kmeans
    rows = torch.from_numpy(x5[:SH_KMEANS_ROWS]).cuda()
    cents = torch.from_numpy(ivf.centroids).cuda()
    newc, inertia = par.sharded_kmeans_step(mesh, PM.shard_rows(mesh, rows),
                                            cents)
    labels, best = KM._assign_chunked(rows[None], cents[None],
                                      (rows * rows).sum(-1)[None])
    ref = KM._update(rows[None], labels, SH_NLISTS, cents[None])[0]
    dc = float((newc - ref).abs().max())
    di = abs(float(inertia) / float(best.sum()) - 1.0)
    log(f"[sharded] sharded_kmeans_step vs one Lloyd step of ml/kmeans "
        f"({SH_KMEANS_ROWS} rows, {SH_NLISTS} centroids): max centroid "
        f"difference {dc:.3e}, relative inertia difference {di:.3e} "
        f"(limit {SH_KMEANS_TOL:.0e}) on {smi}")
    if dc > SH_KMEANS_TOL or di > SH_KMEANS_TOL:
        fail("the sharded k-means step differs from the Lloyd step")
    del ivf, rows, cents, newc, labels, best, ref
    torch.cuda.empty_cache()

    # the 2-D index: streaming build from a factory of 1M-row chunks
    mesh2 = par.make_mesh_2d(2, SH_SHARDS // 2, device="cuda")

    def chunks():
        return (x5[s:s + SH_CHUNK] for s in range(0, SH_ROWS, SH_CHUNK))

    _zero_launches()
    t0 = time.perf_counter()
    mh = par.MultiHostIVFIndex.from_chunks(chunks, nlists=SH_NLISTS,
                                           mesh=mesh2, seed=0)
    build_s = time.perf_counter() - t0
    stages = ", ".join(f"{k} {v:.2f} s" for k, v in mh.build_seconds.items())
    log(f"[sharded] MultiHostIVFIndex.from_chunks(factory of "
        f"{SH_ROWS // SH_CHUNK} x {SH_CHUNK} rows) on {mesh2} built in "
        f"{build_s:.2f} s ({stages}) on {smi}")
    r = 0.0
    for nprobe in SH_NPROBES:
        t0 = time.perf_counter()
        _, ids = mh.search(q5, k=K, nprobe=nprobe)
        r = recall_at_k(ids, gt5)
        if _dup_in_row(ids):
            fail(f"2-D IVF nprobe {nprobe}: an id twice in a row")
        log(f"[sharded] 2-D IVF nprobe {nprobe:>2}: recall@10 {r:.4f}, "
            f"batch {SH_NQ} in {(time.perf_counter() - t0) * 1e3:.1f} ms "
            f"on {smi}")
    n_probe += PS.LAUNCHES
    if r < RECALL_BAR:
        fail(f"2-D IVF recall@10 {r} < {RECALL_BAR} at nprobe "
             f"{SH_NPROBES[-1]}")
    del mh, x5, q5, gt5, fd, sd, si
    torch.cuda.empty_cache()

    # sharded HNSW on the main path's corpus
    seen, restore = _catch(G, "grouped_probe_scan")
    _zero_launches()
    try:
        t0 = time.perf_counter()
        hn = par.ShardedHNSWIndex(x, m=HNSW_M, mesh=mesh, seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        restore()
    n_grouped = G.LAUNCHES
    phases = ", ".join(f"{k} {v:.2f} s" for k, v in hn.build_seconds.items())
    log(f"[sharded] ShardedHNSWIndex({x.shape[0]} x {x.shape[1]}, m="
        f"{HNSW_M}, {SH_SHARDS} shards) built in {build_s:.2f} s (summed "
        f"over shards: {phases}); grouped-kernel launches {n_grouped} on "
        f"{smi}")
    if n_grouped == 0 or "args" not in seen:
        fail("the sharded HNSW build did not launch the grouped kernel")
    q = qb[:NQ]
    hn_ok = False
    for ef in SH_EFS:
        t0 = time.perf_counter()
        _, ids = hn.search(q, k=K, ef=ef)
        r = recall_at_k(ids, exact)
        if _dup_in_row(ids):
            fail(f"sharded HNSW ef {ef}: an id twice in a row")
        hn_ok |= r >= RECALL_BAR
        log(f"[sharded] HNSW ef {ef:>3}: recall@10 {r:.4f} vs exact f32, "
            f"{NQ} queries in {(time.perf_counter() - t0) * 1e3:.1f} ms on "
            f"{smi}")
    if not hn_ok:
        fail(f"sharded HNSW recall@10 below {RECALL_BAR} at every ef")
    del hn
    torch.cuda.empty_cache()
    (qpad, vecs, toff, tcnt), kw = seen["args"]
    err = _check_self_query_scan("sharded", "shard-0 bootstrap grouped scan",
                                 qpad, vecs, toff, tcnt, kw)
    log(f"[sharded] grouped kernel vs plain at shard 0's first bootstrap "
        f"batch ({toff.shape[0]} tiles x qt {kw['qt']}, kp {kw['kp']}, pb "
        f"{kw['pos_bits']}, store {vecs.dtype}): max |kernel - plain| "
        f"{err:.3e} (limit atol {SELF_QUERY_ATOL:.0e} at self-hits, rtol "
        f"elsewhere), the wrong-row control fails; on {smi}")
    mode = ("exact" if not kw["pos_bits"] else
            "blockmin" if kw["block_min"] else "packed")
    del qpad, vecs, toff, tcnt, seen

    # sharded IVF-PQ (int8 originals) on the main path's corpus
    _zero_launches()
    t0 = time.perf_counter()
    pq = par.ShardedIVFPQIndex(x, nlists=NLISTS, n_sub=32, mesh=mesh, seed=0)
    build_s = time.perf_counter() - t0
    stages = ", ".join(f"{k} {v:.2f} s" for k, v in pq.build_seconds.items())
    log(f"[sharded] ShardedIVFPQIndex(nlists={NLISTS}, n_sub=32, int8 "
        f"originals, {SH_SHARDS} shards) built in {build_s:.2f} s "
        f"({stages}) on {smi}; {pq.stats()}")
    qpq = qb[:SH_NQ]
    pq_ok = False
    for nprobe, rr in SH_PQ_SWEEP:
        before = PQS.LAUNCHES
        _, ids = pq.search(qpq, k=K, nprobe=nprobe, rerank_k=rr * K)
        per_search = PQS.LAUNCHES - before
        r = recall_at_k(ids[:NQ], exact)
        if _dup_in_row(ids):
            fail(f"sharded IVF-PQ nprobe {nprobe}: an id twice in a row")
        qps, reps = _qps(lambda: pq.search(qpq, k=K, nprobe=nprobe,
                                           rerank_k=rr * K), SH_NQ, reps=3,
                         n_batches=1)
        pq_ok |= r >= RECALL_BAR
        log(f"[sharded] IVF-PQ nprobe {nprobe}, rerank {rr} (rerank_k "
            f"{rr * K} a shard): recall@10 {r:.4f} vs exact f32, QPS median "
            f"{qps:.0f} of {[round(v) for v in reps]} (batch {SH_NQ}), fused "
            f"launches per search {per_search} on {smi}")
        if per_search != SH_SHARDS:
            fail(f"a sharded IVF-PQ search made {per_search} fused launches")
    if not pq_ok:
        fail(f"sharded IVF-PQ recall@10 below {RECALL_BAR}")
    n_pq = PQS.LAUNCHES
    seen, restore = _catch(PQS, "grouped_pq_scan_fused")
    try:
        pq.search(qpq, k=K, nprobe=SH_PQ_SWEEP[-1][0],
                  rerank_k=SH_PQ_SWEEP[-1][1] * K)
    finally:
        restore()
    a, kw = seen["args"]
    kd, ki = PQS.grouped_pq_scan_fused(*a, **kw)
    pd, pi = PQS.grouped_pq_scan_fused_plain(*a, **dict(kw, kp=kw["kp"] + 1))
    torch.cuda.synchronize()
    err = _compare(kd, ki, pd, pi, "sharded shard-0 fused PQ scan",
                   rtol=PQ_TOL, atol=PQ_TOL)
    same = torch.equal(kd, pd[..., :kw["kp"]]) and \
        torch.equal(ki, pi[..., :kw["kp"]])
    log(f"[sharded] fused PQ kernel vs plain at shard 0's tiles "
        f"({a[7].shape[0]} tiles x qt {kw['qt']}, kp {kw['kp']}, pb "
        f"{kw['pos_bits']}): max |kernel - plain| {err:.3e}, bit-identical "
        f"{same} on {smi}")
    if not same:
        fail("sharded fused PQ scan: kernel and plain differ")
    del pq, a, kd, ki, pd, pi, seen
    torch.cuda.empty_cache()
    log(f"[sharded] phase wall {time.perf_counter() - t_phase:.1f} s on "
        f"{smi}; launches: probe {n_probe}, fused PQ {n_pq}, grouped "
        f"{n_grouped} ({mode})")
    return n_probe, n_pq, n_grouped, mode


def _flash_inputs(gen, B, H, S, dh, ragged, device):
    """q, k, v [B, H, S, Dh] as strided views of [B, S, H, Dh] (the dense
    layers' layout, as the encoders pass them) and a ragged int32 mask
    (lengths from S/2 to S) or None."""
    import torch
    q, k, v = (torch.randn((B, S, H, dh), generator=gen, device=device)
               .transpose(1, 2) for _ in range(3))
    mask = None
    if ragged:
        lens = torch.randint(max(1, S // 2), S + 1, (B,), generator=gen,
                             device=device)
        lens[0] = S
        mask = (torch.arange(S, device=device)[None] < lens[:, None]).int()
    return q, k, v, mask


def _flash_ptxas(log):
    """{(mode, Dh, masked): (registers, spill store + load bytes)} of the
    bf16 and f32 instantiations, from ptxas's lines in a flash build's
    log."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_(bf16|f32)_kernelILi(\d+)ELb([01])E", line)
            cur = (m.group(1), int(m.group(2)), m.group(3) == "1") if m else None
            if cur:
                out[cur] = [None, 0]
        elif cur and "spill" in line:
            out[cur][1] = sum(int(n) for n in
                              re.findall(r"(\d+) bytes spill", line))
        elif cur and "registers" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers", line)[1])
    return out


def phase_flash_kernel(smi):
    import torch
    import torch.nn.functional as F
    from neurondb_tpu_torch.ops.kernels import flash_attention as FA
    dev = torch.device("cuda")
    lib = FA._lib()
    if (lib.flash_attention_kv_tile(1), lib.flash_attention_kv_tile(0)) != \
            (FA.KV_TILE, FA.KV_TILE_F32):
        fail("flash kernel's KV tiles differ from the wrapper's")
    from neurondb_tpu_torch.ops.kernels import _build
    ptxas = _flash_ptxas(_build.build_log("flash_attention"))
    for mode in ("bf16", "f32"):
        for dh in (32, 64, 128):
            for masked in (True, False):
                regs, spill = ptxas.get((mode, dh, masked), (None, None))
                log(f"[flash] flash_{mode}_kernel<Dh {dh}, "
                    f"{'mask' if masked else 'no mask'}>: {regs} registers, "
                    f"{spill} bytes spilled (ptxas), "
                    f"{lib.flash_attention_occupancy(dh, int(masked), int(mode == 'bf16'))}"
                    f" resident blocks per SM")
    gen = torch.Generator(device=dev).manual_seed(9)
    errs = {True: 0.0, False: 0.0}
    n_cases = 0
    for bf16 in (True, False):
        tile = FA.KV_TILE if bf16 else FA.KV_TILE_F32
        for dh in (32, 64, 128):
            for S in FLASH_S:
                for masking in ("ragged", "full_row", "none"):
                    B, H = 3, 2
                    q, k, v, _ = _flash_inputs(gen, B, H, S, dh, False, dev)
                    mask = None
                    if masking != "none":
                        # lengths crossing KV tiles: S, S/3, S - 65
                        lens = torch.tensor([S, max(1, S // 3),
                                             max(1, S - 65)], device=dev)
                        mask = (torch.arange(S, device=dev)[None]
                                < lens[:, None]).int()
                        if masking == "full_row":
                            mask[1] = 0
                    got = FA.flash_attention(q, k, v, mask, bf16=bf16)
                    want = FA.flash_attention_plain(q, k, v, mask, bf16=bf16,
                                                    kv_tile=tile)
                    torch.cuda.synchronize()
                    label = f"flash bf16={bf16} Dh={dh} S={S} {masking}"
                    if got.shape != (B, H, S, dh) or \
                            not bool(torch.isfinite(got).all()):
                        fail(f"{label}: wrong shape or non-finite output")
                    err = float((got - want).abs().max())
                    if not torch.allclose(got, want, rtol=FLASH_TOL[bf16],
                                          atol=FLASH_TOL[bf16]):
                        fail(f"{label}: kernel and plain differ by {err}")
                    if masking == "full_row":
                        ref = FA.attention_reference(q[1:2], k[1:2], v[1:2],
                                                     mask[1:2])
                        if not torch.allclose(got[1:2], ref,
                                              rtol=REF_TOL[bf16],
                                              atol=REF_TOL[bf16]):
                            fail(f"{label}: the fully masked row is not the "
                                 f"mean of v")
                    errs[bf16] = max(errs[bf16], err)
                    n_cases += 1
    log(f"[flash] {n_cases} cases match the plain version at the kernel's "
        f"KV tile ({FA.KV_TILE} bf16, {FA.KV_TILE_F32} f32; rtol = atol = "
        f"{FLASH_TOL[True]} bf16, {FLASH_TOL[False]} f32), fully masked rows "
        f"match attention_reference; max |kernel - plain| bf16 "
        f"{errs[True]:.3e}, f32 {errs[False]:.3e}")

    log(f"[flash] timings on {smi}")
    stats = {}
    for B, H, S, dh, ragged in FLASH_SHAPES:
        q, k, v, mask = _flash_inputs(gen, B, H, S, dh, ragged, dev)
        keys = int(mask.sum()) if ragged else B * S    # real keys per query
        amask = None if mask is None else mask.bool()[:, None, None, :]
        # bytes: q, k, v (f32, as the kernel reads them) and the int32
        # mask read once, the f32 output written once; operations: 2 * 2
        # * Dh per (query, real key) pair of each head
        nbytes = 4 * q.numel() * 4 + (0 if mask is None else mask.numel() * 4)
        flops = 4.0 * H * S * keys * dh
        for bf16 in (True, False):
            tile = FA.KV_TILE if bf16 else FA.KV_TILE_F32
            got = FA.flash_attention(q, k, v, mask, bf16=bf16)
            want = FA.flash_attention_plain(q, k, v, mask, bf16=bf16,
                                            kv_tile=tile)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=FLASH_TOL[bf16],
                                  atol=FLASH_TOL[bf16]):
                fail(f"flash {(B, H, S, dh)} bf16={bf16}: kernel and plain "
                     f"differ by {err}")
            del got, want
            mode = "bf16" if bf16 else "f32"

            def kernel():
                return FA.flash_attention(q, k, v, mask, bf16=bf16)

            # the library call on the same f32 inputs (bf16: on bf16
            # casts made inside the timed call, as the kernel reads the
            # f32 inputs and rounds them itself), timed in turns with the
            # kernel so that a shift of the process moves both
            def sdpa():
                args = (q, k, v) if not bf16 else \
                    (q.bfloat16(), k.bfloat16(), v.bfloat16())
                return F.scaled_dot_product_attention(*args, attn_mask=amask)

            if (B, H, S, dh) == FLASH_SHAPES[0][:4]:
                _profile(f"flash SDPA {mode}", sdpa)   # names its kernels
            t = _turns_ms({"kernel": kernel, "sdpa": sdpa}, FLASH_REPS,
                          FLASH_TURNS)
            ms, lib_ms = t["kernel"], t["sdpa"]
            how = (f"medians of {FLASH_TURNS} alternating turns of "
                   f"{FLASH_REPS} calls; kernel / SDPA {ms / lib_ms:.3f}")
            plain_ms = _cuda_ms(lambda: FA.flash_attention_plain(
                q, k, v, mask, bf16=bf16, kv_tile=tile), 2)
            rate = "bf16 tensor core" if bf16 else \
                "f32 as 3 TF32 tensor-core passes"
            bound_ms, bound_by = _bound(nbytes, flops, rate)
            log(f"[flash] {mode:4s} (B, H, S, Dh) = {(B, H, S, dh)}"
                f"{', ragged mask' if ragged else ', no mask'}: kernel "
                f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), SDPA {mode} "
                f"{lib_ms:.3f} ms ({how}), plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({bound_by}; "
                f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP at the "
                f"{rate} peak, {PEAK_FLOPS[rate] / 1e12:.0f} TFLOP/s); "
                f"max |kernel - plain| {err:.3e}")
            if (B, H, S, dh) == FLASH_SHAPES[0][:4]:
                stats[mode] = {"max_abs_err": max(errs[bf16], err), "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by, "library_ms": lib_ms}
        del q, k, v, mask
        torch.cuda.empty_cache()
    return stats


def _probe_ptxas(log):
    """{(store, widest tile, slabs): (registers, spill store + load bytes)}
    of the probe kernel's eight instantiations (bf16, f32 x tiles up to 8,
    up to 32 x D <= 128, wider), from ptxas's lines in its build log."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"probe_scan_kernelI(13__nv_bfloat16|f)Li(\d+)E"
                          r"Lb([01])E", line)
            cur = ("f32" if m.group(1) == "f" else "bf16",
                   int(m.group(2)), m.group(3) == "1") if m else None
            if cur:
                out[cur] = [None, 0]
        elif cur and "spill" in line:
            out[cur][1] = sum(int(n) for n in
                              re.findall(r"(\d+) bytes spill", line))
        elif cur and "registers" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers", line)[1])
    return out


def _probe_check(q, vecs, poff, pcnt, k, metric, max_segs, label):
    """The probe kernel's partials and merged top-k against the plain
    version's; returns max |kernel - plain|."""
    import torch
    from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
    kp = PS.kp_for(k)
    kw = dict(max_segs=max_segs, metric=metric)
    kd, ki = PS.probe_scan(q, vecs, poff, pcnt, kp=kp, **kw)
    pd, pi = PS.probe_scan_plain(q, vecs, poff, pcnt, kp=kp + 1, **kw)
    torch.cuda.synchronize()
    err = _compare(kd, ki, pd, pi, label)
    # the merged top-k: at most kp candidates from one list, and
    # (NEG_FILL, -1) past nprobe * kp
    vd, vi = PS.ivf_probe_scan(q, None, vecs, poff, pcnt, k=k, **kw)
    wd, wi = PS.merge_probes(pd[..., :kp].contiguous(),
                             pi[..., :kp].contiguous(), k=k)
    n = PS._clamped_counts(poff, pcnt, vecs.shape[0]).clamp(
        max=max_segs * PS.SEG)
    want = n.clamp(max=kp).sum(1).clamp(max=k)
    torch.cuda.synchronize()
    if vd.shape != (q.shape[0], k) or not torch.equal(vi < 0, wi < 0) \
            or not torch.allclose(vd, wd, rtol=RTOL, atol=ATOL):
        fail(f"{label}: the merged top-k differs from the plain version's")
    if not torch.equal((vi >= 0).sum(1), want):
        fail(f"{label}: filled columns are not min(k, sum of min(cnt, kp))")
    return err


def _probe_items(poff, pcnt, n_rows, max_segs, tile):
    """(items with rows, rows the kernel reads) for one launch's work
    table: each item reads its list once."""
    from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
    keys, _ = PS.work_table(poff, pcnt, n_rows=n_rows, max_segs=max_segs)
    start, _ = PS.work_items(keys, tile)
    k = keys[start]
    k = k[(k >= 0) & ((k & 0xFFFFFFFF) > 0)]
    return int(k.numel()), int((k & 0xFFFFFFFF).sum())


def _probe_headline(rng, vecs, offsets, counts, lens, batch, nprobe, lib,
                    n_sm):
    """One headline shape: the kernel against plain, then timed (the
    wrapper with its work table, and the kernel alone on a built table)
    beside the bound and the rows it reads."""
    import torch
    from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
    dev = vecs.device
    q = torch.randn((batch, DIM), device=dev)
    probes = _probes(rng, batch, nprobe, nprobe, NLISTS, dev)
    poff, pcnt = offsets[probes.long()], counts[probes.long()]
    kp = PS.kp_for(K)
    max_segs = PS.segments_for(int(lens.max()))
    tuples, rows, uniq = _probe_work(probes, counts, NLISTS)
    # bytes: the distinct probed rows (bf16), the f32 queries and the
    # probes' offsets and counts read once, the partials written once;
    # operations: each tuple's f32 products and each distinct row's |x|^2
    nbytes = uniq * DIM * 2 + batch * DIM * 4 + tuples * 8 + tuples * kp * 8
    flops = 2.0 * rows * DIM + 2.0 * uniq * DIM
    bound_ms, bound_by = _bound(nbytes, flops, "f32")
    kw = dict(kp=kp, max_segs=max_segs)
    kd, ki = PS.probe_scan(q, vecs, poff, pcnt, **kw)
    pd, pi = PS.probe_scan_plain(q, vecs, poff, pcnt, kp=kp + 1,
                                 max_segs=max_segs)
    torch.cuda.synchronize()
    label = f"probe headline {batch} x {nprobe}"
    err = _compare(kd, ki, pd, pi, label)
    del kd, ki, pd, pi
    tile = PS.tile_for(tuples, PS.pick_tile(lib, DIM, kp, True), n_sm)
    items, read = _probe_items(poff, pcnt, vecs.shape[0], max_segs, tile)
    keys, order = PS.work_table(poff, pcnt, n_rows=vecs.shape[0],
                                max_segs=max_segs)
    out_d = torch.empty((nprobe, batch, kp), device=dev)
    out_i = torch.empty((nprobe, batch, kp), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def kernel_alone():
        if lib.ivf_probe_scan(q.data_ptr(), vecs.data_ptr(), keys.data_ptr(),
                              order.data_ptr(), out_d.data_ptr(),
                              out_i.data_ptr(), batch, nprobe, DIM, kp, 0, 1,
                              1, tile, stream):
            fail(f"{label}: launch failed")
    t = _turns_ms({"wrapper": lambda: PS.probe_scan(q, vecs, poff, pcnt, **kw),
                   "kernel": kernel_alone,
                   "table": lambda: PS.work_table(
                       poff, pcnt, n_rows=vecs.shape[0], max_segs=max_segs)},
                  10, 5)
    plain_ms = _cuda_ms(lambda: PS.probe_scan_plain(q, vecs, poff, pcnt,
                                                    **kw), 2)
    ms = t["wrapper"]
    log(f"[probe] headline {batch} x nprobe {nprobe}: {tuples} tuples, "
        f"{rows} rows scanned, {uniq} distinct, max_segs {max_segs}, kp "
        f"{kp}, tile {tile}: {items} items; wrapper (work "
        f"table + kernel) {ms:.4f} ms, kernel alone {t['kernel']:.4f} ms, "
        f"work table alone {t['table']:.4f} ms (medians of 5 turns); plain "
        f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}; "
        f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP at the f32 peak), "
        f"kernel / bound {t['kernel'] / bound_ms:.2f}; rows read by the "
        f"kernel {read * DIM * 2 / 1e9:.3f} GB "
        f"({read * DIM * 2 / t['kernel'] / 1e9:.2f} TB/s; the first kernel "
        f"read {rows * DIM * 2 / 1e9:.2f} GB)")
    return err, ms, plain_ms, bound_ms, bound_by


def _probe_wide_times(rng, dev, smi):
    """The probe kernel at the wide rows, timed (wrapper: work table and
    kernel) beside its bound: 1,024 queries x nprobe 8, k 10, over 200
    lists of ~500 rows (100k rows), both stores."""
    import torch
    from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
    lens = rng.multinomial(PROBE_WIDE_ROWS, np.full(200, 1 / 200))
    max_segs = PS.segments_for(int(lens.max()))
    kp = PS.kp_for(K)
    for dim in PROBE_WIDE:
        for dtype in (torch.bfloat16, torch.float32):
            vecs, offsets, counts = _layout(rng, lens, dim, dtype, dev)
            q = torch.randn((1024, dim), device=dev)
            probes = _probes(rng, 1024, 8, 8, 200, dev)
            poff, pcnt = offsets[probes.long()], counts[probes.long()]
            tuples, rows, uniq = _probe_work(probes, counts, 200)
            esize = vecs.element_size()
            nbytes = (uniq * dim * esize + 1024 * dim * 4 + tuples * 8
                      + tuples * kp * 8)
            flops = 2.0 * rows * dim + 2.0 * uniq * dim
            bound_ms, bound_by = _bound(nbytes, flops, "f32")
            ms = _cuda_ms(lambda: PS.probe_scan(q, vecs, poff, pcnt, kp=kp,
                                                max_segs=max_segs), 10)
            log(f"[probe] D {dim} {'bf16' if esize == 2 else 'f32'} store, "
                f"1024 x nprobe 8 over {PROBE_WIDE_ROWS} rows in 200 lists, "
                f"kp {kp}: wrapper {ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} "
                f"GFLOP at the f32 peak), wrapper / bound "
                f"{ms / bound_ms:.2f} on {smi}")
            del vecs


def phase_probe_kernel(smi):
    import torch
    from neurondb_tpu_torch.ops.kernels import _build
    from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    lib = PS._lib()
    ptxas = _probe_ptxas(_build.build_log("ivf_probe_scan"))
    if len(ptxas) != 8:
        fail(f"probe: ptxas lines for {len(ptxas)} of 8 kernels in the log")
    for (store, widest, slabs), (regs, spill) in sorted(ptxas.items()):
        name = (f"probe_scan_kernel<{store}, tiles to {widest}, "
                f"{'D > 128' if slabs else 'D <= 128'}>")
        log(f"[probe] ptxas {name}: {regs} registers, {spill} bytes spilled")
        if spill:
            fail(f"{name} spills {spill} bytes")
    for kp in (10, 100, 512):
        tq = PS.pick_tile(lib, DIM, kp, True)
        log(f"[probe] kp {kp}: tile {tq}, "
            f"{lib.ivf_probe_scan_smem_bytes(tq, DIM, kp, 1)} B of shared "
            f"memory, {lib.ivf_probe_scan_occupancy(tq, DIM, kp, 1)} blocks "
            f"of 128 threads per SM (bf16 store, D {DIM})")
    vecs, offsets, counts = _layout(rng, PROBE_LENS, DIM, torch.bfloat16, dev)
    nl = len(PROBE_LENS)
    max_segs = PS.segments_for(max(PROBE_LENS))
    err_max = 0.0
    n_cases = 0
    for k, nprobe in PROBE_CASES:
        for metric in ("sqeuclidean", "ip"):
            q = torch.randn((PROBE_B, DIM), device=dev)
            lists = _probes(rng, PROBE_B, nprobe, nprobe, nl, dev).long()
            err_max = max(err_max, _probe_check(
                q, vecs, offsets[lists], counts[lists], k, metric, max_segs,
                f"probe k={k} nprobe={nprobe} {metric}"))
            n_cases += 1
    # hot lists: every query probes the same 3 lists, so items split
    hot = torch.as_tensor(PROBE_HOT, device=dev)
    lists = hot[torch.as_tensor(np.stack([rng.permutation(3) for _ in
                                          range(PROBE_B)]), device=dev)]
    # adjacent empty lists: each shares its offset with the next list
    e_vecs, e_off, e_cnt = _layout(rng, PROBE_LENS_EMPTY, DIM, torch.bfloat16,
                                   dev)
    e_lists = _probes(rng, PROBE_B, 4, 4, len(PROBE_LENS_EMPTY), dev).long()
    for k in (10, 512):
        for metric in ("sqeuclidean", "ip"):
            q = torch.randn((PROBE_B, DIM), device=dev)
            err_max = max(err_max, _probe_check(
                q, vecs, offsets[lists], counts[lists], k, metric, max_segs,
                f"probe hot lists k={k} {metric}"))
            err_max = max(err_max, _probe_check(
                q, e_vecs, e_off[e_lists], e_cnt[e_lists], k, metric,
                PS.segments_for(max(PROBE_LENS_EMPTY)),
                f"probe adjacent empty lists k={k} {metric}"))
            n_cases += 2
    # wide rows, staged in 128-dim slabs: both stores, k 10 and 512
    n_wide = 0
    for dim in PROBE_WIDE:
        for dtype in (torch.bfloat16, torch.float32):
            w_vecs, w_off, w_cnt = _layout(rng, PROBE_LENS, dim, dtype, dev)
            bf16 = dtype == torch.bfloat16
            for k in (10, 512):
                kp = PS.kp_for(k)
                tq = PS.pick_tile(lib, dim, kp, bf16)
                smem = lib.ivf_probe_scan_smem_bytes(tq, dim, kp, int(bf16))
                log(f"[probe] D {dim} {'bf16' if bf16 else 'f32'} kp {kp}: "
                    f"tile {tq}, {smem} B of shared memory, "
                    f"{lib.ivf_probe_scan_occupancy(tq, dim, kp, int(bf16))} "
                    f"blocks per SM")
                for metric in ("sqeuclidean", "ip"):
                    q = torch.randn((PROBE_B, dim), device=dev)
                    lists = _probes(rng, PROBE_B, 3, 3, nl, dev).long()
                    err_max = max(err_max, _probe_check(
                        q, w_vecs, w_off[lists], w_cnt[lists], k, metric,
                        max_segs, f"probe D {dim} {dtype} k={k} {metric}"))
                    n_wide += 1
            del w_vecs
    n_cases += n_wide
    _probe_wide_times(rng, dev, smi)
    q = torch.randn((PROBE_B, DIM), device=dev)
    poff = offsets[_probes(rng, PROBE_B, 3, 3, nl, dev).long()]
    kd, ki = PS.ivf_probe_scan(q, None, vecs, poff, torch.zeros_like(poff),
                               k=10, max_segs=max_segs)
    torch.cuda.synchronize()
    if not (bool((ki == -1).all()) and bool((kd == PS.NEG_FILL).all())):
        fail("probe: an all-empty probe set must give (NEG_FILL, -1) only")
    n_cases += 1
    log(f"[probe] {n_cases} cases match the plain version (lists "
        f"{list(PROBE_LENS)}, bf16 store, B {PROBE_B}, (k, nprobe) in "
        f"{list(PROBE_CASES)}, sqeuclidean and ip; hot lists {PROBE_HOT} "
        f"probed by every query and the lists {list(PROBE_LENS_EMPTY)} at "
        f"nprobe 4, k 10 and 512; D {list(PROBE_WIDE)} in both stores at "
        f"k 10 and 512, nprobe 3 ({n_wide} cases); an all-empty probe set; "
        f"rtol {RTOL}, "
        f"atol {ATOL}; merged top-k with the per-probe cap); max |kernel - "
        f"plain| {err_max:.3e}")
    del vecs, e_vecs
    # the flat kernel's headline shapes: 1M bf16 rows in 1024 lists,
    # 16,384 queries, nprobe 8, k 10; then the small-batch side, 1,024
    # queries at nprobe 4
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lens = rng.multinomial(N_ROWS, np.full(NLISTS, 1.0 / NLISTS))
    vecs, offsets, counts = _layout(rng, lens, DIM, torch.bfloat16, dev)
    err, ms, plain_ms, bound_ms, bound_by = _probe_headline(
        rng, vecs, offsets, counts, lens, BATCH, 8, lib, n_sm)
    err_small, *_ = _probe_headline(rng, vecs, offsets, counts, lens, 1024,
                                    4, lib, n_sm)
    log("[probe] no single PyTorch call computes a per-(query, probe) list "
        "scan with its top-k; library_ms is null")
    del vecs
    torch.cuda.empty_cache()
    return {"exact": {"max_abs_err": max(err_max, err, err_small), "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None}}


def _rerank_vocab():
    """The synthetic WordPiece vocab of scripts/bench_rerank.py:39-47."""
    return (["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [f"w{i}" for i in range(2000)]
            + [f"##s{i}" for i in range(200)])


def _write_bert_export(path, seed=0, c=BERT_BASE):
    """weights.npz under the HF names (Linear weights [out, in]), random
    N(0, 0.02) weights from a numpy seed, zero biases, unit LayerNorm
    gains, a one-logit classifier; vocab.txt; config.json. ``c``: the
    geometry (BERT-base, or all-MiniLM-L6-v2's for the RAG phase)."""
    rng = np.random.default_rng(seed)
    h, ff = c["hidden"], c["ff"]

    def rnd(*shape):
        return (rng.standard_normal(shape, np.float32) * 0.02)

    st = {"embeddings.word_embeddings.weight": rnd(c["vocab"], h),
          "embeddings.position_embeddings.weight": rnd(c["max_len"], h),
          "embeddings.token_type_embeddings.weight": rnd(2, h),
          "embeddings.LayerNorm.weight": np.ones(h, np.float32),
          "embeddings.LayerNorm.bias": np.zeros(h, np.float32),
          "pooler.dense.weight": rnd(h, h),
          "pooler.dense.bias": np.zeros(h, np.float32),
          "classifier.weight": rnd(1, h),
          "classifier.bias": np.zeros(1, np.float32)}
    for i in range(c["layers"]):
        pre = f"bert.encoder.layer.{i}."
        for name, (o, n) in (("attention.self.query", (h, h)),
                             ("attention.self.key", (h, h)),
                             ("attention.self.value", (h, h)),
                             ("attention.output.dense", (h, h)),
                             ("intermediate.dense", (ff, h)),
                             ("output.dense", (h, ff))):
            st[pre + name + ".weight"] = rnd(o, n)
            st[pre + name + ".bias"] = np.zeros(o, np.float32)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            st[pre + name + ".weight"] = np.ones(h, np.float32)
            st[pre + name + ".bias"] = np.zeros(h, np.float32)
    np.savez(os.path.join(path, "weights.npz"), **st)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(_rerank_vocab()))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"hidden": h, "heads": c["heads"], "layers": c["layers"],
                   "max_len": c["max_len"], "lowercase": True}, f)
    return sum(a.size for a in st.values())


def phase_rerank():
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch.ml.transformer import (CrossEncoder,
                                                   PretrainedCrossEncoder,
                                                   PretrainedEmbedder,
                                                   TextEmbedder)
    from neurondb_tpu_torch.ops.kernels import flash_attention as FA
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS
    from neurondb_tpu_torch.search.rerank import rerank_cross_encoder

    rng = np.random.default_rng(0)         # scripts/bench_rerank.py:48-52

    def mktext(n_words):
        return " ".join(f"w{int(i)}" for i in rng.integers(0, 2000, n_words))

    query = mktext(24)
    docs = [mktext(480) for _ in range(RR_DOCS)]   # fills 512 tokens
    with tempfile.TemporaryDirectory() as wdir:
        t0 = time.perf_counter()
        n_params = _write_bert_export(wdir)
        t1 = time.perf_counter()
        ce = PretrainedCrossEncoder(wdir, max_len=RR_LEN, batch=RR_BATCH,
                                    device="cuda")
        emb = PretrainedEmbedder(wdir, max_len=128, device="cuda")
        torch.cuda.synchronize()
        log(f"[rerank] BERT-base export ({n_params / 1e6:.1f} M params, "
            f"{BERT_BASE}) written in {t1 - t0:.2f} s, loaded onto the card "
            f"twice (cross-encoder, embedder) in "
            f"{time.perf_counter() - t1:.2f} s; use_flash {ce.use_flash}")
    if not ce.use_flash or ce.model.tok_emb.device.type != "cuda":
        fail("the cross-encoder must run on the card with the flash kernel")

    def call():
        return rerank_cross_encoder(query, docs, ce, k=RR_K)

    t0 = time.perf_counter()
    call()                                           # warm: cuBLAS, caches
    warm_s = time.perf_counter() - t0
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, order = call()
    main_s = time.perf_counter() - t0
    launches = dict(FA.LAUNCHES)
    want = BERT_BASE["layers"] * -(-RR_DOCS // RR_BATCH)
    log(f"[rerank] main path: rerank_cross_encoder(query of 24 words, "
        f"{RR_DOCS} docs of 480 words, k {RR_K}) through "
        f"PretrainedCrossEncoder(max_len {RR_LEN}, batch {RR_BATCH}) in "
        f"{main_s * 1e3:.1f} ms (warm-up call {warm_s * 1e3:.1f} ms); flash "
        f"launches {launches} (want bf16 {want}, f32 0), flat {G.LAUNCHES}, "
        f"IVF-PQ {PQS.LAUNCHES}")
    if launches != {"bf16": want, "f32": 0}:
        fail(f"the cross-encoder made flash launches {launches}, not bf16 "
             f"{want} and f32 0")
    if scores.shape != (RR_K,) or not np.isfinite(scores).all() or \
            not (np.diff(scores) <= 0).all():
        fail("rerank scores must be k finite values, descending")

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        walls.append(time.perf_counter() - t0)
    pipelined = RR_DOCS / float(np.median(walls))

    def serial():
        # a host sync per sub-batch: tokenizer and card strictly alternate
        return np.concatenate([ce(query, docs[s:s + RR_BATCH], batch=0)
                               for s in range(0, RR_DOCS, RR_BATCH)])
    serial()
    s_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        s_scores = serial()
        s_walls.append(time.perf_counter() - t0)
    serial_rate = RR_DOCS / float(np.median(s_walls))

    t0 = time.perf_counter()
    enc = [ce.tok.encode_pair(query, d, RR_LEN) for d in docs]
    tok_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.stack([e[0] for e in enc])).cuda()
    types = torch.from_numpy(np.stack([e[1] for e in enc])).cuda()
    real = int((ids > 0).sum())

    def encode_only():
        return [ce.model(ids[s:s + RR_BATCH], types[s:s + RR_BATCH],
                         use_flash=True)["score"]
                for s in range(0, RR_DOCS, RR_BATCH)]
    encode_only()
    e_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode_only()
        torch.cuda.synchronize()
        e_walls.append(time.perf_counter() - t0)
    enc_s = float(np.median(e_walls))
    log(f"[rerank] docs/s: pipelined {pipelined:.1f} (median of "
        f"{[round(w * 1e3, 1) for w in walls]} ms), serial {serial_rate:.1f} "
        f"(median of {[round(w * 1e3, 1) for w in s_walls]} ms), encode-bound "
        f"{RR_DOCS / enc_s:.1f} ({enc_s * 1e3:.1f} ms for {RR_DOCS} docs); "
        f"tokenizer {tok_s * 1e3:.1f} ms for {RR_DOCS} pairs (warm word memo), "
        f"share {tok_s / (tok_s + enc_s):.3f} of tokenize + encode; "
        f"{real} real tokens of {RR_DOCS * RR_LEN}")

    full = ce(query, docs)
    ce.use_flash = False
    ref = ce(query, docs)
    ce.use_flash = True
    diff = float(np.abs(full - ref).max())
    top_k = set(np.argsort(-full, kind="stable")[:RR_K])
    top_r = set(np.argsort(-ref, kind="stable")[:RR_K])
    log(f"[rerank] scores with the kernel vs use_flash=False on the card: "
        f"max |diff| {diff:.3e} (tolerance {SCORE_TOL}), score range "
        f"{full.min():.4f}..{full.max():.4f}, top-{RR_K} overlap "
        f"{len(top_k & top_r)}/{RR_K}; serial vs pipelined scores max |diff| "
        f"{float(np.abs(s_scores - full).max()):.3e}")
    if diff > SCORE_TOL or not np.isfinite(full).all():
        fail(f"flash scores differ from use_flash=False by {diff}")
    if not np.allclose(s_scores, full, rtol=1e-5, atol=1e-5):
        fail("serial (one-shot sub-batches) and pipelined scores differ")

    busy_ms, events = _profile(f"rerank profile {RR_DOCS} docs", call)
    flash = [e for e in events if "flash_bf16_kernel" in e.key]
    flash_ms = sum(e.self_device_time_total for e in flash) / 1e3
    n_flash = sum(e.count for e in flash)
    log(f"[rerank] flash_bf16_kernel in the profiled call: {flash_ms:.3f} ms "
        f"over {n_flash} launches ({flash_ms / max(n_flash, 1):.3f} ms each), "
        f"share {flash_ms / busy_ms:.4f} of {busy_ms:.2f} ms busy")
    del ce, ids, types
    torch.cuda.empty_cache()

    # the embedder: 4,096 texts into a cosine FlatIndex; 1,024 of them
    # embedded again in another batch order must find themselves
    texts = [mktext(int(n)) for n in rng.integers(8, 100, 4096)]
    t0 = time.perf_counter()
    x = emb(texts)
    embed_s = time.perf_counter() - t0
    index = nt.FlatIndex(x, metric="cosine", device="cuda")
    pick = rng.permutation(len(texts))[:1024]
    _, hits = index.search(emb([texts[i] for i in pick]), k=1)
    rate = float((hits[:, 0] == pick).mean())
    log(f"[rerank] PretrainedEmbedder(max_len 128): {len(texts)} texts "
        f"embedded in {embed_s:.2f} s ({x.shape}, unit norm "
        f"{np.allclose(np.linalg.norm(x, axis=1), 1.0, atol=1e-5)}); "
        f"self-retrieval through FlatIndex(cosine), 1,024 queries in "
        f"another batch order: {rate:.4f} (bar {SELF_HIT_BAR})")
    if rate < SELF_HIT_BAR or not np.isfinite(x).all():
        fail(f"embedder self-retrieval {rate} < {SELF_HIT_BAR}")
    del emb, index
    torch.cuda.empty_cache()

    before = dict(FA.LAUNCHES)
    few = docs[:100]
    small = CrossEncoder(device="cuda")(query, few)
    te = TextEmbedder(device="cuda")(few[:10])
    n = FA.LAUNCHES["bf16"] - before["bf16"]
    want = 4 * -(-len(few) // 64) + 4          # 4 layers each, batch 64
    log(f"[rerank] default CrossEncoder() scored {len(few)} docs and "
        f"TextEmbedder() embedded 10 texts (hash tokenizer, pre-LN, hidden "
        f"256): flash launches {n} (want {want})")
    if n != want or FA.LAUNCHES["f32"] != before["f32"] or \
            not (np.isfinite(small).all() and np.isfinite(te).all()):
        fail("the default encoders did not run through the flash kernel")
    return launches


class _BlockImports:
    """A finder that refuses the named top-level modules: the generation
    phase runs as on a machine without them (the card machine has no
    transformers, PIL or regex)."""

    def __init__(self, names):
        self.names = set(names)

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"{name} is blocked in phase_generate")
        return None


def _gpt_prompts(rng, lens, S, vocab):
    ids = np.zeros((len(lens), S), np.int64)
    for b, n in enumerate(lens):
        ids[b, S - n:] = rng.integers(0, vocab, n)
    return ids


def _teacher_forced(params, ids, lens, toks, heads, cache_len, **kw):
    """Logits [steps, B, V]: prefill, then one decode step a given token
    (``toks`` [B, steps]); ``kw``: kv_int8 / int8_dot."""
    import torch
    from neurondb_tpu_torch.ml import gpt as TG
    dev = params["wte"].device
    idt = torch.as_tensor(ids, device=dev)
    lt = torch.as_tensor(lens, device=dev).long()
    with torch.no_grad():
        logits, cache = TG._prefill(params, idt, lt, heads, cache_len,
                                    kv_int8=any(kw.values()))
        out = [logits.float()]
        step = torch.zeros((), dtype=torch.long, device=dev)
        for i in range(toks.shape[1] - 1):
            logits, cache = TG._decode_step(params, cache, toks[:, i], step,
                                            ids.shape[1], lt, heads,
                                            int8_dot=kw.get("int8_dot", False))
            out.append(logits.float())
            step += 1
    return torch.stack(out)


def _kv_compare(params, ids, lens, toks, ref, heads, cache_len, **kw):
    """An int8 cache (``kw``: kv_int8 / int8_dot) against the reference
    cache's teacher-forced logits ``ref`` [steps, B, V] along its greedy
    tokens ``toks`` [B, steps]: max and mean |logit diff|, the share of
    steps whose argmax agrees, the largest reference top-2 gap where it
    does not; free-running greedy decode: tokens equal, and the largest
    reference top-2 gap at a row's first differing token (until then the
    two runs decode the same prefix, so the reference gap is that step's)."""
    import torch
    from neurondb_tpu_torch.ml import gpt as TG
    got = _teacher_forced(params, ids, lens, toks, heads, cache_len, **kw)
    d = (got - ref).abs()
    top2 = ref.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).T                      # [B, steps]
    agree = (got.argmax(-1) == ref.argmax(-1)).T
    free, _ = TG.generate_ids(params, ids, lens, 0, heads=heads,
                              max_new=toks.shape[1], cache_len=cache_len, **kw)
    same = free == toks
    firsts = [(b, int((~same[b]).nonzero()[0]))
              for b in range(same.shape[0]) if not bool(same[b].all())]
    return dict(diff=float(d.max()), mean=float(d.mean()),
                agree=float(agree.float().mean()),
                flip_gap=float(gap[~agree].max()) if bool((~agree).any())
                else 0.0,
                free_equal=int(same.sum()), n=same.numel(),
                free_gap=max((float(gap[b, i]) for b, i in firsts),
                             default=0.0))


def _host_waits(fn):
    """How often ``fn`` makes the host wait for the card, counted by the
    sync debug mode's warnings."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def _phase_gpt(smi, tok):
    """GPT-2 small at full width: (a) f32 greedy decode against the
    no-cache argmax, (b) W8A8 bit for bit, (c) the int8 cache and
    int8_dot, (d) sampling, (e) throughput. Returns (f32 params, the bf16
    GPT2LM)."""
    import torch
    from neurondb_tpu_torch.ml import gpt as TG
    c = GPT2_SMALL
    H, V = c["heads"], c["vocab"]
    t0 = time.perf_counter()
    p32 = TG.init_gpt_params(0, vocab_size=V, hidden=c["hidden"],
                             layers=c["layers"], heads=H, max_len=c["max_len"],
                             device="cuda")
    lm_bf = TG.GPT2LM(p32, tok, heads=H, dtype="bfloat16", device="cuda")
    lm_i8 = TG.GPT2LM(p32, tok, heads=H, dtype="int8", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in TG.ParamTree(p32).parameters())
    log(f"[generate] GPT-2 small {c} (the published gpt2 config, "
        f"{n_params / 1e6:.1f} M params), random N(0, 0.02) weights from "
        f"seed 0, byte tokenizer; f32, bf16 and int8 (W8A8) copies on the "
        f"card in {time.perf_counter() - t0:.2f} s; {smi}")

    # (a) f32 greedy decode vs the no-cache forward's argmax
    rng = np.random.default_rng(11)
    lens = rng.integers(5, GPT_PROMPT + 1, GPT_B)
    lens[:2] = (5, GPT_PROMPT)
    ids = _gpt_prompts(rng, lens, GPT_PROMPT, V)
    cache_len = GPT_PROMPT + GPT_NEW
    toks, n_valid = TG.generate_ids(p32, ids, lens, 0, heads=H,
                                    max_new=GPT_NEW, cache_len=cache_len)
    full = np.concatenate([ids, toks[:, :-1].cpu().numpy()], axis=1)
    lg = TG.gpt_logits(p32, full, heads=H, lens=lens + GPT_NEW - 1)
    lg = lg[:, GPT_PROMPT - 1:]                       # predicts token i
    pred = lg.argmax(-1)
    miss = (pred != toks).nonzero().tolist()
    gaps = [float(lg[b, i, pred[b, i]] - lg[b, i, toks[b, i]])
            for b, i in miss]
    log(f"[generate] (a) f32 greedy decode, KV cache, {GPT_B} left-padded "
        f"prompts of {sorted(lens.tolist())} tokens, {GPT_NEW} new: "
        f"{toks.numel() - len(miss)}/{toks.numel()} tokens equal the argmax of "
        f"gpt_logits over prompt + generated prefix; differing at near-ties "
        f"{[round(g, 7) for g in gaps]} (tolerance {GPT_TIE_TOL}); n_valid "
        f"{n_valid.tolist()}; {smi}")
    if any(g > GPT_TIE_TOL for g in gaps) or not bool(torch.isfinite(lg).all()):
        fail(f"f32 KV-cache decode differs from the full forward: gaps {gaps}")
    del lg, full

    # (b) W8A8: the int32 accumulate bit for bit with the f64 sums
    q8 = lm_i8.params
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases, biggest = 0, 0
    shapes = [(n, q8["blocks"][0][n][0], GPT_MM_ROWS)
              for n in ("w_qkv", "w_o", "w_fc", "w_pr")]
    shapes.append(("lm_head", q8["lm_head"][0], GPT_TP_BATCHES))
    for name, wq, rows in shapes:
        for M in rows:
            x = torch.randn((M, wq.shape[0]), generator=gen, device="cuda")
            acc, sx = TG.w8a8_accumulate(x, wq)
            xq, _ = TG._quant_rows(x)
            want = TG.int8_matmul_plain(xq, wq)
            if not torch.equal(acc, want):
                fail(f"W8A8 {name} at {M} rows: _int_mm and the f64 sums "
                     f"differ by {int((acc - want).abs().max())}")
            biggest = max(biggest, int(want.abs().max()))
            cases += 1
    x8 = TG._quant_rows(torch.randn((128, c["hidden"]), generator=gen,
                                    device="cuda"))[0]
    t_int = _cuda_ms(lambda: TG.int8_matmul(x8, q8["lm_head"][0]), 5)
    log(f"[generate] (b) W8A8: {cases} GEMMs (w_qkv, w_o, w_fc, w_pr at "
        f"{GPT_MM_ROWS} rows, lm head [768, 50257] at {GPT_TP_BATCHES}: "
        f"every decode and prefill shape of the int8 model in (e)) bit for "
        f"bit with int8_matmul_plain (f64); largest |sum| {biggest} (2^24 = "
        f"{2 ** 24}: an f32 GEMM on the codes would round); lm head at 128 "
        f"rows {t_int:.3f} ms with its padding; {smi}")

    # (c) the int8 cache: the JAX test's bound on the f32 model's cache,
    # then int8 KV and int8_dot against the bf16 cache, teacher-forced
    idt, lt = torch.as_tensor(ids, device="cuda"), torch.as_tensor(
        lens, device="cuda")
    with torch.no_grad():
        _, exact = TG._prefill(p32, idt, lt, H, cache_len)
        _, quant = TG._prefill(p32, idt, lt, H, cache_len, kv_int8=True)
    worst = float("inf")
    for e, qe in zip(exact["k"] + exact["v"], quant["k"] + quant["v"]):
        dq = TG._dequant_kv(qe).float()
        step = e.abs().amax(-1, keepdim=True) / 127.0
        slack = 0.5 * step + e.abs() * 2 ** -7 + 1e-6 - (dq - e).abs()
        worst = min(worst, float(slack.min()))
    if worst < 0:
        fail(f"int8 KV cache dequantizes past the bound by {-worst}")
    del exact, quant
    pb = lm_bf.params
    tb, _ = TG.generate_ids(pb, ids, lens, 0, heads=H, max_new=GPT_NEW,
                            cache_len=cache_len)
    ref = _teacher_forced(pb, ids, lens, tb, H, cache_len)
    for label, kw in (("int8 KV", dict(kv_int8=True)),
                      ("int8 KV + int8_dot", dict(int8_dot=True))):
        tol, floor = GPT_KV_TOL[label], GPT_KV_AGREE[label]
        st = _kv_compare(pb, ids, lens, tb, ref, H, cache_len, **kw)
        log(f"[generate] (c) {label} vs the bf16 cache (bf16 weights), "
            f"teacher-forced over {tb.numel()} steps: max |logit diff| "
            f"{st['diff']:.4f} (tolerance {tol}; mean {st['mean']:.5f}, "
            f"tolerance {GPT_KV_MEAN[label]}; logits' std "
            f"{float(ref.std()):.3f}), argmax equal at "
            f"{st['agree']:.4f} of steps (floor {floor}), largest top-2 gap "
            f"where not {st['flip_gap']:.4f}; free-running greedy tokens "
            f"equal {st['free_equal']}/{st['n']}, each row's first "
            f"difference at a top-2 gap up to {st['free_gap']:.4f} (bound "
            f"{2 * tol}); {smi}")
        if st["diff"] > tol or st["mean"] > GPT_KV_MEAN[label] \
                or st["agree"] < floor or st["free_gap"] > 2 * tol:
            fail(f"{label} off the bf16 cache: {st}")
    # int8_dot's code products: exact integers (f32 chunks under 2^24)
    # at GPT-2's longest cache, extreme codes, against f64
    g = torch.Generator(device="cuda").manual_seed(6)
    P = c["max_len"] + RAG_GEN_NEW
    kc = torch.randint(-127, 128, (GPT_B, H, P, 64), generator=g,
                       device="cuda").to(torch.int8)
    qq = torch.randint(-127, 128, (GPT_B, H, 64), generator=g,
                       device="cuda").to(torch.int8)
    aq = torch.full((GPT_B, H, P), 127, dtype=torch.int8, device="cuda")
    kc[:, :, :, 0] = -127
    exact_s = torch.equal(TG._int8_scores(qq, kc).double(), torch.einsum(
        "bhd,bhkd->bhk", qq.double(), kc.double()))
    mixed = TG._int8_mix(aq, kc).double()
    exact_o = torch.equal(mixed, torch.einsum("bhk,bhkd->bhd", aq.double(),
                                              kc.double()))
    log(f"[generate] (c) int8_dot code products at P {P} bit for bit with "
        f"f64: scores {exact_s}, mix {exact_o} (largest |sum| "
        f"{int(mixed.abs().max())} > 2^24 = {2 ** 24}); {smi}")
    if not (exact_s and exact_o):
        fail("int8_dot's code products are not the exact integer sums")
    del kc
    log(f"[generate] (c) int8 cache vs the f32 model's f32 cache: within half "
        f"a step + |e| 2^-7 + 1e-6 everywhere (least slack {worst:.3e}); "
        f"{smi}")
    del ref

    # (d) sampling: draws in the kept set, seeded, eos latched
    seen = []
    sample = TG._sample

    def recording(logits, g, temperature, top_k, top_p, do_sample):
        t = sample(logits, g, temperature, top_k, top_p, do_sample)
        seen.append((logits.clone(), t.clone()))
        return t

    kw = dict(heads=H, max_new=GPT_NEW, cache_len=cache_len, temperature=1.0,
              top_k=GPT_TOP_K, top_p=GPT_TOP_P)
    TG._sample = recording
    try:
        s7, _ = TG.generate_ids(pb, ids, lens, 7, **kw)
    finally:
        TG._sample = sample
    kept_sizes = []
    for logits, t in seen:
        lgf, idxs = TG._filter_logits(logits, 1.0, GPT_TOP_K, GPT_TOP_P)
        live = lgf > TG._NEG
        if not bool(((idxs == t[:, None]) & live).any(1).all()):
            fail("a sampled token lies outside the top-k / top-p set")
        kept_sizes += live.sum(1).tolist()
    again, _ = TG.generate_ids(pb, ids, lens, 7, **kw)
    other, _ = TG.generate_ids(pb, ids, lens, 8, **kw)
    eos = int(tb[0, 3])
    latched, nv = TG.generate_ids(pb, ids, lens, 0, heads=H, max_new=GPT_NEW,
                                  cache_len=cache_len, eos_id=eos)
    for b in range(GPT_B):
        hits = (tb[b] == eos).nonzero()
        f = int(hits[0]) if len(hits) else GPT_NEW - 1
        if not (torch.equal(latched[b, :f + 1], tb[b, :f + 1])
                and bool((latched[b, f + 1:] == eos).all())
                and int(nv[b]) == min(f + 1, GPT_NEW)):
            fail(f"eos {eos} did not latch in row {b}")
    log(f"[generate] (d) sampling top_k {GPT_TOP_K}, top_p {GPT_TOP_P}, "
        f"temperature 1: {len(seen)} steps x {GPT_B} draws all in the kept "
        f"set (kept {min(kept_sizes)}-{max(kept_sizes)} tokens); seed 7 twice "
        f"equal {torch.equal(s7, again)}, seed 8 differs "
        f"{not torch.equal(s7, other)}; eos {eos} latches (n_valid "
        f"{nv.tolist()}); {smi}")
    if not torch.equal(s7, again) or torch.equal(s7, other):
        fail("sampling does not follow its seed")
    # no host wait inside the decode loop: GPT_NEW tokens wait as often
    # as 2 (the set-up's copies), greedy, sampled and int8_dot
    control = _host_waits(lambda: torch.ones(1, device="cuda").item())
    waits = {}
    for label, extra in (("greedy", {}), ("sampled", dict(
            temperature=1.0, top_k=GPT_TOP_K, top_p=GPT_TOP_P)),
            ("int8_dot", dict(int8_dot=True))):
        waits[label] = [_host_waits(lambda: TG.generate_ids(
            pb, ids, lens, 0, heads=H, max_new=n, cache_len=cache_len,
            eos_id=eos, **extra)) for n in (2, GPT_NEW)]
    log(f"[generate] (d) host waits for the card (sync debug mode) at 2 and "
        f"{GPT_NEW} new tokens: {waits}; an .item() counts {control}; {smi}")
    if control < 1 or any(a != b for a, b in waits.values()):
        fail(f"the decode loop waits for the card: {waits}")

    # (e) throughput: B x (f32, bf16, int8 weights) x (kv None, int8)
    log(f"[generate] (e) throughput, prompt {GPT_TP_PROMPT}, "
        f"{GPT_TP_NEW} new tokens, greedy, on {smi}")
    models = {"f32": p32, "bf16": pb, "int8": q8}
    tps = {}
    cl = GPT_TP_PROMPT + GPT_TP_NEW
    for B in GPT_TP_BATCHES:
        ids_b = np.random.default_rng(B).integers(0, V, (B, GPT_TP_PROMPT))
        lens_b = np.full(B, GPT_TP_PROMPT)
        idt = torch.as_tensor(ids_b, device="cuda")
        lt = torch.as_tensor(lens_b, device="cuda")
        for dtype, params in models.items():
            for kv in (False, True):
                def run():
                    return TG.generate_ids(params, ids_b, lens_b, 0, heads=H,
                                           max_new=GPT_TP_NEW, cache_len=cl,
                                           kv_int8=kv)[0].cpu()
                run()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                run()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                with torch.no_grad():
                    pre = _cuda_ms(lambda: TG._prefill(params, idt, lt, H, cl,
                                                       kv_int8=kv), 3)
                step_ms = (wall * 1e3 - pre) / (GPT_TP_NEW - 1)
                tps[(B, dtype, kv)] = B * GPT_TP_NEW / wall
                log(f"[generate] B {B:3d} {dtype:4s} kv "
                    f"{'int8' if kv else 'None'}: {tps[(B, dtype, kv)]:9.1f} "
                    f"tokens/s end to end ({wall * 1e3:.1f} ms), prefill "
                    f"{pre:.2f} ms, decode {step_ms:.3f} ms/step "
                    f"({B / step_ms * 1e3:.1f} tokens/s), peak "
                    f"{peak / 2 ** 30:.3f} GiB above the models")
    for dtype in ("bf16", "int8"):
        wins = [B for B in GPT_TP_BATCHES
                if tps[(B, dtype, True)] >= tps[(B, dtype, False)]]
        log(f"[generate] {dtype} weights: int8 KV at least as fast as the bf16 "
            f"cache at B {wins} of {list(GPT_TP_BATCHES)} (the JAX "
            f"crossover, kept: B >= {TG.KV_INT8_MIN_BATCH}); {smi}")
    ids_b = np.random.default_rng(128).integers(0, V, (128, GPT_TP_PROMPT))
    busy, events = _profile(
        "generate profile B 128 bf16", lambda: TG.generate_ids(
            pb, ids_b, np.full(128, GPT_TP_PROMPT), 0, heads=H,
            max_new=GPT_TP_NEW, cache_len=cl)[0].cpu())
    del models
    return p32, lm_bf


def _phase_vit(smi):
    """ViT-base: 64 raw-RGB images through the flash kernel (S 197, no
    mask): the kernel at that shape against its plain version, the
    encoder against use_flash=False, images/s, the service. Returns the
    main path's flash launches."""
    import torch
    from neurondb_tpu_torch.ml import bert as TB
    from neurondb_tpu_torch.ml import vision as TV
    from neurondb_tpu_torch.ops.kernels import flash_attention as FA
    from neurondb_tpu_torch.service.embeddings import EmbeddingService
    from neurondb_tpu_torch.service.llm import LLMRouter, LocalProvider
    c = VIT_BASE
    t0 = time.perf_counter()
    enc = TV.VisionEncoder(TV.init_vit_params(1, **c), heads=c["heads"],
                           device="cuda")
    rng = np.random.default_rng(12)
    blobs = [rng.integers(0, 256, (int(side), int(side), 3),
                          dtype=np.uint8).tobytes()
             for side in rng.integers(96, 321, VIT_IMAGES)]
    t1 = time.perf_counter()
    arr = np.stack([TV.preprocess_image(b, enc.image_size) for b in blobs])
    prep_s = time.perf_counter() - t1
    if not enc.use_flash:
        fail("the ViT encoder must run the flash kernel on the card")
    seen, restore = _catch(TB, "flash_attention")
    try:
        enc.embed_images(arr)                              # warm
    finally:
        restore()
    (q, k, v, mask), _ = seen["args"]
    got = FA.flash_attention(q, k, v, mask)
    want = FA.flash_attention_plain(q, k, v, mask, bf16=True,
                                    kv_tile=FA.KV_TILE)
    err = float((got - want).abs().max())
    log(f"[vit] ViT-base {c} (google/vit-base-patch16-224's geometry), random "
        f"weights, set up in {t1 - t0:.2f} s; {VIT_IMAGES} raw RGB images of "
        f"96-320 px preprocessed (nearest resize, no PIL) in {prep_s:.3f} s; "
        f"flash kernel at {tuple(q.shape)}, mask {mask}, vs plain at its KV "
        f"tile: max |diff| {err:.3e} (tolerance {FLASH_TOL[True]}); {smi}")
    if tuple(q.shape) != (VIT_IMAGES, c["heads"], 197, 64) or mask is not None \
            or not torch.allclose(got, want, rtol=FLASH_TOL[True],
                                  atol=FLASH_TOL[True]):
        fail(f"ViT flash kernel at {tuple(q.shape)} differs from plain by {err}")
    del q, k, v, got, want, seen
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = enc.embed_images(arr)
    main_s = time.perf_counter() - t0
    launches = dict(FA.LAUNCHES)
    want_l = {"bf16": c["layers"], "f32": 0}
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        enc.embed_images(arr)
        walls.append(time.perf_counter() - t0)
    enc.use_flash = False
    ref = enc.embed_images(arr)
    enc.use_flash = True
    diff = float(np.abs(emb - ref).max())
    log(f"[vit] main path: VisionEncoder.embed_images({VIT_IMAGES} images) "
        f"in {main_s * 1e3:.1f} ms, flash launches {launches} (want {want_l}); "
        f"{VIT_IMAGES / float(np.median(walls)):.1f} images/s (median of "
        f"{[round(w * 1e3, 1) for w in walls]} ms); vs use_flash=False max "
        f"|diff| {diff:.3e} of |cls| up to {float(np.abs(ref).max()):.3f} "
        f"(tolerance {VIT_FLASH_TOL}); {smi}")
    if launches != want_l:
        fail(f"the ViT made flash launches {launches}, not {want_l}")
    if emb.shape != (VIT_IMAGES, c["hidden"]) or not np.isfinite(emb).all() \
            or diff > VIT_FLASH_TOL:
        fail(f"ViT embeddings off use_flash=False by {diff}")
    # the service, one image a call: each result the batch's CLS row cut
    # to the model config's dim and normalized (B 1 vs B 64 GEMMs: f32
    # sums in another order)
    svc = EmbeddingService(LLMRouter([LocalProvider(device="cuda")]))
    svc.set_vision_encoder(enc)
    dim = svc.get_model("default").dim
    want = np.pad(emb[:, :dim], ((0, 0), (0, max(dim - emb.shape[1], 0))))
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    t0 = time.perf_counter()
    got = np.stack([svc.embed_image(b) for b in blobs])
    svc_s = time.perf_counter() - t0
    svc_err = float(np.abs(got - want).max())
    if svc_err > 1e-4 or np.abs(np.linalg.norm(got, axis=1) - 1).max() > 1e-5:
        fail(f"EmbeddingService.embed_image is {svc_err} off the ViT's unit CLS")
    busy_ms, events = _profile(f"vit profile {VIT_IMAGES} images",
                               lambda: enc.embed_images(arr))
    flash = [e for e in events if "flash_bf16_kernel" in e.key]
    flash_ms = sum(e.self_device_time_total for e in flash) / 1e3
    log(f"[vit] EmbeddingService.embed_image on the {VIT_IMAGES} raw images, "
        f"one a call: {VIT_IMAGES / svc_s:.1f} images/s, unit norm, within "
        f"{svc_err:.2e} of the batch's CLS (dim {dim}; tolerance 1e-4); "
        f"flash_bf16_kernel {flash_ms:.3f} ms over "
        f"{sum(e.count for e in flash)} launches in the profiled batch, "
        f"share {flash_ms / busy_ms:.4f} of {busy_ms:.2f} ms busy; {smi}")
    return launches["bf16"]


def _rag_corpus(rng):
    """RAG_DOCS documents of RAG_SENTS sentences (6-14 words of the rerank
    vocabulary); every document's sentences kept for the queries."""
    words = np.asarray([f"w{i}" for i in range(2000)])
    docs, sents = [], []
    for _ in range(RAG_DOCS):
        n = rng.integers(6, 15, RAG_SENTS)
        w = words[rng.integers(0, 2000, int(n.sum()))]
        ss = [" ".join(x) + "." for x in np.split(w, np.cumsum(n)[:-1])]
        sents.append(ss)
        docs.append(" ".join(ss))
    return docs, sents


def _phase_rag(smi, lm_bf):
    """Client().rag() on a MiniLM-geometry export: 10,000 documents,
    256 hybrid queries (self-hit), the dense side against f64 on the
    host, then 64 answers through Client().llm. Returns the embed
    call's flash launches."""
    import torch
    from neurondb_tpu_torch.client import Client
    from neurondb_tpu_torch.ml import bert as TB
    from neurondb_tpu_torch.ops.kernels import flash_attention as FA
    from neurondb_tpu_torch.service.llm import LocalProvider
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    docs, sents = _rag_corpus(rng)
    gen_s = time.perf_counter() - t0
    wdir = tempfile.mkdtemp(prefix="ndb_minilm_")
    old = os.environ.get("NEURONDB_TORCH_WEIGHTS")
    try:
        n_params = _write_bert_export(wdir, seed=3, c=MINILM)
        os.environ["NEURONDB_TORCH_WEIGHTS"] = wdir
        client = Client()
        rag = client.rag()
        # the first sub-batch's attention inputs, copied as the counted
        # call makes them, for the kernel check below
        seen, restore = _catch(TB, "flash_attention", clone=True)
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            rag.add_documents(docs)
        finally:
            restore()
        add_s = time.perf_counter() - t0
        launches = dict(FA.LAUNCHES)
    finally:
        if old is None:
            os.environ.pop("NEURONDB_TORCH_WEIGHTS", None)
        else:
            os.environ["NEURONDB_TORCH_WEIGHTS"] = old
        import shutil
        shutil.rmtree(wdir, ignore_errors=True)
    emb = client.llm.providers[0]._embedder
    n_chunks = len(rag.chunks)
    want_l = MINILM["layers"] * -(-n_chunks // emb.batch)
    log(f"[rag] all-MiniLM-L6-v2 geometry {MINILM} ({n_params / 1e6:.1f} M "
        f"params, random), {RAG_DOCS} documents of "
        f"{np.mean([len(d) for d in docs]):.0f} characters (made in "
        f"{gen_s:.2f} s) -> {n_chunks} chunks (512 / overlap 64); "
        f"add_documents {add_s:.2f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in rag.build_seconds.items())
        + f"; embed flash launches {launches} (want bf16 {want_l}: "
        f"{MINILM['layers']} layers x {-(-n_chunks // emb.batch)} sub-batches "
        f"of {emb.batch}); {smi}")
    if launches != {"bf16": want_l, "f32": 0} or \
            type(emb).__name__ != "PretrainedEmbedder":
        fail(f"the RAG embed made flash launches {launches}, not bf16 {want_l}")
    # the kernel at the embed's own shape (Dh 32, ragged key mask), held
    # to its plain version on the inputs of the first sub-batch
    (q, k, v, mask), _ = seen["args"]
    got = FA.flash_attention(q, k, v, mask)
    want = FA.flash_attention_plain(q, k, v, mask, bf16=True,
                                    kv_tile=FA.KV_TILE)
    err = float((got - want).abs().max())
    pads = 0 if mask is None else int((mask == 0).sum())
    log(f"[rag] flash kernel at the embed's first sub-batch {tuple(q.shape)}, "
        f"key mask with {pads} padded keys, vs plain at its KV tile: max "
        f"|diff| {err:.3e} (tolerance {FLASH_TOL[True]}); {smi}")
    if tuple(q.shape) != (emb.batch, MINILM["heads"], emb.max_len, 32) \
            or mask is None or pads == 0 \
            or not torch.allclose(got, want, rtol=FLASH_TOL[True],
                                  atol=FLASH_TOL[True]):
        fail(f"RAG flash kernel at {tuple(q.shape)} differs from plain by "
             f"{err}")
    del q, k, v, mask, got, want, seen
    # the counted call's embeddings (the index's vectors) against the
    # embedder with use_flash=False on the same chunks
    n0 = min(emb.batch, n_chunks)
    main = rag._index._vecs[:n0].float().cpu().numpy()
    emb.use_flash = False
    try:
        plain = np.asarray(emb(rag.chunks[:n0]), np.float32)
    finally:
        emb.use_flash = True
    e_err = float(np.abs(main - plain).max())
    cos = float(((main * plain).sum(1) / (np.linalg.norm(main, axis=1)
                                          * np.linalg.norm(plain, axis=1))
                 ).min())
    log(f"[rag] the embed's vectors for the first {n0} chunks vs "
        f"use_flash=False: max |diff| {e_err:.3e} (tolerance {RAG_EMB_TOL}), "
        f"least cosine {cos:.7f}; {smi}")
    if main.shape != plain.shape or not np.isfinite(main).all() \
            or e_err > RAG_EMB_TOL:
        fail(f"RAG embeddings off use_flash=False by {e_err}")
    picks = rng.choice(RAG_DOCS, RAG_QUERIES, replace=False)
    queries = [sents[d][int(rng.integers(RAG_SENTS))] for d in picks]
    hits = {}
    for weight in (0.0, 0.5):
        t0 = time.perf_counter()
        res = [rag.retrieve(q, k=5, hybrid=True, weight=weight)
               for q in queries]
        secs = time.perf_counter() - t0
        hits[weight] = float(np.mean([r[0]["doc_id"] == d
                                      for r, d in zip(res, picks)]))
        log(f"[rag] retrieve(k=5, hybrid=True, weight={weight}) x "
            f"{RAG_QUERIES}: self-hit {hits[weight]:.4f}"
            f"{f' (bar {RAG_SELF_HIT_BAR})' if weight == 0.0 else ' (random weights: no bar)'}"
            f", {RAG_QUERIES / secs:.1f} queries/s one at a time; {smi}")
    if hits[0.0] < RAG_SELF_HIT_BAR:
        fail(f"RAG text-only self-hit {hits[0.0]} < {RAG_SELF_HIT_BAR}")
    # the dense side against f64 on the host, over the card's embeddings
    E = rag._index._vecs.double().cpu().numpy()
    bad = 0
    for q in queries[:RAG_DENSE]:
        qv = np.asarray(rag.embed([q]), np.float64)[0]
        _, ids = rag._index.search(qv.astype(np.float32), k=5)
        cos = E @ qv / (np.linalg.norm(E, axis=1) * np.linalg.norm(qv))
        want = np.argsort(-cos, kind="stable")[:5]
        for a, b in zip(ids, want):
            if a != b and abs(cos[a] - cos[b]) > RAG_TIE_TOL:
                bad += 1
    log(f"[rag] dense top-5 of {RAG_DENSE} queries vs a float64 host "
        f"recomputation over the card's {E.shape} embeddings: {bad} ids differ "
        f"past ties (cosine within {RAG_TIE_TOL}); {smi}")
    if bad:
        fail(f"FlatIndex cosine top-5 differs from float64 at {bad} places")
    # generation through the client's LLM router
    client.llm.providers[:] = [LocalProvider(lm=lm_bf, device="cuda")]
    prompts = [rag.context(q, k=3) + "\n\nQuestion: " + q + "\nAnswer:"
               for q in queries[:RAG_GEN]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = client.llm.complete_batch(prompts, max_tokens=RAG_GEN_NEW)
    gen_wall = time.perf_counter() - t0
    n_tok = [len(lm_bf.tok.encode(p)) for p in prompts]
    log(f"[rag] Client().llm.complete_batch({RAG_GEN} prompts of "
        f"{min(n_tok)}-{max(n_tok)} byte tokens (context k=3 + question), "
        f"max_tokens {RAG_GEN_NEW}) -> LocalProvider -> GPT2LM (GPT-2 small, "
        f"bf16; prompts cut to {lm_bf.max_len - RAG_GEN_NEW}, cache 1,056): "
        f"{gen_wall:.2f} s, {RAG_GEN * RAG_GEN_NEW / gen_wall:.1f} tokens/s; "
        f"{smi}")
    if len(answers) != RAG_GEN or not all(isinstance(a, str) for a in answers):
        fail("the LLM router did not answer every prompt")
    return launches["bf16"]


def phase_generate(smi):
    """GPT-2 small decode, ViT-base and RAG end to end on the card (no
    transformers, PIL or regex). Returns the flash kernel's bf16 launches
    of the ViT and RAG main paths."""
    t_phase = time.perf_counter()
    block = _BlockImports(("transformers", "PIL", "regex"))
    sys.meta_path.insert(0, block)
    try:
        loaded = [m for m in ("transformers", "PIL", "regex")
                  if m in sys.modules]
        if loaded:
            fail(f"{loaded} already imported before phase_generate")
        from neurondb_tpu_torch.ml.bpe import BPETokenizer
        tok = BPETokenizer.byte_fallback()
        p32, lm_bf = _phase_gpt(smi, tok)
        del p32
        n_vit = _phase_vit(smi)
        n_rag = _phase_rag(smi, lm_bf)
    finally:
        sys.meta_path.remove(block)
    log(f"[generate] phase in {time.perf_counter() - t_phase:.1f} s on {smi}")
    return n_vit + n_rag


def _tie_swaps(d_a, i_a, d_b, i_b):
    """Where two exact scans return other ids at a position, whether their
    distances there agree within SH_FLAT_TIE_RTOL (a tie swapped):
    (positions that differ, all of them ties)."""
    swap = i_a != i_b
    tie = np.abs(d_a - d_b) <= SH_FLAT_TIE_RTOL * np.abs(d_b)
    return int(swap.sum()), bool(tie[swap].all())


def phase_store(x, qb, smi):
    """VectorStore (f32 and bf16), RerankReadyIndex and ConsistentIndex on
    the main path's 1M x 128 corpus, 1,024 queries, k 10."""
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch.ml.metrics import recall_at_k
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    n, dim = x.shape
    q = qb[:STORE_NQ]
    flat = {}
    for metric in ("l2", "cosine"):
        f = nt.FlatIndex(x, metric=metric, device="cuda")
        flat[metric] = f.search(q, k=K)
        del f
    torch.cuda.empty_cache()
    rng = np.random.default_rng(11)
    drop = np.sort(rng.choice(n, int(STORE_DELETE * n), replace=False))
    keep = np.setdiff1d(np.arange(n), drop)

    for dtype in ("float32", "bfloat16"):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        store = nt.VectorStore(dim, dtype=dtype, device="cuda")
        t0 = time.perf_counter()
        for s in range(0, n, STORE_BATCH):
            store.add(x[s:s + STORE_BATCH])
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated() - mem0
        if store.capacity != 1 << max(10, (n - 1).bit_length()) or \
                len(store) != n:
            fail(f"VectorStore {dtype}: capacity {store.capacity}, {len(store)} "
                 f"rows after adding {n}")
        log(f"[store] VectorStore({dim}, {dtype}): {n} rows added in batches "
            f"of {STORE_BATCH} in {add_s:.2f} s ({n / add_s:.0f} rows/s), "
            f"capacity {store.capacity}, {held / 2**20:.1f} MiB held on {smi}")
        for metric in ("l2", "cosine"):
            d, ids = store.search(q, k=K, metric=metric)
            fd, fi = flat[metric]
            nswap, ties = _tie_swaps(d, ids, fd, fi)
            qps, reps = _qps(lambda: store.search(q, k=K, metric=metric),
                             STORE_NQ, reps=3, n_batches=1)
            how = (f"all at distance ties within {SH_FLAT_TIE_RTOL:.0e}: "
                   f"{ties}" if dtype == "float32" else "bf16 rows")
            log(f"[store] {dtype} {metric}: recall@10 vs FlatIndex "
                f"{recall_at_k(ids, fi):.4f}, {nswap} of {ids.size} ids "
                f"differ ({how}); QPS median {qps:.0f} of "
                f"{[round(v) for v in reps]} ({STORE_NQ} queries a search)")
            if dtype == "float32" and not ties:
                fail(f"the f32 VectorStore ({metric}) disagrees with "
                     f"FlatIndex past a distance tie")
            if recall_at_k(ids, fi) < RECALL_BAR:
                fail(f"VectorStore {dtype} {metric} recall@10 under "
                     f"{RECALL_BAR} against FlatIndex")
        removed = store.delete(drop)
        _, ids = store.search(q, k=K)
        if removed != len(drop) or np.isin(ids, drop).any():
            fail(f"VectorStore {dtype}: a deleted id was returned (or the "
                 f"delete missed ids: {removed} of {len(drop)})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.compact()
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        fresh = nt.VectorStore(dim, dtype=dtype, device="cuda")
        for s in range(0, len(keep), STORE_BATCH):
            part = keep[s:s + STORE_BATCH]
            fresh.add(x[part], ids=part)
        same = (torch.equal(store.vectors, fresh.vectors)
                and torch.equal(store.sqnorms, fresh.sqnorms)
                and torch.equal(store.valid, fresh.valid)
                and np.array_equal(store.ids, fresh.ids))
        for metric in ("l2", "cosine"):
            a, b = store.search(q, k=K, metric=metric), fresh.search(
                q, k=K, metric=metric)
            same &= all(u.tobytes() == v.tobytes() for u, v in zip(a, b))
        log(f"[store] {dtype}: deleted {removed} ids (none returned), "
            f"compact in {compact_s:.2f} s to {len(store)} rows, capacity "
            f"{store.capacity}; equal to a fresh store of the survivors "
            f"(rows, norms, ids, both metrics' results byte for byte): {same}")
        if not same:
            fail(f"the compacted {dtype} VectorStore differs from a fresh "
                 f"store of the survivors")
        del store, fresh
        torch.cuda.empty_cache()

    # RerankReadyIndex: warm, then every lookup a hit without a launch
    t0 = time.perf_counter()
    rri = nt.RerankReadyIndex(x, k=RRI_K, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    added = rri.warm(q)
    warm_s = time.perf_counter() - t0
    hits = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(STORE_NQ):
            hits.append(rri.get_candidates(q[i]))
        hit_s = time.perf_counter() - t0
    device_events = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
    if rri.hits != STORE_NQ or rri.misses or device_events:
        fail(f"RerankReadyIndex: {rri.hits} hits, {rri.misses} misses, "
             f"{len(device_events)} device events over {STORE_NQ} warmed "
             f"lookups")
    rri._cache.clear()
    t0 = time.perf_counter()
    nswap = 0
    for i in range(RRI_MISSES):
        d, ids, vecs = rri.get_candidates(q[i])
        sw, ties = _tie_swaps(d, ids, hits[i][0], hits[i][1])
        nswap += sw
        if not ties or not np.array_equal(vecs[ids == hits[i][1]],
                                          hits[i][2][ids == hits[i][1]]):
            fail(f"RerankReadyIndex: a miss returns other candidates than "
                 f"the warmed hit for query {i}")
    miss_s = time.perf_counter() - t0
    log(f"[rri] RerankReadyIndex(x, k={RRI_K}) in {build_s:.2f} s; warm "
        f"{STORE_NQ} queries ({added} distinct) in {warm_s:.2f} s; "
        f"{STORE_NQ} lookups all hits, {hit_s / STORE_NQ * 1e6:.1f} us each, "
        f"0 device events under the profiler; {RRI_MISSES} misses "
        f"{miss_s / RRI_MISSES * 1e3:.2f} ms each return the hits' ids "
        f"({nswap} differ, all at distance ties) on {smi}")
    del rri, hits
    torch.cuda.empty_cache()

    # ConsistentIndex: a pin survives adds and deletes, byte for byte
    ci = nt.ConsistentIndex(x, device="cuda")
    p1 = ci.pin()
    t0 = time.perf_counter()
    a1 = ci.search(q, k=K, snapshot=p1)
    search_s = time.perf_counter() - t0
    a2 = ci.search(q, k=K, snapshot=p1)
    new = x[rng.choice(n, CQ_ADD, replace=False)] + \
        0.5 * rng.standard_normal((CQ_ADD, dim)).astype(np.float32)
    ci.add(new)
    gone = rng.choice(ci.n, int(STORE_DELETE * ci.n), replace=False)
    removed = ci.delete(gone)
    p2 = ci.pin()
    a3 = ci.search(q, k=K, snapshot=p1)
    b1 = ci.search(q, k=K, snapshot=p2)
    b2 = ci.search(q, k=K, snapshot=p2)
    same_pin = all(u.tobytes() == v.tobytes() == w.tobytes()
                   for u, v, w in zip(a1, a2, a3))
    same_p2 = all(u.tobytes() == v.tobytes() for u, v in zip(b1, b2))
    r = recall_at_k(a1[1], flat["l2"][1])
    log(f"[cq] ConsistentIndex: pin 1, {CQ_ADD} rows added, {removed} ids "
        f"deleted, pin 2 ({ci.n} rows); pin 1's results byte-identical "
        f"before and after: {same_pin}; pin 2's two searches "
        f"byte-identical: {same_p2}; a deleted id returned at pin 2: "
        f"{bool(np.isin(b1[1], gone).any())}; recall@10 at pin 1 vs "
        f"FlatIndex {r:.4f}; {STORE_NQ} queries in {search_s * 1e3:.1f} ms")
    if not (same_pin and same_p2) or np.isin(b1[1], gone).any() or \
            r < RECALL_BAR:
        fail("ConsistentIndex snapshots are not stable, or pin 2 returned a "
             "deleted id")
    del ci
    torch.cuda.empty_cache()
    log(f"[store] phase in {time.perf_counter() - t_phase:.1f} s on {smi}")


def _validate_ivf_checks(index, smi):
    """validate_index on the main path's 1M IVFFlatIndex (bf16 store), and
    a row count off by one that must turn the report invalid."""
    from neurondb_tpu_torch.index.validate import validate_index
    t0 = time.perf_counter()
    r = validate_index(index)
    secs = time.perf_counter() - t0
    checks = {c["check"]: c for c in r["checks"]}
    a = checks["assignment_consistency"]
    log(f"[validate] IVFFlatIndex ({index.n} rows, {index._vecs.dtype} "
        f"store) in {secs:.2f} s: valid {r['valid']}; assignment of 256 "
        f"sampled rows: {a['mismatches']} recomputed labels differ, "
        f"{a['within_bound']} of them within the bf16 rounding bound; "
        f"imbalance {checks['list_balance']['imbalance']:.2f}, empty lists "
        f"{checks['list_balance']['empty_lists']} on {smi}")
    if not r["valid"]:
        fail(f"validate_index reports the IVF index invalid: {r}")
    saved = index._counts
    counts = saved.clone()
    counts[0] -= 1
    index._counts = counts
    try:
        bad = validate_index(index)
    finally:
        index._counts = saved
    log(f"[validate] IVF with one list's count off by one: valid "
        f"{bad['valid']}")
    if bad["valid"]:
        fail("validate_index missed a row count off by one")


def _hnsw_validate_and_graph(index, smi):
    """validate_index on the 1M HNSWIndex (and a planted self loop), then
    its level-0 adjacency as a VectorGraph on the card: BFS from the entry
    (its reachable share equal to validate's), connected components,
    PageRank, community labels (held to the CPU on an induced subgraph)."""
    import torch
    from neurondb_tpu_torch.index.validate import validate_index
    from neurondb_tpu_torch.types import graph as VG
    t0 = time.perf_counter()
    r = validate_index(index)
    secs = time.perf_counter() - t0
    checks = {c["check"]: c for c in r["checks"]}
    frac = checks["connectivity_from_entry"]["reachable_fraction"]
    log(f"[validate] HNSWIndex ({index.n} rows) in {secs:.2f} s: valid "
        f"{r['valid']}; reachable fraction from the entry {frac}; mean "
        f"degree {checks['degree_bounds']['mean_degree']:.2f}")
    if not r["valid"]:
        fail(f"validate_index reports the HNSW graph invalid: {r}")
    row = index.n // 3
    saved = index._nbr0[row, 0].clone()
    index._nbr0[row, 0] = row
    try:
        bad = validate_index(index)
    finally:
        index._nbr0[row, 0] = saved
    loops = [c for c in bad["checks"] if c["check"] == "no_self_loops"][0]
    log(f"[validate] HNSW with a planted self loop: valid {bad['valid']}, "
        f"self loops {loops['count']}")
    if bad["valid"] or loops["count"] != 1:
        fail("validate_index missed a planted self loop")

    n = index.n
    nbr = index._nbr0[:n]
    g = VG.VectorGraph(nbr, (nbr >= 0).float())

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    level, bfs_s = timed(lambda: VG.bfs(g, index.entry))
    reach = int((level >= 0).sum())
    _hnsw_unreached_self_search(index, level, smi)
    global HNSW_LEVEL0
    HNSW_LEVEL0 = nbr.cpu().numpy()          # the ML phase's GCN graph
    (labels, passes), cc_s = timed(lambda: VG.connected_components_passes(g))
    pr, pr_s = timed(lambda: VG.pagerank(g, iters=GRAPH_PR_ITERS))
    total = float(pr.sum(dtype=torch.float64))
    cl, cl_s = timed(lambda: VG.community_labels(g, iters=GRAPH_CL_ITERS))
    sub = nbr[:GRAPH_SUB]
    sub = torch.where(sub < GRAPH_SUB, sub, -1)
    card = VG.community_labels(VG.VectorGraph(sub, (sub >= 0).float()),
                               iters=GRAPH_CL_ITERS).cpu()
    host_sub = sub.cpu()
    host = VG.community_labels(VG.VectorGraph(host_sub,
                                              (host_sub >= 0).float()),
                               iters=GRAPH_CL_ITERS)
    log(f"[graph] VectorGraph of the level-0 adjacency {tuple(nbr.shape)} on "
        f"{nbr.device}: bfs from the entry {bfs_s:.2f} s, depth "
        f"{int(level.max())}, reachable {reach} of {n} ({reach / n} vs "
        f"validate's {frac}); connected_components {passes} passes in "
        f"{cc_s:.2f} s, {int(torch.unique(labels).numel())} components; "
        f"pagerank {GRAPH_PR_ITERS} iterations in {pr_s:.2f} s, sum "
        f"{total:.7f}; community_labels {GRAPH_CL_ITERS} iterations in "
        f"{cl_s:.2f} s, {int(torch.unique(cl).numel())} labels; on the "
        f"{GRAPH_SUB}-node induced subgraph card == CPU: "
        f"{bool(torch.equal(card, host))} on {smi}")
    if reach / n != frac:
        fail(f"BFS reaches {reach / n} of the graph, validate_index {frac}")
    if abs(total - 1.0) > PR_SUM_TOL:
        fail(f"pagerank sums to {total}")
    if not torch.equal(card, host):
        fail("community_labels on the card differ from the CPU run")


def _ml_targets(x):
    """The ML table's targets from ML_LABEL_SEED: a regression target, a
    binary label (no label noise) and a 10-class label (Gaussian noise on
    the class scores), and the 10-class label's Bayes-optimal accuracy on
    this draw (the accuracy of the noiseless argmax)."""
    n, dim = x.shape
    rng = np.random.default_rng(ML_LABEL_SEED)
    w = rng.standard_normal(dim).astype(np.float32) / np.float32(np.sqrt(dim))
    W = rng.standard_normal((dim, 10)).astype(np.float32) / \
        np.float32(np.sqrt(dim))
    s = x @ w
    y_reg = (s + 0.1 * rng.standard_normal(n)).astype(np.float32)
    y_bin = (s > np.median(s)).astype(np.int32)
    scores = x @ W
    y_mc = np.argmax(scores + rng.standard_normal((n, 10)).astype(np.float32),
                     axis=1).astype(np.int32)
    bayes_mc = float((np.argmax(scores, axis=1) == y_mc).mean())
    return y_reg, y_bin, y_mc, bayes_mc


def _ml_cases(x, small, y_reg, y_bin, y_mc):
    """(label, algorithm, hyperparameters, X, y): every ported algorithm
    at its JAX defaults, apart from k-means (k 256), GMM (k 64) and PCA
    (32 components); the SVM's dual solver at its default sample_cap and
    its random-feature solver at a gamma scaled to the data."""
    gamma = float(1.0 / (x.shape[1] * x.var()))
    return [
        ("kmeans", "kmeans", {"k": 256}, x, None),
        ("minibatch_kmeans", "minibatch_kmeans", {"k": 256}, x, None),
        ("linear_regression", "linear_regression", {}, x, y_reg),
        ("ridge", "ridge", {}, x, y_reg),
        ("lasso", "lasso", {}, x, y_reg),
        ("elastic_net", "elastic_net", {}, x, y_reg),
        ("logistic binary", "logistic_regression", {}, x, y_bin),
        ("logistic 10-class", "logistic_regression", {}, x, y_mc),
        ("gmm", "gmm", {"k": 64}, x, None),
        ("pca", "pca", {"n_components": 32}, x, None),
        ("pca whiten", "pca", {"n_components": 32, "whiten": True}, x, None),
        ("naive_bayes", "naive_bayes", {}, x, y_mc),
        ("svm primal", "svm", {}, x, y_bin),
        ("svm dual", "svm", {"solver": "dual"}, x, y_bin),
        ("svm rff", "svm", {"solver": "rff", "gamma": gamma}, x, y_bin),
        ("knn_classifier", "knn_classifier", {}, x, y_mc),
        ("knn_regressor", "knn_regressor", {}, x, y_reg),
        ("anomaly_detection", "anomaly_detection", {}, x, None),
        ("dbscan", "dbscan", {}, small, None),
        ("dbscan eps 17", "dbscan", {"eps": 17.0}, small, None),
        ("hierarchical", "hierarchical", {}, small, None),
    ]


def _f64_inertia(x_dev, centroids):
    """Sum of squared distances to the nearest centroid, in float64 on the
    card."""
    import torch
    c = centroids.double()
    c_sq = (c * c).sum(1)
    total = 0.0
    for s in range(0, x_dev.shape[0], 1 << 17):
        xs = x_dev[s:s + (1 << 17)].double()
        d2 = (xs * xs).sum(1)[:, None] + c_sq[None, :] - 2.0 * (xs @ c.T)
        total += float(torch.clamp(d2, min=0.0).amin(1).sum())
    return total


def phase_ml(x, qb, smi):
    """The ML runtime through Client(device="cuda").train / predict /
    evaluate on config 1's corpus (DBSCAN and agglomerative clustering on
    its first 10,000 rows): every ported algorithm, each held to a
    reference computed apart from the code under test, each model
    persisted and reloaded, and a JAX-format model on the card."""
    import torch
    from neurondb_tpu_torch.client import Client
    from neurondb_tpu_torch.ml import api as ML
    from neurondb_tpu_torch.ml import registry as MR
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    n, dim = x.shape
    y_reg, y_bin, y_mc, bayes_mc = _ml_targets(x)
    small = np.ascontiguousarray(x[:ML_SMALL_ROWS])
    rng = np.random.default_rng(ML_LABEL_SEED + 1)
    rows = np.sort(rng.choice(n, ML_PREDICT_ROWS, replace=False))
    Xp = x[rows]
    client = Client(device="cuda")
    models = {}
    with tempfile.TemporaryDirectory() as root:
        running = MR.ModelRegistry(root, device="cuda")
        MR.set_registry(running)
        try:
            for label, algo, hp, X, y in _ml_cases(x, small, y_reg, y_bin,
                                                   y_mc):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mid = client.train("chip", algo, X, y, hp)
                train_s = time.perf_counter() - t0
                rec = MR.get_registry().get(mid)
                yp = None if y is None else y[rows]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred = client.predict(mid, Xp)
                pred_s = time.perf_counter() - t0
                ev = client.evaluate(mid, Xp, yp) \
                    if ML._resolve(algo).evaluate is not None else {}
                # a fresh registry reads the model back from its files
                MR.set_registry(MR.ModelRegistry(root, device="cuda"))
                same = np.array_equal(client.predict(mid, Xp), pred)
                MR.set_registry(running)
                shown = {k: round(v, 6) for k, v in rec.metrics.items()
                         if k != "train_seconds"}
                if algo in ("dbscan", "hierarchical"):
                    lab = rec.model["labels"]
                    shown["clusters"] = int(torch.unique(lab[lab >= 0]).numel())
                    shown["noise"] = int((lab < 0).sum())
                log(f"[ml] {label}: train {train_s:.2f} s ({X.shape[0]} x "
                    f"{X.shape[1]}), predict {len(Xp) / pred_s:.0f} rows/s "
                    f"({len(Xp)} rows), train-time metrics {shown}, "
                    f"evaluate on the predict rows "
                    f"{ {k: round(v, 6) for k, v in ev.items()} }; "
                    f"persisted and reloaded, predicts bit for bit: {same}")
                if not same:
                    fail(f"{label}: the reloaded model predicts otherwise")
                models[label] = (mid, rec.model, rec.metrics)
            _ml_checks(x, qb, models, y_reg, y_bin, y_mc, bayes_mc, client)
            rec_stats, ml2_top = phase_ml2(x, rows, client, root, y_reg,
                                           y_bin, y_mc, bayes_mc, smi)
            _ml_fixture(smi)          # these two set the fixtures' registry
            _ml2_fixture(smi)
        finally:
            MR.set_registry(None)
    # phase_ml2 resets the peak per section: the largest of its peaks
    peak = max(torch.cuda.max_memory_allocated(), ml2_top) - base_mem
    log(f"[ml] phase in {time.perf_counter() - t_phase:.1f} s (budget "
        f"{ML_PHASE_S} s for the first families, {ML2_PHASE_S} s for the "
        f"rest), peak device memory {peak / 2**30:.2f} GiB above the "
        f"{base_mem / 2**30:.2f} GiB held before, on {smi}")
    return rec_stats


def _ml_checks(x, qb, models, y_reg, y_bin, y_mc, bayes_mc, client):
    """Each model against a reference computed apart from the code under
    test: f64 normal equations and covariance on the host, f64 class
    moments, f64 inertia on the card, kNN votes and weights from
    FlatIndex's exact neighbours, accuracy bars from the labels' noise."""
    import torch
    import neurondb_tpu_torch as nt
    from neurondb_tpu_torch.ml import gmm as MG
    n, dim = x.shape
    # linear and ridge: the f64 normal equations (the JAX package's 1e-8
    # ridge and the unpenalized intercept)
    A = np.empty((n, dim + 1))
    A[:, :dim] = x
    A[:, dim] = 1.0
    G = A.T @ A
    b = A.T @ y_reg.astype(np.float64)
    eye = np.eye(dim + 1)
    reg = eye.copy()
    reg[-1, -1] = 0.0
    for label, R in (("linear_regression", 0.0), ("ridge", 1.0)):
        w64 = np.linalg.solve(G + R * reg + 1e-8 * eye, b)
        m = models[label][1]
        w = np.concatenate([m["coef"].cpu().numpy(),
                            [float(m["intercept"])]]).astype(np.float64)
        err = float(np.linalg.norm(w - w64) / np.linalg.norm(w64))
        log(f"[ml] {label}: coefficients vs the f64 normal equations, "
            f"relative error {err:.3e} (bar {LIN_RTOL:.0e})")
        if err > LIN_RTOL:
            fail(f"{label} coefficients off the f64 normal equations")
    # PCA: the f64 covariance's eigenvalues
    mu = G[:dim, dim] / n
    cov = (G[:dim, :dim] - n * np.outer(mu, mu)) / (n - 1)
    ev64 = np.linalg.eigh(cov)[0][::-1][:32]
    for label in ("pca", "pca whiten"):
        ev = models[label][1]["explained_variance"].cpu().numpy()
        err = float(np.max(np.abs(ev - ev64) / ev64))
        log(f"[ml] {label}: 32 eigenvalues {ev[0]:.4f} .. {ev[-1]:.4f} vs "
            f"f64 numpy.linalg.eigh, max relative error {err:.3e} (bar "
            f"{PCA_RTOL:.1e})")
        if err > PCA_RTOL:
            fail(f"{label} eigenvalues off the f64 covariance's")
    del A, G
    # naive Bayes: f64 class means and variances
    m = models["naive_bayes"][1]
    smooth = 1e-9 * float(x.var(axis=0, dtype=np.float64).max())
    means, var = m["means"].cpu().numpy(), m["variances"].cpu().numpy()
    err_m = err_v = 0.0
    for c in range(means.shape[0]):
        xc = x[y_mc == c].astype(np.float64)
        mu_c, var_c = xc.mean(0), xc.var(0)
        err_m = max(err_m, float(np.max(np.abs(means[c] - mu_c)
                                        / np.maximum(np.abs(mu_c), 1.0))))
        err_v = max(err_v, float(np.max(np.abs(var[c] - smooth - var_c)
                                        / var_c)))
    log(f"[ml] naive_bayes: class means vs f64, max error {err_m:.3e} "
        f"(relative, or absolute under 1); variances {err_v:.3e} relative "
        f"(bar {NB_RTOL:.0e})")
    if max(err_m, err_v) > NB_RTOL:
        fail("naive Bayes moments off the f64 class moments")
    # k-means: the f64 inertia of the returned centroids
    x_dev = torch.from_numpy(x).cuda()
    for label in ("kmeans", "minibatch_kmeans"):
        m = models[label][1]
        want = _f64_inertia(x_dev, m["centroids"])
        err = abs(float(m["inertia"]) - want) / want
        log(f"[ml] {label}: inertia {float(m['inertia']):.6g} vs the f64 "
            f"inertia of its centroids {want:.6g}, relative error "
            f"{err:.3e} (bar {INERTIA_RTOL:.0e})")
        if err > INERTIA_RTOL:
            fail(f"{label} inertia off the f64 inertia of its centroids")
    # GMM: a finite log-likelihood above its k-means++ start's
    m = models["gmm"][1]
    m0, v0, w0 = MG.gmm_init(x_dev, m["means"].shape[0])
    start = float(torch.logsumexp(MG._log_prob(x_dev, m0, v0, w0), 1).sum())
    ll = float(m["log_likelihood"])
    log(f"[ml] gmm: log-likelihood {ll:.6g} after EM, {start:.6g} at its "
        f"k-means++ start")
    if not np.isfinite(ll) or ll <= start:
        fail("GMM log-likelihood not finite or not above its start")
    del x_dev
    torch.cuda.empty_cache()
    # kNN: votes and inverse-distance weights from FlatIndex's neighbours
    q = qb[:ML_KNN_CHECK]
    flat = nt.FlatIndex(x, metric="l2", device="cuda")
    fd, fi = flat.search(q, k=6)
    del flat
    torch.cuda.empty_cache()
    tie = np.abs(fd[:, 4] - fd[:, 5]) <= SH_FLAT_TIE_RTOL * fd[:, 5]
    votes = np.stack([np.bincount(r, minlength=10) for r in y_mc[fi[:, :5]]])
    want_cls = votes.argmax(1)
    wgt = 1.0 / np.maximum(fd[:, :5].astype(np.float64), 1e-6)
    want_reg = (y_reg[fi[:, :5]] * wgt).sum(1) / wgt.sum(1)
    got_cls = client.predict(models["knn_classifier"][0], q)
    got_reg = client.predict(models["knn_regressor"][0], q)
    bad_cls = (got_cls != want_cls) & ~tie
    rel = np.abs(got_reg - want_reg) / np.maximum(np.abs(want_reg), 1e-3)
    bad_reg = (rel > KNN_RTOL) & ~tie
    log(f"[ml] knn on {ML_KNN_CHECK} rows vs FlatIndex's exact neighbours: "
        f"classifier {int((got_cls != want_cls).sum())} differ, "
        f"{int(bad_cls.sum())} away from a 5th/6th distance tie; regressor "
        f"max relative error {float(rel[~tie].max()):.3e} (bar "
        f"{KNN_RTOL:.0e}); {int(tie.sum())} rows at a tie")
    if bad_cls.any() or bad_reg.any():
        fail("kNN predictions differ from FlatIndex's neighbours")
    # accuracy bars: Bayes-optimal accuracy of the labels' noise, less a
    # margin (the binary label is noiseless: Bayes-optimal 1.0); the
    # accuracy is counted here from client.predict and the seeded labels,
    # and the port's own train-time metric must agree with it
    for label, y, bayes in (("logistic binary", y_bin, 1.0),
                            ("logistic 10-class", y_mc, bayes_mc),
                            ("svm primal", y_bin, 1.0),
                            ("svm dual", y_bin, 1.0),
                            ("svm rff", y_bin, 1.0)):
        mid, _, metrics = models[label]
        acc = float(np.mean(client.predict(mid, x) == y))
        own = metrics["accuracy"]
        bar = bayes - ACC_MARGIN[label]
        log(f"[ml] {label}: accuracy {acc:.4f} on the {n}-row table from "
            f"client.predict and the labels (the port's own train-time "
            f"metric {own:.4f}), Bayes-optimal {bayes:.4f}, bar {bar:.4f} "
            f"(margin {ACC_MARGIN[label]})")
        if acc < bar:
            fail(f"{label} accuracy {acc} under its bar {bar}")
        if abs(own - acc) > ACC_AGREE:
            fail(f"{label}: the port's accuracy metric {own} is not the "
                 f"accuracy of its predictions {acc}")


def _ml_fixture(smi):
    """Two models the JAX registry persisted on the CPU
    (tests/data/jax_registry: an RBF dual SVM and a whitened PCA) load on
    the card and predict as the JAX package did on the CPU."""
    from neurondb_tpu_torch.ml import api as ML
    from neurondb_tpu_torch.ml import neighbors as MN
    from neurondb_tpu_torch.ml import registry as MR
    import torch
    root = os.path.join(ROOT, "tests", "data", "jax_registry")
    reg = MR.ModelRegistry(root, device="cuda")
    MR.set_registry(reg)
    with np.load(os.path.join(root, "expected.npz")) as e:
        X, want_svm, want_pca = e["X"], e["svm"], e["pca"]
    svm = ML.predict(1, X, device="cuda")
    pca = ML.predict(2, X, device="cuda")
    dec = MN.svm_kernel_decision(reg.get(1).model,
                                 torch.from_numpy(X).cuda())
    top2 = torch.topk(dec, 2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    off = (svm != want_svm) & (gap > FIXTURE_TIE)
    err = float(np.max(np.abs(pca - want_pca)))
    log(f"[ml] JAX-format models (tests/data/jax_registry) on the card: svm "
        f"{int((svm != want_svm).sum())} of {len(X)} labels differ from the "
        f"JAX CPU run ({int(off.sum())} away from a decision tie under "
        f"{FIXTURE_TIE}), whitened pca max |diff| {err:.3e} (bar "
        f"{FIXTURE_TOL}) on {smi}")
    if off.any() or err > FIXTURE_TOL:
        fail("a JAX-format model predicts otherwise on the card")


def _hnsw_unreached_self_search(index, level, smi):
    """Each node the BFS from the entry does not reach, searched with its
    own vector: does it return itself first?"""
    rows = np.flatnonzero((level < 0).cpu().numpy())
    if not len(rows):
        log(f"[hnsw] every node has a level-0 path from the entry")
        return
    q = index._vecs[rows].float().cpu().numpy()
    _, ids = index.search(q, k=1)
    own = index._ids_np[rows]
    hit = ids[:, 0] == own
    log(f"[hnsw] {len(rows)} nodes without a level-0 path from the entry "
        f"(rows {rows[:12].tolist()}); searched with their own vectors, "
        f"{int(hit.sum())} of {len(rows)} return themselves first "
        f"(default ef) on {smi}")


# ---- ML families ported last: trees, boosting, time series, ALS, MLP,
# Q-learning, GCN, LDA, drift, automl, mlops ----

def _f64_hist(Xb, cols):
    """[F, 64, C] f64 sums of cols [N, C] per (feature, bin) on the card,
    16 features an index_add_."""
    import torch
    N, F = Xb.shape
    C = cols.shape[1]
    out = torch.zeros((F * 64, C), dtype=torch.float64, device=Xb.device)
    for f0 in range(0, F, 16):
        f1 = min(F, f0 + 16)
        idx = Xb[:, f0:f1].long() + torch.arange(
            f0, f1, device=Xb.device)[None, :] * 64
        out.index_add_(0, idx.reshape(-1),
                       cols[:, None, :].expand(N, f1 - f0, C).reshape(-1, C))
    return out.view(F, 64, C)


def _var_gains64(Xb, w, Y, min_leaf):
    """grow_tree's root gains in f64: weighted variance reduction."""
    import torch
    h = _f64_hist(Xb, torch.cat([w[:, None], Y * w[:, None]], 1).double())
    c = torch.cumsum(h, 1)
    cnt, s = c[..., 0], c[..., 1:]
    tc, ts = cnt[:, -1:], s[:, -1:, :]
    gain = ((s * s).sum(-1) / cnt.clamp(min=1e-9)
            + ((ts - s) ** 2).sum(-1) / (tc - cnt).clamp(min=1e-9)
            - (ts * ts).sum(-1) / tc.clamp(min=1e-9))
    ok = (cnt >= min_leaf) & (tc - cnt >= min_leaf)
    return torch.where(ok, gain, -torch.inf)


def _gh_gains64(Xb, g, h, l2, mcw=1.0):
    """The XGBoost gain (gamma 0) of every root split in f64."""
    import torch
    c = torch.cumsum(_f64_hist(Xb, torch.stack([g, h], 1).double()), 1)
    G, H = c[..., 0], c[..., 1]
    tG, tH = G[:, -1:], H[:, -1:]
    gain = 0.5 * (G * G / (H + l2) + (tG - G) ** 2 / (tH - H + l2)
                  - tG * tG / (tH + l2))
    ok = (H >= mcw) & (tH - H >= mcw)
    return torch.where(ok, gain, -torch.inf)


def _root_gap(gains64, f, b, floor):
    """(best f64 gain - the chosen split's f64 gain) / |best|; a root left
    unsplit must have no f64 gain above the grower's floor."""
    best = float(gains64.max())
    if f < 0:
        return 0.0 if best <= floor * (1 + TREE_GAIN_RTOL) else float("inf")
    return (best - float(gains64[f, b])) / max(abs(best), 1e-30)


def _tree_root_checks(family, model, Xb, y):
    """The largest relative gap between each tree's chosen root split and
    the best split of an f64 histogram of the same rows and targets (for
    the boosting families, the gradients the fit had at that round)."""
    import torch
    import torch.nn.functional as F_
    from neurondb_tpu_torch.ml import boosting as BO
    from neurondb_tpu_torch.ml import trees as TR
    N = Xb.shape[0]
    trees = model["trees"]
    worst = 0.0
    if family in ("decision_tree", "random_forest", "gradient_boosting"):
        C = trees["leaf"].shape[-1]
        Y = F_.one_hot(y.long(), C).float() if family != "gradient_boosting" \
            else y.float()[:, None]
        ones = torch.ones(N, device=Xb.device)
        if family == "decision_tree":
            return _root_gap(_var_gains64(Xb, ones, Y, 1),
                             int(trees["feat"][0, 0]),
                             int(trees["tbin"][0, 0]), 1e-7)
        if family == "random_forest":
            gen = torch.Generator(device=Xb.device)
            gen.manual_seed(0)
            for t in range(trees["feat"].shape[0]):
                w = torch.poisson(torch.ones((N,), device=Xb.device),
                                  generator=gen)
                fm = torch.rand((Xb.shape[1],), generator=gen,
                                device=Xb.device) < 0.7
                g64 = _var_gains64(torch.where(fm[None, :], Xb, 0), w, Y, 1)
                worst = max(worst, _root_gap(g64, int(trees["feat"][t, 0]),
                                             int(trees["tbin"][t, 0]), 1e-7))
            return worst
        pred = model["base"][None, :].expand(N, 1).clone()
        lr = float(model["learning_rate"])
        for t in range(trees["feat"].shape[0]):
            tree = {k: v[t] for k, v in trees.items()}
            g64 = _var_gains64(Xb, ones, Y - pred, 5)
            worst = max(worst, _root_gap(g64, int(tree["feat"][0]),
                                         int(tree["tbin"][0]), 1e-7))
            pred = pred + lr * TR.tree_predict(tree, Xb, depth=4)
        return worst
    C = int(model["C"])
    Y = F_.one_hot(y.long(), C).float()
    pred = torch.zeros((N, C), device=Xb.device)
    lr = float(model["lr"])
    if family == "catboost":
        perm = np.random.default_rng(0).permutation(N)
        pos = np.empty(N, np.int64)
        pos[perm] = np.arange(N)
        pos = torch.from_numpy(pos).to(Xb.device)
    for t in range(trees["leaf"].shape[0]):
        g, h = BO._grad_hess(pred, Y, "classify")
        for c in range(C):
            tree = {k: v[t, c] for k, v in trees.items()}
            gc, hc = g[:, c].contiguous(), h[:, c].contiguous()
            if family == "catboost":
                g64 = _gh_gains64(Xb, gc, hc, 3.0)
                worst = max(worst, _root_gap(g64, int(tree["feats"][0]),
                                             int(tree["bins"][0]), 0.0))
                member = BO._oblivious_leaf_index(Xb, tree["feats"],
                                                  tree["bins"])
                pred[:, c] += lr * BO.ordered_leaf_values(gc, hc, member, pos,
                                                          l2=3.0)
                continue
            g64 = _gh_gains64(Xb, gc, hc, 1.0)
            worst = max(worst, _root_gap(g64, int(tree["feat"][0]),
                                         int(tree["tbin"][0]), 0.0))
            upd = BO._xgb_tree_predict(tree, Xb, depth=6) \
                if family == "xgboost" else \
                BO._leafwise_predict(tree, Xb, max_steps=31)
            pred[:, c] += lr * upd
    return worst


def _np_bins(X, edges):
    return np.stack([np.searchsorted(edges[f], X[:, f], side="left")
                     for f in range(X.shape[1])], 1)


def _np_tree_predict(model, X):
    """Predictions from the persisted arrays by a host numpy traversal
    (f32 sums in the port's order)."""
    Xb = _np_bins(X, model["edges"])
    rows = np.arange(len(X))
    if "algo" not in model:                      # trees.py ensembles
        tr = model["trees"]
        depth = int(model["depth"])
        acc = np.zeros((len(X), tr["leaf"].shape[-1]), np.float32)
        for t in range(tr["feat"].shape[0]):
            node = np.zeros(len(X), np.int64)
            for _ in range(depth):
                f, b = tr["feat"][t][node], tr["tbin"][t][node]
                right = Xb[rows, np.maximum(f, 0)] > b
                node = np.where(f >= 0, 2 * node + 1 + right, node)
            acc = acc + tr["leaf"][t][node]
        if int(model["kind"]) == 1:
            raw = model["base"][None, :] + np.float32(
                model["learning_rate"]) * acc
        else:
            raw = acc / np.float32(tr["feat"].shape[0])
        if bool(model["task_classify"]):
            return raw.argmax(1).astype(np.int32)
        return raw[:, 0]
    tr = model["trees"]
    algo = str(model["algo"])
    lr = np.float32(model["lr"])
    if algo == "catboost":
        T, C = tr["feats"].shape[:2]
        out = np.zeros((len(X), C), np.float32)
        for t in range(T):
            for c in range(C):
                member = np.zeros(len(X), np.int64)
                for lvl in range(tr["feats"].shape[2]):
                    member = member * 2 + (Xb[:, tr["feats"][t, c, lvl]]
                                           > tr["bins"][t, c, lvl])
                out[:, c] = out[:, c] + lr * tr["leaf"][t, c][member]
        return out.argmax(1).astype(np.int32)
    T, C = tr["leaf"].shape[:2]
    acc = np.zeros((C, len(X)), np.float32)
    steps = int(model["depth"]) if algo == "xgboost" else \
        int(model["num_leaves"])
    for t in range(T):
        per = []
        for c in range(C):
            node = np.zeros(len(X), np.int64)
            for _ in range(steps):
                f, b = tr["feat"][t, c][node], tr["tbin"][t, c][node]
                right = Xb[rows, np.maximum(f, 0)] > b
                if algo == "xgboost":
                    child = 2 * node + 1 + right
                else:
                    child = np.where(right, tr["right"][t, c][node],
                                     tr["left"][t, c][node])
                node = np.where(f >= 0, child, node)
            per.append(tr["leaf"][t, c][node])
        acc = acc + np.stack(per)
    return (lr * acc.T).argmax(1).astype(np.int32)


def _first_tree_plain_vs_card(family, x, y):
    """The family's first tree on the first TREE_PLAIN_ROWS rows by the
    plain CPU path and on the card: every array equal (the random forest
    from the same draws; the boosting families' first class's tree from
    the first round's gradients)."""
    import torch
    from neurondb_tpu_torch.ml import boosting as BO
    from neurondb_tpu_torch.ml import trees as TR
    n = TREE_PLAIN_ROWS
    draws = {}
    if family == "random_forest":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        draws["w"] = torch.poisson(torch.ones((n,), device="cuda"),
                                   generator=gen)[None]
        draws["fm"] = (torch.rand((x.shape[1],), generator=gen,
                                  device="cuda") < 0.7)[None]

    def grow(dev):
        X = torch.from_numpy(x[:n]).to(dev)
        Yl = torch.from_numpy(y[:n]).to(dev)
        if family == "decision_tree":
            return TR.decision_tree_fit(X, Yl)["trees"]
        if family == "gradient_boosting":
            return TR.gradient_boosting_fit(X, Yl, task="regress",
                                            n_trees=1)["trees"]
        if family == "random_forest":
            Xb, Y, _, _ = TR._prep(X, Yl, "classify", None)
            return TR.forest_from_draws(Xb, Y, draws["w"].to(dev),
                                        draws["fm"].to(dev), depth=6,
                                        min_leaf=1)
        Xb, Y, _, _ = BO._task_prep(X, Yl, "classify", None)
        g, h = BO._grad_hess(torch.zeros_like(Y), Y, "classify")
        g, h = g[:, 0].contiguous(), h[:, 0].contiguous()
        if family == "xgboost":
            return BO._grow_xgb_tree(
                Xb, g, h, torch.ones(Xb.shape[1], dtype=torch.bool,
                                     device=dev), depth=6, n_bins=64,
                l2=1.0, gamma=0.0, min_child_weight=1.0)
        if family == "lightgbm":
            return BO._grow_leafwise_tree(Xb, g, h, num_leaves=31, n_bins=64,
                                          l2=1.0, gamma=0.0,
                                          min_child_weight=1.0)
        feats, bins_, member = BO._grow_oblivious_tree(
            Xb, g, h, depth=6, n_bins=64, l2=3.0, min_child_weight=1.0)
        return {"feats": feats, "bins": bins_, "member": member}

    t0 = time.perf_counter()
    card, cpu = grow("cuda"), grow("cpu")
    secs = time.perf_counter() - t0
    same = {k: bool(torch.equal(card[k].cpu(), cpu[k])) for k in cpu}
    return same, secs


def _note_peak():
    """Keep the allocation peak before the peak statistics are reset."""
    import torch
    ML2_PEAK[0] = max(ML2_PEAK[0], torch.cuda.max_memory_allocated())


def _ml_trees(x, rows, client, reg_root, y_reg, y_bin, y_mc, smi):
    """The six tree families on config 1's corpus (LightGBM cut, see
    TREE_ROWS): train, predict, persist and reload, the host traversal of
    the persisted arrays, the f64 root gains, the first tree plain vs card."""
    import torch
    from neurondb_tpu_torch.ml import api as ML
    from neurondb_tpu_torch.ml import registry as MR
    from neurondb_tpu_torch.ml import trees as TR
    ML._ensure_loaded()
    targets = {"decision_tree": y_mc, "random_forest": y_bin,
               "gradient_boosting": y_reg, "xgboost": y_bin,
               "lightgbm": y_bin, "catboost": y_bin}
    Xp = x[rows]
    for family, y in targets.items():
        n = TREE_ROWS[family]
        X = x[:n]
        torch.cuda.synchronize()
        _note_peak()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        t = ML._ALGORITHMS[family]
        Xpd = torch.from_numpy(Xp).cuda()
        if family in ("xgboost", "lightgbm", "catboost"):
            # the API aliases these names to gradient_boosting (as the JAX
            # package does): the registered trainer, then the registry
            model = t.train(torch.from_numpy(X).cuda(),
                            torch.from_numpy(y[:n]).cuda())
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            mid = MR.get_registry().register("chip", family, model, {},
                                             {"train_seconds": train_s})
            ev = t.evaluate(model, Xpd, torch.from_numpy(y[rows]).cuda())
        else:
            hp = {"task": "regress"} if family == "gradient_boosting" else {}
            mid = client.train("chip", family, X, y[:n], hp)
            train_s = time.perf_counter() - t0
            model = MR.get_registry().get(mid).model
            ev = client.evaluate(mid, Xp, y[rows])
        peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = t.predict(model, Xpd).cpu().numpy()
        pred_s = time.perf_counter() - t0
        # a fresh registry reads the model back from its files
        fresh = MR.ModelRegistry(reg_root, device="cuda").get(mid).model
        reloaded = t.predict(fresh, Xpd).cpu().numpy()
        fresh_np = MR.tree_to(fresh, torch.device("cpu"))
        fresh_np = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                        if isinstance(v, dict) else
                        (v.numpy() if isinstance(v, torch.Tensor) else v))
                    for k, v in fresh_np.items()}
        host = _np_tree_predict(fresh_np, Xp)
        same_reload = np.array_equal(reloaded, pred)
        same_host = np.array_equal(host, pred)
        ML2_OWN_S[family] = train_s + pred_s
        Xb = TR.bin_features(torch.from_numpy(X).cuda(), model["edges"])
        gap = _tree_root_checks(family, model, Xb,
                                torch.from_numpy(y[:n]).cuda())
        del Xb
        plain, plain_s = _first_tree_plain_vs_card(family, x, y)
        torch.cuda.empty_cache()
        log(f"[ml2] {family}: train {train_s:.2f} s ({n} x {x.shape[1]}), "
            f"peak {peak / 2**30:.2f} GiB, predict {len(Xp) / pred_s:.0f} "
            f"rows/s, evaluate {ev}; persisted and reloaded predicts bit "
            f"for bit: {same_reload}; host numpy traversal of the persisted "
            f"arrays == predict: {same_host}; largest root gap to the best "
            f"f64 split {gap:.3e} (bar {TREE_GAIN_RTOL:.0e}); first tree on "
            f"{TREE_PLAIN_ROWS} rows, plain CPU path vs card equal: {plain} "
            f"({plain_s:.1f} s) on {smi}")
        if not (same_reload and same_host):
            fail(f"{family}: the reloaded model or the host traversal "
                 "predicts otherwise")
        if not gap <= TREE_GAIN_RTOL:
            fail(f"{family}: a root split {gap} below the best f64 gain")
        if family != "gradient_boosting" and not all(plain.values()):
            fail(f"{family}: the first tree differs between the CPU and "
                 f"the card: {plain}")
    return {}


def _ts_series():
    """TS_POINTS minute readings: trend + season TS_SEASON + AR(2) noise."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(ML_LABEL_SEED + 2)
    t = np.arange(TS_POINTS)
    e = lfilter([1.0], [1.0, -0.5, 0.2], rng.standard_normal(TS_POINTS))
    return (10.0 + 2e-6 * t + 2.0 * np.sin(2 * np.pi * t / TS_SEASON)
            + e).astype(np.float32)


def _ls64(X, t, l2):
    return np.linalg.solve(X.T @ X + l2 * np.eye(X.shape[1]), X.T @ t)


def _arima64(y, p, d, q, l2=1e-6):
    """Hannan-Rissanen in f64 numpy (the JAX package's algorithm)."""
    z = np.diff(y.astype(np.float64), n=d)
    n = len(z)
    m = max(p + q, min(n // 4, 2 * (p + q) + 4), 1)
    zc = z - z.mean()
    Xl = np.lib.stride_tricks.sliding_window_view(zc, m)[:n - m]
    wl = _ls64(Xl, zc[m:], l2)
    e = np.concatenate([np.zeros(m), zc[m:] - Xl @ wl])
    lag = max(p, q)
    rows = n - lag
    cols = [zc[lag - i: lag - i + rows] for i in range(1, p + 1)]
    cols += [e[lag - j: lag - j + rows] for j in range(1, q + 1)]
    w = _ls64(np.stack(cols, 1), zc[lag:], l2)
    return w[:p], w[p:]


def _hw64(y, season, a=0.3, b=0.1, g=0.1):
    """The Holt-Winters recurrence in f64 (Python floats)."""
    y = y.astype(np.float64)
    level = float(y[:season].mean())
    trend = (float(y[season:2 * season].mean()) - level) / season
    seas = list(y[:season] - level)
    fitted = np.empty(len(y))
    yl = y.tolist()
    for i, yt in enumerate(yl):
        k = i % season
        s0 = seas[k]
        fitted[i] = level + trend + s0
        nl = a * (yt - s0) + (1 - a) * (level + trend)
        trend = b * (nl - level) + (1 - b) * trend
        seas[k] = g * (yt - nl) + (1 - g) * s0
        level = nl
    return fitted


def _ml_timeseries(client, smi):
    """AR(4), Holt-Winters (season 12) and ARIMA(1,1,1) on a 1,051,200-point
    series through the client; the recurrence kernel against its plain
    loop. Returns the kernel row's numbers for holt_winters."""
    import torch
    from neurondb_tpu_torch.ml import registry as MR
    from neurondb_tpu_torch.ops.kernels import ml_recurrence as MREC
    y = _ts_series()
    out = {}
    for label, hp in (("AR(4)", {"order": 4}),
                      ("Holt-Winters", {"method": "holt_winters",
                                        "season": TS_SEASON}),
                      ("ARIMA(1,1,1)", {"method": "arima"})):
        MREC.LAUNCHES = dict.fromkeys(MREC.LAUNCHES, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mid = client.train("chip", "timeseries", y, hyperparams=hp)
        secs = time.perf_counter() - t0
        launches = dict(MREC.LAUNCHES)
        m = MR.get_registry().get(mid).model
        t0 = time.perf_counter()
        fc = client.predict(mid, np.array([8]))
        ML2_OWN_S[f"timeseries {label}"] = secs + time.perf_counter() - t0
        if label == "AR(4)":
            yc = y.astype(np.float64) - y.astype(np.float64).mean()
            X = np.lib.stride_tricks.sliding_window_view(yc, 4)[:-1]
            w64 = _ls64(X, yc[4:], 1e-6)
            err = float(np.linalg.norm(m["coef"].cpu().numpy() - w64)
                        / np.linalg.norm(w64))
            bar = TS_AR_RTOL
        elif label == "ARIMA(1,1,1)":
            phi, theta = _arima64(y, 1, 1, 1)
            w64 = np.concatenate([phi, theta])
            w = np.concatenate([m["ar_coeffs"].cpu().numpy(),
                                m["ma_coeffs"].cpu().numpy()])
            err = float(np.max(np.abs(w - w64) / np.abs(w64)))
            bar = TS_AR_RTOL
        else:
            out["launches"] = launches["holt_winters"]
            t1 = time.perf_counter()
            f64 = _hw64(y, TS_SEASON)
            ref_s = time.perf_counter() - t1
            err = float(np.max(np.abs(m["fitted"].cpu().numpy() - f64))
                        / np.max(np.abs(y)))
            bar = HW_RTOL
        log(f"[ml2] timeseries {label}: train {secs:.2f} s ({TS_POINTS} "
            f"points), recurrence launches {launches}, forecast {fc[:3]}..., "
            f"vs the f64 reference: relative error {err:.3e} (bar {bar:.0e})")
        if not np.isfinite(fc).all() or not err <= bar:
            fail(f"timeseries {label} off its f64 reference")
        if label == "Holt-Winters" and launches["holt_winters"] != 1:
            fail("Holt-Winters did not run the recurrence kernel once")
    # the kernel against the plain loop on the first HW_CHECK_STEPS steps
    yd = torch.from_numpy(y[:HW_CHECK_STEPS]).cuda()
    l0 = yd[:TS_SEASON].mean()
    t0_ = (yd[TS_SEASON:2 * TS_SEASON].mean() - l0) / TS_SEASON
    s0 = yd[:TS_SEASON] - l0
    kw = dict(alpha=0.3, beta=0.1, gamma=0.1)
    card = MREC.holt_winters(yd, l0, t0_, s0, **kw)
    t1 = time.perf_counter()
    plain = MREC.holt_winters_plain(yd.cpu(), l0.cpu(), t0_.cpu(), s0.cpu(),
                                    **kw)
    plain_ms = (time.perf_counter() - t1) * 1e3
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card, plain))
    err = float((card[3].cpu() - plain[3]).abs().max())
    ms = _cuda_ms(lambda: MREC.holt_winters(yd, l0, t0_, s0, **kw), 5)
    yfull = torch.from_numpy(y).cuda()
    full_ms = _cuda_ms(lambda: MREC.holt_winters(
        yfull, l0, t0_, s0, **kw), 2)
    n = HW_CHECK_STEPS
    bound, by = _bound(8 * n + 8 * TS_SEASON, 10 * n, "f32")
    log(f"[ml2] holt_winters kernel vs plain loop on {n} steps: equal bit "
        f"for bit {same}; kernel {ms:.3f} ms, plain loop on the CPU "
        f"{plain_ms:.1f} ms, bound {bound:.5f} ms ({by}); dependent-step "
        f"latency bound {n * SMEM_ROUND_TRIP_NS * 1e-6:.3f} ms; the whole "
        f"{TS_POINTS}-point series {full_ms:.2f} ms on {smi}")
    if not same:
        fail("the Holt-Winters kernel differs from its plain loop")
    out.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, library_ms=None, shape=f"{n} steps")
    return out


def _ml1m_ratings():
    """MovieLens-1M's geometry from a seed: a rank-16 model plus noise,
    rounded and clipped to 1-5, every user with >= 20 ratings."""
    c = ML1M
    rng = np.random.default_rng(ML_LABEL_SEED + 3)
    U, I = c["users"], c["items"]
    extra = c["ratings"] - c["min_per_user"] * U
    wu = rng.lognormal(0.0, 0.9, U)
    per = c["min_per_user"] + rng.multinomial(extra, wu / wu.sum())
    while (per > I).any():                   # no user rates an item twice
        spill = int((per - I).clip(min=0).sum())
        per = np.minimum(per, I)
        room = per < I
        per[room] += rng.multinomial(spill, np.full(room.sum(),
                                                    1.0 / room.sum()))
    logpop = np.log(rng.pareto(1.0, I) + 1.0)
    users = np.repeat(np.arange(U), per)
    # each user's items: popularity-weighted, without replacement (the
    # Gumbel top-k draw)
    items = np.concatenate([np.argpartition(
        -(logpop + rng.gumbel(size=I)), k - 1)[:k] for k in per])
    P = rng.standard_normal((U, c["rank"])) / c["rank"] ** 0.25
    Q = rng.standard_normal((I, c["rank"])) / c["rank"] ** 0.25
    r = 3.6 + (P[users] * Q[items]).sum(1) + 0.5 * rng.standard_normal(
        len(users))
    r = np.clip(np.round(r), 1, 5)
    return np.stack([users, items, r], 1).astype(np.float32)


def _ml_recommender(client, smi):
    import torch
    from neurondb_tpu_torch.ml import registry as MR
    trip = _ml1m_ratings()
    rng = np.random.default_rng(ML_LABEL_SEED + 4)
    test = rng.uniform(size=len(trip)) < ALS_HOLDOUT
    # the training triples must name the last user and item
    test[np.argmax(trip[:, 0])] = test[np.argmax(trip[:, 1])] = False
    train = trip[~test]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mid = client.train("chip", "recommender", train,
                       hyperparams={"factors": 16, "iters": 10})
    secs = time.perf_counter() - t0
    m = MR.get_registry().get(mid).model
    t0 = time.perf_counter()
    pred = client.predict(mid, trip[test, :2])
    pred_rate = int(test.sum()) / (time.perf_counter() - t0)
    ML2_OWN_S["recommender"] = secs + int(test.sum()) / pred_rate
    rmse = float(np.sqrt(np.mean((pred - trip[test, 2]) ** 2)))
    # the last half-step: each item row against its f64 normal equations
    P = m["user_factors"].double().cpu().numpy()
    Q = m["item_factors"].cpu().numpy()
    import scipy.sparse as sp
    U, I = P.shape[0], Q.shape[0]
    u, i = train[:, 0].astype(int), train[:, 1].astype(int)
    f = P.shape[1]
    Mi = sp.csr_matrix((np.ones(len(u)), (i, u)), shape=(I, U))
    Ri = sp.csr_matrix((train[:, 2].astype(np.float64), (i, u)),
                       shape=(I, U))
    A = (Mi @ (P[:, :, None] * P[:, None, :]).reshape(U, f * f)).reshape(
        I, f, f) + 0.1 * np.eye(f)
    b = Ri @ P
    Q64 = np.linalg.solve(A, b[:, :, None])[:, :, 0]
    # how well each port row solves its f64 system: the residual relative
    # to the right-hand side (and, printed, the distance to the f64 solve)
    res = np.linalg.norm((A @ Q.astype(np.float64)[:, :, None])[:, :, 0] - b,
                         axis=1) / np.maximum(np.linalg.norm(b, axis=1), 1e-12)
    fwd = np.linalg.norm(Q - Q64, axis=1) / np.maximum(
        np.linalg.norm(Q64, axis=1), 1e-12)
    log(f"[ml2] recommender (ML-1M geometry: {U} users x {I} items, "
        f"{len(trip)} ratings, {int(test.sum())} held out): ALS 16 factors "
        f"10 iterations in {secs:.2f} s; predict {pred_rate:.0f} rows/s; "
        f"held-out RMSE {rmse:.4f}; last "
        f"half-step rows in their f64 normal equations: max residual "
        f"{res.max():.3e} of |b| (bar {ALS_RTOL:.0e}), max distance to the "
        f"f64 solve {fwd.max():.3e} of its norm on {smi}")
    if not res.max() <= ALS_RTOL or not np.isfinite(rmse):
        fail("ALS item factors off their f64 normal equations")


def _adam64(params, Xn, y, steps, lr=1e-3, l2=1e-5):
    """optax's Adam on the MLP's loss in f64 (autograd on the card)."""
    import torch
    p = [t.detach().double().clone().requires_grad_(True) for t in params]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    nW = len(p) // 2
    for step in range(1, steps + 1):
        h = Xn
        for k in range(nW):
            h = h @ p[k] + p[nW + k]
            if k < nW - 1:
                h = torch.relu(h)
        nll = -torch.log_softmax(h, 1).gather(1, y[:, None]).mean()
        loss = nll + l2 * sum((W * W).sum() for W in p[:nW])
        grads = torch.autograd.grad(loss, p)
        with torch.no_grad():
            for k, g in enumerate(grads):
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                mh = m[k] / (1 - 0.9 ** step)
                vh = v[k] / (1 - 0.999 ** step)
                p[k] -= lr * mh / (torch.sqrt(vh) + 1e-8)
    return [t.detach() for t in p]


def _ml_mlp(x, client, y_mc, bayes_mc, smi):
    import torch
    from neurondb_tpu_torch.ml import neural as NN
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mid = client.train("chip", "neural_network", x, y_mc)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc = float(np.mean(client.predict(mid, x) == y_mc))
    pred_rate = x.shape[0] / (time.perf_counter() - t0)
    ML2_OWN_S["neural_network"] = secs + x.shape[0] / pred_rate
    # the first MLP_CHECK_STEPS Adam steps from the fit's own init, in f32
    # (the port) and in f64 (optax's update written out)
    xd = torch.from_numpy(x).cuda()
    yd = torch.from_numpy(y_mc).cuda().long()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    init = NN._init_mlp(gen, [x.shape[1], 64, 32, 10], "cuda")
    mu, sd = xd.mean(0), torch.clamp(xd.std(0, correction=0), min=1e-6)
    got = NN.mlp_train(init, (xd - mu) / sd, yd, epochs=MLP_CHECK_STEPS)
    x64 = xd.double()
    sd64 = torch.clamp(x64.std(0, correction=0), min=1e-6)
    ref = _adam64(init["W"] + init["b"], (x64 - x64.mean(0)) / sd64, yd,
                  MLP_CHECK_STEPS)
    rel = max(float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
              for a, b in zip(got["W"] + got["b"], ref))
    del xd, x64, ref
    torch.cuda.empty_cache()
    log(f"[ml2] neural_network (64, 32), 200 full-batch epochs on "
        f"{x.shape[0]} x {x.shape[1]}: train {secs:.2f} s, predict "
        f"{pred_rate:.0f} rows/s, accuracy {acc:.4f} "
        f"(Bayes-optimal {bayes_mc:.4f}); {MLP_CHECK_STEPS} Adam steps vs "
        f"f64, max relative error {rel:.3e} (bar {MLP_RTOL:.0e}) on {smi}")
    if not rel <= MLP_RTOL:
        fail("MLP Adam steps off the f64 recomputation")
    if acc < 0.5 * bayes_mc:
        fail(f"MLP accuracy {acc} far under the Bayes-optimal {bayes_mc}")


def _gridworld():
    """Q_TRANSITIONS logged moves of a uniform policy on a Q_SIDE^2 grid;
    reward 1 on entering the far corner."""
    rng = np.random.default_rng(ML_LABEL_SEED + 5)
    S = Q_SIDE * Q_SIDE
    s = rng.integers(0, S, Q_TRANSITIONS)
    a = rng.integers(0, 4, Q_TRANSITIONS)
    s2 = _grid_step(s, a)
    return np.stack([s, a, (s2 == S - 1).astype(np.float32), s2],
                    1).astype(np.float32)


def _grid_step(s, a):
    r, c = s // Q_SIDE, s % Q_SIDE
    r = np.clip(r + np.array([-1, 1, 0, 0])[a], 0, Q_SIDE - 1)
    c = np.clip(c + np.array([0, 0, -1, 1])[a], 0, Q_SIDE - 1)
    return r * Q_SIDE + c


def _ml_qlearning(client, smi):
    """Q-learning through the client (one kernel launch), the greedy
    policy walked from every state, the kernel against the plain loop on
    one epoch of the first Q_CHECK transitions."""
    import torch
    from neurondb_tpu_torch.ops.kernels import ml_recurrence as MREC
    trans = _gridworld()
    MREC.LAUNCHES = dict.fromkeys(MREC.LAUNCHES, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mid = client.train("chip", "reinforcement_learning", trans)
    secs = time.perf_counter() - t0
    launches = MREC.LAUNCHES["q_learning"]
    S = Q_SIDE * Q_SIDE
    t0 = time.perf_counter()
    policy = client.predict(mid, np.arange(S))
    pred_ms = (time.perf_counter() - t0) * 1e3
    ML2_OWN_S["reinforcement_learning"] = secs + pred_ms / 1e3
    state = np.arange(S)
    for _ in range(4 * Q_SIDE):
        state = np.where(state == S - 1, state, _grid_step(state, policy[state]))
    reached = int((state == S - 1).sum())
    t = torch.from_numpy(trans[:Q_CHECK]).cuda()
    s, a, s2 = (t[:, i].to(torch.int32) for i in (0, 1, 3))
    r = t[:, 2].contiguous()
    Q0 = torch.zeros((S, 4), device="cuda")
    kw = dict(alpha=0.1, gamma=0.95, epochs=1)
    card = MREC.q_learning(s, a, r, s2, Q0, **kw)
    t1 = time.perf_counter()
    plain = MREC.q_learning_plain(s.cpu(), a.cpu(), r.cpu(), s2.cpu(),
                                  Q0.cpu(), **kw)
    plain_ms = (time.perf_counter() - t1) * 1e3
    same = torch.equal(card.cpu(), plain)
    err = float((card.cpu() - plain).abs().max())
    ms = _cuda_ms(lambda: MREC.q_learning(s, a, r, s2, Q0, **kw), 3)
    n = Q_CHECK
    bound, by = _bound(16 * n + 2 * 4 * S * 4, 8 * n, "f32")
    log(f"[ml2] reinforcement_learning: {Q_TRANSITIONS} transitions x 50 "
        f"epochs on a {Q_SIDE}x{Q_SIDE} grid in {secs:.2f} s, q_learning "
        f"launches {launches}; the policy of {S} states in {pred_ms:.2f} ms; "
        f"the greedy policy reaches the goal from "
        f"{reached} of {S} states; kernel vs plain loop on {n} transitions "
        f"x 1 epoch: equal bit for bit {same}; kernel {ms:.3f} ms, plain "
        f"loop on the CPU {plain_ms:.1f} ms, bound {bound:.5f} ms ({by}), "
        f"dependent-step latency bound {n * SMEM_ROUND_TRIP_NS * 1e-6:.3f} "
        f"ms on {smi}")
    if launches != 1:
        fail("Q-learning did not run the recurrence kernel once")
    if reached != S:
        fail(f"the greedy policy reaches the goal from {reached} of {S}")
    if not same:
        fail("the Q-learning kernel differs from its plain loop")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"{n} transitions x 1 epoch")


def _ml_gcn(x, y_mc, reg_root, smi):
    """A GCN on the HNSW phase's 1M x 32 level-0 graph, features the
    corpus, labels y_mc, a 10% train mask: the first layer's propagation
    against an f64 scipy.sparse mean on the host, the loss before and
    after, the model persisted and reloaded."""
    import torch
    import scipy.sparse as sp
    import torch.nn.functional as F_
    from neurondb_tpu_torch.ml import gnn as GN
    from neurondb_tpu_torch.ml import registry as MR
    from neurondb_tpu_torch.types.graph import VectorGraph
    nbr_h = HNSW_LEVEL0
    if nbr_h is None:
        import neurondb_tpu_torch as nt
        index = nt.HNSWIndex(x, m=16, seed=0, build_mode="bulk",
                             device="cuda")
        nbr_h = index._nbr0[:index.n].cpu().numpy()
        del index
    nbr_h = np.asarray(nbr_h)
    nbr = torch.from_numpy(nbr_h).cuda()
    g = VectorGraph(nbr, (nbr >= 0).float())
    X = torch.from_numpy(x).cuda()
    y = torch.from_numpy(y_mc).cuda()
    n = x.shape[0]
    tm = (np.random.default_rng(ML_LABEL_SEED + 6).uniform(size=n)
          < GCN_TRAIN_FRAC).astype(np.float32)
    tmd = torch.from_numpy(tm).cuda()
    P1 = GN._propagate_chunked(nbr, nbr >= 0, X)
    k = GCN_PROP_ROWS
    rr, cc = np.nonzero(nbr_h[:k] >= 0)
    A = sp.csr_matrix((np.ones(len(rr)), (rr, nbr_h[:k][rr, cc])),
                      shape=(k, n))
    deg = np.maximum(np.asarray(A.sum(1)), 1.0)
    x64 = x.astype(np.float64)
    ref = (A @ x64 + x64[:k]) / (deg + 1.0)
    err = float(np.max(np.abs(P1[:k].cpu().numpy() - ref)) / np.max(np.abs(ref)))

    def loss(params):
        logits = GN._forward_from(params, nbr, nbr >= 0, P1)
        nll = -torch.log_softmax(logits, 1).gather(1, y.long()[:, None])[:, 0]
        return float((nll * tmd).sum() / tmd.sum())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    init = GN.gcn_init(gen, x.shape[1], 32, 10, 2, device="cuda")
    torch.cuda.synchronize()
    _note_peak()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = GN.gcn_fit(g, X, y, train_mask=tm)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    l0, l1 = loss(init), loss(model["params"])
    t0 = time.perf_counter()
    pred = GN.gcn_predict(model, X).cpu().numpy()
    ML2_OWN_S["gcn"] = secs + time.perf_counter() - t0
    acc = float(np.mean(pred[tm == 0] == y_mc[tm == 0]))
    mid = MR.get_registry().register("chip", "gcn", model, {})
    again = MR.ModelRegistry(reg_root, device="cuda").get(mid).model
    same = np.array_equal(GN.gcn_predict(again, X).cpu().numpy(), pred)
    del X, P1, nbr, g
    torch.cuda.empty_cache()
    log(f"[ml2] gcn on the {nbr_h.shape} level-0 graph, {int(tm.sum())} "
        f"training nodes: fit (200 steps) {secs:.2f} s, peak "
        f"{peak / 2**30:.2f} GiB; first-layer propagation vs f64 "
        f"scipy.sparse on {k} rows: max error {err:.3e} of max |ref| (bar "
        f"{GCN_PROP_RTOL:.0e}); train loss {l0:.4f} -> {l1:.4f}; held-out "
        f"accuracy {acc:.4f}; persisted and reloaded predicts bit for bit "
        f"{same} on {smi}")
    if not err <= GCN_PROP_RTOL:
        fail("GCN propagation off the f64 scipy.sparse mean")
    if not l1 < l0:
        fail("the GCN loss did not fall")
    if not same:
        fail("the reloaded GCN predicts otherwise")


def _ml_lda(smi):
    import torch
    from neurondb_tpu_torch.ml import extras as EX
    docs, _ = _rag_corpus(np.random.default_rng(ML_LABEL_SEED + 7))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = EX.lda_topics(docs, n_topics=5, device="cuda")
    secs = time.perf_counter() - t0
    ML2_OWN_S["lda_topics"] = secs
    X, _ = EX._counts(docs)
    Xd = torch.from_numpy(X).cuda()
    # restart 0 from its start: the proxy after one EM step and after 30,
    # and the topic rows of the second

    def proxy(lam, gamma):
        tw_ = lam / lam.sum(1, keepdim=True)
        dt_ = gamma / gamma.sum(1, keepdim=True)
        return float((Xd * torch.log(dt_ @ tw_ + 1e-30)).sum())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lam0 = torch._standard_gamma(torch.full((5, X.shape[1]), 100.0,
                                            device="cuda"),
                                 generator=gen) * 0.01 + 0.01
    ll1 = proxy(*EX.lda_run(Xd, lam0, iters=1))
    lam, gamma = EX.lda_run(Xd, lam0, iters=30)
    ll30 = proxy(lam, gamma)
    tw = (lam / lam.sum(1, keepdim=True)).double().cpu().numpy()
    sums = max(np.abs(tw.sum(1) - 1.0).max(),
               np.abs(np.asarray(out["doc_topic"]).sum(1) - 1.0).max())
    log(f"[ml2] lda_topics on {len(docs)} documents ({X.shape[1]} terms), 5 "
        f"topics: {secs:.2f} s; topic and document rows sum to 1 within "
        f"{sums:.2e} (bar "
        f"{LDA_SUM_TOL:.0e}); restart 0's log-likelihood proxy {ll1:.6g} "
        f"after 1 EM step, {ll30:.6g} after 30; topic sizes "
        f"{[t['size'] for t in out['topics']]} on {smi}")
    if not sums <= LDA_SUM_TOL or not ll30 >= ll1:
        fail("LDA topic rows do not sum to 1 or the proxy fell")


def _psi64(ref, live, bins=10):
    qs = np.quantile(ref.astype(np.float64), np.linspace(0, 1, bins + 1))
    qs[0], qs[-1] = -np.inf, np.inf
    r, _ = np.histogram(ref, qs)
    l, _ = np.histogram(live, qs)
    rp = np.maximum(r / len(ref), 1e-6)
    lp = np.maximum(l / len(live), 1e-6)
    return float(np.sum((lp - rp) * np.log(lp / rp)))


def _ml_drift(x, smi):
    import torch
    from scipy.stats import ks_2samp
    from neurondb_tpu_torch.ml import drift as DR
    ref = x[:DRIFT_ROWS]
    live = x[-DRIFT_ROWS:].copy()
    live[:, :DRIFT_SHIFTED] += ref[:, :DRIFT_SHIFTED].std(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = DR.feature_drift_report(torch.from_numpy(ref).cuda(),
                                  torch.from_numpy(live).cuda())
    emb = DR.embedding_drift(torch.from_numpy(ref).cuda(),
                             torch.from_numpy(live).cuda())
    secs = time.perf_counter() - t0
    ML2_OWN_S["drift"] = secs
    psi_err = ks_err = 0.0
    for f in range(DRIFT_CHECK):
        psi_err = max(psi_err, abs(DR.population_stability_index(
            torch.from_numpy(ref[:, f]).cuda(),
            torch.from_numpy(live[:, f]).cuda()) - _psi64(ref[:, f],
                                                          live[:, f])))
        ks_err = max(ks_err, abs(rep["features"][f]["ks"] - round(
            ks_2samp(ref[:, f], live[:, f]).statistic, 4)))
    drifted = [r["feature"] for r in rep["features"] if r["drifted"]]
    log(f"[ml2] drift, first vs last {DRIFT_ROWS} rows with features "
        f"0-{DRIFT_SHIFTED - 1} shifted by their std: report in {secs:.2f} s, drifted "
        f"features {drifted}, max PSI {rep['max_psi']}; on {DRIFT_CHECK} "
        f"features PSI vs f64 numpy max |diff| {psi_err:.2e} (bar "
        f"{PSI_ATOL:.0e}), KS vs scipy.stats.ks_2samp max |diff| "
        f"{ks_err:.2e}; embedding drift {emb} on {smi}")
    if psi_err > PSI_ATOL or ks_err > 0:
        fail("drift statistics off their references")
    if drifted != list(range(DRIFT_SHIFTED)):
        fail(f"drift flags {drifted}, shifted {list(range(DRIFT_SHIFTED))}")


def _ml_automl(x, y_bin, smi):
    import torch
    from neurondb_tpu_torch.ml import api as ML
    from neurondb_tpu_torch.ml import automl as AM
    X, y = x[:AUTOML_ROWS], y_bin[:AUTOML_ROWS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = AM.automl("chip", X, y, folds=3, device="cuda")
    secs = time.perf_counter() - t0
    ML2_OWN_S["automl"] = secs
    cv = AM.cross_validate("naive_bayes", X, y, folds=5, device="cuda")
    # each leaderboard score from the trainers called directly
    Xd, yd = torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()
    worst = 0.0
    for row in res["leaderboard"]:
        t = ML._resolve(row["algorithm"])
        scores = []
        for trn, val in AM._folds(len(X), 3, 0):
            m = t.train(Xd[torch.from_numpy(trn).cuda()],
                        yd[torch.from_numpy(trn).cuda()],
                        **row["hyperparams"])
            p = t.predict(m, Xd[torch.from_numpy(val).cuda()]).cpu().numpy()
            scores.append(float((p == y[val]).mean()))
        worst = max(worst, abs(float(np.mean(scores)) - row["score"]))
    board = [(r["algorithm"], round(r["score"], 4), r["hyperparams"])
             for r in res["leaderboard"]]
    log(f"[ml2] automl on {AUTOML_ROWS} rows, 3 folds: {secs:.2f} s, "
        f"leaderboard {board}, winner {res['best_algorithm']} (model "
        f"{res['model_id']}); scores recomputed by the trainers on the same "
        f"folds, max |diff| {worst:.2e} (bar {AUTOML_TOL:.0e}); "
        f"cross_validate naive_bayes 5 folds mean {cv['mean_score']:.4f} on "
        f"{smi}")
    if worst > AUTOML_TOL:
        fail("automl scores off the trainers' own")


def _ml_mlops(x, rows, client, models, smi):
    """One A/B test between two models (an outcome is a prediction equal
    to the model's own label) and one ModelMonitor pass."""
    from neurondb_tpu_torch.ml import mlops as MO
    (a, ya), (b, yb) = models
    label = {a: ya[rows], b: yb[rows]}
    ab = MO.ABTestManager(seed=0)
    ab.create("trees", a, b, traffic_split=0.5)
    Xp = x[rows]
    preds = {a: client.predict(a, Xp), b: client.predict(b, Xp)}
    rng = np.random.default_rng(ML_LABEL_SEED + 8)
    for j in rng.integers(0, len(rows), 10_000):
        mid = ab.route("trees")
        ab.record_outcome("trees", mid, bool(preds[mid][j] == label[mid][j]))
    ev = ab.evaluate("trees")
    mon = MO.ModelMonitor(a, x[:100_000])
    alert = mon.observe(Xp, predictions=preds[a])
    log(f"[ml2] mlops: A/B test {ev}; ModelMonitor summary {mon.summary()}, "
        f"alert {alert} on {smi}")


def phase_ml2(x, rows, client, reg_root, y_reg, y_bin, y_mc, bayes_mc, smi):
    """The families ported last through Client(device="cuda") (the
    boosting families through their registered trainers and the registry:
    the API aliases their names to gradient_boosting), each held to a
    reference computed apart from the code under test. Returns the
    recurrence kernel's rows."""
    import torch
    from neurondb_tpu_torch.ml import registry as MR
    t_phase = time.perf_counter()
    times, peaks = {}, {}
    ML2_OWN_S.clear()
    ML2_PEAK[0] = torch.cuda.max_memory_allocated()

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        _note_peak()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[name] = round(time.perf_counter() - t0, 2)
        peaks[name] = round((torch.cuda.max_memory_allocated() - base)
                            / 2**30, 2)
        _note_peak()
        return out

    timed("trees", _ml_trees, x, rows, client, reg_root, y_reg, y_bin, y_mc,
          smi)
    hw = timed("timeseries", _ml_timeseries, client, smi)
    timed("recommender", _ml_recommender, client, smi)
    timed("mlp", _ml_mlp, x, client, y_mc, bayes_mc, smi)
    q = timed("q_learning", _ml_qlearning, client, smi)
    timed("gcn", _ml_gcn, x, y_mc, reg_root, smi)
    timed("lda", _ml_lda, smi)
    timed("drift", _ml_drift, x, smi)
    timed("automl", _ml_automl, x, y_bin, smi)
    ids = {r["algorithm"]: r["model_id"]
           for r in MR.get_registry().list("chip")}
    timed("mlops", _ml_mlops, x, rows, client,
          [(ids["decision_tree"], y_mc), (ids["random_forest"], y_bin)], smi)
    secs = time.perf_counter() - t_phase
    own = {k: round(v, 2) for k, v in ML2_OWN_S.items()}
    log(f"[ml2] the families' own train + predict {sum(own.values()):.1f} s "
        f"(budget {ML2_PHASE_S} s): {own}; with the reference checks "
        f"{secs:.1f} s, by section {times}, peak device memory GiB by "
        f"section {peaks} on {smi}")
    if sum(own.values()) > ML2_PHASE_S:
        fail(f"the families ported last took {sum(own.values()):.1f} s of "
             f"their {ML2_PHASE_S} s")
    _note_peak()
    return {"q_learning": q, "holt_winters": hw}, ML2_PEAK[0]


def _ml2_fixture(smi):
    """An XGBoost (binary) and a Holt-Winters model the JAX registry
    persisted on the CPU (tests/data/jax_registry_ml2) load on the card and
    predict as the JAX package did on the CPU."""
    import torch
    from neurondb_tpu_torch.ml import api as ML
    from neurondb_tpu_torch.ml import boosting as BO
    from neurondb_tpu_torch.ml import registry as MR
    ML._ensure_loaded()
    root = os.path.join(ROOT, "tests", "data", "jax_registry_ml2")
    reg = MR.ModelRegistry(root, device="cuda")
    with np.load(os.path.join(root, "expected.npz")) as e:
        X, want_xgb, want_hw = e["X"], e["xgboost"], e["holt_winters"]
    xgb = reg.get(1).model
    Xd = torch.from_numpy(X).cuda()
    got = ML._ALGORITHMS["xgboost"].predict(xgb, Xd).cpu().numpy()
    raw = BO.xgboost_raw(xgb, Xd)
    top2 = torch.topk(raw, 2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    off = (got != want_xgb) & (gap > FIXTURE_TIE)
    hw = ML._ALGORITHMS["timeseries"].predict(
        reg.get(2).model, torch.tensor([24], device="cuda")).cpu().numpy()
    err = float(np.max(np.abs(hw - want_hw)))
    log(f"[ml2] JAX-format models (tests/data/jax_registry_ml2) on the card: "
        f"xgboost {int((got != want_xgb).sum())} of {len(X)} labels differ "
        f"from the JAX CPU run ({int(off.sum())} away from a tie under "
        f"{FIXTURE_TIE}), holt_winters forecast max |diff| {err:.3e} (bar "
        f"{FIXTURE_TOL}) on {smi}")
    if off.any() or err > FIXTURE_TOL:
        fail("a JAX-format model of the last families predicts otherwise")


def main(argv):
    import torch
    kernels_only = "--kernels-only" in argv
    smi = phase_device()
    phase_build()
    flat_stats = phase_kernel()
    pq_stats = phase_pq_kernel(smi)
    flash_stats = phase_flash_kernel(smi)
    probe_stats = phase_probe_kernel(smi)
    flat_launches = {m: None for m in MODES}
    pq_launches = {"exact": None, "packed": None}
    flash_launches = {"bf16": None, "f32": None}
    probe_launches = {"exact": None}
    rec_stats = None
    if not kernels_only:
        index, qb, chosen, flat_launches, x, gt, exact = phase_main()
        _profile(f"profile nprobe {chosen} batch {BATCH}",
                 lambda: index.search(qb, k=K, nprobe=chosen))
        probe_launches = {"exact": phase_probe_route(index, qb, chosen, gt,
                                                     exact)}
        phase_save_load(index, qb, chosen)
        _validate_ivf_checks(index, smi)
        del index
        torch.cuda.empty_cache()
        phase_store(x, qb, smi)
        hnsw_launches, hnsw_mode = phase_hnsw(x, qb, gt, exact, smi)
        flat_launches[hnsw_mode] += hnsw_launches
        pq_launches = phase_ivfpq(x)
        phase_quantized(x, qb, exact, smi)
        # the hybrid ANN takes the default selection (packed at 200k rows)
        from neurondb_tpu_torch import get_config
        flat_launches[get_config().ivf_select] += phase_hybrid(x, smi)
        rec_stats = phase_ml(x, qb, smi)
        n_probe, n_pq, n_grouped, sh_mode = phase_sharded(x, qb, exact, smi)
        probe_launches["exact"] += n_probe
        pq_launches["exact"] += n_pq
        flat_launches[sh_mode] += n_grouped
        del x
        flash_launches = phase_rerank()
        flash_launches["bf16"] += phase_generate(smi)
    kernels = []
    for name, stats, launches in (
            ("ivf_grouped_scan", flat_stats, flat_launches),
            ("ivfpq_grouped_scan", pq_stats, pq_launches),
            ("flash_attention", flash_stats, flash_launches),
            ("ivf_probe_scan", probe_stats, probe_launches)):
        source, replaces = SOURCES[name]
        for mode, s in stats.items():
            kernels.append({"name": name, "mode": mode, "route": "cuda",
                            "source": source, "replaces": replaces,
                            "launches": launches[mode], **s})
    source, replaces = SOURCES["ml_recurrence"]
    for mode in ("q_learning", "holt_winters"):
        st = dict(rec_stats[mode]) if rec_stats else {}
        kernels.append({"name": "ml_recurrence", "mode": mode,
                        "route": "cuda", "source": source,
                        "replaces": replaces[mode],
                        "launches": st.pop("launches", None), **st})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
