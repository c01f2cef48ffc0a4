"""HNSW — hierarchical graph ANN as batched beam search on the card.

Counterpart of ``neurondb_tpu/index/hnsw.py``; every function keeps its
JAX name, and a JAX index's state carries across (``from_state``) to the
same graph. The graph lives on the index's device as int32 adjacency:
level 0 is ``nbr0 [Ncap, 2m]``, each upper level a compact array of local
rows with its row <-> vector maps. A query batch runs in lockstep:

- ``_query_search_routed`` (bulk-built indexes): one centroid GEMM picks
  each query's top-R coarse cells, whose representative rows seed a
  multi-entry level-0 ``_beam_search``;
- ``_query_search`` (incremental indexes): ``_greedy_descent`` through the
  upper levels, then the level-0 beam;
- ``_beam_search``: per step, pop the E best unexpanded beam entries,
  gather their neighbours, test and set each in a ``[B, ceil(Nc / 32)]``
  visited bitmap over the level's Nc rows (n at level 0 in a search),
  score the fresh ones and merge them into the beam, ties in
  ``lax.top_k``'s order. On the card one launch of
  ``csrc/hnsw_beam.cu`` (``ops/kernels/hnsw_beam.py``) runs the whole
  walk, one thread block a query; ``_beam_search_plain`` runs it as torch
  ops (dedup by a stable id sort, the bitmap set by a scatter-add of
  distinct fresh bits, which is OR, the merge by a stable sort) for CPU
  tensors and the shapes past the kernel's limits.

The bulk build (``build_bulk``) bootstraps a k-NN graph (``chunked_knn``
up to ``EXACT_KNN_MAX_ROWS`` rows, else self-queries of an
``IVFFlatIndex`` over the resident corpus, which run the grouped scan
kernel ``csrc/ivf_scan_grouped.cu`` on the card), prunes each node's own
list with the diversity heuristic, reverse-links, refines with one
NN-descent round, bridges components and builds the upper levels from
exact in-level k-NN. ``add`` inserts in waves (``_wave_search``,
``_link_level0_device``), ``delete`` tombstones and ``compact`` removes
with back-link repair.

The JAX primitives are plain functions on tensors. The beam's
``lax.while_loop`` becomes the kernel, whose queries stop one by one, and
in the plain version a Python loop that checks convergence on the host
every 8 steps (a step on a converged query changes nothing, so either
gives the JAX loop's result); the greedy descent's a Python loop; a
``lax.scan`` over slabs a loop over slabs. Rows are
independent, so a slab's size bounds memory and launches and changes no
result: the slabs here are 4x the JAX package's, to cut the launches a
1M-row build makes (its peak stays a few GB).

Deliberate divergences from the JAX package:
- the query path has only the bitmap visited set, the top-k beam merge
  and exact merges: the bitonic network merge (``NDB_SORTNET``,
  ``ops/sortnet.py``), ``NDB_BEAM_MERGE=approx`` and the ring visited set
  (``NDB_VISITED``, a workaround for the TPU's scalar core that re-scores
  evicted nodes) are not ported; the bitmap is the reference semantics
  and what the JAX package runs on the CPU;
- ``config.hnsw_build_rt < 1`` on the upper levels' k-NN is served
  exactly, as every ``*_rt`` knob of this package;
- padding that only bounds XLA's compile shapes is dropped: query
  sub-batches, upper levels, the last insertion wave, the reverse-link
  and repair chunks run at their real sizes (the wave composition, the
  ``self._wave`` real rows per wave, is kept);
- the store is bf16 on CUDA and f32 on the CPU (``store_dtype="auto"``),
  with |x|^2 from the f32 source, as the JAX package does on the TPU;
- random choices use torch's and numpy's generators: the NN-descent
  probes (``_nn_descent_rand``), the router's k-means and the IVF
  bootstrap's sample differ from JAX's draws; level draws use the same
  ``numpy.random.default_rng(seed)`` sequence as JAX;
- component labels come from ``scipy.sparse.csgraph`` at every size,
  each component labelled by its smallest row, the labels of the JAX
  package's propagation; the JAX package's native union-find library
  and its host propagation for small graphs are not used;
- the bridge phase's [C, N] outside-distance scan runs on the index's
  device at every size (the JAX package scans on the host below
  C * N = 2**24), its candidates from ``torch.topk`` ordered by
  (distance, row): rows tied at the candidate list's last distance may
  be other rows than the JAX package's;
- ``compact`` keeps each surviving row's |x|^2 from the f32 source, where
  the JAX package recomputes it from the stored rows (the same numbers
  for an f32 store).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import (get_config, resolve_device,
                                       resolve_store_dtype)
from neurondb_tpu_torch.index.base import BaseIndex, as_batch
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK
from neurondb_tpu_torch.ops.kernels import hnsw_beam as HB
from neurondb_tpu_torch.utils import tracing

INF = float(torch.finfo(torch.float32).max)
INF_NP = float(np.finfo(np.float32).max) * 0.5   # "masked" threshold
EXACT_KNN_MAX_ROWS = 20000      # bulk k-NN graph: exact up to this many rows
CHECK_EVERY = 8                 # loop steps between host convergence checks


# ===========================================================================
# search primitives
# ===========================================================================

def _smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest along the last axis, ascending, ties to the lower
    index: ``lax.top_k(-d, k)``'s order, by a stable sort."""
    v, pos = torch.sort(d, dim=-1, stable=True)
    return v[..., :k], pos[..., :k]


def _bits(ids: torch.Tensor) -> torch.Tensor:
    """1 << (id & 31) as int32 (bit 31 is negative, two's complement)."""
    return torch.ones_like(ids, dtype=torch.int32) << (ids & 31).int()


def _pair_dist(q: torch.Tensor, q_sq: torch.Tensor, g: torch.Tensor,
               g_sq: torch.Tensor, metric: str) -> torch.Tensor:
    """q [B, D] vs per-query gathered rows g [B, C, D] -> [B, C] scores."""
    dots = torch.bmm(g.float(), q[:, :, None])[..., 0]
    if metric == "ip":
        return -dots
    return torch.clamp((q_sq[:, None] + g_sq) - 2.0 * dots, min=0.0)


def _greedy_descent(q, cur, vecs, sqnorms, nbr, rowmap, *, metric: str,
                    max_steps: int):
    """One-level greedy walk: move to the best neighbor while it improves.
    cur: [B] local rows. rowmap: [Nc] local row -> vector row.
    Returns improved [B] local rows."""
    B = q.shape[0]
    q_sq = (q * q).sum(1)
    cur = cur.long()
    vr = rowmap[cur].long()
    dots = (q * vecs[vr].float()).sum(1)
    cur_d = -dots if metric == "ip" else torch.clamp(
        q_sq + sqnorms[vr] - 2.0 * dots, min=0.0)
    moved = torch.ones(B, dtype=torch.bool, device=q.device)
    for step in range(max_steps):
        if step and step % CHECK_EVERY == 0 and not bool(moved.any()):
            break
        nb = nbr[cur].long()                                 # [B, deg]
        valid = (nb >= 0) & moved[:, None]
        nb_safe = nb.clamp(min=0)
        vr = rowmap[nb_safe].long()
        d = _pair_dist(q, q_sq, vecs[vr], sqnorms[vr], metric)
        d = torch.where(valid, d, INF)
        j = d.argmin(1, keepdim=True)
        best_d = d.gather(1, j)[:, 0]
        better = best_d < cur_d
        cur = torch.where(better, nb_safe.gather(1, j)[:, 0], cur)
        cur_d = torch.where(better, best_d, cur_d)
        moved = better
    return cur


def _beam_search(q, entry, vecs, sqnorms, nbr, rowmap, *, metric: str,
                 ef: int, max_steps: int, identity_map: bool,
                 expand: int = 1):
    """ef-bounded best-first expansion at one level.

    q [B, D]; entry [B] or [B, R] local rows (multi-entry: the router's
    seeds; duplicates within a row count once); nbr [Nc, deg] local
    adjacency (-1 pad); rowmap [Nc] local -> vector row (ignored when
    identity_map). ``expand`` pops the E best unexpanded candidates per
    step. Returns (dists [B, ef], rows [B, ef]) ascending, (INF, -1)
    padded. A shape the kernel takes (``hnsw_beam.kernel_takes``: CUDA
    tensors, ef <= 1024, E x deg <= 256, ...) runs ``csrc/hnsw_beam.cu``,
    one launch, each query walking to its own convergence; any other runs
    ``_beam_search_plain``. Both give the same answers up to the order of
    the f32 sums. While tracing, ``hnsw.rows`` counts the rows entering
    and ``hnsw.kernel_rows`` those the kernel served."""
    B = q.shape[0]
    E = max(1, expand)
    deg = nbr.shape[1]
    tally = tracing.recording()
    served = HB.kernel_takes(
        q.device.type, rows=B, dim=q.shape[1], ef=ef, expand=E, deg=deg,
        entries=1 if entry.ndim == 1 else entry.shape[1],
        max_steps=max_steps, store_dtype=vecs.dtype)
    if tally:
        tracing.count("hnsw.rows", B)
        tracing.count("hnsw.kernel_rows", B if served else 0)
    if not served:
        return _beam_search_plain(q, entry, vecs, sqnorms, nbr, rowmap,
                                  metric=metric, ef=ef, max_steps=max_steps,
                                  identity_map=identity_map, expand=E)
    d, rows, fresh, steps = HB.beam_search(
        q, entry, vecs, sqnorms, nbr, None if identity_map else rowmap,
        metric=metric, ef=ef, max_steps=max_steps, expand=E)
    if tally:
        # summed on the card, read when the counters are: the slowest
        # row's steps, the lockstep loop's count
        top = steps.max().long()
        tracing.count("hnsw.fresh", fresh.sum())
        tracing.count("hnsw.steps", top)
        tracing.count("hnsw.gathered", top * (B * E * deg))
    return d, rows


def _beam_search_plain(q, entry, vecs, sqnorms, nbr, rowmap, *, metric: str,
                       ef: int, max_steps: int, identity_map: bool,
                       expand: int = 1):
    """``_beam_search`` as torch ops, the whole batch in lockstep (the
    plain version of the kernel): per step, pop the E best unexpanded
    beam entries, gather their neighbours, dedup them (stable id sort),
    test and set a [B, ceil(Nc / 32)] visited bitmap of int32 words, score
    the fresh ones and merge them into the beam by a stable sort; the host
    checks convergence every ``CHECK_EVERY`` steps."""
    B = q.shape[0]
    Nc, deg = nbr.shape
    E = max(1, expand)
    dev = q.device
    q_sq = (q * q).sum(1)

    def vrow(rows):
        return rows if identity_map else rowmap[rows].long()

    entry = entry.long()
    if entry.ndim == 1:
        entry = entry[:, None]
    R = entry.shape[1]
    e_vr = vrow(entry.clamp(min=0))                          # [B, R]
    e_dots = torch.bmm(vecs[e_vr].float(), q[:, :, None])[..., 0]
    e_d = -e_dots if metric == "ip" else torch.clamp(
        q_sq[:, None] + sqnorms[e_vr] - 2.0 * e_dots, min=0.0)
    entry_ok = entry >= 0
    if R > 1:
        # duplicate entries within a row keep their first occurrence
        dup = (entry[:, :, None] == entry[:, None, :]) & torch.tril(
            torch.ones((R, R), dtype=torch.bool, device=dev), diagonal=-1)
        entry_ok = entry_ok & ~dup.any(2)
    beam_d = torch.full((B, ef), INF, device=dev)
    beam_d[:, :R] = torch.where(entry_ok, e_d, INF)
    beam_i = torch.full((B, ef), -1, dtype=torch.long, device=dev)
    beam_i[:, :R] = torch.where(entry_ok, entry, -1)
    expanded = torch.ones((B, ef), dtype=torch.bool, device=dev)
    expanded[:, :R] = ~entry_ok
    # packed visited words; every bit added is distinct and currently zero
    # (entries deduplicated above, neighbours per step below), so the
    # scatter-add is a bitwise OR
    e_safe = entry.clamp(min=0)
    visited = torch.zeros((B, (Nc + 31) // 32), dtype=torch.int32,
                          device=dev)
    visited.scatter_add_(1, e_safe >> 5,
                         torch.where(entry_ok, _bits(e_safe), 0))

    # counted while tracing: fresh rows summed on the device, one launch
    # a step, read once at the end
    tally = tracing.recording()
    n_fresh = torch.zeros((B, E * deg), dtype=torch.int32, device=dev) \
        if tally else None
    steps = max_steps
    for step in range(max_steps):
        if step and step % CHECK_EVERY == 0:
            with tracing.trace("ndb.hnsw.check"):
                done = bool(expanded.all())
            if done:
                steps = step
                break
        md = torch.where(expanded, INF, beam_d)
        e = md.argmin(1, keepdim=True) if E == 1 else _smallest(md, E)[1]
        active = md.gather(1, e) < INF
        chosen = torch.where(active, beam_i.gather(1, e), 0).clamp(min=0)
        expanded.scatter_(1, e, True)

        nb = nbr[chosen].reshape(B, E * deg).long()
        ok = (nb >= 0) & active.repeat_interleave(deg, dim=1)
        nb_safe = nb.clamp(min=0)
        # dedup within the step (adjacency rows may repeat ids): the
        # scatter-add below is OR only for distinct fresh ids
        order = torch.argsort(torch.where(ok, nb_safe, Nc), dim=1,
                              stable=True)
        nb_safe = nb_safe.gather(1, order)
        ok = ok.gather(1, order)
        ok[:, 1:] &= nb_safe[:, 1:] != nb_safe[:, :-1]
        word = nb_safe >> 5
        bit = _bits(nb_safe)
        fresh = ok & ((visited.gather(1, word) & bit) == 0)
        visited.scatter_add_(1, word, torch.where(fresh, bit, 0))
        if tally:
            n_fresh.add_(fresh)

        vr = vrow(nb_safe)
        d = _pair_dist(q, q_sq, vecs[vr], sqnorms[vr], metric)
        d = torch.where(fresh, d, INF)
        beam_d, pos = _smallest(torch.cat([beam_d, d], dim=1), ef)
        beam_i = torch.cat([beam_i, nb_safe], dim=1).gather(1, pos)
        expanded = torch.cat([expanded, ~fresh], dim=1).gather(1, pos)
        beam_i = torch.where(beam_d < INF, beam_i, -1)
    if tally:
        tracing.count("hnsw.fresh", n_fresh.sum())
        tracing.count("hnsw.steps", steps)
        tracing.count("hnsw.gathered", steps * B * E * deg)
    return beam_d, beam_i


def _prune_closest(vvecs, cand, vecs, sqnorms, *, metric: str, cap: int):
    """Closest-``cap`` of candidates (the reference's prune policy,
    hnsw_am.c:2451-2533). vvecs [V, D] owners; cand [V, C] vector rows
    (-1 pad). Returns lists [V, cap] int32."""
    V, C = cand.shape
    ok = cand >= 0
    cs = cand.clamp(min=0).long()
    v_sq = (vvecs * vvecs).sum(1)
    d = torch.where(ok, _pair_dist(vvecs, v_sq, vecs[cs], sqnorms[cs],
                                   metric), INF)
    k = min(cap, C)
    vals, pos = _smallest(d, k)
    lists = torch.where(vals < INF, cand.gather(1, pos), -1).int()
    if k < cap:
        lists = torch.nn.functional.pad(lists, (0, cap - k), value=-1)
    return lists


def _select_neighbors_heuristic(vvecs, cand, vecs, sqnorms, *, metric: str,
                                cap: int):
    """Diversity-pruned neighbor selection (Malkov & Yashunin Alg. 4),
    batched: accept candidate c (in ascending distance-to-owner order) iff
    d(c, owner) < d(c, a) for every already-accepted a; fill leftover slots
    with the closest rejected candidates (hnswlib keepPrunedConnections).
    Returns lists [V, cap] int32 (-1 pad)."""
    V, C = cand.shape
    dev = cand.device
    ok = cand >= 0
    cs = cand.clamp(min=0).long()
    g = vecs[cs].float()                                     # [V, C, D]
    gs = sqnorms[cs]
    v_sq = (vvecs * vvecs).sum(1)
    d_vc = torch.where(ok, _pair_dist(vvecs, v_sq, g, gs, metric), INF)
    order = torch.argsort(d_vc, dim=1, stable=True)          # invalid last
    cand_s = cand.gather(1, order)
    d_s = d_vc.gather(1, order)
    ok_s = cand_s >= 0
    g_s = g[torch.arange(V, device=dev)[:, None], order]
    gs_s = gs.gather(1, order)
    dots = torch.bmm(g_s, g_s.transpose(1, 2))               # [V, C, C]
    d_cc = -dots if metric == "ip" else torch.clamp(
        gs_s[:, :, None] + gs_s[:, None, :] - 2.0 * dots, min=0.0)
    acc = torch.zeros((V, C), dtype=torch.bool, device=dev)
    cnt = torch.zeros(V, dtype=torch.int32, device=dev)
    for i in range(C):
        if i and i % (2 * CHECK_EVERY) == 0 and not bool(
                ((cnt < cap) & ok_s[:, i:].any(1)).any()):
            break          # no row can accept another candidate
        mmin = torch.where(acc, d_cc[:, i, :], INF).amin(1)
        take = ok_s[:, i] & (cnt < cap) & ((d_s[:, i] < mmin) | (cnt == 0))
        acc[:, i] = take
        cnt += take
    # order: accepted (by distance), then rejected (by distance), invalid last
    iota = torch.arange(C, device=dev)[None, :]
    key = torch.where(ok_s, (~acc).int() * C + iota, 2 * C + iota)
    ord2 = torch.argsort(key, dim=1)[:, :cap]
    lists = cand_s.gather(1, ord2).int()
    if cap > C:
        lists = torch.nn.functional.pad(lists, (0, cap - C), value=-1)
    return lists


def _select(vv, cand, vecs, sqnorms, *, metric: str, cap: int,
            heuristic: bool):
    """The build's selection policy: the diversity heuristic, or
    closest-only (the reference's). Every link pass calls it (the JAX
    package's ``HNSWIndex._select`` method of that name has no caller)."""
    if heuristic:
        return _select_neighbors_heuristic(vv, cand, vecs, sqnorms,
                                           metric=metric, cap=cap)
    return _prune_closest(vv, cand, vecs, sqnorms, metric=metric, cap=cap)


def _group_by_target(v: torch.Tensor, u: torch.Tensor, sent: int):
    """Edges u -> v sorted stably by target: (targets sv, sources su,
    rank within the target's group, group id), the sort/segment trick of
    the JAX package's link passes. v == ``sent`` marks no edge."""
    order = torch.argsort(v, stable=True)
    sv, su = v[order], u[order]
    G = v.shape[0]
    idx = torch.arange(G, device=v.device)
    is_start = torch.ones(G, dtype=torch.bool, device=v.device)
    is_start[1:] = sv[1:] != sv[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    gid = torch.cumsum(is_start.long(), dim=0) - 1
    su = torch.where(sv < sent, su, -1)
    return sv, su, idx - seg_start, gid


def _link_level0_device(nbr0, rows, sel0, vecs, sqnorms, *, m: int,
                        cap: int, metric: str, heuristic: bool,
                        slab: int = 8192):
    """The level-0 link phase of one wave, updating ``nbr0`` in place:
    write each new node's own selected-m list; group the W*m reverse edges
    by target; re-prune every touched target's list (own + at most 2*cap
    incoming) to capacity with the build's selection policy, slab by slab;
    write the lists back. rows [W] global rows; sel0 [W, m] global rows
    (-1 pad)."""
    W = rows.shape[0]
    ncap = nbr0.shape[0]
    rows = rows.long()
    own = torch.full((W, cap), -1, dtype=nbr0.dtype, device=nbr0.device)
    own[:, :m] = sel0
    nbr0[rows] = own
    sent = ncap
    vflat = sel0.reshape(-1).long()
    sv, su, rank, gid = _group_by_target(
        torch.where(vflat >= 0, vflat, sent), rows.repeat_interleave(m),
        sent)
    maxnew = 2 * cap
    ngroups = int(gid[-1]) + 1 if gid.numel() else 0
    tgt = torch.full((ngroups,), sent, dtype=torch.long, device=nbr0.device)
    tgt[gid] = sv
    newmat = torch.full((ngroups, maxnew), -1, dtype=nbr0.dtype,
                        device=nbr0.device)
    keep = rank < maxnew                           # overflow dropped
    newmat[gid[keep], rank[keep]] = su[keep].to(nbr0.dtype)
    tgt_ok = tgt < sent
    tgt, newmat = tgt[tgt_ok], newmat[tgt_ok]      # the no-edge group
    for s in range(0, tgt.shape[0], slab):
        tg = tgt[s:s + slab]
        cand = torch.cat([nbr0[tg], newmat[s:s + slab]], dim=1)
        # a target's own row never enters its list
        cand = torch.where(cand == tg[:, None], -1, cand)
        nbr0[tg] = _select(vecs[tg].float(), cand, vecs, sqnorms,
                           metric=metric, cap=cap, heuristic=heuristic)
    return nbr0


def _bulk_reverse_link(nbr0, sel, vecs, sqnorms, *, m: int, cap: int,
                       metric: str, heuristic: bool, slab: int = 8192):
    """Bulk-build reverse-link pass, updating ``nbr0`` in place: ``sel``
    [N, m] holds every node's own list. Writes the own lists, groups the
    N*m reverse edges by target (at most 2*cap kept a target), and
    re-prunes every node's own + incoming candidates to ``cap``."""
    N = sel.shape[0]
    dev = nbr0.device
    own = torch.full((N, cap), -1, dtype=nbr0.dtype, device=dev)
    own[:, :m] = sel
    nbr0[:N] = own
    sent = nbr0.shape[0]
    v = sel.reshape(-1).long()
    sv, su, rank, _ = _group_by_target(
        torch.where(v >= 0, v, sent),
        torch.arange(N, device=dev).repeat_interleave(m), sent)
    maxnew = 2 * cap
    keep = (rank < maxnew) & (sv < sent)
    newmat = torch.full((N, maxnew), -1, dtype=nbr0.dtype, device=dev)
    newmat[sv[keep], rank[keep]] = su[keep].to(nbr0.dtype)
    for s in range(0, N, slab):
        rows = torch.arange(s, min(s + slab, N), device=dev)
        cand = torch.cat([nbr0[rows], newmat[rows]], dim=1)
        cand = torch.where(cand == rows[:, None], -1, cand)
        nbr0[rows] = _select(vecs[rows].float(), cand, vecs, sqnorms,
                             metric=metric, cap=cap, heuristic=heuristic)
    return nbr0


def _bridge_near(mu, x, x_sq, lab_dense, *, scan_w: int, metric: str):
    """Per-component nearest OUTSIDE nodes for the bridge phase: mu [C, D]
    component centroids, x [N, D], lab_dense [N] dense component label per
    node. Returns (d [C, scan_w], idx [C, scan_w]) ascending, ties by row
    (``torch.topk`` picks among rows tied at the last distance)."""
    dots = mu @ x.T
    d = -dots if metric == "ip" else x_sq[None, :] - 2.0 * dots
    own = lab_dense[None, :] == torch.arange(
        mu.shape[0], dtype=lab_dense.dtype, device=mu.device)[:, None]
    d = torch.where(own, INF, d)
    v, i = torch.topk(d, scan_w, dim=1, largest=False, sorted=False)
    o = torch.argsort(i, dim=1)
    v, i = v.gather(1, o), i.gather(1, o)
    o = torch.argsort(v, dim=1, stable=True)
    return v.gather(1, o), i.gather(1, o)


def _strip_selfhits(ids_all, *, K: int):
    """Drop each row's self-hit from its [N, K+1] kNN ids and left-pack to
    [N, K] (stable: valid entries first, in their order)."""
    n = ids_all.shape[0]
    rows = torch.arange(n, device=ids_all.device)[:, None]
    stripped = torch.where(ids_all == rows, -1, ids_all)
    order = torch.argsort((stripped < 0).int(), dim=1, stable=True)
    return stripped.gather(1, order)[:, :K].int()


def _component_labels(nbr: np.ndarray) -> np.ndarray:
    """Connected-component labels of an adjacency array [N, deg] (-1 pad),
    edges undirected; each node labelled by its component's smallest row
    (``scipy.sparse.csgraph.connected_components``, relabelled)."""
    nbr = np.asarray(nbr)
    n = nbr.shape[0]
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    ok = nbr >= 0
    u = np.repeat(np.arange(n), nbr.shape[1])[ok.ravel()]
    g = coo_matrix((np.ones(len(u), np.int8), (u, nbr.ravel()[ok.ravel()])),
                   shape=(n, n))
    _, comp = connected_components(g, directed=False)
    _, first = np.unique(comp, return_index=True)   # each one's least row
    return first[comp]


def _bulk_prune_own(cand, vecs, sqnorms, *, m: int, heuristic: bool,
                    metric: str, slab: int = 16384):
    """Prune each node's kNN candidate list [N, K] to its own m
    neighbors, slab by slab (bulk build step 2). Returns [N, m] int32."""
    N = cand.shape[0]
    out = torch.empty((N, m), dtype=torch.int32, device=cand.device)
    for s in range(0, N, slab):
        rows = torch.arange(s, min(s + slab, N), device=cand.device)
        c = cand[rows]
        c = torch.where(c == rows[:, None], -1, c)
        out[rows] = _select(vecs[rows].float(), c, vecs, sqnorms,
                            metric=metric, cap=m, heuristic=heuristic)
    return out


def _nn_descent_rand(rnd: int, rows: int, n_rand: int, n: int,
                     device: torch.device) -> torch.Tensor:
    """The NN-descent round's random long-range candidates [rows, n_rand]
    in [0, n): torch's generator seeded by the round (the JAX package
    folds the round and the slab into ``PRNGKey(7)``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(7 * 1_000_003 + rnd)
    return torch.randint(0, max(n, 1), (rows, n_rand), generator=gen,
                         device=device, dtype=torch.int32)


def _nn_descent_round(nbr0, vecs, sqnorms, n: int, rnd: int, *, m: int,
                      metric: str, heuristic: bool, slab: int = 4096,
                      n_rand: int = 16):
    """One NN-descent refinement round (bulk build): each node's
    candidates are its current neighbors, an alternating-column sample of
    its neighbors' full 2m lists (even rounds the own-selected half, odd
    rounds the reverse half), and ``n_rand`` random long-range probes; a
    distance top-(4m) trim bounds the heuristic's pairwise cost, then the
    usual selection picks the node's own m list. Returns sel [N, m] own
    lists (N = nbr0's rows; rows at or past n hold -1)."""
    N, deg = nbr0.shape
    dev = nbr0.device
    out = torch.full((N, m), -1, dtype=torch.int32, device=dev)
    rand_all = _nn_descent_rand(rnd, n, n_rand, n, dev)
    cols = (rnd % 2) + 2 * torch.arange(deg // 2, device=dev)
    for s in range(0, n, slab):
        rows = torch.arange(s, min(s + slab, n), device=dev)
        S = rows.shape[0]
        nb = nbr0[rows]                                      # [S, deg]
        nn2 = nbr0[nb.clamp(min=0).long()]                   # [S, deg, deg]
        nb2 = nn2[:, :, cols].reshape(S, deg * (deg // 2))
        nb2 = torch.where((nb >= 0).repeat_interleave(deg // 2, dim=1),
                          nb2, -1)
        cand = torch.cat([nb, nb2, rand_all[s:s + slab]], dim=1)
        cand = torch.where(cand == rows[:, None], -1, cand)
        # sort-dedup (duplicates would survive _prune_closest)
        order = torch.argsort(torch.where(cand >= 0, cand, 2 ** 30), dim=1,
                              stable=True)
        cs = cand.gather(1, order)
        dup = torch.zeros_like(cs, dtype=torch.bool)
        dup[:, 1:] = cs[:, 1:] == cs[:, :-1]
        cand = torch.where(dup, -1, cs)
        vv = vecs[rows].float()
        trimmed = _prune_closest(vv, cand, vecs, sqnorms, metric=metric,
                                 cap=4 * m)
        out[rows] = (_select_neighbors_heuristic(
            vv, trimmed, vecs, sqnorms, metric=metric, cap=m)
            if heuristic else trimmed[:, :m])
    return out


def _wave_search(rows, entry: int, vecs, sqnorms, nbr0, uppers, *,
                 graph_top: int, node_top: int, efc: int, m: int,
                 metric: str, heuristic: bool):
    """The per-wave search phase: greedy descent through the upper levels,
    intra-wave candidates (earlier wave members), an ef_construction beam
    per level, and neighbor selection. rows [W] global rows of the wave;
    uppers: (nbr, nodes, pos) per level. Returns (sel0 [W, m] global rows,
    {level: sel [W, m] local rows})."""
    W = rows.shape[0]
    dev = rows.device
    rows = rows.long()
    q = vecs[rows].float()

    def select(cand_g):
        if not heuristic:
            return cand_g[:, :m]
        return _select_neighbors_heuristic(q, cand_g, vecs, sqnorms,
                                           metric=metric, cap=m)

    cur_g = torch.full((W,), entry, dtype=torch.long, device=dev)
    per_level_entry = {}
    for l in range(graph_top, 0, -1):
        nbrU, nodesU, posU = uppers[l - 1]
        loc = posU[cur_g].long().clamp(min=0)
        loc = _greedy_descent(q, loc, vecs, sqnorms, nbrU, nodesU,
                              metric=metric, max_steps=256)
        per_level_entry[l] = loc
        cur_g = nodesU[loc].long()
    entry0 = cur_g

    # intra-wave candidates: earlier wave members only (serial-insert
    # visibility order); wave members are invisible in the frozen graph
    within = None
    if W > 1:
        dots = q @ q.T
        if metric == "ip":
            d_ww = -dots
        else:
            qs = (q * q).sum(1)
            d_ww = torch.clamp(qs[:, None] + qs[None, :] - 2.0 * dots,
                               min=0.0)
        i_u = torch.arange(W, device=dev)
        d_ww = torch.where(i_u[None, :] < i_u[:, None], d_ww, INF)
        wd, wpos = _smallest(d_ww, min(m, W))
        within = torch.where(wd < INF, rows[wpos], -1)           # [W, kw]

    sels = {}
    for l in range(min(node_top, graph_top), 0, -1):
        nbrU, nodesU, posU = uppers[l - 1]
        _, bi = _beam_search(q, per_level_entry[l], vecs, sqnorms, nbrU,
                             nodesU, metric=metric, ef=efc,
                             max_steps=efc // 4 + 32, identity_map=False,
                             expand=4)
        cand_g = torch.where(bi >= 0, nodesU[bi.clamp(min=0)].long(), -1)
        if within is not None:
            # keep only wave members that exist at this level
            w_ok = (within >= 0) & (posU[within.clamp(min=0)] >= 0)
            cand_g = torch.cat([cand_g, torch.where(w_ok, within, -1)], dim=1)
        sel_g = select(cand_g).long()
        sels[l] = torch.where(sel_g >= 0, posU[sel_g.clamp(min=0)], -1)

    _, bi0 = _beam_search(q, entry0, vecs, sqnorms, nbr0, None, metric=metric,
                          ef=efc, max_steps=efc // 4 + 32, identity_map=True,
                          expand=4)
    cand0 = bi0 if within is None else torch.cat([bi0, within], dim=1)
    return select(cand0).int(), sels


def _query_search_routed(q, centroids, reps, vecs, sqnorms, nbr0, *,
                         metric: str, ef: int, max_steps: int, expand: int,
                         topr: int):
    """Query search with the centroid router (bulk-built indexes): one
    [B, C] GEMM picks the top-R coarse cells, their representative rows
    seed a multi-entry level-0 beam; no upper-level descent."""
    dots = q @ centroids.T
    if metric == "ip":
        cd = -dots
    else:
        cd = (centroids * centroids).sum(1)[None, :] - 2.0 * dots
    _, top = _smallest(cd, min(topr, centroids.shape[0]))
    return _beam_search(q, reps[top], vecs, sqnorms, nbr0, None,
                        metric=metric, ef=ef, max_steps=max_steps,
                        identity_map=True, expand=expand)


def _query_search(q, entry: int, vecs, sqnorms, nbr0, uppers, *,
                  graph_top: int, ef: int, max_steps: int, metric: str,
                  expand: int):
    """Query-time search: greedy descent through the upper levels, then
    the level-0 beam."""
    cur = torch.full((q.shape[0],), entry, dtype=torch.long, device=q.device)
    for l in range(graph_top, 0, -1):
        nbrU, nodesU, posU = uppers[l - 1]
        loc = posU[cur].long().clamp(min=0)
        loc = _greedy_descent(q, loc, vecs, sqnorms, nbrU, nodesU,
                              metric=metric, max_steps=256)
        cur = nodesU[loc].long()
    return _beam_search(q, cur, vecs, sqnorms, nbr0, None, metric=metric,
                        ef=ef, max_steps=max_steps, identity_map=True,
                        expand=expand)


class _PhaseClock:
    """Wall seconds of the build's phases, each phase ended by a device
    synchronisation (one per phase)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t0 = self.t = time.perf_counter()
        self.seconds: Dict[str, float] = {}

    def mark(self, label: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[label] = self.seconds.get(label, 0.0) + now - self.t
        self.t = now

    def total(self) -> Dict[str, float]:
        return dict(self.seconds, total=self.t - self.t0)


# ===========================================================================
# the index
# ===========================================================================

class HNSWIndex(BaseIndex):
    kind = "hnsw"

    def __init__(self, vectors=None, *, dim: Optional[int] = None,
                 m: Optional[int] = None,
                 ef_construction: Optional[int] = None,
                 ef_search: Optional[int] = None, ml: Optional[float] = None,
                 metric: str = "l2", ids=None, seed: int = 0,
                 wave: Optional[int] = None, neighbor_heuristic: bool = True,
                 build_mode: str = "auto", device=None):
        cfg = get_config()
        self.device = resolve_device(device)
        self._heuristic = neighbor_heuristic
        self.metric = D.canonical_metric(metric)
        self.m = int(m or cfg.hnsw_m)
        self.ef_construction = int(ef_construction or cfg.hnsw_ef_construction)
        self.ef_search = int(ef_search or cfg.hnsw_ef_search)
        self.ml = float(ml or cfg.hnsw_ml)
        self.max_level = cfg.hnsw_max_level
        self._wave = int(wave or cfg.hnsw_build_wave)
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._spherical = self.metric == "cosine"
        if vectors is None and dim is None:
            raise ValueError("need vectors or dim")
        x = None
        if vectors is not None:
            x = np.asarray(vectors, np.float32)
            dim = x.shape[1]
        self.dim = int(dim)
        self.n = 0
        self.entry: int = -1          # global row of entry point
        self.entry_level: int = -1
        self._ncap = 0
        self._ids_np = np.zeros((0,), np.int64)
        self._levels_np = np.zeros((0,), np.int32)
        self._alive_np = np.zeros((0,), bool)     # tombstones (delete)
        self._vecs = None             # [Ncap, D] store dtype
        self._sqnorms = None          # [Ncap] f32
        self._nbr0 = None             # [Ncap, 2M] int32
        self._upper: List[Dict[str, Any]] = []   # indexed by level - 1
        self._router = None           # centroid router (bulk builds)
        self.build_seconds: Dict[str, float] = {}
        self._build_mode = build_mode
        if x is not None and len(x):
            if build_mode == "bulk" or (build_mode == "auto"
                                        and len(x) >= 4096):
                self.build_bulk(x, ids=ids)
            else:
                self.add(x, ids=ids)

    # ---- capacity management ----
    def _ensure_capacity(self, need: int) -> None:
        if need <= self._ncap:
            return
        cap = max(1024, self._ncap or 1024)
        while cap < need:
            cap *= 2
        pad = cap - self._ncap
        dev = self.device
        if self._vecs is None:
            self._vecs = torch.zeros((cap, self.dim),
                                     dtype=resolve_store_dtype(dev),
                                     device=dev)
            self._sqnorms = torch.zeros(cap, device=dev)
            self._nbr0 = torch.full((cap, 2 * self.m), -1, dtype=torch.int32,
                                    device=dev)
        else:
            self._vecs = torch.cat([self._vecs, self._vecs.new_zeros(
                (pad, self.dim))])
            self._sqnorms = torch.cat([self._sqnorms,
                                       self._sqnorms.new_zeros(pad)])
            self._nbr0 = torch.cat([self._nbr0, self._nbr0.new_full(
                (pad, 2 * self.m), -1)])
        for u in self._upper:
            u["pos"] = torch.cat([u["pos"], u["pos"].new_full(
                (cap - u["pos"].shape[0],), -1)])
        self._ncap = cap

    def _ensure_level(self, level: int) -> None:
        """Allocate upper-level structures up to ``level``."""
        dev = self.device
        while len(self._upper) < level:
            self._upper.append({
                "n": 0,
                "nodes": torch.full((1024,), -1, dtype=torch.int32,
                                    device=dev),          # local -> global
                "pos": torch.full((max(self._ncap, 1),), -1,
                                  dtype=torch.int32, device=dev),
                "nbr": torch.full((1024, self.m), -1, dtype=torch.int32,
                                  device=dev),            # local rows
            })

    def _grow_upper(self, l: int, need: int) -> None:
        u = self._upper[l - 1]
        cap = u["nodes"].shape[0]
        if need <= cap:
            return
        new = cap
        while new < need:
            new *= 2
        u["nodes"] = torch.cat([u["nodes"], u["nodes"].new_full(
            (new - cap,), -1)])
        u["nbr"] = torch.cat([u["nbr"], u["nbr"].new_full(
            (new - cap, self.m), -1)])

    # ---- level assignment (hnsw_am.c:1143) ----
    def _draw_levels(self, count: int) -> np.ndarray:
        u = self._rng.random(count)
        lv = np.floor(-np.log(np.maximum(u, 1e-12)) * self.ml).astype(np.int32)
        return np.minimum(lv, self.max_level)

    def _put_rows(self, start: int, x: np.ndarray) -> torch.Tensor:
        """Rows [start, start + len(x)) of the store and |x|^2 from the
        f32 source; returns the f32 rows on the device."""
        xj = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        self._vecs[start:start + len(x)] = xj.to(self._vecs.dtype)
        self._sqnorms[start:start + len(x)] = (xj * xj).sum(1)
        return xj

    # ---- bulk construction ----
    def build_bulk(self, vectors, ids=None, *, knn_k: Optional[int] = None,
                   nprobe: int = 16, bridges: int = 8,
                   refine: int = 1) -> np.ndarray:
        """Batch-build the whole graph: (1) a k-NN candidate graph [N, K]
        (exact, or IVF-bootstrapped self-queries); (2) each node's own m
        list by the selection policy; (3) one bulk reverse-link pass to
        2m; NN-descent refinement rounds; component bridging; (4) upper
        levels from exact in-level k-NN with the same prune/link machinery
        in local coordinates. ``build_seconds`` holds each phase's wall
        seconds."""
        x = np.asarray(vectors, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if self.n:
            return self.add(x, ids=ids)      # bulk is build-time only
        if self._spherical:
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                               1e-30)
        n = x.shape[0]
        new_ids = (np.asarray(ids, np.int64) if ids is not None
                   else np.arange(n, dtype=np.int64))
        levels = self._draw_levels(n)
        K = int(knn_k or max(2 * self.m, 32))
        clock = _PhaseClock(self.device)
        self._ensure_capacity(n)
        xj = self._put_rows(0, x)
        self._ids_np = new_ids.copy()
        self._levels_np = levels
        self._alive_np = np.ones(n, bool)
        self.n = n
        clock.mark("upload")
        m, met, heur = self.m, self._imetric, self._heuristic

        # (1) candidate kNN graph; the resident f32 corpus rides along
        cand = self._bulk_knn_graph(x, K, nprobe, xdev=xj)
        del xj
        clock.mark("knn_graph")
        # (2) own lists + (3) bulk reverse link at level 0
        sel = _bulk_prune_own(cand, self._vecs, self._sqnorms, m=m,
                              heuristic=heur, metric=met)
        del cand
        clock.mark("prune_own")
        _bulk_reverse_link(self._nbr0, sel, self._vecs, self._sqnorms, m=m,
                           cap=2 * m, metric=met, heuristic=heur)
        del sel
        clock.mark("reverse_link")
        for r in range(max(0, refine)):
            sel_r = _nn_descent_round(self._nbr0, self._vecs, self._sqnorms,
                                      n, r, m=m, metric=met,
                                      heuristic=heur)[:n]
            self._nbr0 = _bulk_reverse_link(
                torch.full_like(self._nbr0, -1), sel_r, self._vecs,
                self._sqnorms, m=m, cap=2 * m, metric=met, heuristic=heur)
            del sel_r
        clock.mark("nn_descent")
        # bridge disconnected components (clustered corpora: the kNN
        # graph has no cross-cluster edges)
        nbr_host = self._nbr0[:n].cpu().numpy()
        bridged = self._connect_components(nbr_host, x, met, bridges=bridges,
                                           device=self.device)
        if not np.array_equal(bridged, nbr_host):
            self._nbr0[:n] = torch.from_numpy(bridged).to(self.device)
        clock.mark("bridge")

        # (4) upper levels in local coordinates
        top = int(levels.max()) if n else 0
        self._ensure_level(top)
        for l in range(1, top + 1):
            members = np.where(levels >= l)[0].astype(np.int32)
            u = self._upper[l - 1]
            S = len(members)
            self._grow_upper(l, S)
            mem_d = torch.from_numpy(members).to(self.device)
            u["nodes"][:S] = mem_d
            u["pos"][mem_d.long()] = torch.arange(
                S, dtype=torch.int32, device=self.device)
            u["n"] = S
            if S <= 1:
                continue
            xs = torch.from_numpy(x[members]).to(self.device)
            sq = (xs * xs).sum(1)
            kk = m + 8
            nn_loc = torch.cat([TK.chunked_knn(
                xs[b:b + 8192], xs, kk + 1,
                metric="ip" if met == "ip" else "sqeuclidean",
                chunk=min(S, 16384), base_sqnorms=sq)[1]
                for b in range(0, S, 8192)])
            if nn_loc.shape[1] < kk + 1:
                nn_loc = torch.nn.functional.pad(
                    nn_loc, (0, kk + 1 - nn_loc.shape[1]), value=-1)
            sel_l = _bulk_prune_own(_strip_selfhits(nn_loc, K=kk), xs, sq,
                                    m=m, heuristic=heur, metric=met)
            nbr_l = _bulk_reverse_link(
                torch.full((S, m), -1, dtype=torch.int32, device=self.device),
                sel_l, xs, sq, m=m, cap=m, metric=met, heuristic=heur)
            nbr_host = nbr_l.cpu().numpy()
            bridged = self._connect_components(nbr_host, x[members], met,
                                               device=self.device)
            u["nbr"][:S] = torch.from_numpy(bridged).to(self.device)
        clock.mark("upper_levels")
        best = int(levels.argmax()) if n else -1
        self.entry = best
        self.entry_level = int(levels[best]) if n else -1
        self.build_seconds = clock.total()
        return new_ids

    def _set_router(self, centroids, reps) -> None:
        """Centroid router: the bulk build replaces greedy upper-level
        descent with one [B, C] centroid GEMM whose top-R members seed a
        multi-entry level-0 beam."""
        self._router = {
            "centroids": torch.as_tensor(centroids, dtype=torch.float32,
                                         device=self.device),
            "reps": torch.as_tensor(reps, dtype=torch.int32,
                                    device=self.device)}

    @staticmethod
    def _connect_components(nbr: np.ndarray, x: np.ndarray, metric: str,
                            bridges: int = 3, device=None) -> np.ndarray:
        """Bridge disconnected components of a bulk-built graph: per
        round, every non-largest component gets ``bridges`` bidirectional
        edges to its nearest outside nodes of distinct other components;
        iterate until connected. nbr [N, deg] (numpy, modified copy
        returned); x [N, D] host rows; ``device`` serves the [C, N]
        outside-distance scan."""
        nbr = nbr.copy()
        n = x.shape[0]
        x_sq = (x * x).sum(1)
        lab = None
        xd = None
        for _ in range(32):
            if lab is None:
                # labels once; later rounds only add edges, so the
                # connectivity changes are exactly the added bridges' unions
                lab = _component_labels(nbr)
            comps, lab_dense = np.unique(lab, return_inverse=True)
            C = len(comps)
            if C <= 1:
                break
            counts = np.bincount(lab_dense)
            main = int(np.argmax(counts))
            mu = np.zeros((C, x.shape[1]), np.float32)
            np.add.at(mu, lab_dense, x)
            mu /= counts[:, None]
            scan_w = min(max(1000, 64 * bridges), n - 1)
            if xd is None:
                dev = resolve_device(device)
                xd = torch.from_numpy(x).to(dev)
                xsd = torch.from_numpy(x_sq).to(dev)
            dn, near = _bridge_near(
                torch.from_numpy(mu).to(dev), xd, xsd,
                torch.from_numpy(lab_dense.astype(np.int64)).to(dev),
                scan_w=scan_w, metric="ip" if metric == "ip" else "l2")
            near, d_near = near.cpu().numpy(), dn.cpu().numpy()
            uf = np.arange(C)

            def find(c):
                while uf[c] != c:
                    uf[c] = uf[uf[c]]
                    c = uf[c]
                return c

            for ci in range(C):
                if ci == main:
                    continue
                outs, seen_lab = [], set()
                for j, b in enumerate(near[ci]):
                    if not np.isfinite(d_near[ci, j]) or \
                            d_near[ci, j] >= INF_NP:
                        break
                    lb = lab_dense[b]
                    if lb in seen_lab:
                        continue
                    seen_lab.add(lb)
                    outs.append(int(b))
                    if len(outs) >= bridges:
                        break
                if not outs:
                    continue
                mem = np.where(lab_dense == ci)[0]
                xb = x[outs]                                  # [nb, D]
                if metric == "ip":
                    d_in = -(x[mem] @ xb.T)                   # [M, nb]
                else:
                    d_in = x_sq[mem][:, None] - 2.0 * (x[mem] @ xb.T)
                a_rows = mem[np.argmin(d_in, axis=0)]
                for a, b in zip(a_rows, outs):
                    ra, rb = find(ci), find(int(lab_dense[b]))
                    if ra != rb:
                        uf[max(ra, rb)] = min(ra, rb)
                    for src, dst in ((int(a), int(b)), (int(b), int(a))):
                        row = nbr[src]
                        if dst in row:
                            continue
                        free = np.where(row < 0)[0]
                        nbr[src, free[0] if len(free) else len(row) - 1] = dst
            # fold the unions back into per-node labels for the next round
            roots = np.array([find(c) for c in range(C)])
            lab = comps[roots][lab_dense]
        return nbr

    def _bulk_knn_graph(self, x: np.ndarray, K: int, nprobe: int,
                        xdev: torch.Tensor) -> torch.Tensor:
        """[N, K] candidate rows per node (self stripped), on the device.
        ``xdev``: the same corpus resident on the device (f32,
        pre-normalized): the exact scan and the IVF bootstrap read it."""
        n = x.shape[0]
        metric = "ip" if self._imetric == "ip" else "sqeuclidean"
        if n <= EXACT_KNN_MAX_ROWS:                # exact is cheap enough
            kk = min(K + 1, n)
            sq = (xdev * xdev).sum(1)
            ids_all = torch.cat([TK.chunked_knn(
                xdev[s:s + 4096], xdev, kk, metric=metric,
                chunk=min(n, 65536), base_sqnorms=sq)[1]
                for s in range(0, n, 4096)])
            if kk < K + 1:
                ids_all = torch.nn.functional.pad(ids_all, (0, K + 1 - kk),
                                                  value=-1)
            # router centroids: a k-means over the corpus (small)
            from neurondb_tpu_torch.ml.kmeans import kmeans_fit, kmeans_predict
            ncl = max(8, min(256, n // 64))
            st = kmeans_fit(xdev, ncl, max_iter=10, seed=self._seed)
            lab = kmeans_predict(st.centroids, xdev).cpu().numpy()
            reps = np.zeros(ncl, np.int64)
            for c in range(ncl):
                mem = np.where(lab == c)[0]
                reps[c] = mem[0] if len(mem) else 0
            self._set_router(st.centroids, reps)
            return _strip_selfhits(ids_all, K=K)
        from neurondb_tpu_torch.index.ivf import IVFFlatIndex
        nlists = max(64, min(4096, int(2 * np.sqrt(n))))
        # bootstrap quantizer only: the candidate graph tolerates a coarse
        # k-means (NN-descent and the reverse-link prune repair it)
        ivf = IVFFlatIndex(x, nlists=nlists,
                           metric="ip" if metric == "ip" else "l2",
                           seed=self._seed, kmeans_iters=10,
                           sample_cap=131072, device_vectors=xdev,
                           device=self.device)
        batch = 16384
        allj = torch.cat([ivf.search(xdev[s:s + batch], k=K + 1,
                                     nprobe=nprobe, out="device")[1]
                          for s in range(0, n, batch)])
        cand = _strip_selfhits(allj, K=K)
        # router from the build's own coarse quantizer: one member row
        # per non-empty list
        live = ivf._counts > 0
        self._set_router(ivf.centroids[live],
                         ivf._row_ids[ivf._offsets[live].long()])
        return cand

    # ---- insertion ----
    def add(self, vectors, ids=None) -> np.ndarray:
        x = np.asarray(vectors, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if self._spherical:
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        m = x.shape[0]
        start_id = int(self._ids_np.max()) + 1 if len(self._ids_np) else 0
        new_ids = (np.asarray(ids, np.int64) if ids is not None
                   else np.arange(start_id, start_id + m, dtype=np.int64))
        # internal insertion order is shuffled, so that correlated input
        # does not land in one wave; external ids are unaffected
        perm = self._rng.permutation(m)
        x = x[perm]
        ret_ids = new_ids.copy()
        new_ids = new_ids[perm]
        levels = self._draw_levels(m)

        self._ensure_capacity(self.n + m)
        rows = np.arange(self.n, self.n + m, dtype=np.int32)
        self._put_rows(self.n, x)
        self._ids_np = np.concatenate([self._ids_np, new_ids])
        self._levels_np = np.concatenate([self._levels_np, levels])
        self._alive_np = np.concatenate([self._alive_np, np.ones(m, bool)])
        self.n += m

        # register upper-level membership
        top = int(levels.max()) if m else 0
        self._ensure_level(max(top, 0))
        upper_rows = {}
        for l in range(1, top + 1):
            members = rows[levels >= l]
            if len(members) == 0:
                continue
            u = self._upper[l - 1]
            self._grow_upper(l, u["n"] + len(members))
            loc = np.arange(u["n"], u["n"] + len(members), dtype=np.int32)
            mem_d = torch.from_numpy(members).to(self.device)
            u["nodes"][u["n"]:u["n"] + len(members)] = mem_d
            u["pos"][mem_d.long()] = torch.from_numpy(loc).to(self.device)
            u["n"] += len(members)
            upper_rows[l] = dict(zip(members.tolist(), loc.tolist()))

        # bootstrap: first ever node becomes the entry point
        offset = 0
        if self.entry < 0:
            self.entry = int(rows[0])
            self.entry_level = int(levels[0])
            offset = 1
        # waves with geometric growth: a wave never exceeds the number of
        # already-linked nodes; sizes are powers of two, a remainder split
        # into power-of-two chunks; entry promotion between waves
        linked = self.n - m + offset
        s = offset
        while s < m:
            w = max(16, min(self._wave, linked))
            w = 1 << (w.bit_length() - 1)                 # floor pow2
            remaining = m - s
            if remaining < w:
                w = min(w, 1 << max(remaining.bit_length() - 1, 4))
                w = min(w, remaining)
            e = s + w
            self._insert_wave(rows[s:e], levels[s:e], upper_rows)
            linked += e - s
            wbest = int(levels[s:e].argmax())
            if int(levels[s:e][wbest]) > self.entry_level:
                self.entry = int(rows[s:e][wbest])
                self.entry_level = int(levels[s:e][wbest])
            s = e
        return ret_ids

    def _insert_wave(self, rows: np.ndarray, levels: np.ndarray,
                     upper_rows: Dict[int, Dict[int, int]]) -> None:
        if len(rows) == 0:
            return
        uppers = tuple((u["nbr"], u["nodes"], u["pos"]) for u in self._upper)
        rows_d = torch.from_numpy(rows).to(self.device)
        sel0, sels = _wave_search(
            rows_d, self.entry, self._vecs, self._sqnorms, self._nbr0,
            uppers, graph_top=self.entry_level, node_top=int(levels.max()),
            efc=self.ef_construction, m=self.m, metric=self._imetric,
            heuristic=self._heuristic)
        _link_level0_device(self._nbr0, rows_d, sel0, self._vecs,
                            self._sqnorms, m=self.m, cap=2 * self.m,
                            metric=self._imetric, heuristic=self._heuristic)
        # upper levels (few nodes; host grouping)
        for l, sj in sels.items():
            sel = sj.cpu().numpy().astype(np.int32)
            sel[~(levels >= l)] = -1
            self._link_upper(l, rows, levels, sel, upper_rows[l])

    def _link_upper(self, l: int, rows: np.ndarray, levels: np.ndarray,
                    sel: np.ndarray, local_of: Dict[int, int]) -> None:
        u = self._upper[l - 1]
        mask = levels >= l
        wrows = rows[mask]
        wsel = sel[mask]
        if len(wrows) == 0:
            return
        wloc = np.asarray([local_of[int(r)] for r in wrows], np.int64)
        u["nbr"][torch.from_numpy(wloc).to(self.device)] = \
            torch.from_numpy(np.ascontiguousarray(wsel[:, :self.m])).to(
                self.device)
        self._apply_reverse(wloc, wsel, level=l)

    def _apply_reverse(self, src_rows: np.ndarray, sel: np.ndarray,
                       level: int) -> None:
        """Group reverse edges by target and re-prune each touched list to
        capacity. src/sel are local rows at ``level``."""
        cap = 2 * self.m if level == 0 else self.m
        ok = sel >= 0
        ev = sel[ok].astype(np.int64)                   # row-major order
        eu = np.repeat(np.asarray(src_rows, np.int64), sel.shape[1])[
            ok.ravel()]
        if len(ev) == 0:
            return
        order = np.argsort(ev, kind="stable")
        ev, eu = ev[order], eu[order]
        uniq, starts = np.unique(ev, return_index=True)
        groups = np.split(eu, starts[1:])
        maxnew = 2 * cap         # a target's new edges past this are dropped
        newmat = np.full((len(uniq), maxnew), -1, np.int32)
        for i, g in enumerate(groups):
            newmat[i, :min(len(g), maxnew)] = g[:maxnew]
        dev = self.device
        nbr = self._nbr0 if level == 0 else self._upper[level - 1]["nbr"]
        uq = torch.from_numpy(uniq).to(dev)
        cand = torch.cat([nbr[uq], torch.from_numpy(newmat).to(dev)], dim=1)
        if level == 0:
            vvecs = self._vecs[uq].float()
            cand_g = cand
        else:
            u = self._upper[level - 1]
            vvecs = self._vecs[u["nodes"][uq].long()].float()
            cand_g = torch.where(cand >= 0,
                                 u["nodes"][cand.clamp(min=0).long()], -1)
        # bound the heuristic's O(C^2) pairwise block for hub targets
        if cand_g.shape[1] > 6 * cap:
            cand_g = _prune_closest(vvecs, cand_g, self._vecs, self._sqnorms,
                                    metric=self._imetric, cap=6 * cap)
        lists_g = _select(vvecs, cand_g, self._vecs, self._sqnorms,
                          metric=self._imetric, cap=cap,
                          heuristic=self._heuristic)
        if level == 0:
            self._nbr0[uq] = lists_g
        else:
            u = self._upper[level - 1]
            u["nbr"][uq] = torch.where(
                lists_g >= 0, u["pos"][lists_g.clamp(min=0).long()], -1)

    @property
    def _imetric(self) -> str:
        # internal metric: cosine runs on the unit sphere as squared L2
        return "ip" if self.metric == "ip" else "sqeuclidean"

    # ---- delete / vacuum (hnsw_am.c:544-733 bulkdelete role) ----
    def delete(self, ids) -> int:
        """Tombstone delete: deleted nodes stay traversable but are masked
        out of every result; ``compact()`` removes them with back-link
        repair. Returns #removed."""
        drop = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        mask = np.isin(self._ids_np, drop) & self._alive_np
        hit = int(mask.sum())
        if hit == 0:
            return 0
        self._alive_np[mask] = False
        if self.entry >= 0 and not self._alive_np[self.entry]:
            self._promote_entry()
        return hit

    def _promote_entry(self) -> None:
        alive_rows = np.where(self._alive_np)[0]
        if len(alive_rows) == 0:
            self.entry, self.entry_level = -1, -1
            return
        best = alive_rows[np.argmax(self._levels_np[alive_rows])]
        self.entry = int(best)
        self.entry_level = int(self._levels_np[best])

    @property
    def dead_ratio(self) -> float:
        return (1.0 - float(self._alive_np.sum()) / self.n) if self.n \
            else 0.0

    def compact(self) -> int:
        """Physically remove tombstoned nodes: repair every touched
        neighbor list by splicing in the dead neighbor's alive neighbors
        (pruned to capacity), then renumber rows. Returns #removed."""
        dead = ~self._alive_np
        ndead = int(dead.sum())
        if ndead == 0:
            return 0
        n = self.n
        alive_rows = np.where(~dead)[0]
        nbr0 = self._nbr0[:n].cpu().numpy()
        vec_np = self._vecs[:n].float().cpu().numpy()
        nbr0 = self._repair_adjacency(nbr0, dead, vec_np, rowmap=None,
                                      cap=2 * self.m)
        newpos = np.full(n, -1, np.int64)
        newpos[alive_rows] = np.arange(len(alive_rows))
        nbr0_l = nbr0[alive_rows]
        nbr0_l = np.where(nbr0_l >= 0, newpos[np.maximum(nbr0_l, 0)], -1)
        nbr0_l = np.where(nbr0_l >= 0, nbr0_l, -1).astype(np.int32)
        arrays = {"vecs": vec_np[alive_rows], "nbr0": nbr0_l,
                  "ids": self._ids_np[alive_rows],
                  "levels": self._levels_np[alive_rows],
                  "sqnorms": self._sqnorms[:n].cpu().numpy()[alive_rows]}
        num_upper = 0
        for l, u in enumerate(self._upper, start=1):
            nodes = u["nodes"][:u["n"]].cpu().numpy()
            keep_loc = np.where(self._alive_np[nodes])[0]
            if len(keep_loc) == 0:
                break      # levels are nested: higher ones are empty too
            nbr = self._repair_adjacency(u["nbr"][:u["n"]].cpu().numpy(),
                                         ~self._alive_np[nodes], vec_np,
                                         rowmap=nodes, cap=self.m)
            locpos = np.full(u["n"], -1, np.int64)
            locpos[keep_loc] = np.arange(len(keep_loc))
            nbr_l = nbr[keep_loc]
            nbr_l = np.where(nbr_l >= 0, locpos[np.maximum(nbr_l, 0)], -1)
            arrays[f"u{l}_nodes"] = newpos[nodes[keep_loc]].astype(np.int32)
            arrays[f"u{l}_nbr"] = nbr_l.astype(np.int32)
            num_upper = l
        # remap router representatives; a deleted rep falls back to the
        # nearest alive row of its centroid
        if self._router is not None:
            cents = self._router["centroids"].cpu().numpy()
            reps_old = self._router["reps"].cpu().numpy()
            reps_new = np.where(reps_old < n,
                                newpos[np.minimum(reps_old, n - 1)], -1)
            x_l = arrays["vecs"]
            if len(x_l):
                for ci in np.where(reps_new < 0)[0]:
                    reps_new[ci] = int(np.argmin(((x_l - cents[ci]) ** 2)
                                                 .sum(1)))
            else:
                reps_new[:] = -1   # fully-deleted index
            arrays["router_centroids"] = cents
            arrays["router_reps"] = reps_new.astype(np.int32)
        entry_new = int(newpos[self.entry]) if (
            self.entry >= 0 and self._alive_np[self.entry]) else -1
        meta = {"metric": self.metric, "dim": self.dim, "m": self.m,
                "ef_construction": self.ef_construction,
                "ef_search": self.ef_search, "ml": self.ml,
                "n": len(alive_rows), "entry": entry_new,
                "entry_level": self.entry_level if entry_new >= 0 else -1,
                "seed": self._seed, "heuristic": self._heuristic,
                "num_upper": num_upper}
        self._load_state(arrays, meta, device=self.device)
        if self.entry < 0 and self.n:
            self._promote_entry()
        return ndead

    def _repair_adjacency(self, nbr: np.ndarray, dead_rows: np.ndarray,
                          vec_np: np.ndarray, rowmap, cap: int,
                          chunk: int = 2048) -> np.ndarray:
        """For every node with >= 1 dead neighbor: candidates = alive
        neighbors + dead neighbors' alive neighbors (one-hop splice),
        pruned to ``cap`` by the selection policy. ``nbr`` holds local
        rows when ``rowmap`` (local -> vector row) is given, else vector
        rows."""
        valid = nbr >= 0
        is_dead = np.zeros_like(valid)
        is_dead[valid] = dead_rows[nbr[valid]]
        touched = np.where(is_dead.any(axis=1))[0]
        if len(touched) == 0:
            return nbr
        out = nbr.copy()
        back = None
        if rowmap is not None:
            back = np.full(vec_np.shape[0], -1, np.int64)
            back[rowmap] = np.arange(len(rowmap))
        dev = self.device
        for s in range(0, len(touched), chunk):
            rows_c = touched[s:s + chunk]
            C = len(rows_c)
            nb = nbr[rows_c]                              # [C, deg]
            nb_dead = is_dead[rows_c]
            alive_nb = np.where((nb >= 0) & ~nb_dead, nb, -1)
            hop = nbr[np.where(nb_dead, nb, 0)]           # [C, deg, deg]
            hop = np.where(nb_dead[:, :, None], hop, -1)
            hop_valid = hop >= 0
            hop_alive = np.zeros_like(hop_valid)
            hop_alive[hop_valid] = ~dead_rows[hop[hop_valid]]
            hop = np.where(hop_valid & hop_alive, hop, -1)
            cand = np.concatenate([alive_nb, hop.reshape(C, -1)], axis=1)
            vrows = rows_c if rowmap is None else rowmap[rows_c]
            crows = cand if rowmap is None else np.where(
                cand >= 0, rowmap[np.maximum(cand, 0)], -1)
            crows = np.where(crows == vrows[:, None], -1, crows)  # no self
            vv = torch.from_numpy(vec_np[vrows]).to(dev)
            cj = torch.from_numpy(crows.astype(np.int32)).to(dev)
            if cj.shape[1] > 6 * cap:      # bound the heuristic's O(C^2)
                cj = _prune_closest(vv, cj, self._vecs, self._sqnorms,
                                    metric=self._imetric, cap=6 * cap)
            sel = _select(vv, cj, self._vecs, self._sqnorms,
                          metric=self._imetric, cap=cap,
                          heuristic=self._heuristic).cpu().numpy().astype(
                np.int64)
            out[rows_c] = sel if rowmap is None else np.where(
                sel >= 0, back[np.maximum(sel, 0)], -1)
        return out

    # ---- search ----
    @tracing.annotate_fn("ndb.hnsw.search")
    def search(self, queries, k: int = 10, *, ef: Optional[int] = None,
               max_steps: Optional[int] = None, batch: Optional[int] = None,
               expand: int = 4, router_topr: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
        ef = max(int(ef or self.ef_search), k)
        q, single = as_batch(queries, device=self.device)
        if self._spherical:
            q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1,
                                                         keepdim=True),
                                min=1e-30)
        expand = max(1, expand)
        steps = int(max_steps or ((2 * ef + 32) // expand + 16))
        if batch is None:
            # the visited set is [B, Ncap/32] int32 words: sub-batches keep
            # it within 512 MB (a 1M-row corpus allows B = 4096)
            batch = int(max(64, min(4096, (1 << 32) // max(self._ncap, 1))))
        tombstones = not self._alive_np.all()
        keep = ef if tombstones else k
        uppers = tuple((u["nbr"], u["nodes"], u["pos"]) for u in self._upper)
        # rows past n hold no node and no link: the visited sets span n rows
        nbr0 = self._nbr0[:self.n]
        outs_d, outs_i = [], []
        for s in range(0, q.shape[0], batch):
            qb = q[s:s + batch]
            with tracing.trace("ndb.hnsw.beam"):
                if self._router is not None:
                    bd, bi = _query_search_routed(
                        qb, self._router["centroids"], self._router["reps"],
                        self._vecs, self._sqnorms, nbr0,
                        metric=self._imetric, ef=ef, max_steps=steps,
                        expand=expand, topr=min(router_topr, ef))
                else:
                    bd, bi = _query_search(
                        qb, self.entry, self._vecs, self._sqnorms,
                        nbr0, uppers, graph_top=self.entry_level,
                        ef=ef, max_steps=steps, metric=self._imetric,
                        expand=expand)
            outs_d.append(bd[:, :keep])
            outs_i.append(bi[:, :keep])
        with tracing.trace("ndb.hnsw.collect"):
            dists = torch.cat(outs_d).cpu().numpy()
            rows = torch.cat(outs_i).cpu().numpy()
            if tombstones:
                # deleted nodes were traversable but are never returned:
                # mask and re-rank within the ef beam
                dead = (rows < 0) | ~self._alive_np[np.maximum(rows, 0)]
                dists = np.where(dead, np.inf, dists)
                rows = np.where(dead, -1, rows)
                order = np.argsort(dists, axis=1, kind="stable")[:, :k]
                dists = np.take_along_axis(dists, order, axis=1)
                rows = np.take_along_axis(rows, order, axis=1)
            dists = self._postprocess_dist(dists)
            ids = np.where(rows >= 0, self._ids_np[np.maximum(rows, 0)], -1)
        return (dists[0], ids[0]) if single else (dists, ids)

    def _postprocess_dist(self, d: np.ndarray) -> np.ndarray:
        if self.metric == "l2":
            return np.sqrt(np.maximum(d, 0.0))
        if self.metric == "cosine":
            return d * 0.5
        return d

    # ---- persistence ----
    def _state(self):
        arrays = {
            "vecs": self._vecs[:self.n],
            "nbr0": self._nbr0[:self.n],
            "ids": self._ids_np,
            "levels": self._levels_np,
            "alive": self._alive_np,
            # |x|^2 from the f32 source: a loaded bf16 store then scores
            # exactly as before
            "sqnorms": self._sqnorms[:self.n],
        }
        for l, u in enumerate(self._upper, start=1):
            arrays[f"u{l}_nodes"] = u["nodes"][:u["n"]]
            arrays[f"u{l}_nbr"] = u["nbr"][:u["n"]]
        if self._router is not None:
            arrays["router_centroids"] = self._router["centroids"]
            arrays["router_reps"] = self._router["reps"]
        meta = {"m": self.m, "ef_construction": self.ef_construction,
                "ef_search": self.ef_search, "ml": self.ml, "n": self.n,
                "entry": self.entry, "entry_level": self.entry_level,
                "num_upper": len(self._upper), "seed": self._seed,
                "heuristic": self._heuristic}
        return arrays, meta

    def _load_state(self, arrays, meta, device=None):
        cfg = get_config()
        self.device = resolve_device(device)
        self.metric = meta["metric"]
        self.dim = meta["dim"]
        self.m = meta["m"]
        self.ef_construction = meta["ef_construction"]
        self.ef_search = meta["ef_search"]
        self.ml = meta["ml"]
        self.max_level = cfg.hnsw_max_level
        self._wave = cfg.hnsw_build_wave
        self._rng = np.random.default_rng(meta.get("seed", 0))
        self._seed = meta.get("seed", 0)
        self._heuristic = meta.get("heuristic", True)
        self._spherical = self.metric == "cosine"
        self._build_mode = "auto"
        self.build_seconds = {}
        self.entry = meta["entry"]
        self.entry_level = meta["entry_level"]
        n = meta["n"]
        self.n = n
        self._ncap = 0
        self._vecs = None
        self._upper = []
        self._ensure_capacity(max(n, 1))
        dev = self.device
        x = torch.as_tensor(np.asarray(arrays["vecs"], np.float32),
                            device=dev)
        self._vecs[:n] = x.to(self._vecs.dtype)
        if "sqnorms" in arrays:
            self._sqnorms[:n] = torch.as_tensor(
                np.asarray(arrays["sqnorms"], np.float32), device=dev)
        else:  # older saves: from the stored vectors
            self._sqnorms[:n] = (x * x).sum(1)
        self._nbr0[:n] = torch.as_tensor(
            np.asarray(arrays["nbr0"]).astype(np.int32), device=dev)
        self._ids_np = np.asarray(arrays["ids"]).astype(np.int64)
        self._levels_np = np.asarray(arrays["levels"]).astype(np.int32)
        self._alive_np = (np.array(arrays["alive"], bool)
                          if "alive" in arrays else np.ones(n, bool))
        self._router = None
        if "router_centroids" in arrays:
            self._set_router(np.asarray(arrays["router_centroids"]),
                             np.asarray(arrays["router_reps"]))
        for l in range(1, meta["num_upper"] + 1):
            nodes = np.asarray(arrays[f"u{l}_nodes"]).astype(np.int32)
            nbr = np.asarray(arrays[f"u{l}_nbr"]).astype(np.int32)
            nl = len(nodes)
            cap = max(1024, nl)
            pos = np.full((self._ncap,), -1, np.int32)
            pos[nodes] = np.arange(nl, dtype=np.int32)
            self._upper.append({
                "n": nl,
                "nodes": torch.as_tensor(np.pad(nodes, (0, cap - nl),
                                                constant_values=-1),
                                         device=dev),
                "pos": torch.as_tensor(pos, device=dev),
                "nbr": torch.as_tensor(np.pad(nbr, ((0, cap - nl), (0, 0)),
                                              constant_values=-1),
                                       device=dev),
            })

    # ---- diagnostics (index_validator.c analog) ----
    def stats(self) -> Dict[str, Any]:
        deg = (self._nbr0[:self.n] >= 0).sum(1).cpu().numpy()
        return {"kind": self.kind, "n": self.n, "m": self.m,
                "metric": self.metric, "entry_level": self.entry_level,
                "level_histogram": np.bincount(self._levels_np).tolist(),
                "degree_mean": float(deg.mean()) if self.n else 0.0,
                "degree_min": int(deg.min()) if self.n else 0,
                "isolated_nodes": int((deg == 0).sum())}
