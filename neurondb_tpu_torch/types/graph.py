"""Vector graph type + graph algorithms — `vgraph` parity.

Counterpart of ``neurondb_tpu/types/graph.py``. The graph is a padded
dense adjacency on one device: ``neighbors [N, deg_max] int32`` (pad =
-1) and ``weights [N, deg_max] f32``. BFS is masked frontier expansion
(a scatter-max), shortest paths Bellman-Ford (a scatter-min), PageRank
power iteration (a scatter-add), community detection synchronous
weighted label propagation, connected components min-label
propagation; DFS order is computed on the host.

Divergences, each computing the same result:

- ``bfs``, ``shortest_path_lengths`` and ``connected_components`` run the
  JAX package's fixed pass count (``n`` by default: 1M passes on a 1M-node
  graph) only until a pass changes nothing; after that every further pass
  is the identity, so the array is the same. The check runs every
  ``CHECK_EVERY`` passes, so there is no host sync per pass.
- ``community_labels`` does not build the JAX package's one-hot
  ``[N, deg, N]`` histogram (a 1M-node graph could never hold it). Each
  row's weighted histogram over its neighbours' labels is summed per slot
  over the slots holding the same label (``[chunk, deg, deg]``), and the
  winner is ``jnp.argmax``'s over all N labels: the largest weight, the
  lowest label among equal ones, where a label no neighbour holds weighs 0
  (it wins only when every present label's weight is below 0, or ties at
  0 below the present ones). Sums run in another order than the einsum's,
  so float weights may break a near-tie otherwise; integer weights are
  exact.
- ``pagerank``'s scatter-add is ``index_add_``, unordered on CUDA: its
  sums are held to a tolerance, not bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device

CHECK_EVERY = 32          # passes between fixed-point checks (host syncs)
HIST_BUDGET = 1 << 26     # floats in one community_labels [chunk, deg, deg]


@dataclass
class VectorGraph:
    neighbors: torch.Tensor   # [N, deg_max] int32, -1 = pad
    weights: torch.Tensor     # [N, deg_max] f32

    @property
    def num_nodes(self) -> int:
        return self.neighbors.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        return self.neighbors >= 0

    @property
    def device(self) -> torch.device:
        return self.neighbors.device

    @classmethod
    def from_edges(cls, n: int, edges: Sequence[Tuple[int, int]],
                   weights: Optional[Sequence[float]] = None,
                   directed: bool = False, *, device=None) -> "VectorGraph":
        adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
        ws = weights if weights is not None else [1.0] * len(edges)
        for (u, v), w in zip(edges, ws):
            adj[u].append((v, w))
            if not directed:
                adj[v].append((u, w))
        deg = max((len(a) for a in adj), default=1) or 1
        nb = np.full((n, deg), -1, np.int32)
        wt = np.zeros((n, deg), np.float32)
        for i, a in enumerate(adj):
            for j, (v, w) in enumerate(a):
                nb[i, j] = v
                wt[i, j] = w
        dev = resolve_device(device)
        return cls(torch.from_numpy(nb).to(dev), torch.from_numpy(wt).to(dev))


def _safe(g: VectorGraph) -> torch.Tensor:
    """Neighbour ids with pads at 0, flattened, int64 for the scatters."""
    return torch.where(g.mask, g.neighbors, 0).reshape(-1).long()


def bfs(g: VectorGraph, source: int,
        max_steps: Optional[int] = None) -> torch.Tensor:
    """BFS levels from ``source`` -> [N] int32 (-1 unreachable).
    vector_graph_ops.c BFS parity as masked frontier expansion."""
    n = g.num_nodes
    steps = max_steps if max_steps is not None else n
    level = torch.full((n,), -1, dtype=torch.int32, device=g.device)
    level[source] = 0
    safe, mask = _safe(g), g.mask
    for i in range(steps):
        from_frontier = ((level == i)[:, None] & mask).reshape(-1)
        hit = torch.zeros(n, dtype=torch.int32, device=g.device)
        hit.scatter_reduce_(0, safe, from_frontier.int(), "amax")
        level = torch.where((hit > 0) & (level < 0), i + 1, level)
        # no node at level i + 1: every later pass changes nothing
        if (i + 1) % CHECK_EVERY == 0 and not bool((level == i + 1).any()):
            break
    return level


def shortest_path_lengths(g: VectorGraph, source: int) -> torch.Tensor:
    """Weighted SSSP via Bellman-Ford iterations -> [N] f32 (inf
    unreachable)."""
    n = g.num_nodes
    inf = float("inf")
    dist = torch.full((n,), inf, dtype=torch.float32, device=g.device)
    dist[source] = 0.0
    safe, mask = _safe(g), g.mask
    w = g.weights.float()
    for i in range(n):
        cand = torch.where(mask, dist[:, None] + w, inf).reshape(-1)
        upd = torch.full((n,), inf, dtype=torch.float32, device=g.device)
        upd.scatter_reduce_(0, safe, cand, "amin")
        new = torch.minimum(dist, upd)
        if (i + 1) % CHECK_EVERY == 0 and torch.equal(new, dist):
            break
        dist = new
    return dist


def dfs_order(g: VectorGraph, source: int) -> List[int]:
    """Host-side DFS preorder (sequential by nature; API parity only)."""
    nb = g.neighbors.cpu().numpy()
    seen = set()
    order: List[int] = []
    stack = [source]
    while stack:
        u = stack.pop()
        if u in seen:
            continue
        seen.add(u)
        order.append(u)
        for v in reversed([int(v) for v in nb[u] if v >= 0]):
            if v not in seen:
                stack.append(v)
    return order


def pagerank(g: VectorGraph, damping: float = 0.85,
             iters: int = 50) -> torch.Tensor:
    """PageRank power iteration (vector_graph_ops.c pagerank parity)."""
    n = g.num_nodes
    mask = g.mask
    nnb = mask.sum(1)
    deg = torch.clamp(nnb, min=1).float()
    dangling_rows = nnb == 0
    pr = torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.device)
    safe = _safe(g)
    for _ in range(iters):
        contrib = torch.where(mask, (pr / deg)[:, None], 0.0)
        inbound = torch.zeros(n, dtype=torch.float32, device=g.device)
        inbound.index_add_(0, safe, contrib.reshape(-1))
        # dangling mass redistributed uniformly
        dangling = torch.where(dangling_rows, pr, 0.0).sum()
        pr = (1.0 - damping) / n + damping * (inbound + dangling / n)
    return pr


def _mex(labels: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Per row, the smallest label >= 0 absent from the row's present
    labels (at most deg of them, so the answer is <= deg)."""
    deg = labels.shape[1]
    cand = torch.arange(deg + 1, device=labels.device)
    held = ((labels[:, :, None] == cand) & present[:, :, None]).any(1)
    return torch.argmin(held.to(torch.uint8), dim=1).to(torch.int32)


def _label_winners(nl: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                   n: int) -> torch.Tensor:
    """``argmax_l sum_j w[j] [nl[j] == l]`` over l in 0..n-1, per row:
    each slot's sum over the slots of its label, the largest sum, the
    lowest label among ties; absent labels weigh 0."""
    same = (nl[:, :, None] == nl[:, None, :]) & mask[:, None, :]
    hist = (same.float() * w[:, None, :]).sum(-1)               # [c, deg]
    hist = torch.where(mask, hist, -float("inf"))
    best = hist.amax(1)
    big = torch.iinfo(torch.int32).max
    win = torch.where(mask & (hist == best[:, None]), nl, big).amin(1)
    # labels held by no neighbour weigh 0: they win when the best present
    # sum is below 0, and share the tie at 0
    n_present = torch.where(mask, 1, 0).sum(1)
    absent = _mex(nl, mask)
    has_absent = absent < n
    take_absent = has_absent & ((best < 0) | ((best == 0) & (absent < win)))
    return torch.where(take_absent | (n_present == 0), absent, win)


def community_labels(g: VectorGraph, iters: int = 20,
                     seed: int = 0) -> torch.Tensor:
    """Community detection by synchronous weighted label propagation ->
    [N] int32 labels. Matches the reference's community-detection
    surface (``seed`` is accepted for parity, as in the JAX package)."""
    n, deg = g.neighbors.shape
    labels = torch.arange(n, dtype=torch.int32, device=g.device)
    mask = g.mask
    safe = torch.where(mask, g.neighbors, 0).long()
    w = torch.where(mask, g.weights.float(), 0.0)
    has_nbr = mask.any(1)
    chunk = max(1, HIST_BUDGET // max(deg * deg, 1))
    for _ in range(iters):
        nl = labels[safe]
        best = torch.empty_like(labels)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            best[s:e] = _label_winners(nl[s:e], w[s:e], mask[s:e], n)
        labels = torch.where(has_nbr, best, labels)
    return labels


def connected_components(g: VectorGraph,
                         iters: Optional[int] = None) -> torch.Tensor:
    """Min-label propagation -> component ids [N] int32."""
    labels, _ = connected_components_passes(g, iters)
    return labels


def connected_components_passes(g: VectorGraph, iters: Optional[int] = None
                                ) -> Tuple[torch.Tensor, int]:
    """``connected_components`` and the passes it ran before the fixed
    point was seen."""
    n = g.num_nodes
    labels = torch.arange(n, dtype=torch.int32, device=g.device)
    mask = g.mask
    safe = torch.where(mask, g.neighbors, 0).long()
    passes = 0
    for i in range(iters or n):
        nbr = torch.where(mask, labels[safe], n)
        new = torch.minimum(nbr.amin(1), labels)
        passes = i + 1
        if passes % CHECK_EVERY == 0 and torch.equal(new, labels):
            break
        labels = new
    return labels, passes
