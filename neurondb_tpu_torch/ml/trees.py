"""Tree ensembles — decision tree, random forest, gradient boosting.

Counterpart of ``neurondb_tpu/ml/trees.py`` (``quantile_bins``,
``bin_features``, ``grow_tree``, ``tree_predict``, the decision tree,
random forest and gradient boosting fits, ``ensemble_*``). Reference:
NeuronDB/src/ml/ml_decision_tree.c, ml_random_forest.c. The same
histogram trees grown level-synchronous: features are quantile-binned
once; each level sums the targets per (node, feature, bin), evaluates
every split's gain from cumulative sums over the bins, takes the flat
``argmax`` over ``F * n_bins`` (ties to the first index, as
``jnp.argmax``) and advances every sample's node id in lockstep. The tree
is a flat array over ``2^(depth+1) - 1`` nodes.

Divergences:

- the histograms (the weight and each weighted target) are one 1-D
  ``index_add_`` a column and chunk of features, its repeated source at
  most ``HIST_ELEMS`` values (128 MB), where the JAX package's
  ``segment_sum`` reads a ``[N * F, O]`` temporary (5.1 GB a level at 1M
  x 128 x 10 classes). On the CPU both add each segment's rows in row
  order; on a card ``index_add_`` adds in no fixed order, so regression
  and gradient sums may differ in the last bits there. Classification
  counts are sums of integers and exact in any order;
- cumulative sums over the bins use ``cumsum_xla``, the order in which
  XLA's CPU backend sums ``jnp.cumsum`` (16-element blocks, then the
  blocks' running totals), on every device; ``torch.cumsum`` accumulates
  in f64 on the CPU;
- the random forest grows its trees one at a time (the JAX package
  ``vmap``s all of them, and its ``[N * F, O]`` temporary with them). Its
  bootstrap weights (Poisson(1)) and feature masks come from a
  ``torch.Generator`` on the data's device seeded with ``seed``, not from
  ``jax.random``; ``forest_from_draws`` grows the forest from given
  draws, so tests feed it JAX's;
- ``quantile_bins`` goes through ``ops.vector_ops._quantile`` (a copy of
  ``jnp.quantile``'s linear method): ``torch.quantile`` refuses inputs
  above 2^24 elements;
- ensembles are summed tree by tree into one ``[N, O]`` accumulator
  (the JAX package stacks ``[T, N, O]``), in tree order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from neurondb_tpu_torch.ops.vector_ops import _quantile

MAX_BINS = 64
SCAN_BLOCK = 16          # XLA CPU's cumulative-sum block
BIN_ROWS = 1 << 18       # rows a chunk in bin_features
HIST_ELEMS = 1 << 25     # source values one histogram index_add_ reads


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running f32 sum along the last dim, one add a position."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def cumsum_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum(x, axis=dim)`` as XLA's CPU backend sums it: running
    sums inside blocks of 16, the blocks' totals scanned the same way
    (recursively), each block's exclusive prefix added last."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _seq_cumsum(x).movedim(-1, dim)
    nb = -(-n // SCAN_BLOCK)
    pad = nb * SCAN_BLOCK - n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], -1)
    inner = _seq_cumsum(x.reshape(x.shape[:-1] + (nb, SCAN_BLOCK)))
    tot = cumsum_xla(inner[..., -1], -1)
    excl = torch.cat([tot.new_zeros(tot.shape[:-1] + (1,)), tot[..., :-1]],
                     -1)
    out = (inner + excl[..., None]).reshape(x.shape)[..., :n]
    return out.movedim(-1, dim)


def quantile_bins(X: torch.Tensor, n_bins: int = MAX_BINS) -> torch.Tensor:
    """Per-feature bin edges [F, n_bins-1] from quantiles."""
    qs = torch.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return _quantile(X.float(), qs, dim=0).T.contiguous()


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """[N, F] int32 bin ids: the left-sided ``searchsorted`` of each value
    in its feature's edges, in row chunks."""
    X = X.float()
    edges = edges.to(X.device).float().contiguous()
    out = torch.empty(X.shape, dtype=torch.int32, device=X.device)
    for s in range(0, X.shape[0], BIN_ROWS):
        cols = X[s:s + BIN_ROWS].T.contiguous()              # [F, rows]
        out[s:s + BIN_ROWS] = torch.searchsorted(
            edges, cols, right=False).T.to(torch.int32)
    return out


def hist(Xb: torch.Tensor, group: torch.Tensor, src: torch.Tensor,
         n_groups: int, n_bins: int) -> torch.Tensor:
    """[n_groups, F, n_bins, C] sums of ``src [N, C]`` rows per (group,
    feature, bin); ``group [N]`` in [0, n_groups). Per chunk of features,
    one 1-D ``index_add_`` a column of ``src`` repeated for the chunk's
    features (at most ``HIST_ELEMS`` values): the JAX package's ``[N * F,
    C]`` temporary cut to size. Rows add in row order within each bin (on
    the CPU: the JAX package's order)."""
    N, F = Xb.shape
    C = src.shape[1]
    out = torch.zeros((C, n_groups * F * n_bins), dtype=src.dtype,
                      device=src.device)
    base = group.long()[:, None] * (F * n_bins)
    fc = max(1, min(F, HIST_ELEMS // max(1, N)))
    for f0 in range(0, F, fc):
        f1 = min(F, f0 + fc)
        off = torch.arange(f0, f1, device=Xb.device) * n_bins
        idx = (base + off[None, :] + Xb[:, f0:f1]).reshape(-1)
        for c in range(C):
            out[c].index_add_(0, idx, src[:, c, None].expand(N, f1 - f0)
                              .reshape(-1))
    return out.T.reshape(n_groups, F, n_bins, C)


def _argmax_split(gain: torch.Tensor, n_bins: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per group: the flat argmax over (feature, bin) (first index among
    ties), its gain, feature and bin."""
    flat = gain.reshape(gain.shape[0], -1)
    best = torch.argmax(flat, dim=1)
    bg = flat.gather(1, best[:, None])[:, 0]
    return best, bg, (best // n_bins).to(torch.int32), \
        (best % n_bins).to(torch.int32)


def _go_right(Xb: torch.Tensor, f: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    return Xb.gather(1, torch.clamp(f, min=0).long()[:, None])[:, 0] > b


def grow_tree(Xb: torch.Tensor, Y: torch.Tensor, sample_w: torch.Tensor, *,
              depth: int = 6, n_bins: int = MAX_BINS,
              min_leaf: int = 1) -> Dict:
    """Grow one regression tree on binned features.

    Xb [N, F] int32 bins; Y [N, O] targets; sample_w [N] weights (0 drops
    a row). Returns flat arrays over 2^(depth+1)-1 nodes: feat, tbin,
    leaf [nodes, O]. Split criterion: weighted variance reduction summed
    over outputs."""
    N, F = Xb.shape
    dev = Xb.device
    Y = Y.float()
    sample_w = sample_w.float()
    total = 2 ** (depth + 1) - 1
    feat = torch.full((total,), -1, dtype=torch.int32, device=dev)
    tbin = torch.zeros((total,), dtype=torch.int32, device=dev)
    node_of = torch.zeros((N,), dtype=torch.int64, device=dev)
    eps = 1e-9
    for lvl in range(depth):
        start, n_level = 2 ** lvl - 1, 2 ** lvl
        local = node_of - start
        active = (local >= 0) & (local < n_level)
        nl = torch.clamp(local, 0, n_level - 1)
        w = torch.where(active, sample_w, 0.0)
        src = torch.cat([w[:, None], Y * w[:, None]], 1)
        h = hist(Xb, nl, src, n_level, n_bins)              # [n, F, B, 1+O]
        c = cumsum_xla(h, 2)
        ccnt, csum = c[..., 0], c[..., 1:]
        tot_cnt = ccnt[:, :, -1:]
        tot_sum = csum[:, :, -1:, :]
        lcnt, rcnt = ccnt, tot_cnt - ccnt
        lsum, rsum = csum, tot_sum - csum
        gain = ((lsum * lsum).sum(-1) / torch.clamp(lcnt, min=eps)
                + (rsum * rsum).sum(-1) / torch.clamp(rcnt, min=eps)
                - (tot_sum * tot_sum).sum(-1) / torch.clamp(tot_cnt, min=eps))
        ok = (lcnt >= min_leaf) & (rcnt >= min_leaf)
        gain = torch.where(ok, gain, -torch.inf)
        _, bg, bf, bb = _argmax_split(gain, n_bins)
        bf = torch.where(bg > 1e-7, bf, -1)
        feat[start:start + n_level] = bf
        tbin[start:start + n_level] = bb
        sf, sb = bf[nl], bb[nl]
        has_split = active & (sf >= 0)
        child = 2 * node_of + 1 + _go_right(Xb, sf, sb).long()
        node_of = torch.where(has_split, child, node_of)
    cnt = torch.zeros(total, device=dev).index_add_(0, node_of, sample_w)
    sums = torch.zeros((total, Y.shape[1]), device=dev).index_add_(
        0, node_of, Y * sample_w[:, None])
    leaf = sums / torch.clamp(cnt[:, None], min=1e-9)
    return {"feat": feat, "tbin": tbin, "leaf": leaf}


def tree_predict(tree: Dict, Xb: torch.Tensor, *, depth: int = 6
                 ) -> torch.Tensor:
    """[N, O] leaf values by lockstep traversal."""
    node = torch.zeros((Xb.shape[0],), dtype=torch.int64, device=Xb.device)
    for _ in range(depth):
        f = tree["feat"][node]
        b = tree["tbin"][node]
        child = 2 * node + 1 + _go_right(Xb, f, b).long()
        node = torch.where(f >= 0, child, node)
    return tree["leaf"][node]


def _stack(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _tree(trees: Dict, t: int) -> Dict:
    return {k: v[t] for k, v in trees.items()}


# ---- public trainers ----

def _prep(X, y, task: str, num_classes: Optional[int]):
    X = X.float()
    edges = quantile_bins(X)
    Xb = bin_features(X, edges)
    if task == "classify":
        y = y.long()
        C = int(num_classes if num_classes is not None else int(y.max()) + 1)
        Y = torch.nn.functional.one_hot(y, C).float()
    else:
        Y = y.float()
        if Y.ndim == 1:
            Y = Y[:, None]
        C = Y.shape[1]
    return Xb, Y, edges, C


def _scalars(dev, depth, task, lr, C, kind):
    return {"depth": torch.tensor(depth, dtype=torch.int32, device=dev),
            "task_classify": torch.tensor(task == "classify", device=dev),
            "learning_rate": torch.tensor(lr, dtype=torch.float32,
                                          device=dev),
            "base": torch.zeros((C,), device=dev),
            "kind": torch.tensor(kind, dtype=torch.int32, device=dev)}


def decision_tree_fit(X, y, *, task: str = "classify", depth: int = 6,
                      min_leaf: int = 1, num_classes: Optional[int] = None
                      ) -> Dict:
    Xb, Y, edges, C = _prep(X, y, task, num_classes)
    w = torch.ones((Xb.shape[0],), device=Xb.device)
    tree = grow_tree(Xb, Y, w, depth=depth, min_leaf=min_leaf)
    return {"trees": _stack([tree]), "edges": edges,
            **_scalars(Xb.device, depth, task, 1.0, C, 0)}


def forest_from_draws(Xb: torch.Tensor, Y: torch.Tensor,
                      weights: torch.Tensor, fmasks: torch.Tensor, *,
                      depth: int, min_leaf: int) -> Dict:
    """The forest grown from given bootstrap weights [T, N] and feature
    masks [T, F] (a masked feature's bins read 0), one tree at a time."""
    trees = []
    for w, fm in zip(weights, fmasks):
        Xb_t = torch.where(fm[None, :], Xb, 0)
        trees.append(grow_tree(Xb_t, Y, w, depth=depth, min_leaf=min_leaf))
        del Xb_t
    return _stack(trees)


def random_forest_fit(X, y, *, task: str = "classify", n_trees: int = 50,
                      depth: int = 6, min_leaf: int = 1, seed: int = 0,
                      feature_frac: float = 0.7,
                      num_classes: Optional[int] = None) -> Dict:
    Xb, Y, edges, C = _prep(X, y, task, num_classes)
    N, F = Xb.shape
    dev = Xb.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    trees = []
    for _ in range(n_trees):
        w = torch.poisson(torch.ones((N,), device=dev), generator=gen)
        fm = torch.rand((F,), generator=gen, device=dev) < feature_frac
        trees.append(_tree(forest_from_draws(Xb, Y, w[None], fm[None],
                                             depth=depth,
                                             min_leaf=min_leaf), 0))
    return {"trees": _stack(trees), "edges": edges,
            **_scalars(dev, depth, task, 1.0 / n_trees, C, 0)}


def gradient_boosting_fit(X, y, *, task: str = "classify",
                          n_trees: int = 50, depth: int = 4,
                          learning_rate: float = 0.1, min_leaf: int = 5,
                          num_classes: Optional[int] = None) -> Dict:
    """Squared-loss boosting on (one-hot) targets."""
    Xb, Y, edges, C = _prep(X, y, task, num_classes)
    N = Xb.shape[0]
    w = torch.ones((N,), device=Xb.device)
    base = Y.mean(0)
    pred = base[None, :].expand(N, C).clone()
    trees = []
    for _ in range(n_trees):
        tree = grow_tree(Xb, Y - pred, w, depth=depth, min_leaf=min_leaf)
        pred = pred + learning_rate * tree_predict(tree, Xb, depth=depth)
        trees.append(tree)
    out = {"trees": _stack(trees), "edges": edges,
           **_scalars(Xb.device, depth, task, learning_rate, C, 1)}
    out["base"] = base
    return out


def ensemble_raw(model: Dict, X) -> torch.Tensor:
    Xb = bin_features(X, model["edges"])
    depth = int(model["depth"])
    trees = model["trees"]
    T = trees["feat"].shape[0]
    acc = torch.zeros((Xb.shape[0], trees["leaf"].shape[-1]),
                      device=Xb.device)
    for t in range(T):
        acc = acc + tree_predict(_tree(trees, t), Xb, depth=depth)
    if int(model["kind"]) == 1:                              # boosting
        return model["base"][None, :] + float(model["learning_rate"]) * acc
    return acc / T                                           # averaging


def ensemble_predict(model: Dict, X) -> torch.Tensor:
    raw = ensemble_raw(model, X)
    if bool(model["task_classify"]):
        return torch.argmax(raw, dim=1).to(torch.int32)
    return raw[:, 0] if raw.shape[1] == 1 else raw


def ensemble_predict_proba(model: Dict, X) -> torch.Tensor:
    raw = torch.clamp(ensemble_raw(model, X), min=0.0)
    return raw / torch.clamp(raw.sum(1, keepdim=True), min=1e-9)
