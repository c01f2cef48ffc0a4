"""Per-algorithm gradient boosting: XGBoost, LightGBM, CatBoost semantics.

Counterpart of ``neurondb_tpu/ml/boosting.py``. Reference:
NeuronDB/src/ml/ml_xgboost.c, ml_lightgbm.c, ml_catboost.c. On the binned
features of ``ml/trees.py``:

- ``xgboost_fit``: second-order boosting with the regularized gain
  1/2 [GL^2/(HL+l2) + GR^2/(HR+l2) - G^2/(H+l2)] - gamma, leaf value
  -G/(H+l2), logistic (binary) or softmax (multiclass, diagonal Hessian)
  loss, level-wise growth, eta shrinkage, column subsampling;
- ``lightgbm_fit``: leaf-wise (best-first) growth to ``num_leaves`` with
  explicit child pointers, optional GOSS;
- ``catboost_fit``: oblivious trees (one (feature, bin) split a level)
  and ordered boosting (each sample's gradient from the leaf statistics
  of the samples before it in a random permutation), plus ordered target
  statistics for categorical features.

Divergences:

- histograms are ``trees.hist`` (one ``index_add_`` a feature, in the
  JAX package's (group, feature, bin) layout) and cumulative sums
  ``trees.cumsum_xla``; gradient and Hessian sums are floats, so on a
  card, where ``index_add_`` adds in no fixed order, a split whose gain
  ties another's within the last bits may go either way;
- LightGBM's host loop keeps one round trip a split, but copies only
  each leaf's best gain and its flat index (the first among ties, so
  the split is the flat ``argmax``'s) where the JAX package copies every
  gain; samples move to their children on the device;
- XGBoost's ``colsample`` masks come from a ``torch.Generator`` on the
  data's device (drawn only when ``colsample < 1``); LightGBM's GOSS and
  CatBoost's permutation are host numpy draws with the same seeds, so
  they equal the JAX package's;
- the API's alias table maps ``xgboost`` / ``lightgbm`` / ``catboost``
  to ``gradient_boosting`` (``ml/api.py``, as in the JAX package), so
  ``train(..., "xgboost")`` trains ``trees.gradient_boosting_fit``; the
  trainers registered under these names are reached only by a record
  that names them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from neurondb_tpu_torch.ml.trees import (MAX_BINS, _argmax_split, _go_right,
                                         _stack, _tree, bin_features,
                                         cumsum_xla, hist, quantile_bins)


# ---------------------------------------------------------------------------
# shared: g/h histograms + regularized gain
# ---------------------------------------------------------------------------

def _gh_hist(Xb, g, h, member, n_groups, n_bins):
    """Per-(group, feature, bin) sums of g and h [n_groups, F, n_bins]
    each; member [N] group id (-1 = inactive)."""
    active = member >= 0
    gid = torch.clamp(member, 0, n_groups - 1)
    src = torch.stack([torch.where(active, g, 0.0),
                       torch.where(active, h, 0.0)], 1)
    H = hist(Xb, gid, src, n_groups, n_bins)
    return H[..., 0], H[..., 1]


def _xgb_gain(G, H, *, l2, gamma, min_child_weight):
    """[groups, F, bins] split gains for every (feature, threshold)."""
    cG = cumsum_xla(G, 2)
    cH = cumsum_xla(H, 2)
    tG = cG[:, :, -1:]
    tH = cH[:, :, -1:]
    GL, HL = cG, cH
    GR, HR = tG - cG, tH - cH
    gain = 0.5 * (GL * GL / (HL + l2) + GR * GR / (HR + l2)
                  - tG * tG / (tH + l2)) - gamma
    ok = (HL >= min_child_weight) & (HR >= min_child_weight)
    return torch.where(ok, gain, -torch.inf)


# ---------------------------------------------------------------------------
# XGBoost: level-wise g/h trees
# ---------------------------------------------------------------------------

def _grow_xgb_tree(Xb, g, h, fmask, *, depth: int, n_bins: int,
                   l2: float, gamma: float, min_child_weight: float):
    N, F = Xb.shape
    dev = Xb.device
    n_nodes = 2 ** (depth + 1) - 1
    feat = torch.full((n_nodes,), -1, dtype=torch.int32, device=dev)
    tbin = torch.zeros((n_nodes,), dtype=torch.int32, device=dev)
    node_of = torch.zeros((N,), dtype=torch.int64, device=dev)
    for lvl in range(depth):
        start, n_level = 2 ** lvl - 1, 2 ** lvl
        local = node_of - start
        member = torch.where((local >= 0) & (local < n_level), local, -1)
        G, H = _gh_hist(Xb, g, h, member, n_level, n_bins)
        gain = _xgb_gain(G, H, l2=l2, gamma=gamma,
                         min_child_weight=min_child_weight)
        gain = torch.where(fmask[None, :, None], gain, -torch.inf)
        _, bg, bf, bb = _argmax_split(gain, n_bins)
        bf = torch.where(bg > 0.0, bf, -1)
        feat[start:start + n_level] = bf
        tbin[start:start + n_level] = bb
        nl = torch.clamp(local, 0, n_level - 1)
        sf, sb = bf[nl], bb[nl]
        has = (member >= 0) & (sf >= 0)
        node_of = torch.where(
            has, 2 * node_of + 1 + _go_right(Xb, sf, sb).long(), node_of)
    Gn = torch.zeros(n_nodes, device=dev).index_add_(0, node_of, g)
    Hn = torch.zeros(n_nodes, device=dev).index_add_(0, node_of, h)
    return {"feat": feat, "tbin": tbin, "leaf": -Gn / (Hn + l2)}


def _xgb_tree_predict(tree, Xb, *, depth: int):
    node = torch.zeros((Xb.shape[0],), dtype=torch.int64, device=Xb.device)
    for _ in range(depth):
        f = tree["feat"][node]
        b = tree["tbin"][node]
        node = torch.where(f >= 0, 2 * node + 1 + _go_right(Xb, f, b).long(),
                           node)
    return tree["leaf"][node]


def _task_prep(X, y, task, num_classes):
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


def _grad_hess(pred_raw, Y, task):
    """Per-output g/h: logistic loss (binary) or softmax cross-entropy
    with XGBoost's diagonal Hessian (multiclass); squared loss for
    regression."""
    if task == "classify":
        if Y.shape[1] > 1:
            p = torch.softmax(pred_raw, dim=1)
        else:
            p = torch.sigmoid(pred_raw)
        return p - Y, torch.clamp(p * (1 - p), min=1e-6)
    return pred_raw - Y, torch.ones_like(Y)


def _predict_rounds(rounds, Xb, predict_one):
    """Sum over rounds of each round's [C, N] predictions, in round
    order: [N, C]."""
    T, C = rounds["leaf"].shape[:2]
    acc = torch.zeros((C, Xb.shape[0]), device=Xb.device)
    for t in range(T):
        r = _tree(rounds, t)
        acc = acc + torch.stack([predict_one(_tree(r, c)) for c in range(C)])
    return acc.T


def xgboost_fit(X, y, *, task: str = "classify", n_trees: int = 50,
                depth: int = 6, learning_rate: float = 0.3,
                reg_lambda: float = 1.0, gamma: float = 0.0,
                min_child_weight: float = 1.0,
                colsample: float = 1.0, seed: int = 0,
                num_classes: Optional[int] = None) -> Dict:
    Xb, Y, edges, C = _task_prep(X, y, task, num_classes)
    N, F = Xb.shape
    dev = Xb.device
    pred = torch.zeros((N, C), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    trees = []
    for _ in range(n_trees):
        fmask = (torch.rand((F,), generator=gen, device=dev) < colsample) \
            if colsample < 1.0 else torch.ones((F,), dtype=torch.bool,
                                                device=dev)
        g, h = _grad_hess(pred, Y, task)
        per_out = [_grow_xgb_tree(Xb, g[:, c].contiguous(),
                                  h[:, c].contiguous(), fmask, depth=depth,
                                  n_bins=MAX_BINS, l2=reg_lambda,
                                  gamma=gamma,
                                  min_child_weight=min_child_weight)
                   for c in range(C)]
        upd = torch.stack([_xgb_tree_predict(t, Xb, depth=depth)
                           for t in per_out])                 # [C, N]
        pred = pred + learning_rate * upd.T
        trees.append(_stack(per_out))
    return {"algo": "xgboost", "trees": _stack(trees), "edges": edges,
            "depth": depth, "lr": learning_rate, "task": task, "C": C}


def xgboost_raw(model: Dict, X) -> torch.Tensor:
    Xb = bin_features(X, model["edges"])
    depth = int(model["depth"])
    acc = _predict_rounds(model["trees"], Xb,
                          lambda t: _xgb_tree_predict(t, Xb, depth=depth))
    return float(model["lr"]) * acc


def xgboost_predict(model: Dict, X) -> torch.Tensor:
    raw = xgboost_raw(model, X)
    if model["task"] == "classify":
        return torch.argmax(raw, dim=1).to(torch.int32)
    return raw[:, 0] if raw.shape[1] == 1 else raw


def xgboost_predict_proba(model: Dict, X) -> torch.Tensor:
    raw = xgboost_raw(model, X)
    if raw.shape[1] > 1:
        return torch.softmax(raw, dim=1)     # multi:softprob
    p = torch.sigmoid(raw)
    return torch.cat([1.0 - p, p], dim=1)


# ---------------------------------------------------------------------------
# LightGBM: leaf-wise growth (+ GOSS)
# ---------------------------------------------------------------------------

def _grow_leafwise_tree(Xb, g, h, *, num_leaves: int, n_bins: int,
                        l2: float, gamma: float,
                        min_child_weight: float) -> Dict:
    """Best-first growth: repeatedly split the highest-gain leaf. A host
    loop (num_leaves - 1 iterations) over device histograms; each
    iteration copies one (gain, flat index) pair a leaf."""
    N, F = Xb.shape
    dev = Xb.device
    max_nodes = 2 * num_leaves - 1
    feat = np.full(max_nodes, -1, np.int32)
    tbin = np.zeros(max_nodes, np.int32)
    left = np.full(max_nodes, -1, np.int32)
    right = np.full(max_nodes, -1, np.int32)
    member = torch.zeros((N,), dtype=torch.int64, device=dev)
    n_nodes = 1
    leaves = [0]
    for _ in range(num_leaves - 1):
        n_leaves = len(leaves)
        leaf_of = np.full(max_nodes, -1, np.int64)
        leaf_of[leaves] = np.arange(n_leaves)
        grp = torch.from_numpy(leaf_of).to(dev)[member]
        G, H = _gh_hist(Xb, g, h, grp, n_leaves, n_bins)
        gain = _xgb_gain(G, H, l2=l2, gamma=gamma,
                         min_child_weight=min_child_weight)
        best, bg, _, _ = _argmax_split(gain, n_bins)
        pair = torch.stack([bg.double(), best.double()]).cpu().numpy()
        li = int(pair[0].argmax())          # first leaf among equal gains
        top = pair[0, li]
        if not np.isfinite(top) or top <= 0.0:
            break
        bf, bb = divmod(int(pair[1, li]), n_bins)
        node = leaves[li]
        feat[node], tbin[node] = bf, bb
        left[node], right[node] = n_nodes, n_nodes + 1
        lchild, rchild = n_nodes, n_nodes + 1
        n_nodes += 2
        go_right = Xb[:, bf] > bb
        member = torch.where(member == node,
                             torch.where(go_right, rchild, lchild), member)
        leaves[li] = lchild
        leaves.append(rchild)
    Gn = torch.zeros(max_nodes, device=dev).index_add_(0, member, g)
    Hn = torch.zeros(max_nodes, device=dev).index_add_(0, member, h)
    return {"feat": torch.from_numpy(feat).to(dev),
            "tbin": torch.from_numpy(tbin).to(dev),
            "left": torch.from_numpy(left).to(dev),
            "right": torch.from_numpy(right).to(dev),
            "leaf": -Gn / (Hn + l2)}


def _leafwise_predict(tree, Xb, *, max_steps: int):
    node = torch.zeros((Xb.shape[0],), dtype=torch.int64, device=Xb.device)
    for _ in range(max_steps):
        f = tree["feat"][node]
        b = tree["tbin"][node]
        child = torch.where(_go_right(Xb, f, b), tree["right"][node],
                            tree["left"][node]).long()
        node = torch.where(f >= 0, child, node)
    return tree["leaf"][node]


def lightgbm_fit(X, y, *, task: str = "classify", n_trees: int = 50,
                 num_leaves: int = 31, learning_rate: float = 0.1,
                 reg_lambda: float = 1.0, min_child_weight: float = 1.0,
                 goss: bool = False, goss_top: float = 0.2,
                 goss_other: float = 0.1, seed: int = 0,
                 num_classes: Optional[int] = None) -> Dict:
    Xb, Y, edges, C = _task_prep(X, y, task, num_classes)
    N = Xb.shape[0]
    dev = Xb.device
    pred = torch.zeros((N, C), device=dev)
    rng = np.random.default_rng(seed)
    rounds = []
    for _ in range(n_trees):
        g, h = _grad_hess(pred, Y, task)
        if goss:
            # gradient-based one-side sampling on the host, as the JAX
            # package draws it: the top-a fraction by |g|, b of the rest
            # amplified by (1-a)/b
            mag = np.abs(g.cpu().numpy()).sum(axis=1)
            na = max(1, int(goss_top * N))
            nb = max(1, int(goss_other * N))
            order = np.argsort(-mag)
            keep_top = order[:na]
            rest = order[na:]
            keep_rand = rng.choice(rest, size=min(nb, len(rest)),
                                   replace=False)
            w = np.zeros(N, np.float32)
            w[keep_top] = 1.0
            w[keep_rand] = (1.0 - goss_top) / goss_other
            wt = torch.from_numpy(w).to(dev)[:, None]
            g, h = g * wt, h * wt
        per_out = [_grow_leafwise_tree(
            Xb, g[:, c].contiguous(), h[:, c].contiguous(),
            num_leaves=num_leaves, n_bins=MAX_BINS, l2=reg_lambda,
            gamma=0.0, min_child_weight=min_child_weight) for c in range(C)]
        upd = torch.stack([_leafwise_predict(t, Xb, max_steps=num_leaves)
                           for t in per_out])
        pred = pred + learning_rate * upd.T
        rounds.append(_stack(per_out))
    return {"algo": "lightgbm", "trees": _stack(rounds), "edges": edges,
            "num_leaves": num_leaves, "lr": learning_rate,
            "task": task, "C": C}


def lightgbm_raw(model: Dict, X) -> torch.Tensor:
    Xb = bin_features(X, model["edges"])
    steps = int(model["num_leaves"])
    acc = _predict_rounds(model["trees"], Xb,
                          lambda t: _leafwise_predict(t, Xb, max_steps=steps))
    return float(model["lr"]) * acc


def lightgbm_predict(model: Dict, X) -> torch.Tensor:
    raw = lightgbm_raw(model, X)
    if model["task"] == "classify":
        return torch.argmax(raw, dim=1).to(torch.int32)
    return raw[:, 0] if raw.shape[1] == 1 else raw


# ---------------------------------------------------------------------------
# CatBoost: oblivious trees + ordered boosting + ordered target stats
# ---------------------------------------------------------------------------

def ordered_target_encode(cat: np.ndarray, y: np.ndarray,
                          permutation: np.ndarray, *, prior: float = 0.5,
                          a: float = 1.0) -> np.ndarray:
    """Ordered target statistics: value_i = (prefix_sum + a*prior) /
    (prefix_count + a) over samples of the same category earlier in the
    permutation (a host loop, as in the JAX package)."""
    n = len(cat)
    out = np.zeros(n, np.float32)
    sums: Dict[Any, float] = {}
    cnts: Dict[Any, int] = {}
    for i in permutation:
        c = cat[i]
        s = sums.get(c, 0.0)
        k = cnts.get(c, 0)
        out[i] = (s + a * prior) / (k + a)
        sums[c] = s + float(y[i])
        cnts[c] = k + 1
    return out


def _grow_oblivious_tree(Xb, g, h, *, depth: int, n_bins: int,
                         l2: float, min_child_weight: float):
    """Symmetric tree: each level's one (feature, bin) split maximizes
    the gain summed over every current partition; the leaf index is the
    bitstring of the depth comparisons."""
    N, F = Xb.shape
    dev = Xb.device
    member = torch.zeros((N,), dtype=torch.int64, device=dev)
    feats = torch.zeros((depth,), dtype=torch.int32, device=dev)
    bins_ = torch.zeros((depth,), dtype=torch.int32, device=dev)
    for lvl in range(depth):
        G, H = _gh_hist(Xb, g, h, member, 2 ** lvl, n_bins)
        gain = _xgb_gain(G, H, l2=l2, gamma=0.0,
                         min_child_weight=min_child_weight)
        fin = torch.isfinite(gain)
        tot = torch.where(fin, gain, 0.0).sum(0)
        tot = torch.where(fin.any(0), tot, -torch.inf)       # [F, bins]
        _, _, bf, bb = _argmax_split(tot[None], n_bins)
        feats[lvl] = bf[0]
        bins_[lvl] = bb[0]
        right = Xb.gather(1, bf.long().expand(N)[:, None])[:, 0] > bb[0]
        member = member * 2 + right.long()
    return feats, bins_, member


def _oblivious_leaf_index(Xb, feats, bins_):
    member = torch.zeros((Xb.shape[0],), dtype=torch.int64, device=Xb.device)
    for lvl in range(feats.shape[0]):
        right = Xb[:, int(feats[lvl])] > bins_[lvl]
        member = member * 2 + right.long()
    return member


def ordered_leaf_values(gs, hs, member, pos, *, l2: float) -> torch.Tensor:
    """Each sample's leaf value from the samples of its leaf before it
    in the permutation (``pos`` its position there): exclusive prefix
    sums of g and h within each leaf."""
    N = gs.shape[0]
    order = torch.argsort(member * (N + 1) + pos)
    gs_s, hs_s, mem_s = gs[order], hs[order], member[order]
    cg = cumsum_xla(gs_s, 0) - gs_s          # exclusive prefix
    ch = cumsum_xla(hs_s, 0) - hs_s
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=gs.device),
                          mem_s[1:] != mem_s[:-1]])
    idxr = torch.arange(N, device=gs.device)
    seg0 = torch.cummax(torch.where(is_start, idxr, 0), 0).values
    ord_s = -(cg - cg[seg0]) / ((ch - ch[seg0]) + l2)
    return torch.zeros((N,), device=gs.device).index_put_((order,), ord_s)


def catboost_fit(X, y, *, task: str = "classify", n_trees: int = 50,
                 depth: int = 6, learning_rate: float = 0.1,
                 reg_lambda: float = 3.0, min_child_weight: float = 1.0,
                 ordered: bool = True, seed: int = 0,
                 num_classes: Optional[int] = None) -> Dict:
    Xb, Y, edges, C = _task_prep(X, y, task, num_classes)
    N = Xb.shape[0]
    dev = Xb.device
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    pos = np.empty(N, np.int64)
    pos[perm] = np.arange(N)                 # position in the permutation
    pos_t = torch.from_numpy(pos).to(dev)
    n_leaves = 2 ** depth
    pred_ord = torch.zeros((N, C), device=dev)
    rounds = []
    for _ in range(n_trees):
        g, h = _grad_hess(pred_ord, Y, task)
        feats_l, bins_l, leaf_v = [], [], []
        for c in range(C):
            gs, hs = g[:, c].contiguous(), h[:, c].contiguous()
            feats, bins_, member = _grow_oblivious_tree(
                Xb, gs, hs, depth=depth, n_bins=MAX_BINS, l2=reg_lambda,
                min_child_weight=min_child_weight)
            Gn = torch.zeros(n_leaves, device=dev).index_add_(0, member, gs)
            Hn = torch.zeros(n_leaves, device=dev).index_add_(0, member, hs)
            leaf_full = -Gn / (Hn + reg_lambda)
            if ordered:
                ord_val = ordered_leaf_values(gs, hs, member, pos_t,
                                              l2=reg_lambda)
            else:
                ord_val = leaf_full[member]
            pred_ord[:, c] += learning_rate * ord_val
            feats_l.append(feats)
            bins_l.append(bins_)
            leaf_v.append(leaf_full)
        rounds.append({"feats": torch.stack(feats_l),
                       "bins": torch.stack(bins_l),
                       "leaf": torch.stack(leaf_v)})
    return {"algo": "catboost", "trees": _stack(rounds), "edges": edges,
            "depth": depth, "lr": learning_rate, "task": task, "C": C}


def catboost_raw(model: Dict, X) -> torch.Tensor:
    Xb = bin_features(X, model["edges"])
    trees = model["trees"]
    T = trees["feats"].shape[0]
    C = int(model["C"])
    lr = float(model["lr"])
    out = torch.zeros((Xb.shape[0], C), device=Xb.device)
    for t in range(T):
        for c in range(C):
            member = _oblivious_leaf_index(Xb, trees["feats"][t, c],
                                           trees["bins"][t, c])
            out[:, c] += lr * trees["leaf"][t, c][member]
    return out


def catboost_predict(model: Dict, X) -> torch.Tensor:
    raw = catboost_raw(model, X)
    if model["task"] == "classify":
        return torch.argmax(raw, dim=1).to(torch.int32)
    return raw[:, 0] if raw.shape[1] == 1 else raw
