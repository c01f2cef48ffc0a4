"""Graph neural networks — a GCN over ``VectorGraph``'s padded adjacency.

Counterpart of ``neurondb_tpu/ml/gnn.py``. Reference:
NeuronDB/src/ml/ml_graph_neural_networks.c. Message passing is a masked
gather-mean over the neighbours plus a self loop, then a GEMM, per
layer; training is full-batch gradient descent (node classification)
with autograd.

Divergences:

- the first layer's propagation ``_propagate(X)`` does not depend on the
  weights, so ``gcn_fit`` computes it once (in row chunks) and every
  step starts from it: the same arithmetic as the JAX package's, which
  recomputes it every step;
- the initial weights come from a ``torch.Generator`` on the data's
  device seeded with ``seed``, not from ``jax.random``; ``gcn_train``
  runs the loop from given parameters, so tests feed it JAX's;
- ``gcn_predict`` propagates in row chunks too; the neighbour gather is
  ``index_select``, whose gradient is an ``index_add_`` (an indexed read
  ``h[nbr]`` differentiates through a sorted ``index_put_``, ~2 s a step
  at 1M nodes x 32 neighbours on an H100).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from neurondb_tpu_torch.types.graph import VectorGraph

PROP_ELEMS = 1 << 27      # floats in one [chunk, deg, H] gather


def _propagate(nbr: torch.Tensor, mask: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """Mean aggregation over neighbours + self loop."""
    safe = torch.where(mask, nbr, 0).long()
    msgs = h.index_select(0, safe.reshape(-1)).view(
        *safe.shape, h.shape[1]) * mask[:, :, None]     # [N, deg, H]
    deg = torch.clamp(mask.sum(1, keepdim=True, dtype=torch.float32),
                      min=1.0)
    return (msgs.sum(1) + h) / (deg + 1.0)


def _propagate_chunked(nbr, mask, h) -> torch.Tensor:
    """``_propagate`` in row chunks (no autograd)."""
    rows = max(1, PROP_ELEMS // max(1, nbr.shape[1] * h.shape[1]))
    out = torch.empty_like(h)
    for s in range(0, h.shape[0], rows):
        e = min(s + rows, h.shape[0])
        safe = torch.where(mask[s:e], nbr[s:e], 0).long()
        msgs = h.index_select(0, safe.reshape(-1)).view(
            *safe.shape, h.shape[1]) * mask[s:e, :, None]
        deg = torch.clamp(mask[s:e].sum(1, keepdim=True,
                                        dtype=torch.float32), min=1.0)
        out[s:e] = (msgs.sum(1) + h[s:e]) / (deg + 1.0)
    return out


def gcn_init(gen: torch.Generator, in_dim: int, hidden: int, out_dim: int,
             layers: int = 2, device=None) -> Dict[str, List[torch.Tensor]]:
    dims = [in_dim] + [hidden] * (layers - 1) + [out_dim]
    return {"W": [torch.randn((dims[i], dims[i + 1]), generator=gen,
                              device=device) * (2.0 / dims[i]) ** 0.5
                  for i in range(layers)]}


def _forward_from(params: Dict, nbr, mask, P1: torch.Tensor
                  ) -> torch.Tensor:
    """The forward pass given the first layer's propagation P1."""
    n_layers = len(params["W"])
    h = P1 @ params["W"][0]
    for i in range(1, n_layers):
        h = torch.relu(h)
        h = _propagate(nbr, mask, h) @ params["W"][i]
    return h


def gcn_forward(params: Dict, g: VectorGraph, X: torch.Tensor
                ) -> torch.Tensor:
    """[N, out_dim] logits."""
    mask = g.mask
    h = X.float()
    n_layers = len(params["W"])
    for i, W in enumerate(params["W"]):
        h = _propagate_chunked(g.neighbors, mask, h) @ W
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def gcn_train(params: Dict, nbr: torch.Tensor, X: torch.Tensor,
              y: torch.Tensor, train_mask: torch.Tensor, *, lr: float,
              iters: int) -> Dict:
    """Plain gradient descent on the masked mean NLL from ``params``."""
    mask = nbr >= 0
    P1 = _propagate_chunked(nbr, mask, X.float())
    W = [w.detach().clone().requires_grad_(True) for w in params["W"]]
    yl = y.long()[:, None]
    denom = torch.clamp(train_mask.sum(), min=1.0)
    for _ in range(iters):
        logits = _forward_from({"W": W}, nbr, mask, P1)
        nll = -torch.log_softmax(logits, dim=1).gather(1, yl)[:, 0]
        loss = (nll * train_mask).sum() / denom
        grads = torch.autograd.grad(loss, W)
        with torch.no_grad():
            W = [(w - lr * g).requires_grad_(True) for w, g in zip(W, grads)]
    return {"W": [w.detach() for w in W]}


def gcn_fit(g: VectorGraph, X, y, *, train_mask=None, hidden: int = 32,
            layers: int = 2, lr: float = 0.1, iters: int = 200,
            num_classes: Optional[int] = None, seed: int = 0) -> Dict:
    """Semi-supervised node classification."""
    X = X.float()
    nc = int(num_classes if num_classes is not None else int(y.max()) + 1)
    tm = (torch.ones(X.shape[0], device=X.device) if train_mask is None
          else torch.as_tensor(train_mask, device=X.device).float())
    gen = torch.Generator(device=X.device)
    gen.manual_seed(int(seed))
    params = gcn_init(gen, X.shape[1], hidden, nc, layers, device=X.device)
    params = gcn_train(params, g.neighbors, X, y, tm, lr=lr, iters=iters)
    return {"params": params, "neighbors": g.neighbors,
            "weights": g.weights}


def gcn_predict(model: Dict, X) -> torch.Tensor:
    g = VectorGraph(model["neighbors"], model["weights"])
    logits = gcn_forward(model["params"], g, X.float())
    return torch.argmax(logits, dim=1).to(torch.int32)
