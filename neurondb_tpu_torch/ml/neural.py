"""Neural network trainer — an MLP classifier / regressor on Adam.

Counterpart of ``neurondb_tpu/ml/neural.py``. Reference:
NeuronDB/src/ml/ml_neural_network.c. Inputs standardized by their mean
and (population) standard deviation, He-normal weights, zero biases,
ReLU between layers, full-batch Adam by default (mini-batches of
``batch`` rows drawn with replacement when ``0 < batch < n``), an L2
penalty on the weights.

Divergences:

- optax's ``adam`` becomes ``torch.optim.Adam`` with the same constants
  (b1 0.9, b2 0.999, eps 1e-8, no weight decay); it computes the same
  update in another order (``sqrt(nu) / sqrt(1 - b2^t) + eps`` where
  optax takes ``sqrt(nu / (1 - b2^t)) + eps``), so parameters agree to a
  tolerance step for step;
- the initial weights and the mini-batch indices come from a
  ``torch.Generator`` on the data's device seeded with ``seed`` (and
  ``seed + 1`` for the batches), not from ``jax.random``; ``mlp_train``
  runs the loop from given parameters, so tests feed it JAX's;
- ``jnp.std`` divides by N: ``correction=0``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


def _init_mlp(gen: torch.Generator, dims: Sequence[int],
              device) -> Dict[str, List[torch.Tensor]]:
    return {"W": [torch.randn((dims[i], dims[i + 1]), generator=gen,
                              device=device) * (2.0 / dims[i]) ** 0.5
                  for i in range(len(dims) - 1)],
            "b": [torch.zeros(dims[i + 1], device=device)
                  for i in range(len(dims) - 1)]}


def _forward(params: Dict, X: torch.Tensor) -> torch.Tensor:
    h = X
    n = len(params["W"])
    for i, (W, b) in enumerate(zip(params["W"], params["b"])):
        h = h @ W + b
        if i < n - 1:
            h = torch.relu(h)
    return h


def mlp_train(params: Dict, Xn: torch.Tensor, y: torch.Tensor, *,
              task: str = "classify", lr: float = 1e-3, epochs: int = 200,
              batch: int = 0, seed: int = 0, l2: float = 1e-5) -> Dict:
    """Adam from the given parameters on standardized inputs."""
    p = {k: [t.detach().clone().requires_grad_(True) for t in v]
         for k, v in params.items()}
    opt = torch.optim.Adam(p["W"] + p["b"], lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    n = Xn.shape[0]
    yl = y.long() if task == "classify" else y

    def loss_fn(xb, yb):
        out = _forward(p, xb)
        if task == "classify":
            logp = torch.log_softmax(out, dim=1)
            nll = -logp.gather(1, yb[:, None]).mean()
        else:
            tgt = yb if yb.ndim > 1 else yb[:, None]
            nll = ((out - tgt) ** 2).mean()
        reg = sum((W * W).sum() for W in p["W"])
        return nll + l2 * reg

    gen = None
    if batch and batch < n:
        gen = torch.Generator(device=Xn.device)
        gen.manual_seed(int(seed) + 1)
    for _ in range(epochs):
        if gen is not None:
            idx = torch.randint(0, n, (batch,), generator=gen,
                                device=Xn.device)
            xb, yb = Xn[idx], yl[idx]
        else:
            xb, yb = Xn, yl
        opt.zero_grad(set_to_none=True)
        loss_fn(xb, yb).backward()
        opt.step()
    return {k: [t.detach() for t in v] for k, v in p.items()}


def mlp_fit(X, y, *, hidden: Sequence[int] = (64, 32),
            task: str = "classify", num_classes: Optional[int] = None,
            lr: float = 1e-3, epochs: int = 200, batch: int = 0,
            seed: int = 0, l2: float = 1e-5) -> Dict:
    X = X.float()
    d = X.shape[1]
    if task == "classify":
        out_dim = int(num_classes if num_classes is not None
                      else int(y.max()) + 1)
    else:
        y = y.float()
        out_dim = 1 if y.ndim == 1 else y.shape[1]
    mu = X.mean(0)
    sd = torch.clamp(X.std(0, correction=0), min=1e-6)
    Xn = (X - mu) / sd
    gen = torch.Generator(device=X.device)
    gen.manual_seed(int(seed))
    params = _init_mlp(gen, [d, *hidden, out_dim], X.device)
    params = mlp_train(params, Xn, y, task=task, lr=lr, epochs=epochs,
                       batch=batch, seed=seed, l2=l2)
    return {"params": params, "mu": mu, "sd": sd,
            "classify": torch.tensor(task == "classify", device=X.device)}


def mlp_predict(model: Dict, X) -> torch.Tensor:
    out = _forward(model["params"], (X.float() - model["mu"]) / model["sd"])
    if bool(model["classify"]):
        return torch.argmax(out, dim=1).to(torch.int32)
    return out[:, 0] if out.shape[1] == 1 else out


def mlp_predict_proba(model: Dict, X) -> torch.Tensor:
    X = (X.float() - model["mu"]) / model["sd"]
    return torch.softmax(_forward(model["params"], X), dim=1)
