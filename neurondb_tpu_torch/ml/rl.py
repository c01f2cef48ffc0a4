"""Reinforcement learning — tabular Q-learning + LinUCB contextual bandit.

Counterpart of ``neurondb_tpu/ml/rl.py``. Reference:
NeuronDB/src/ml/ml_reinforcement_learning.c: tabular policies trained
from logged (state, action, reward, next_state) tuples.

Divergences: ``q_learning_fit``'s scan over the transitions inside a
loop over epochs runs in ``ops/kernels/ml_recurrence.q_learning``: on a
card one launch of the hand-written kernel, on the CPU the plain torch
loop, bit for bit alike. ``LinUCB`` is host numpy, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from neurondb_tpu_torch.ops.kernels import ml_recurrence as MR


def q_learning_fit(transitions, *, n_states: int, n_actions: int,
                   alpha: float = 0.1, gamma: float = 0.95,
                   epochs: int = 50) -> torch.Tensor:
    """Offline Q-learning over logged transitions [T, 4] =
    (state, action, reward, next_state). Returns Q [S, A]."""
    t = transitions.float()
    s = t[:, 0].to(torch.int32)
    a = t[:, 1].to(torch.int32)
    s2 = t[:, 3].to(torch.int32)
    Q0 = torch.zeros((n_states, n_actions), device=t.device)
    return MR.q_learning(s, a, t[:, 2].contiguous(), s2, Q0, alpha=alpha,
                         gamma=gamma, epochs=epochs)


def q_policy(Q) -> np.ndarray:
    """Greedy policy: state -> action."""
    return torch.argmax(Q, dim=1).cpu().numpy()


class LinUCB:
    """Contextual bandit (one ridge model per arm, UCB exploration)."""

    def __init__(self, n_arms: int, dim: int, alpha: float = 1.0,
                 l2: float = 1.0):
        self.n_arms = n_arms
        self.dim = dim
        self.alpha = alpha
        self.A = np.stack([np.eye(dim, dtype=np.float64) * l2
                           for _ in range(n_arms)])
        self.b = np.zeros((n_arms, dim))

    def select(self, context) -> int:
        x = np.asarray(context, np.float64).ravel()
        scores = np.empty(self.n_arms)
        for a in range(self.n_arms):
            Ainv = np.linalg.inv(self.A[a])
            theta = Ainv @ self.b[a]
            scores[a] = theta @ x + self.alpha * np.sqrt(x @ Ainv @ x)
        return int(np.argmax(scores))

    def update(self, arm: int, context, reward: float) -> None:
        x = np.asarray(context, np.float64).ravel()
        self.A[arm] += np.outer(x, x)
        self.b[arm] += reward * x
