"""Parameter trees: the JAX package's layout, held as torch tensors.

The encoders keep the JAX package's parameter pytrees (nested dicts and
lists, the same keys and the same [in, out] weight orientation), so a
tree carried across from ``neurondb_tpu`` computes the same function in
both packages:

- ``params_from_jax(tree, device)``: a pytree of numpy (or JAX) arrays
  from ``init_encoder_params`` / ``init_bert_params`` /
  ``params_from_hf_state_dict`` -> the same tree of f32 torch tensors;
- ``tree_map``: a function over every leaf;
- ``ParamTree``: an ``nn.Module`` holding a tree as non-trainable
  parameters (``.to(device)``, ``state_dict``), ``tree()`` giving it back.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree: Any, device=None) -> Any:
    """A JAX parameter pytree (numpy or JAX arrays) -> the same tree of
    f32 torch tensors on ``device``."""
    return tree_map(lambda a: torch.tensor(np.array(a, np.float32),
                                           device=device), tree)


class ParamTree(nn.Module):
    """A parameter tree as an ``nn.Module``: dicts become submodules,
    lists ``nn.ModuleList``s, leaves frozen ``nn.Parameter``s."""

    def __init__(self, tree: Any):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(torch.as_tensor(val), requires_grad=False))

    def tree(self) -> dict:
        out = {name: p for name, p in self._parameters.items()}
        for name, mod in self._modules.items():
            out[name] = ([m.tree() for m in mod] if isinstance(mod, nn.ModuleList)
                         else mod.tree())
        return out
