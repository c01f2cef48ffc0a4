"""Parameter trees: the JAX package's layout, held as torch tensors.

The encoders keep the JAX package's parameter pytrees (nested dicts and
lists, the same keys and the same [in, out] weight orientation), so a
tree carried across from ``neurondb_tpu`` computes the same function in
both packages:

- ``params_from_jax(tree, device)``: a pytree of numpy (or JAX) arrays
  from ``init_encoder_params`` / ``init_bert_params`` /
  ``params_from_hf_state_dict`` (BERT, GPT-2, ViT; the ViT tree's int
  entries ``patch`` / ``image_size`` / ``channels`` stay ints) -> the
  same tree of f32 torch tensors;
- ``tree_map``: a function over every leaf;
- ``ParamTree``: an ``nn.Module`` holding a tree as non-trainable
  parameters (``.to(device)``, ``state_dict``), ``tree()`` giving it back.
  A tuple of tensors stays a tuple (the GPT decoder's int8 weights are
  ``(codes, scale)`` pairs, as in the JAX package).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over every leaf; dicts, lists and tuples keep their kind."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_jax(tree: Any, device=None) -> Any:
    """A JAX parameter pytree (numpy or JAX arrays) -> the same tree of
    f32 torch tensors on ``device``."""
    return tree_map(lambda a: a if isinstance(a, int) else
                    torch.tensor(np.array(a, np.float32), device=device), tree)


class ParamTree(nn.Module):
    """A parameter tree as an ``nn.Module``: dicts become submodules,
    lists ``nn.ModuleList``s, leaves frozen ``nn.Parameter``s."""

    def __init__(self, tree: Any):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, tuple):
                self.add_module(key, _Tuple(val))
            elif isinstance(val, list):
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


class _Tuple(nn.Module):
    """A tuple of tensors as frozen parameters ``0``, ``1``, ..."""

    def __init__(self, leaves):
        super().__init__()
        for i, t in enumerate(leaves):
            self.register_parameter(
                str(i), nn.Parameter(torch.as_tensor(t), requires_grad=False))

    def tree(self) -> tuple:
        return tuple(self._parameters.values())
