"""Device meshes and the collectives of the sharded indexes.

Counterpart of ``neurondb_tpu/parallel/mesh.py``. The JAX package shards
under one controller: a ``jax.sharding.Mesh`` of devices, one
``shard_map`` program per search, ``all_gather`` and ``psum`` between
the shards. The port keeps that single-controller design as a mesh of
torch devices in one process:

- each shard's tensors live on the shard's device (per-shard lists of
  tensors take the place of the JAX package's sharded global arrays);
- the host launches each shard's work in turn; the work is queued on the
  shard's device and nothing waits for it;
- the collectives are explicit gathers to one device, in the mesh's
  fixed shard order: ``merge_shards`` (the JAX package's
  ``multihost._merge_axis``) and ``psum``. Both reduce the mesh's last
  axis first, onto the first device of each of its rows, then the next
  axis: on a ``("dcn", "ici")`` mesh the ICI merge inside each host row,
  then the DCN merge onto the lead device.

On CUDA, shard s sits on ``cuda:{s % torch.cuda.device_count()}``: on one
card every shard is a logical shard of ``cuda:0``, as the JAX tests put 8
virtual devices on one CPU, and on four cards each shard has a card.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device
from neurondb_tpu_torch.ops import topk as TK


class Mesh:
    """A grid of torch devices with named axes: ``devices`` (an object
    array, one ``torch.device`` per shard), ``axis_names`` and ``shape``
    (``mesh.shape["shard"]``, as in JAX). Shards are numbered in the
    grid's row-major order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"a mesh of shape {grid.shape} cannot take "
                             f"the axes {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device that collectives end on."""
        return self.devices.flat[0]

    def shard_devices(self) -> List[torch.device]:
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def _devices(n: Optional[int], device) -> List[torch.device]:
    """``n`` shard devices: on CUDA one per visible card in turn (``n``
    defaults to the number of cards), on the CPU ``n`` (required) shards
    of the one CPU device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("a CUDA mesh needs a card and none is "
                               "visible; pass device='cpu' for a CPU mesh")
        n = count if n is None else n
        if dev.index is not None:
            return [dev] * n
        return [torch.device("cuda", s % count) for s in range(n)]
    if n is None:
        raise ValueError(f"a {dev.type} mesh needs its shard count")
    return [dev] * n


def make_mesh(n_devices: Optional[int] = None, *, device=None,
              axis: str = "shard") -> Mesh:
    """1-D mesh of ``n_devices`` shards. ``device`` defaults to
    ``config.device`` (``"cuda"``): shard s on ``cuda:{s % cards}``,
    ``n_devices`` defaulting to the visible cards; it raises without a
    card. ``device="cpu"`` needs ``n_devices``; ``"cuda:N"`` puts every
    shard on card N."""
    return Mesh(_devices(n_devices, device), (axis,))


def local_mesh(axes: Sequence[Tuple[str, int]], *, device=None) -> Mesh:
    """N-D mesh, e.g. ``local_mesh([("data", 4), ("model", 2)])``."""
    shape = tuple(n for _, n in axes)
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = _devices(int(np.prod(shape)), device)
    return Mesh(devs.reshape(shape), tuple(a for a, _ in axes))


def as_tensor(a) -> torch.Tensor:
    """A tensor as is; an array as a tensor over its memory (copied when
    read-only, as an array of a JAX index's state is)."""
    if torch.is_tensor(a):
        return a
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def shard_rows(mesh: Mesh, arr) -> List[torch.Tensor]:
    """[N, ...] -> one tensor per shard on its device: contiguous blocks
    of ceil(N / shards) rows in shard order (the last ones shorter), the
    rows ``NamedSharding(mesh, P(axis))`` gives each device of a padded
    array; the padding itself is not kept."""
    t = as_tensor(arr)
    per = -(-t.shape[0] // mesh.size)
    return [t[s * per:(s + 1) * per].to(dev)
            for s, dev in enumerate(mesh.shard_devices())]


def replicate(mesh: Mesh, arr) -> List[torch.Tensor]:
    """One copy per shard (shards on one device share it)."""
    return per_device(as_tensor(arr), mesh.shard_devices())


def per_device(t: torch.Tensor, devices: Sequence[torch.device]
               ) -> List[torch.Tensor]:
    """``t`` on each of ``devices``, copied once per distinct device."""
    copies: Dict[torch.device, torch.Tensor] = {}
    return [copies.setdefault(d, t.to(d)) for d in devices]


def _reduce(mesh: Mesh, parts: Sequence,
            combine: Callable[[Sequence, torch.device], object]):
    """Reduce per-shard ``parts`` (shard order) along the mesh's axes,
    last axis first: each row of the axis is combined onto the row's
    first device, in the axis' fixed order; the last combine ends on the
    lead device."""
    devs = mesh.devices
    parts = list(parts)
    for _ in range(devs.ndim):
        width = devs.shape[-1]
        devs = devs[..., 0]               # the rows' first devices
        parts = [combine(parts[j * width:(j + 1) * width], d)
                 for j, d in enumerate(devs.flat)]
    return parts[0]


def _merge(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
           device: torch.device, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    gd = torch.cat([d.to(device) for d, _ in parts], dim=1)
    gi = torch.cat([i.to(device) for _, i in parts], dim=1)
    vals, pos = TK.topk_smallest(gd, min(k, gd.shape[1]))
    return vals, torch.gather(gi, 1, pos)


def merge_shards(mesh: Mesh, dists: Sequence[torch.Tensor],
                 ids: Sequence[torch.Tensor], k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-shard top-k merge (``multihost._merge_axis`` of the JAX
    package, over every axis of the mesh): each shard's partial
    (dists [B, kk], ids [B, kk]), in shard order, gathered onto one
    device shard-major into [B, S * kk] and reselected by
    ``topk_smallest``, whose ties go to the lower gathered position (the
    lower shard, then the lower column), as ``lax.top_k`` orders them and
    ``merge_distributed_results`` (distributed.c:320) merges. Returns
    (dists, ids) [B, min(k, S * kk)] on the lead device."""
    return _reduce(mesh, list(zip(dists, ids)),
                   lambda parts, device: _merge(parts, device, k))


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of the shards' tensors (``lax.psum`` over every axis), added
    in the mesh's fixed order onto the lead device."""
    def add(ps, device):
        return functools.reduce(torch.add, [p.to(device) for p in ps])
    return _reduce(mesh, parts, add)
