"""Corpus and query generation from the run's seed, on the run's device.

The clustered mixture is the pattern of the repository's JAX benchmark
(256 centres drawn from N(0, 1) and scaled by 2.0, each row its centre plus
unit Gaussian noise), rewritten in torch so that it runs on the card in a
few large calls. Queries are fresh draws from the same mixture (the same
centres, their own labels and noise), as SIFT1M's and GloVe's query sets
are held out from their base sets.

The mixture itself (its centres) belongs to the configuration: it comes
from the configuration's ``centres_seed`` and is the same in every run,
so that a run's seed draws another sample of one deployment's data (the
rows and the queries), not another deployment. Every stream comes from
its own ``torch.Generator`` seeded by ``stream_seed(seed, name)``, so the
corpus does not depend on how many queries were drawn, and a seed gives
the same data on every run.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

ROWS_PER_CALL = 1 << 20     # rows drawn per generator call


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the named stream of a run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(stream_seed(seed, name))
    return gen


def centres(spec: Dict, device) -> torch.Tensor:
    """The mixture's centres [n_centres, dim] f32, from the
    configuration's ``centres_seed``."""
    gen = generator(int(spec["centres_seed"]), "centres", device)
    c = torch.randn((int(spec["centres"]), int(spec["dim"])), generator=gen,
                    device=device)
    return c * float(spec["centre_scale"])


def draw(spec: Dict, seed: int, n: int, stream: str, device) -> torch.Tensor:
    """n rows [n, dim] f32 of the mixture: a uniform centre each, plus
    Gaussian noise of standard deviation ``spec["noise"]``."""
    c = centres(spec, device)
    gen = generator(seed, stream, device)
    out = torch.empty((n, c.shape[1]), dtype=torch.float32, device=device)
    for s in range(0, n, ROWS_PER_CALL):
        e = min(s + ROWS_PER_CALL, n)
        lab = torch.randint(0, c.shape[0], (e - s,), generator=gen,
                            device=device)
        torch.randn((e - s, c.shape[1]), generator=gen, device=device,
                    out=out[s:e])
        out[s:e].mul_(float(spec["noise"])).add_(c[lab])
    return out


def corpus(spec: Dict, seed: int, device) -> torch.Tensor:
    """The base rows [rows, dim] f32."""
    return draw(spec, seed, int(spec["rows"]), "corpus", device)


def queries(spec: Dict, seed: int, n: int, device) -> torch.Tensor:
    """n held-out query rows [n, dim] f32."""
    return draw(spec, seed, n, "queries", device)
