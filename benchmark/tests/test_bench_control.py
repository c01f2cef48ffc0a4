"""The comparison fails what it must: the lower-precision control in the
program's place, and runs whose timed path is broken underneath (an
answer altered where it is produced, half of a batch left out, a batch
that never comes back). The small cells keep the full cells' rows per
centre and per list, and the shipped mixes' limits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bench_tiny as T
from benchlib import cells, check, corpus
from benchlib import main as M
from benchlib import reference as R


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return T.make_root(tmp_path_factory.mktemp("ctl"))


@pytest.mark.parametrize("cell", sorted(T.TINY_CELLS))
def test_fp8_control_fails_the_limits(root, cell):
    c = cells.Cell(root, cell)
    pool, sample = M.make_queries(c, 5, "cpu")
    x = corpus.corpus(c.config["corpus"], 5, "cpu")
    metric, k = c.config["metric"], int(c.traffic["k"])
    qs = np.concatenate([pool[s][sample[s]] for s in range(len(pool))])
    ans = check.control_answers(R.prepare(x, metric),
                                R.prepare(torch.from_numpy(qs), metric), k,
                                metric, "fp8")
    numbers, _ = M.compare(c, pool, sample, [], "cpu", x, answers=ans)
    ok, _ = check.verdict(numbers, c.traffic["limits"])
    assert not ok, numbers


def _alter_ids(out):
    d, i = out
    return d, i + 1


def _drop_half(out):
    d, i = out
    h = i.shape[0] // 2
    d, i = d.clone() if torch.is_tensor(d) else d.copy(), \
        i.clone() if torch.is_tensor(i) else i.copy()
    d[h:2 * h], i[h:2 * h] = d[:h], i[:h]
    return d, i


def _never(out):
    raise RuntimeError("no answer")


FAULTS = {"answer_altered": _alter_ids, "half_left_out": _drop_half,
          "never_answered": _never}
TARGETS = {"tiny-ivfflat.grouped": ("neurondb_tpu_torch.index.ivf",
                                    "IVFFlatIndex"),
           "tiny-ivfflat.grouped99": ("neurondb_tpu_torch.index.ivf",
                                      "IVFFlatIndex"),
           "tiny-ivfflat.exact": ("neurondb_tpu_torch.index.ivf",
                                  "IVFFlatIndex"),
           "tiny-hnsw.beam": ("neurondb_tpu_torch.index.hnsw", "HNSWIndex")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(T.TINY_CELLS))
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    import importlib
    mod, cls = TARGETS[cell]
    klass = getattr(importlib.import_module(mod), cls)
    search = klass.search
    calls = {"n": 0}

    def broken(self, *a, **kw):
        out = search(self, *a, **kw)
        calls["n"] += 1
        # set-up's warm-up searches pass; the window's are broken
        if calls["n"] <= int(cells.Cell(root, cell).traffic["pool"]):
            return out
        return FAULTS[fault](out)

    monkeypatch.setattr(klass, "search", broken)
    line, _, _ = T.run_cpu(root, cell, seconds=0.5)
    assert line["correct"] is False, line["checks"]
