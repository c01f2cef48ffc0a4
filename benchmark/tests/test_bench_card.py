"""On the card, at the cells' own sizes: each cell's run comes out
correct, and the fp8 control in the program's place does not.

    python -m pytest benchmark/tests -m cuda -q

(on a machine with an NVIDIA card; the tests skip on one without).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_tiny as T

CELLS = [w["name"] for w in json.loads(
    (T.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "2",
                        "--trace", "0"], cwd=T.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_is_not_correct(card, cell):
    from benchlib import cells, check, corpus
    from benchlib import main as M
    from benchlib import reference as R
    c = cells.Cell(T.ROOT, cell)
    pool, sample = M.make_queries(c, 3, "cuda")
    x = corpus.corpus(c.config["corpus"], 3, "cuda")
    metric, k = c.config["metric"], int(c.traffic["k"])
    qs = np.concatenate([pool[s][sample[s]] for s in range(len(pool))])
    ans = check.control_answers(R.prepare(x, metric),
                                R.prepare(torch.as_tensor(qs, device="cuda"),
                                          metric), k, metric, "fp8")
    numbers, _ = M.compare(c, pool, sample, [], "cuda", x, answers=ans)
    assert not check.verdict(numbers, c.traffic["limits"])[0], numbers
