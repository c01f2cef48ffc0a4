"""Nothing of the benchmark imports JAX or the JAX package (by whole
top-level module name), the reference imports nothing of the program, and
no file of the benchmark reads the JAX benchmark's files."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

import bench_tiny as T

FORBIDDEN = {"jax", "jaxlib", "flax", "neurondb_tpu"}
PROGRAM = "neurondb_tpu_torch"
YARDSTICK = ("benchlib/reference.py", "benchlib/check.py",
             "benchlib/counts.py", "benchlib/corpus.py")
SOURCES = sorted(p for p in T.BENCH_DIR.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(T.BENCH_DIR))
                              for p in SOURCES])
def test_no_jax_imports(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


def test_top_level_names_are_compared_whole():
    from benchlib import main
    assert "neurondb_tpu_torch".split(".", 1)[0] not in main.FORBIDDEN
    assert "neurondb_tpu.index".split(".", 1)[0] in main.FORBIDDEN


@pytest.mark.parametrize("rel", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(rel):
    assert PROGRAM not in set(_top_level_imports(T.BENCH_DIR / rel))


def test_no_file_reads_the_jax_benchmark():
    jax_files = ("bench" + ".py", "bench" + "_cache", "BENCH" + "_r")
    for path in SOURCES + sorted(T.BENCH_DIR.rglob("*.json")):
        text = path.read_text()
        assert not any(f in text for f in jax_files), path


def test_a_cpu_run_loads_no_jax(tmp_path):
    import sys
    root = T.make_root(tmp_path)
    T.run_cpu(root, "tiny-ivfflat.exact")
    assert not {m.split(".", 1)[0] for m in sys.modules} & FORBIDDEN
