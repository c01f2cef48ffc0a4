"""The torch port stands alone: no JAX, no neurondb_tpu, no fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neurondb_tpu_torch.ops.kernels import _build
from neurondb_tpu_torch.ops.kernels import flash_attention as FA
from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "neurondb_tpu_torch"


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "neurondb_tpu"
            or name.startswith("neurondb_tpu."))


def test_import_leaves_jax_out():
    """Importing the package and every module in it loads neither jax nor
    the JAX package (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import neurondb_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'neurondb_tpu' or "
        "m.startswith('neurondb_tpu.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_jax_import_in_source():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (f, names)


@pytest.fixture()
def no_nvcc(tmp_path, monkeypatch):
    """A machine without the CUDA toolkit and without a built library."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})


def test_loader_raises_without_nvcc(no_nvcc):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("ivf_scan_grouped")


def test_kernel_wrapper_raises_instead_of_falling_back(no_nvcc):
    """The CUDA branch of the dispatch builds its kernel or raises; it
    never runs the plain version."""
    before = G.LAUNCHES
    qpad = torch.zeros((16, 8), dtype=torch.float32)
    vecs = torch.zeros((64, 8), dtype=torch.float32)
    toff = torch.zeros(1, dtype=torch.int32)
    tcnt = torch.ones(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc"):
        G._grouped_scan_cuda(qpad, vecs, toff, tcnt, kp=8, qt=16,
                             metric="sqeuclidean")
    assert G.LAUNCHES == before


def test_cpu_tensors_never_launch():
    rng = np.random.default_rng(0)
    vecs = torch.as_tensor(rng.standard_normal((2048, 16)).astype(np.float32))
    offsets = torch.tensor([0, 512, 1024], dtype=torch.int32)
    counts = torch.tensor([500, 300, 1000], dtype=torch.int32)
    q = torch.as_tensor(rng.standard_normal((20, 16)).astype(np.float32))
    probes = torch.tensor([[0, 2, 3]] * 20, dtype=torch.int32)
    before = G.LAUNCHES
    d, rows = G.ivf_grouped_search(q, probes, vecs, offsets, counts, k=5)
    assert G.LAUNCHES == before == 0
    assert d.device.type == "cpu" and rows.shape == (20, 5)


def test_grouped_scan_rejects_mixed_devices():
    meta = torch.empty(1, device="meta")
    cpu = torch.zeros(1)
    with pytest.raises(ValueError, match="several devices"):
        G.grouped_probe_scan(cpu, meta, cpu, cpu, kp=8)


def test_new_modules_import_without_jax():
    """The IVF-PQ slice's modules load in a fresh interpreter where jax
    and the JAX package cannot be imported at all."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'neurondb_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import neurondb_tpu_torch as nt\n"
        "from neurondb_tpu_torch.index import pq, ivfpq\n"
        "from neurondb_tpu_torch.ops.kernels import ivfpq_scan\n"
        "print(nt.PQIndex.__name__, nt.IVFPQIndex.__name__)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["PQIndex", "IVFPQIndex"]


def test_pq_kernel_wrapper_raises_instead_of_falling_back(no_nvcc):
    before = PQS.LAUNCHES
    lut = torch.zeros((16, 8 * 256))
    codes = torch.zeros((8, 2048), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc"):
        PQS._grouped_pq_scan_cuda(lut, codes, one, one + 5, kp=8, qt=16,
                                  pos_bits=0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["ivf_scan_grouped", "ivfpq_scan"])
    assert PQS.LAUNCHES == before


def test_build_log_survives_a_cached_build(tmp_path, monkeypatch):
    """nvcc's output is kept beside the library: a later build that finds
    the library compiles nothing and still reads the ptxas lines."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(f'#!/bin/sh\necho x >> "{calls}"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n: > "$2"\n'
                    'echo "ptxas info    : Used 40 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.build_log("ivfpq_scan") == ""
    _build.build(["ivfpq_scan"])
    _build.build(["ivfpq_scan"])
    assert _build.library_path("ivfpq_scan").exists()
    assert calls.read_text() == "x\n"
    assert "Used 40 registers" in _build.build_log("ivfpq_scan")


def test_build_other_uses_package_flags_and_own_headers_first(tmp_path,
                                                             monkeypatch):
    """Another source (an A/B script's) builds with the package's nvcc
    flags and its extra ones, its own directory before csrc/ on the
    include path; all start together, each build's output comes back in
    order, and a failed build raises naming its source."""
    log = tmp_path / "argv"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> "{log}"\n'
                    'case "$*" in *bad.cu*) echo broken; exit 2;; esac\n'
                    'while [ "$1" != "-o" ]; do shift; done\n: > "$2"\n'
                    'echo "ptxas info    : Used 7 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(nvcc.parent))
    other = tmp_path / "old" / "k.cu"
    other.parent.mkdir()
    other.write_text("// kernel\n")
    jobs = [(str(other), str(tmp_path / "a.so"), ()),
            (str(other), str(tmp_path / "b.so"), ("-DCUT=1",))]
    outs = _build.build_other(jobs)
    assert outs == ["ptxas info    : Used 7 registers\n"] * 2
    assert (tmp_path / "a.so").exists() and (tmp_path / "b.so").exists()
    lines = log.read_text().splitlines()
    assert sorted("-DCUT=1" in ln for ln in lines) == [False, True]
    for ln in lines:
        assert " ".join(_build.NVCC_FLAGS) in ln
        assert ln.index(f"-I {other.parent}") < ln.index(f"-I {_build.CSRC}")
    bad = tmp_path / "bad.cu"
    bad.write_text("// broken\n")
    with pytest.raises(RuntimeError, match="bad.cu"):
        _build.build_other([(str(bad), str(tmp_path / "c.so"), ())])


@pytest.mark.parametrize("bf16", [True, False])
def test_grouped_sources_share_one_c_entry(bf16):
    """One source serves both stores: one library (one nvcc build) whose
    two C entries take the store as an argument, with the bf16 store's
    products by bf16 mma.sync and the f32 store's by 3xTF32 mma.sync; the
    wrapper passes the store through to the shared-memory sizing."""
    assert G.SOURCES == ("ivf_scan_grouped",)
    assert not (_build.CSRC / "ivf_scan_grouped_f32.cu").exists()
    src = (_build.CSRC / f"{G.SOURCES[0]}.cu").read_text()
    for entry in ("long long ivf_grouped_scan_smem_bytes(int qs, int D, "
                  "int kp, int mode,", "int ivf_grouped_scan(const void* qpad,"):
        assert entry in src
    for call in (("ndb::mma_bf16(",) if bf16 else
                 ("ndb::split_tf32(", "ndb::mma_tf32(")):
        assert call in src
    seen = []

    class Lib:
        def ivf_grouped_scan_smem_bytes(self, qs, D, kp, mode, store_bf16):
            seen.append(store_bf16)
            return G.SMEM_MAX + 1 if qs > 16 else G.SMEM_MAX
    assert G._pick_qs(Lib(), 64, 128, 10, 0, bf16) == 16
    assert set(seen) == {int(bf16)}


def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared header (csrc/*.cuh) renames every library, so
    a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    (csrc / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path("k")
    (csrc / "h.cuh").write_text("// header, edited\n")
    assert _build.library_path("k") != first


def test_rerank_slice_imports_without_jax():
    """The encoder/rerank slice's modules load where jax and the JAX
    package cannot be imported, and importing them loads neither."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'neurondb_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import neurondb_tpu_torch.ml.transformer, neurondb_tpu_torch.search.rerank\n"
        "from neurondb_tpu_torch.ml import bert, params, tokenizer\n"
        "from neurondb_tpu_torch.search import bm25\n"
        "from neurondb_tpu_torch.ops.kernels import flash_attention\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'neurondb_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_flash_wrapper_raises_instead_of_falling_back(no_nvcc):
    """The CUDA branch builds csrc/flash_attention.cu or raises; it never
    runs the plain version."""
    before = dict(FA.LAUNCHES)
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(RuntimeError, match="nvcc"):
        FA._flash_attention_cuda(q, q, q, None, bf16=True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_attention"])
    assert FA.LAUNCHES == before


def test_flash_wrapper_rejects_other_head_widths():
    q = torch.zeros((1, 2, 8, 48))
    with pytest.raises(ValueError, match="head widths"):
        FA._flash_attention_cuda(q, q, q, None, bf16=True)
    with pytest.raises(ValueError, match="mask"):
        FA._flash_attention_cuda(torch.zeros((1, 2, 8, 64)),
                                 torch.zeros((1, 2, 8, 64)),
                                 torch.zeros((1, 2, 8, 64)),
                                 torch.ones((2, 8)), bf16=True)
    meta = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="several devices"):
        FA.flash_attention(meta, q, q)


def test_cpu_tensors_never_launch_flash():
    """The encoders on the CPU, with use_flash on, take the plain version."""
    from neurondb_tpu_torch.ml.transformer import CrossEncoder, TextEmbedder
    before = dict(FA.LAUNCHES)
    ce = CrossEncoder(dim=64, max_len=16, use_flash=True, device="cpu")
    scores = ce("a query", ["one doc", "another doc", "third"], batch=2)
    emb = TextEmbedder(dim=64, max_len=16, use_flash=True, device="cpu")
    assert emb(["text"]).shape == (1, 64) and scores.shape == (3,)
    assert FA.LAUNCHES == before == {"bf16": 0, "f32": 0}


def test_probe_scan_module_imports_without_jax():
    """The probe route's modules load where jax and the JAX package
    cannot be imported, and importing them loads neither."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'neurondb_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from neurondb_tpu_torch.ops.kernels import ivf_scan\n"
        "from neurondb_tpu_torch.index.ivf import _ivf_search_probe\n"
        "print(ivf_scan.SEG, sorted(m for m in sys.modules if "
        "m.split('.')[0] in ('jax', 'neurondb_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "512 []"


def test_probe_wrapper_raises_instead_of_falling_back(no_nvcc):
    """The CUDA branch builds csrc/ivf_probe_scan.cu or raises; it never
    runs the plain version."""
    before = PS.LAUNCHES
    q = torch.zeros((4, 8))
    vecs = torch.zeros((1024, 8))
    poff = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc"):
        PS._probe_scan_cuda(q, vecs, poff, poff + 5, kp=8, max_segs=1,
                            metric="sqeuclidean")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["ivf_probe_scan"])
    assert PS.LAUNCHES == before


def test_probe_wrapper_checks_its_inputs():
    q = torch.zeros((4, 8))
    vecs = torch.zeros((1024, 8))
    poff = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="kp"):
        PS._probe_scan_cuda(q, vecs, poff, poff, kp=513, max_segs=1,
                            metric="ip")
    with pytest.raises(ValueError, match="int32"):
        PS._probe_scan_cuda(q, vecs, poff.long(), poff, kp=8, max_segs=1,
                            metric="ip")
    with pytest.raises(ValueError, match="f32"):
        PS._probe_scan_cuda(q.double(), vecs, poff, poff, kp=8, max_segs=1,
                            metric="ip")
    meta = torch.empty((1024, 8), device="meta")
    with pytest.raises(ValueError, match="several devices"):
        PS.probe_scan(q, meta, poff, poff, kp=8, max_segs=1)
    with pytest.raises(ValueError, match="metric"):
        PS.probe_scan(q, vecs, poff, poff, kp=8, max_segs=1, metric="l2")


def test_cpu_tensors_never_launch_probe_scan():
    rng = np.random.default_rng(0)
    vecs = torch.as_tensor(rng.standard_normal((2048, 16)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((20, 16)).astype(np.float32))
    poff = torch.tensor([[0, 512, 1024]] * 20, dtype=torch.int32)
    pcnt = torch.tensor([[500, 0, 1000]] * 20, dtype=torch.int32)
    before = PS.LAUNCHES
    d, rows = PS.ivf_probe_scan(q, None, vecs, poff, pcnt, k=5, max_segs=2)
    assert PS.LAUNCHES == before == 0
    assert d.device.type == "cpu" and rows.shape == (20, 5)


def test_hnsw_imports_without_jax():
    """The HNSW module loads where jax and the JAX package cannot be
    imported (blocked from sys.modules' finders), and loads neither."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'neurondb_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from neurondb_tpu_torch.index import hnsw\n"
        "from neurondb_tpu_torch import HNSWIndex\n"
        "assert HNSWIndex is hnsw.HNSWIndex\n"
        "print(hnsw.EXACT_KNN_MAX_ROWS, sorted(m for m in sys.modules if "
        "m.split('.')[0] in ('jax', 'neurondb_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "20000 []"


def test_search_slice_imports_without_jax():
    """The quantized-flat and BM25/hybrid slice loads where jax and the
    JAX package (its native library included) cannot be imported, and
    loads neither; the package exports the JAX ``__init__``'s names."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'neurondb_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import neurondb_tpu_torch as nt\n"
        "from neurondb_tpu_torch.types import quantized, sparse\n"
        "from neurondb_tpu_torch.search import (bm25, hybrid, planner,\n"
        "                                       sparse_search)\n"
        "from neurondb_tpu_torch import client\n"
        "names = ['QuantizedFlatIndex', 'topk_smallest', 'merge_topk',\n"
        "         'l1_distance', 'hamming_distance', 'chebyshev_distance',\n"
        "         'minkowski_distance', 'jaccard_distance', 'pairwise_distance']\n"
        "assert all(n in nt.__all__ and hasattr(nt, n) for n in names)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'neurondb_tpu') or 'ndbnative' in m))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_parallel_slice_imports_without_jax():
    """The sharding modules load where jax and the JAX package cannot be
    imported, and load neither; the subpackage exports the JAX
    ``neurondb_tpu.parallel``'s names."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'neurondb_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import neurondb_tpu_torch.parallel as par\n"
        "from neurondb_tpu_torch.parallel import (mesh, multihost, sharded,\n"
        "                                         sharded_hnsw, sharded_ivfpq)\n"
        "names = ['make_mesh', 'local_mesh', 'sharded_knn',\n"
        "         'sharded_kmeans_step', 'ShardedFlatIndex', 'ShardedIVFIndex',\n"
        "         'ShardedHNSWIndex', 'ShardedIVFPQIndex', 'MultiHostFlatIndex',\n"
        "         'MultiHostIVFIndex', 'kmeans_fit_2d', 'knn_2d', 'make_mesh_2d']\n"
        "assert all(hasattr(par, n) for n in names)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'neurondb_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_generate_slice_imports_without_jax():
    """GPT decode, BPE, ViT, the LLM router, the embedding service and
    RAG load where jax and the JAX package cannot be imported, and load
    neither; the service package exports the JAX one's names."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'neurondb_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from neurondb_tpu_torch.ml import bpe, gpt, vision\n"
        "from neurondb_tpu_torch.service import llm, embeddings\n"
        "from neurondb_tpu_torch.search import rag\n"
        "import neurondb_tpu_torch.service as svc\n"
        "assert svc.LLMRouter and svc.LLMCache and svc.EmbeddingService\n"
        "from neurondb_tpu_torch.client import Client\n"
        "c = Client(device='cpu')\n"
        "assert c.llm.complete('a. b.').startswith('[extractive-local]')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'neurondb_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_gpt_int8_matmul_pads_for_int_mm(monkeypatch):
    """The card's W8A8 product: ``torch._int_mm`` on operands padded to
    more than 16 rows and to a depth and width that are multiples of 8,
    the int32 sums exact (here ``_int_mm`` runs on CPU tensors); CPU
    tensors take the plain f64 sums and never ``_int_mm``."""
    from neurondb_tpu_torch.ml import gpt
    seen = []
    int_mm = torch._int_mm

    def recording(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", recording)
    g = torch.Generator().manual_seed(0)
    for M, K, N, want in ((3, 20, 13, ((32, 24), (24, 16))),
                          (40, 768, 2304, ((40, 768), (768, 2304))),
                          (16, 768, 50257, ((32, 768), (768, 50264)))):
        xq = torch.randint(-127, 128, (M, K), generator=g).to(torch.int8)
        wq = torch.randint(-127, 128, (K, N), generator=g).to(torch.int8)
        seen.clear()
        got = gpt._int_mm_padded(xq, wq)
        assert seen == [want] and got.shape == (M, N)
        assert torch.equal(got, gpt.int8_matmul_plain(xq, wq))
        seen.clear()
        assert torch.equal(gpt.int8_matmul(xq, wq), got) and seen == []


def test_store_and_ml_slice_imports_without_jax():
    """The store, the specialty indexes, validate, tuning, vector ops, the
    graph and exotic types and the ML runtime (every family, the
    recurrence kernel's wrapper) load where jax and the JAX package cannot
    be imported, and load neither; the package exports the JAX
    ``__init__``'s store and specialty names, and the API registers all 27
    of the JAX package's algorithms without them."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'neurondb_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import neurondb_tpu_torch as nt\n"
        "from neurondb_tpu_torch import store\n"
        "from neurondb_tpu_torch.index import specialty, tuning, validate\n"
        "from neurondb_tpu_torch.ops import vector_ops\n"
        "from neurondb_tpu_torch.types import exotic, graph\n"
        "from neurondb_tpu_torch.ml import (algorithms, api, cluster_extra,\n"
        "                                   gmm, linear, metrics, neighbors,\n"
        "                                   pca, registry, trees, boosting,\n"
        "                                   timeseries, recommender, neural,\n"
        "                                   rl, drift, mlops, automl, extras,\n"
        "                                   gnn)\n"
        "from neurondb_tpu_torch.ops.kernels import ml_recurrence\n"
        "names = ['VectorStore', 'RerankReadyIndex', 'ConsistentIndex']\n"
        "assert all(n in nt.__all__ and hasattr(nt, n) for n in names)\n"
        "assert len(api.list_algorithms()) == 27\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'neurondb_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_recurrence_kernel_wrapper_raises_instead_of_falling_back(no_nvcc):
    """The ML recurrences' CUDA branch builds csrc/ml_recurrence.cu or
    raises; it never runs the plain loop (CPU tensors do)."""
    from neurondb_tpu_torch.ops.kernels import ml_recurrence as MREC
    before = dict(MREC.LAUNCHES)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc"):
        MREC._q_learning_cuda(idx, idx, torch.zeros(3), idx,
                              torch.zeros((2, 2)), alpha=0.1, gamma=0.9,
                              epochs=1)
    with pytest.raises(RuntimeError, match="nvcc"):
        MREC._holt_winters_cuda(torch.zeros(30), torch.zeros(()),
                                torch.zeros(()), torch.zeros(12),
                                alpha=0.3, beta=0.1, gamma=0.1)
    assert MREC.LAUNCHES == before
    Q = MREC.q_learning(idx, idx, torch.ones(3), idx, torch.zeros((2, 2)),
                        alpha=0.1, gamma=0.9, epochs=1)
    assert Q.device.type == "cpu" and MREC.LAUNCHES == before
    with pytest.raises(ValueError, match="several devices"):
        MREC.q_learning(idx, idx, torch.ones(3, device="meta"), idx,
                        torch.zeros((2, 2)), alpha=0.1, gamma=0.9, epochs=1)


SERVICE_MODULES = (
    "utils", "utils.tracing", "utils.safeeval", "service.metrics",
    "service.batcher", "service.agent", "service.websocket", "service.rest",
    "service.mcp_middleware", "service.mcp", "service.mcp_tools_extra",
    "service.tenant", "service.workers", "service.data_management",
    "service.onnx_runtime", "__main__")

_BLOCK_JAX = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'neurondb_tpu'):\n"
    "            raise ImportError(name)\n"
    "sys.meta_path.insert(0, Block())\n")


def test_service_layer_imports_without_jax():
    """The service layer's modules (a counterpart of each of the JAX
    package's) are among those the walk above imports, and each loads in
    a fresh interpreter where jax and the JAX package cannot be
    imported."""
    import pkgutil
    import neurondb_tpu_torch as p
    walked = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                    p.__name__ + ".")}
    want = {f"neurondb_tpu_torch.{m}" for m in SERVICE_MODULES}
    assert want <= walked, want - walked
    for m in SERVICE_MODULES:
        assert (PKG / (m.replace(".", "/") + ".py")).exists() or \
            (PKG / m / "__init__.py").exists()
    code = _BLOCK_JAX + (
        "import importlib\n"
        f"for m in {SERVICE_MODULES!r}:\n"
        "    importlib.import_module('neurondb_tpu_torch.' + m)\n"
        "from neurondb_tpu_torch.service.mcp import MCPServer\n"
        "print(len(MCPServer()._tools))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["86"]


def _cli(args):
    code = _BLOCK_JAX + (
        "import runpy\n"
        f"sys.argv = ['neurondb_tpu_torch'] + {args!r}\n"
        "runpy.run_module('neurondb_tpu_torch', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_cli_config_and_algorithms_without_jax():
    import json
    from neurondb_tpu_torch.ml.api import list_algorithms
    out = _cli(["config"])
    assert out.returncode == 0, out.stderr
    cfg = json.loads(out.stdout)
    assert cfg["device"] == "cuda" and cfg["prometheus_port"] == 9187
    out = _cli(["algorithms"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == list_algorithms()


def test_cli_devices_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _cli(["devices"])
    assert out.returncode != 0
    assert out.stdout == "" and "no CUDA device" in out.stderr
