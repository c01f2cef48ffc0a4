"""Build and load the hand-written CUDA kernels of this package.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``neurondb_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source
rebuilds. The library is then loaded with ``ctypes``. A missing ``nvcc``
or a failed compile raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}       # name -> nvcc output of the build


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of neurondb_tpu_torch are built from source at first "
        "use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    with _lock:
        if name in _libs:
            return _libs[name]
        so = library_path(name)
        if not so.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOG[name] = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}.cu "
                                   f"(exit {res.returncode}):\n"
                                   f"{BUILD_LOG[name]}")
            os.replace(tmp, so)
        _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]
