"""Build and load the hand-written CUDA kernels of this package.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``neurondb_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source, the shared headers and the flags, so an
edited source rebuilds; nvcc's output (ptxas registers and spills) is
kept beside it as ``.log``. The library is then loaded with ``ctypes``. A
missing ``nvcc`` or a failed compile raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build_log(name: str) -> str:
    """nvcc's output from the build of the current library ("" if it is
    not built)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str]) -> None:
    """Compile each named ``csrc/<name>.cu`` whose library is missing:
    one nvcc per source, all started together, all waited for."""
    with _lock:
        jobs = []
        for name in names:
            so = library_path(name)
            if name in _libs or so.exists():
                continue
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, so, tmp, proc in jobs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {name}.cu (exit "
                              f"{proc.returncode}):\n{out}")
            else:
                so.with_suffix(".log").write_text(out)
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))


def build_other(jobs: Sequence[Tuple[str, str, Sequence[str]]]
                ) -> List[str]:
    """Compile sources that are not the package's own (another version of
    a kernel, a stage cut) for a side-by-side comparison: each (source,
    library path, extra flags) with the package's nvcc flags, the source's
    directory before ``csrc/`` on the include path (so a header beside
    the source wins); one nvcc per source, all started together. Returns
    each build's nvcc output (ptxas lines), in order; a failed build
    raises."""
    nvcc = find_nvcc()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *flags, "-I", os.path.dirname(os.path.abspath(src)),
         "-I", str(CSRC), "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, so, flags in jobs]
    outs = [proc.communicate()[0] for proc in procs]
    failed = [f"nvcc failed on {src} {' '.join(flags)} (exit "
              f"{proc.returncode}):\n{out}"
              for (src, _, flags), proc, out in zip(jobs, procs, outs)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it.
    Once loaded, the library is returned without hashing its sources
    again: the wrappers call this on every launch."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
