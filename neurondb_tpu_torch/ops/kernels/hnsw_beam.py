"""HNSW beam search at one graph level as one CUDA kernel a sub-batch.

Counterpart of the JAX package's ``_beam_search`` ``lax.while_loop``
(``neurondb_tpu/index/hnsw.py:195``), which no Pallas kernel serves. One
launch of ``csrc/hnsw_beam.cu`` runs the whole walk of every row of a
sub-batch, one thread block a query, each looping to its own convergence;
the plain torch loop (``index/hnsw.py`` ``_beam_search_plain``) computes
the same answers in lockstep and serves CPU tensors and the shapes past
the kernel's limits. ``kernel_takes`` decides from the shapes alone;
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from neurondb_tpu_torch.ops.kernels import _build

LAUNCHES = 0

MAX_EF = 1024          # beam width
MAX_CAND = 256         # popped rows x degree: two slots a thread
MAX_DIM = 32_768       # the block's shared memory then stays under 156 KB
STORES = (torch.bfloat16, torch.float32)


def kernel_takes(device_type: str, *, rows: int, dim: int, ef: int,
                 expand: int, deg: int, entries: int, max_steps: int,
                 store_dtype: torch.dtype) -> bool:
    """Whether the kernel serves a beam search of this shape: a CUDA
    tensor, 1 <= ef <= 1024, E x deg <= 256, dim <= 32,768, 1 <= R <= ef,
    at least one step, a bf16 or f32 store."""
    return (device_type == "cuda" and rows >= 1 and 1 <= dim <= MAX_DIM
            and store_dtype in STORES and 1 <= ef <= MAX_EF
            and expand >= 1 and deg >= 1 and expand * deg <= MAX_CAND
            and 1 <= entries <= ef and max_steps >= 1)


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("hnsw_beam")
    f = lib.hnsw_beam_search
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong]
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5)
        f.restype = ctypes.c_int
    return lib


def beam_search(q, entry, vecs, sqnorms, nbr, rowmap: Optional[torch.Tensor],
                *, metric: str, ef: int, max_steps: int, expand: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The kernel on CUDA tensors of a shape ``kernel_takes`` (the caller
    asks it): q [B, D]; entry [B] or [B, R] local rows; vecs [Nv, D] bf16
    or f32; sqnorms [Nv]; nbr [Nc, deg] local adjacency (-1 pad); rowmap
    [Nc] local -> store row, or None (identity). Returns (dists [B, ef]
    f32, rows [B, ef] int64, fresh [B], steps [B] int32): the beam
    ascending, (FLT_MAX, -1) padded, and each row's fresh rows scored and
    steps run."""
    global LAUNCHES
    dev = q.device
    B, D = q.shape
    Nc, deg = nbr.shape
    if entry.ndim == 1:
        entry = entry[:, None]
    R = entry.shape[1]
    held = [entry, vecs, sqnorms, nbr] + ([] if rowmap is None else [rowmap])
    if dev.type != "cuda" or any(t.device != dev for t in held):
        raise ValueError(f"hnsw_beam takes no beam on {dev} (its inputs on "
                         f"{sorted({str(t.device) for t in held})})")
    if (entry.shape[0] != B or vecs.shape[1] != D
            or sqnorms.shape != vecs.shape[:1]
            or (rowmap is not None and rowmap.shape != (Nc,))):
        raise ValueError(f"hnsw_beam shapes disagree: q {tuple(q.shape)}, "
                         f"entry {tuple(entry.shape)}, vecs "
                         f"{tuple(vecs.shape)}, sqnorms "
                         f"{tuple(sqnorms.shape)}, nbr {tuple(nbr.shape)}")
    q = q.float().contiguous()
    entry = entry.to(torch.int32).contiguous()
    vecs = vecs.contiguous()
    sqnorms = sqnorms.float().contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    if rowmap is not None:
        rowmap = rowmap.to(torch.int32).contiguous()
    words = (Nc + 31) // 32
    visited = torch.zeros((B, words), dtype=torch.int32, device=dev)
    out_d = torch.empty((B, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, ef), dtype=torch.int64, device=dev)
    fresh = torch.empty(B, dtype=torch.int32, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev)
    vec4 = D % 4 == 0 and vecs.data_ptr() % 16 == 0
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hnsw_beam_search(
            q.data_ptr(), B, D, entry.data_ptr(), R, vecs.data_ptr(),
            int(vecs.dtype == torch.bfloat16), int(vec4), sqnorms.data_ptr(),
            nbr.data_ptr(), deg,
            rowmap.data_ptr() if rowmap is not None else None,
            visited.data_ptr(), words, ef, expand, max_steps,
            int(metric == "ip"),
            out_d.data_ptr(), out_i.data_ptr(), fresh.data_ptr(),
            steps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hnsw_beam launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out_d, out_i, fresh, steps
