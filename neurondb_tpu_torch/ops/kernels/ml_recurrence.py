"""Sequential ML recurrences: offline Q-learning and Holt-Winters.

Counterparts of two ``lax.scan`` loops of the JAX package, which no
Pallas kernel serves: ``q_learning_fit``'s scan over transitions inside
a ``fori_loop`` over epochs (``neurondb_tpu/ml/rl.py:33-41``) and
``holt_winters_fit``'s scan (``neurondb_tpu/ml/timeseries.py:62-74``).
Each step depends on the one before; a loop of torch ops on a card would
cost about ten launches a step. On a CUDA tensor each entry launches the
hand-written kernel ``csrc/ml_recurrence.cu`` once (one thread runs the
recurrence, its block stages the inputs); on a CPU tensor it runs the
plain torch loop beside it (``*_plain``). Both evaluate the JAX
package's expressions in its order in f32, with no fused multiply-add,
so they agree bit for bit. ``LAUNCHES`` counts the kernel's launches per
entry.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from neurondb_tpu_torch.ops.kernels import _build

LAUNCHES = {"q_learning": 0, "holt_winters": 0}


def _f32(v) -> float:
    return float(np.float32(v))


def _one_minus(v) -> float:
    """``1 - v`` in f32, as JAX computes it on a traced f32 scalar."""
    return float(np.float32(1.0) - np.float32(v))


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("ml_recurrence")
    q = lib.ml_q_learning
    q.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                  + [ctypes.c_int, ctypes.c_void_p])
    q.restype = ctypes.c_int
    hw = lib.ml_holt_winters
    hw.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    hw.restype = ctypes.c_int
    for name, n in (("ml_q_in_smem", 2), ("ml_ring_in_smem", 1)):
        f = getattr(lib, name)
        f.argtypes = [ctypes.c_int] * n
        f.restype = ctypes.c_int
    return lib


# ---- Q-learning ----

def q_learning_plain(s, a, r, s2, Q0, *, alpha: float, gamma: float,
                     epochs: int) -> torch.Tensor:
    """The plain loop: for each epoch, for each transition i in order,
    Q[s, a] = (1 - alpha) * Q[s, a] + alpha * (r + gamma * max Q[s2])."""
    Q = Q0.clone()
    dev = Q.device
    al = torch.tensor(_f32(alpha), device=dev)
    oma = torch.tensor(_one_minus(alpha), device=dev)
    ga = torch.tensor(_f32(gamma), device=dev)
    si, ai, s2i = s.tolist(), a.tolist(), s2.tolist()
    rr = list(r.unbind(0))
    for _ in range(epochs):
        for i in range(len(si)):
            target = rr[i] + ga * Q[s2i[i]].max()
            Q[si[i], ai[i]] = oma * Q[si[i], ai[i]] + al * target
    return Q


def _q_learning_cuda(s, a, r, s2, Q0, *, alpha, gamma, epochs):
    S, A = Q0.shape
    T = s.shape[0]
    Q = Q0.float().contiguous().clone()
    s, a, s2 = (t.to(torch.int32).contiguous() for t in (s, a, s2))
    r = r.float().contiguous()
    lib = _lib()
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        err = lib.ml_q_learning(s.data_ptr(), a.data_ptr(), r.data_ptr(),
                                s2.data_ptr(), Q.data_ptr(), T, S, A,
                                _f32(alpha), _one_minus(alpha), _f32(gamma),
                                int(epochs), stream)
    if err != 0:
        raise RuntimeError(f"ml_q_learning launch failed: CUDA error {err}")
    LAUNCHES["q_learning"] += 1
    return Q


def q_learning(s, a, r, s2, Q0, *, alpha: float, gamma: float,
               epochs: int) -> torch.Tensor:
    """s, a, s2 [T] int; r [T] f32; Q0 [S, A] f32. Returns Q after
    ``epochs`` passes over the transitions. CPU tensors take
    ``q_learning_plain``; CUDA tensors launch the kernel or raise."""
    devs = {t.device for t in (s, a, r, s2, Q0)}
    if len(devs) != 1:
        raise ValueError(f"q_learning inputs on several devices: {devs}")
    dev = Q0.device
    kw = dict(alpha=alpha, gamma=gamma, epochs=epochs)
    if dev.type == "cpu":
        return q_learning_plain(s, a, r, s2, Q0.float(), **kw)
    if dev.type == "cuda":
        return _q_learning_cuda(s, a, r, s2, Q0, **kw)
    raise ValueError(f"no q_learning for device {dev}")


# ---- Holt-Winters ----

HWState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def holt_winters_plain(y, level0, trend0, seas0, *, alpha: float,
                       beta: float, gamma: float) -> HWState:
    """The plain loop over y: returns (level, trend, seasonal [season] in
    its logical order, fitted [n])."""
    dev = y.device
    c = {k: torch.tensor(v, device=dev) for k, v in (
        ("a", _f32(alpha)), ("oma", _one_minus(alpha)),
        ("b", _f32(beta)), ("omb", _one_minus(beta)),
        ("g", _f32(gamma)), ("omg", _one_minus(gamma)))}
    level, trend = level0.float().clone(), trend0.float().clone()
    seas = list(seas0.float().unbind(0))
    season = len(seas)
    fitted = []
    head = 0
    for yt in y.float().unbind(0):
        s0 = seas[head]
        lt = level + trend
        new_level = c["a"] * (yt - s0) + c["oma"] * lt
        new_trend = c["b"] * (new_level - level) + c["omb"] * trend
        seas[head] = c["g"] * (yt - new_level) + c["omg"] * s0
        fitted.append(lt + s0)
        head = head + 1 if head + 1 < season else 0
        level, trend = new_level, new_trend
    ring = seas[head:] + seas[:head]
    return (level, trend, torch.stack(ring),
            torch.stack(fitted) if fitted else y.new_zeros((0,)))


def _holt_winters_cuda(y, level0, trend0, seas0, *, alpha, beta, gamma):
    y = y.float().contiguous()
    n = y.shape[0]
    season = seas0.shape[0]
    state = torch.stack([level0.float().reshape(()),
                         trend0.float().reshape(())]).contiguous()
    seas = seas0.float().contiguous().clone()
    fitted = torch.empty_like(y)
    lib = _lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.ml_holt_winters(
            y.data_ptr(), fitted.data_ptr(), state.data_ptr(),
            seas.data_ptr(), n, season, _f32(alpha), _one_minus(alpha),
            _f32(beta), _one_minus(beta), _f32(gamma), _one_minus(gamma),
            stream)
    if err != 0:
        raise RuntimeError(f"ml_holt_winters launch failed: CUDA error {err}")
    LAUNCHES["holt_winters"] += 1
    return state[0], state[1], seas, fitted


def holt_winters(y, level0, trend0, seas0, *, alpha: float, beta: float,
                 gamma: float) -> HWState:
    """Additive Holt-Winters over y [n] f32 from (level0, trend0, seas0
    [season]). CPU tensors take ``holt_winters_plain``; CUDA tensors
    launch the kernel or raise."""
    if seas0.shape[0] < 1:
        raise ValueError("season must be at least 1")
    devs = {t.device for t in (y, level0, trend0, seas0)}
    if len(devs) != 1:
        raise ValueError(f"holt_winters inputs on several devices: {devs}")
    dev = y.device
    kw = dict(alpha=alpha, beta=beta, gamma=gamma)
    if dev.type == "cpu":
        return holt_winters_plain(y, level0, trend0, seas0, **kw)
    if dev.type == "cuda":
        return _holt_winters_cuda(y, level0, trend0, seas0, **kw)
    raise ValueError(f"no holt_winters for device {dev}")
