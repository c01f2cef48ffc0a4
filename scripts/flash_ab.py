#!/usr/bin/env python3
"""A/B of two sources of the port's flash-attention kernel on one card.

    git show <commit>:neurondb_tpu_torch/csrc/flash_attention.cu > _archive/other.cu
    python3 scripts/flash_ab.py _archive/other.cu

Builds ``neurondb_tpu_torch/csrc/flash_attention.cu`` (through the
package's build helper) and the other source (same ``flash_attention_fwd``
interface, same nvcc flags) side by side, prints both builds' ptxas
registers and spills per instantiation, and for each product mode (bf16,
f32) prints the max |difference| of the two kernels' outputs over Dh
32/64/128, S 1-1900, ragged mask and none (bf16: 0 where both keep the
same rounding; f32: not 0, as sums reorder), then times both kernels and
``scaled_dot_product_attention`` (bf16: on bf16 casts; f32: on the f32
inputs) in alternating turns in this one process at the three shapes of
``chip_smoke.FLASH_SHAPES``, launched straight through ctypes (no
wrapper work is timed). It also times what a launch through the wrapper
pays on the host to find its library: the source hash of
``_build.library_path`` (which the wrappers paid on every launch before
``load_library`` returned loaded libraries first) and the cached lookup.
Needs one CUDA card and nvcc; exits non-zero without them.
"""

import ctypes
import os
import sys
import tempfile
import timeit

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

TURNS, REPS = 9, 10


def main(argv):
    if len(argv) != 1:
        raise SystemExit(__doc__)
    import torch
    import torch.nn.functional as F
    from neurondb_tpu_torch.ops.kernels import _build
    from neurondb_tpu_torch.ops.kernels import flash_attention as FA
    smi = CS.phase_device()
    other_src = os.path.abspath(argv[0])
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libother.so")
        other_log = _build.build_other([(other_src, so, ())])[0]
        other = ctypes.CDLL(so)
        tree = FA._lib()
        f = other.flash_attention_fwd
        f.argtypes, f.restype = tree.flash_attention_fwd.argtypes, ctypes.c_int
        logs = {"tree": _build.build_log("flash_attention"),
                "other": other_log}
        for name, log in logs.items():
            regs = CS._flash_ptxas(log)
            print(f"[ab] {name} ptxas: " + ", ".join(
                f"{mode} Dh {dh} {'mask' if m else 'no mask'} {r} registers / "
                f"{sp} B spilled" for (mode, dh, m), (r, sp) in sorted(regs.items())))

        dev = torch.device("cuda")

        def bind(q, k, v, mask, bf16):
            """The output and the C arguments of one launch."""
            B, H, S, dh = q.shape
            out = torch.empty((B, S, H, dh), device=dev).permute(0, 2, 1, 3)
            mask_i = None if mask is None else mask.int().contiguous()
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask_i is None else mask_i.data_ptr(), out.data_ptr(),
                    B, H, S, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *out.stride()[:3], FA.LOG2E / dh ** 0.5, int(bf16),
                    torch.cuda.current_stream().cuda_stream)
            return out, mask_i, args

        def launch(lib, args):
            err = lib.flash_attention_fwd(*args)
            if err:
                raise SystemExit(f"launch failed: CUDA error {err}")

        gen = torch.Generator(device=dev).manual_seed(11)
        for bf16 in (True, False):
            worst, n = 0.0, 0
            for dh in (32, 64, 128):
                for S in (1, 100, 127, 129, 513, 640, 1900):
                    for ragged in (True, False):
                        q, k, v, mask = CS._flash_inputs(gen, 3, 2, S, dh, ragged, dev)
                        a, mask_a, args_a = bind(q, k, v, mask, bf16)
                        b, mask_b, args_b = bind(q, k, v, mask, bf16)
                        launch(tree, args_a)
                        launch(other, args_b)
                        torch.cuda.synchronize()
                        del mask_a, mask_b
                        worst = max(worst, float((a - b).abs().max()))
                        n += 1
            print(f"[ab] {'bf16' if bf16 else 'f32'} outputs over {n} cases: "
                  f"max |tree - other| {worst:.3e}")

        print(f"[ab] timings on {smi}: medians of {TURNS} alternating turns of "
              f"{REPS} launches (ctypes straight, no wrapper)")
        for bf16 in (True, False):
            mode = "bf16" if bf16 else "f32"
            for B, H, S, dh, ragged in CS.FLASH_SHAPES:
                q, k, v, mask = CS._flash_inputs(gen, B, H, S, dh, ragged, dev)
                amask = None if mask is None else mask.bool()[:, None, None, :]
                out, mask_i, args = bind(q, k, v, mask, bf16)
                sdpa_in = (q.bfloat16, k.bfloat16, v.bfloat16) if bf16 else \
                    (q.float, k.float, v.float)     # float() of f32: itself
                t = CS._turns_ms({
                    "tree": lambda: launch(tree, args),
                    "other": lambda: launch(other, args),
                    "sdpa": lambda: F.scaled_dot_product_attention(
                        *(f() for f in sdpa_in), attn_mask=amask)},
                    REPS, TURNS)
                print(f"[ab] {mode} {(B, H, S, dh)}"
                      f"{', ragged mask' if ragged else ', no mask'}: "
                      f"tree {t['tree']:.4f} ms, other {t['other']:.4f} ms, "
                      f"SDPA {t['sdpa']:.4f} ms; other / tree "
                      f"{t['other'] / t['tree']:.3f}, tree / SDPA "
                      f"{t['tree'] / t['sdpa']:.3f}")
                del q, k, v, mask, out, mask_i
                torch.cuda.empty_cache()

    hash_us = timeit.timeit(lambda: _build.library_path("flash_attention"),
                            number=200) / 200 * 1e6
    cached_us = timeit.timeit(lambda: _build.load_library("flash_attention"),
                              number=2000) / 2000 * 1e6
    print(f"[ab] host work to find the library per launch: source hash "
          f"{hash_us:.1f} us, loaded-library lookup {cached_us:.2f} us")


if __name__ == "__main__":
    main(sys.argv[1:])
