#!/usr/bin/env python3
"""The int8 KV cache's gates in ``chip_smoke.py`` against planted faults,
at GPT-2 small's full width on one card.

    python3 scripts/gpt_kv_faults.py

Sets up what ``chip_smoke.py``'s phase_generate (c) compares: GPT-2 small
(the published ``gpt2`` widths, seed-0 random weights, bf16), its 8
left-padded prompts and 32 greedy tokens with the bf16 cache, and their
teacher-forced logits. Then runs ``chip_smoke._kv_compare`` for int8 KV
and int8_dot, first on ``neurondb_tpu_torch/ml/gpt.py`` as it is, then on
mutants of it built in memory from its source text (nothing is written):

- int8_dot without the value scales (``aw = a``);
- int8_dot without the key scales;
- int8_dot with one attention-weight scale for the whole tensor, not
  one a row;
- int8 cache codes truncated, not rounded.

Prints each comparison and whether the gates (``GPT_KV_TOL``,
``GPT_KV_MEAN``, ``GPT_KV_AGREE``, the near-tie bound) reject it. Exits
non-zero if the sound module is rejected, or if a dropped scale or the
truncation gets through. Needs one CUDA card; exits non-zero without one.
"""

import os
import sys
import types

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

DOT = "int8 KV + int8_dot"
LABELS = (("int8 KV", dict(kv_int8=True)), (DOT, dict(int8_dot=True)))
# name: (original text, replacement, the comparison that must reject it)
MUTANTS = {
    "int8_dot: value scales dropped":
        ("aw = a * vsc", "aw = a", DOT),
    "int8_dot: key scales dropped":
        ("* (sq[..., None] * ksc) * scale", "* (sq[..., None]) * scale", DOT),
    "int8_dot: one weight scale per tensor":
        ("sa = torch.clamp(_div(aw.abs().amax(-1), 127.0), min=1e-12)",
         "sa = torch.clamp(_div(aw.abs().amax(), 127.0), "
         "min=1e-12).expand(aw.shape[:-1])", None),
    "int8 KV: codes truncated, not rounded":
        ("return torch.round(t / s[..., None]).to(torch.int8), s",
         "return torch.trunc(t / s[..., None]).to(torch.int8), s",
         "int8 KV"),
}


def rejected(label, st):
    tol = CS.GPT_KV_TOL[label]
    return (st["diff"] > tol or st["mean"] > CS.GPT_KV_MEAN[label]
            or st["agree"] < CS.GPT_KV_AGREE[label]
            or st["free_gap"] > 2 * tol)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import neurondb_tpu_torch.ml as ML
    from neurondb_tpu_torch.ml import gpt as TG
    from neurondb_tpu_torch.ml.bpe import BPETokenizer
    smi = CS.phase_device()
    c = CS.GPT2_SMALL
    H = c["heads"]
    p32 = TG.init_gpt_params(0, vocab_size=c["vocab"], hidden=c["hidden"],
                             layers=c["layers"], heads=H,
                             max_len=c["max_len"], device="cuda")
    pb = TG.GPT2LM(p32, BPETokenizer.byte_fallback(), heads=H,
                   dtype="bfloat16", device="cuda").params
    del p32
    rng = np.random.default_rng(11)                  # phase_generate's (a)
    lens = rng.integers(5, CS.GPT_PROMPT + 1, CS.GPT_B)
    lens[:2] = (5, CS.GPT_PROMPT)
    ids = CS._gpt_prompts(rng, lens, CS.GPT_PROMPT, c["vocab"])
    cl = CS.GPT_PROMPT + CS.GPT_NEW
    tb, _ = TG.generate_ids(pb, ids, lens, 0, heads=H, max_new=CS.GPT_NEW,
                            cache_len=cl)
    ref = CS._teacher_forced(pb, ids, lens, tb, H, cl)
    bad = []
    for label, kw in LABELS:
        st = CS._kv_compare(pb, ids, lens, tb, ref, H, cl, **kw)
        print(f"[kv faults] sound, {label}: rejected {rejected(label, st)} "
              f"{st}; {smi}", flush=True)
        if rejected(label, st):
            bad.append(f"sound {label}")
    src = open(TG.__file__).read()
    for name, (a, b, must) in MUTANTS.items():
        if src.count(a) != 1:
            raise SystemExit(f"{name}: the text to mutate is not in gpt.py")
        mod = types.ModuleType(TG.__name__)
        exec(compile(src.replace(a, b), "gpt_mutant.py", "exec"), mod.__dict__)
        sys.modules[TG.__name__], ML.gpt = mod, mod
        try:
            for label, kw in LABELS:
                if name.startswith("int8_dot") and "int8_dot" not in kw:
                    continue
                st = CS._kv_compare(pb, ids, lens, tb, ref, H, cl, **kw)
                caught = rejected(label, st)
                print(f"[kv faults] '{name}', {label}: rejected {caught} "
                      f"{st}; {smi}", flush=True)
                if label == must and not caught:
                    bad.append(f"{name} ({label})")
        finally:
            sys.modules[TG.__name__], ML.gpt = TG, TG
    if bad:
        raise SystemExit(f"gates wrong on: {bad}")
    print("[kv faults] the gates pass the sound module and reject every "
          "dropped scale and the truncation", flush=True)


if __name__ == "__main__":
    main()
