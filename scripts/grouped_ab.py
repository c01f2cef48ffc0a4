#!/usr/bin/env python3
"""A/B of the grouped-scan kernel against its first (FMA) design.

    mkdir -p _archive/g2
    git show 541d804:neurondb_tpu_torch/csrc/ivf_scan_grouped.cu > _archive/g2/ivf_scan_grouped.cu
    git show 541d804:neurondb_tpu_torch/csrc/topk_select.cuh > _archive/g2/topk_select.cuh
    python3 scripts/grouped_ab.py [--stages] _archive/g2/ivf_scan_grouped.cu

Builds ``neurondb_tpu_torch/csrc/ivf_scan_grouped.cu`` (through the
package's build helper) and the other source (same nvcc flags; a
``topk_select.cuh`` beside it wins over the package's), which must keep
the first design's C interface: ``ivf_grouped_scan`` as the package's and
``ivf_grouped_scan_smem_bytes(qs, D, kp, mode)``. Then, on one card, for
the bf16 store:

- both builds' ptxas lines;
- both kernels over the cases of ``chip_smoke.phase_kernel`` (ragged
  lists, qt 16, 32, 64, k 10, 100, 1024, both metrics, the three modes)
  and the headline (16,384 queries x nprobe 8 padded to 16, 1M rows in
  1,024 lists, k 10): the largest |new - old| over the slots both fill,
  and the share of rows that agree; the tensor cores add the products in
  their own order, so distances differ by f32 rounding and rows may trade
  places at near-ties;
- both kernels launched through ctypes (no wrapper) in alternating turns
  at the headline and at the main path's small batch (1,024 queries x
  nprobe 4, qt 16), each mode; with ``--stages`` also the package's source
  built with ``-DNDB_GROUPED_CUT=1`` (no selection) and ``=2`` (staging
  only), a cut the package never sets.

Every build runs in parallel (one nvcc per source, started together).

Needs one CUDA card and nvcc; exits non-zero without them.
"""

import ctypes
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

TURNS, REPS = 7, 10


def _ptxas(text):
    """nvcc's lines that name a kernel, its registers or its spills."""
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def main(argv):
    stages = "--stages" in argv
    argv = [a for a in argv if a != "--stages"]
    if len(argv) != 1:
        raise SystemExit(__doc__)
    import torch
    from neurondb_tpu_torch.ops.kernels import _build
    from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
    smi = CS.phase_device()
    dev = torch.device("cuda")
    new = G._lib()
    with tempfile.TemporaryDirectory() as tmp:
        pkg = str(_build.CSRC / "ivf_scan_grouped.cu")
        # name -> (source, flags, arguments of its smem_bytes)
        builds = {"old": (os.path.abspath(argv[0]), (), 4)}
        for cut in ((1, 2) if stages else ()):
            builds[f"cut {cut}"] = (pkg, (f"-DNDB_GROUPED_CUT={cut}",), 5)
        jobs = [(src, os.path.join(tmp, f"lib{j}.so"), flags)
                for j, (src, flags, _) in enumerate(builds.values())]
        lines = {name: _ptxas(out) for name, out in
                 zip(builds, _build.build_other(jobs))}
        lines["new"] = _ptxas(_build.build_log("ivf_scan_grouped"))
        libs = {name: (ctypes.CDLL(so), b[2]) for (name, b), (_, so, _) in
                zip(builds.items(), jobs)}     # name -> (library, smem args)
        libs["new"] = (new, 5)
        for lib, nargs in libs.values():
            lib.ivf_grouped_scan.argtypes = new.ivf_grouped_scan.argtypes
            lib.ivf_grouped_scan.restype = ctypes.c_int
            lib.ivf_grouped_scan_smem_bytes.argtypes = [ctypes.c_int] * nargs
            lib.ivf_grouped_scan_smem_bytes.restype = ctypes.c_longlong
        for name, text in lines.items():
            if name.startswith("cut"):
                continue
            for ln in text:
                print(f"[ab] {name} ptxas: {ln}")

        def call(name, qpad, vecs, toff, tcnt, kp, qt, mode, pb, metric):
            """Outputs and a launch of one library's kernel, blocks of the
            widest qs its shared memory allows, as its wrapper picks."""
            lib, nargs = libs[name]
            T, D = toff.shape[0], qpad.shape[1]
            extra = (1,) if nargs == 5 else ()
            qs = qt
            while qs % 2 == 0 and (
                    qs > G.QS_MAX or lib.ivf_grouped_scan_smem_bytes(
                        qs, D, kp, mode, *extra) > G.SMEM_MAX):
                qs //= 2
            out_d = torch.empty((T, qt, kp), device=dev)
            out_i = torch.empty((T, qt, kp), dtype=torch.int32, device=dev)
            args = (qpad.data_ptr(), vecs.data_ptr(), toff.data_ptr(),
                    tcnt.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                    T * (qt // qs), qt // qs, qs, D, vecs.shape[0], kp,
                    int(metric == "ip"), 1, mode, pb,
                    torch.cuda.current_stream().cuda_stream)

            def launch():
                if lib.ivf_grouped_scan(*args):
                    raise SystemExit(f"[ab] {name}: launch failed")
            return out_d, out_i, launch

        worst = {m: [0.0, 1.0] for m in CS.MODES}    # max |diff|, agreement

        def compare(label, mode, *a):
            nd, ni, ln = call("new", *a)
            od, oi, lo = call("old", *a)
            ln()
            lo()
            torch.cuda.synchronize()
            live = (nd < 1e30) & (od < 1e30)
            if not torch.equal(nd < 1e30, od < 1e30):
                raise SystemExit(f"[ab] FAILED: {label}: filled slots differ")
            diff = float((nd[live] - od[live]).abs().max()) if live.any() \
                else 0.0
            agree = float((ni[live] == oi[live]).float().mean()) \
                if live.any() else 1.0
            worst[mode][0] = max(worst[mode][0], diff)
            worst[mode][1] = min(worst[mode][1], agree)
            return diff, agree

        rng = np.random.default_rng(0)
        lens = [0, 3, 31, 1024, 1025, 2500, 700, 64, 1, 333]
        vecs, offsets, counts = CS._layout(rng, lens, CS.DIM, torch.bfloat16,
                                           dev)
        pb_small = max(11, (max(lens) - 1).bit_length())
        n_cases = 0
        for mode, (packed, bmin) in CS.MODES.items():
            for qt in (16, 32, 64):
                for k in (10, 100, 1024):
                    for metric in ("sqeuclidean", "ip"):
                        q = torch.randn((3 * qt, CS.DIM), device=dev) * 0.5
                        probes = CS._probes(rng, 3 * qt, 4, 6, len(lens), dev)
                        qpad, toff, tcnt, _ = CS._tiles(q, probes, offsets,
                                                        counts, qt)
                        compare(f"{mode} qt={qt} k={k} {metric}", mode, qpad,
                                vecs, toff, tcnt, max(8, min(k, G.SEG)), qt,
                                list(CS.MODES).index(mode),
                                pb_small if packed else 0, metric)
                        n_cases += 1
        for mode in CS.MODES:
            print(f"[ab] {mode}: small cases, max |new - old| "
                  f"{worst[mode][0]:.3e}, least row agreement "
                  f"{worst[mode][1]:.5f}")
        print(f"[ab] {n_cases} small cases compared")

        lens = rng.multinomial(CS.N_ROWS, np.full(CS.NLISTS, 1.0 / CS.NLISTS))
        vecs, offsets, counts = CS._layout(rng, lens, CS.DIM, torch.bfloat16,
                                           dev)
        pb = max(11, int(lens.max() - 1).bit_length())
        print(f"[ab] timings on {smi}: medians of {TURNS} alternating turns "
              f"of {REPS} calls, kernels launched through ctypes")
        for batch, nprobe, npad in ((CS.BATCH, 8, 16), (1024, 4, 4)):
            q = torch.randn((batch, CS.DIM), device=dev)
            probes = CS._probes(rng, batch, nprobe, npad, CS.NLISTS, dev)
            qt = G.auto_qt(batch, npad, CS.NLISTS)
            qpad, toff, tcnt, _ = CS._tiles(q, probes, offsets, counts, qt)
            for mode, (packed, _) in CS.MODES.items():
                a = (qpad, vecs, toff, tcnt, max(8, CS.K), qt,
                     list(CS.MODES).index(mode), pb if packed else 0,
                     "sqeuclidean")
                diff, agree = compare(f"{batch} x {nprobe} {mode}", mode, *a)
                t = CS._turns_ms({name: call(name, *a)[2] for name in libs},
                                 REPS, TURNS)
                print(f"[ab] {batch} x nprobe {nprobe} (qt {qt}) {mode}: new "
                      f"{t['new']:.4f} ms, old {t['old']:.4f} ms, old / new "
                      f"{t['old'] / t['new']:.2f}; max |new - old| {diff:.3e}, "
                      f"rows agree {agree:.5f}" +
                      "".join(f"; {name} {v:.4f} ms" for name, v in t.items()
                              if name.startswith("cut")))


if __name__ == "__main__":
    main(sys.argv[1:])
