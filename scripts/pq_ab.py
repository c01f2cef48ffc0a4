#!/usr/bin/env python3
"""A/B of sources of the port's IVF-PQ scan kernel, and of its slots per
block, on one card.

    python3 scripts/pq_ab.py [--qs 6,3,2] [--stages] [other.cu ...]

Builds ``neurondb_tpu_torch/csrc/ivfpq_scan.cu`` (through the package's
build helper) and each other source (same C interface and nvcc flags; the
other source's own directory comes first on the include path, so it may
carry its own ``topk_select.cuh``), and prints each build's ptxas
registers and spills. ``--stages`` adds two builds of the package
source with the kernel's measurement-only cut ``-DNDB_PQ_CUT``, to split
the fused kernel's time: "no selection" (1: every candidate is dropped;
table build and ADC sums only) and "build only" (2: no row is scanned).

Then, at ``chip_smoke.py``'s IVF-PQ headline (8,192 queries, nprobe 8,
n_sub 32, kp 80, 1M rows, sq-L2), it launches the fused entry straight
through ctypes (no wrapper work timed) for every source, selection mode
and number of slots per block in ``--qs`` (each with its resident warps
per SM), says whether each output equals the package kernel's at the
wrapper's own slot count bit for bit, and times them all in alternating
turns, beside the card's name and power limit. Needs one CUDA card and
nvcc; exits non-zero without them.
"""

import ctypes
import os
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as CS  # noqa: E402

TURNS, REPS = 5, 5
# --stages: (name, value of the kernel's NDB_PQ_CUT)
STAGES = (("no selection", 1), ("build only", 2))


def main(argv):
    qs_list = (6, 3, 2)
    if "--qs" in argv:
        i = argv.index("--qs")
        qs_list = tuple(int(v) for v in argv[i + 1].split(","))
        argv = argv[:i] + argv[i + 2:]
    stages = "--stages" in argv
    others = [os.path.abspath(a) for a in argv if a != "--stages"]
    import torch
    from neurondb_tpu_torch.ops.kernels import _build
    from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS
    smi = CS.phase_device()
    tree = PQS._lib()
    with tempfile.TemporaryDirectory() as tmp:
        srcs = [(os.path.relpath(o, ROOT), o, []) for o in others]
        if stages:
            own = os.path.join(ROOT, "neurondb_tpu_torch", "csrc",
                               "ivfpq_scan.cu")
            srcs += [(name, own, [f"-DNDB_PQ_CUT={cut}"])
                     for name, cut in STAGES]
        outs = _build.build_other(
            [(src, os.path.join(tmp, f"lib{i}.so"), flags)
             for i, (_, src, flags) in enumerate(srcs)])
        libs = {"tree": tree}
        logs = {"tree": _build.build_log("ivfpq_scan")}
        for i, ((name, _, _), out) in enumerate(zip(srcs, outs)):
            lib = ctypes.CDLL(os.path.join(tmp, f"lib{i}.so"))
            for fn in ("ivfpq_fused_scan", "ivfpq_scan_resident_blocks"):
                getattr(lib, fn).argtypes = getattr(tree, fn).argtypes
                getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib
            logs[name] = out
        for name, log in logs.items():
            print(f"[pq_ab] {name} ptxas: " + ", ".join(
                f"{m} {e} {r} registers / {sp} B spilled"
                for (m, e), (r, sp) in sorted(CS._pq_ptxas(log).items())),
                flush=True)

        dev = torch.device("cuda")
        rng = np.random.default_rng(7)
        ns = 32
        lens = rng.multinomial(CS.N_ROWS, np.full(CS.NLISTS, 1.0 / CS.NLISTS))
        codes_t, cents, cb, offsets, counts = CS._pq_layout(rng, lens, ns, dev)
        q = torch.randn((CS.PQ_BATCH, CS.DIM), device=dev)
        probes = CS._probes(rng, CS.PQ_BATCH, 8, 8, CS.NLISTS, dev)
        qt = PQS.auto_qt(CS.PQ_BATCH, 8, CS.NLISTS)
        toff, tcnt, _, _, (qc, cn, sq, scale, st) = CS._pq_case(
            q, probes, cents, cb, offsets, counts, qt, "sqeuclidean")
        T = toff.shape[0]
        kp = max(8, min(CS.K * 8, PQS.KP_MAX))
        pb_packed = max(11, int(lens.max() - 1).bit_length())
        ks, ds = cb.shape[1], cb.shape[2]

        def bind(lib, qs, pb):
            out_d = torch.empty((T, qt, kp), device=dev)
            out_i = torch.empty((T, qt, kp), dtype=torch.int32, device=dev)
            args = (qc.data_ptr(), cn.data_ptr(), cb.data_ptr(), sq.data_ptr(),
                    float(scale), st.data_ptr(), codes_t.data_ptr(),
                    toff.data_ptr(), tcnt.data_ptr(), out_d.data_ptr(),
                    out_i.data_ptr(), T, qt, qs, ns, ks, ds,
                    codes_t.shape[1], kp, pb,
                    torch.cuda.current_stream().cuda_stream)

            def launch():
                return lib.ivfpq_fused_scan(*args)
            return out_d, out_i, launch

        fns = {}
        for mode, pb in (("exact", 0), ("packed", pb_packed)):
            ref_d, ref_i = PQS.grouped_pq_scan_fused(
                qc, cn, cb, sq, scale, st, codes_t, toff, tcnt, kp=kp, qt=qt,
                pos_bits=pb)
            for name, lib in libs.items():
                for qs in qs_list:
                    warps = 4 * qs * lib.ivfpq_scan_resident_blocks(
                        qs, ns, ks, ds, kp, int(pb > 0))
                    if warps <= 0:
                        print(f"[pq_ab] {name} {mode} qs {qs}: does not fit "
                              f"({warps})")
                        continue
                    out_d, out_i, launch = bind(lib, qs, pb)
                    err = launch()
                    torch.cuda.synchronize()
                    if err:
                        print(f"[pq_ab] {name} {mode} qs {qs}: refused (CUDA "
                              f"error {err})")
                        continue
                    same = bool(torch.equal(out_d, ref_d)
                                and torch.equal(out_i, ref_i))
                    print(f"[pq_ab] {name} {mode} qs {qs}: {warps} resident "
                          f"warps per SM; equal to the package kernel: {same}",
                          flush=True)
                    fns[f"{name} {mode} qs {qs}"] = launch
        times = CS._turns_ms(fns, REPS, TURNS)
        for key, ms in times.items():
            print(f"[pq_ab] {key}: {ms:.3f} ms ({smi}; median of {TURNS} "
                  f"alternating turns of {REPS} launches)")


if __name__ == "__main__":
    main(sys.argv[1:])
