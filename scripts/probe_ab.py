#!/usr/bin/env python3
"""A/B of the probe-scan kernel against the first (one warp per tuple) one.

    git show 4b38b45:neurondb_tpu_torch/csrc/ivf_probe_scan.cu > _archive/first.cu
    python3 scripts/probe_ab.py [--stages] [--tiles] [--variant SRC ...] _archive/first.cu

Builds ``neurondb_tpu_torch/csrc/ivf_probe_scan.cu`` (through the
package's build helper) and the other source (same nvcc flags; a
``topk_select.cuh`` beside it wins over the package's), which must keep
the first kernel's C interface: ``ivf_probe_scan(q, vecs, probes_off,
probes_cnt, out_d, out_i, B, nprobe, D, n_rows, kp, max_segs, metric_ip,
store_bf16, vec8, warps, stream)`` and ``ivf_probe_scan_smem_bytes(warps,
D, kp)``. Then, on one card:

- both builds' ptxas lines, and the instructions before each build's
  first ``max(d, 0)`` (``FMNMX ... RZ``) from ``cuobjdump -sass``: whether
  nvcc contracted ``(qsq + xsq) - 2 * dot`` into an FFMA;
- the same bits from both kernels (distances and rows, ``torch.equal``)
  over the cases of ``chip_smoke.phase_probe_kernel`` (ragged lists, B 37,
  k 1 to 1000, both metrics, hot lists, adjacent empty lists), an f32
  store, D 100 (scalar loads), D 384, 768, 1024 and 2048 in both stores
  at k 10 and 512 (rows staged in 128-dim slabs) and both headlines
  (16,384 x nprobe 8 and 1,024 x nprobe 4 on 1M bf16 rows in 1,024
  lists); any difference fails;
- both kernels timed in alternating turns at the two headlines: the new
  one through its wrapper (work table + kernel) and alone on a built
  table, the old one straight through ctypes; with ``--stages`` also the
  package's source built with ``-DNDB_PROBE_CUT=1`` (no selection) and
  ``=2`` (staging only), a cut the package never sets; with ``--tiles``
  the package's kernel at every query tile of ``TILES`` on the same
  table; with ``--variant SRC`` (repeatable) another source with the
  package's C interface, checked bit for bit against the package's kernel
  at both headlines and timed beside it.

Needs one CUDA card and nvcc; exits non-zero without them.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

TURNS, REPS = 7, 10


def _sass_before_max(so):
    """The 4 instructions before the first FMNMX with RZ in each kernel
    of a library, and each kernel's instruction count, from cuobjdump
    -sass ("cuobjdump not found" without it)."""
    from neurondb_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True).stdout
    out, prev, done, size = [], [], False, {}
    for line in sass.splitlines():
        if "Function :" in line:
            out.append(line.strip())
            prev, done = [], False
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if m and out:
            size[out[-1]] = size.get(out[-1], 0) + 1
        if not m or done:
            continue
        ins = m.group(1)
        if "FMNMX" in ins and "RZ" in ins:
            out += [f"    {p}" for p in prev[-4:]] + [f"    {ins}"]
            done = True
        prev.append(ins)
    return "\n".join(out + [f"{k}: {v} instructions" for k, v in
                            size.items()])


def main(argv):
    stages = "--stages" in argv
    tiles = "--tiles" in argv
    argv = [a for a in argv if a not in ("--stages", "--tiles")]
    variants = []
    while "--variant" in argv:
        i = argv.index("--variant")
        variants.append(os.path.abspath(argv[i + 1]))
        del argv[i:i + 2]
    if len(argv) != 1:
        raise SystemExit(__doc__)
    import torch
    from neurondb_tpu_torch.ops.kernels import _build
    from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
    smi = CS.phase_device()
    other_src = os.path.abspath(argv[0])
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libother.so")
        builds = [(f"cut {c}", f"-DNDB_PROBE_CUT={c}",
                   str(_build.CSRC / "ivf_probe_scan.cu"), False)
                  for c in ((1, 2) if stages else ())]
        builds += [(f"variant {i}", "-DNDB_PROBE_CUT=0", v, True)
                   for i, v in enumerate(variants)]
        sos = [os.path.join(tmp, f"lib{name.replace(' ', '')}.so")
               for name, _, _, _ in builds]
        old_log, *outs = _build.build_other(
            [(other_src, so, ())] +
            [(src, lib_so, (flag,))
             for (_, flag, src, _), lib_so in zip(builds, sos)])
        old = ctypes.CDLL(so)
        f = old.ivf_probe_scan
        f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                      + [ctypes.c_longlong] + [ctypes.c_int] * 6
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        g = old.ivf_probe_scan_smem_bytes
        g.argtypes = [ctypes.c_int] * 3
        g.restype = ctypes.c_longlong
        new = PS._lib()
        cuts = {}        # name -> (library, checked bit for bit)
        for (name, _, src, check), lib_so, out in zip(builds, sos, outs):
            for line in out.splitlines():
                if check and ("registers" in line or "spill" in line):
                    print(f"[ab] {name} ({os.path.basename(src)}) ptxas: "
                          f"{line.strip()}")
            lib = ctypes.CDLL(lib_so)
            lib.ivf_probe_scan.argtypes = new.ivf_probe_scan.argtypes
            cuts[name] = (lib, check)
        logs = {"new": _build.build_log("ivf_probe_scan"),
                "old": old_log}
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ab] {name} ptxas: {line.strip()}")
        for name, lib_so in (("new", str(_build.library_path(
                "ivf_probe_scan"))), ("old", so)):
            print(f"[ab] {name} SASS before the first max(d, 0):\n"
                  f"{_sass_before_max(lib_so)}")

        def old_call(q, vecs, poff, pcnt, kp, max_segs, metric):
            """The old kernel's partials and its launch, as its own wrapper
            made them."""
            B, D = q.shape
            nprobe = poff.shape[1]
            warps = 8
            while warps > 1 and g(warps, D, kp) > PS.SMEM_MAX:
                warps //= 2
            out_d = torch.empty((nprobe, B, kp), device=dev)
            out_i = torch.empty((nprobe, B, kp), dtype=torch.int32,
                                device=dev)
            args = (q.data_ptr(), vecs.data_ptr(), poff.data_ptr(),
                    pcnt.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), B,
                    nprobe, D, vecs.shape[0], kp, max(0, max_segs),
                    int(metric == "ip"), int(vecs.dtype == torch.bfloat16),
                    int(D % 8 == 0 and vecs.data_ptr() % 16 == 0), warps,
                    torch.cuda.current_stream().cuda_stream)

            def launch():
                if f(*args):
                    raise SystemExit("old kernel: launch failed")
            return out_d, out_i, launch

        n_cases = 0

        def same(q, vecs, poff, pcnt, k, metric, max_segs, label):
            nonlocal n_cases
            kp = PS.kp_for(k)
            nd, ni = PS.probe_scan(q, vecs, poff, pcnt, kp=kp,
                                   max_segs=max_segs, metric=metric)
            od, oi, launch = old_call(q, vecs, poff, pcnt, kp, max_segs,
                                      metric)
            launch()
            torch.cuda.synchronize()
            if not (torch.equal(nd, od) and torch.equal(ni, oi)):
                bad = int(((nd != od) | (ni != oi)).sum())
                raise SystemExit(f"[ab] FAILED: {label}: {bad} entries differ")
            n_cases += 1

        rng = np.random.default_rng(5)
        for dtype, dim in ((torch.bfloat16, CS.DIM), (torch.float32, CS.DIM),
                           (torch.bfloat16, 100),
                           *((dt, d) for d in (*CS.PROBE_WIDE, 2048)
                             for dt in (torch.bfloat16, torch.float32))):
            vecs, offsets, counts = CS._layout(rng, CS.PROBE_LENS, dim, dtype,
                                               dev)
            nl = len(CS.PROBE_LENS)
            ms = PS.segments_for(max(CS.PROBE_LENS))
            cases = CS.PROBE_CASES if dim == CS.DIM and dtype == \
                torch.bfloat16 else ((10, 3), (512, 3))
            for k, nprobe in cases:
                for metric in ("sqeuclidean", "ip"):
                    q = torch.randn((CS.PROBE_B, dim), device=dev)
                    lists = CS._probes(rng, CS.PROBE_B, nprobe, nprobe, nl,
                                       dev).long()
                    same(q, vecs, offsets[lists], counts[lists], k, metric,
                         ms, f"{dtype} D {dim} k={k} nprobe={nprobe} "
                             f"{metric}")
            hot = torch.as_tensor(CS.PROBE_HOT, device=dev)[torch.as_tensor(
                np.stack([rng.permutation(3) for _ in range(CS.PROBE_B)]),
                device=dev)]
            e_vecs, e_off, e_cnt = CS._layout(rng, CS.PROBE_LENS_EMPTY, dim,
                                              dtype, dev)
            e_lists = CS._probes(rng, CS.PROBE_B, 4, 4,
                                 len(CS.PROBE_LENS_EMPTY), dev).long()
            for k in (10, 512):
                for metric in ("sqeuclidean", "ip"):
                    q = torch.randn((CS.PROBE_B, dim), device=dev)
                    same(q, vecs, offsets[hot], counts[hot], k, metric, ms,
                         f"{dtype} D {dim} hot lists k={k} {metric}")
                    same(q, e_vecs, e_off[e_lists], e_cnt[e_lists], k,
                         metric, PS.segments_for(max(CS.PROBE_LENS_EMPTY)),
                         f"{dtype} D {dim} adjacent empty lists k={k} "
                         f"{metric}")
        print(f"[ab] {n_cases} small cases: distances and rows bit-identical")

        lens = rng.multinomial(CS.N_ROWS, np.full(CS.NLISTS, 1.0 / CS.NLISTS))
        vecs, offsets, counts = CS._layout(rng, lens, CS.DIM, torch.bfloat16,
                                           dev)
        max_segs = PS.segments_for(int(lens.max()))
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        kp = PS.kp_for(CS.K)
        print(f"[ab] timings on {smi}: medians of {TURNS} alternating turns "
              f"of {REPS} calls")
        for batch, nprobe in ((CS.BATCH, 8), (1024, 4)):
            q = torch.randn((batch, CS.DIM), device=dev)
            probes = CS._probes(rng, batch, nprobe, nprobe, CS.NLISTS,
                                dev).long()
            poff, pcnt = offsets[probes], counts[probes]
            for metric in ("sqeuclidean", "ip"):
                same(q, vecs, poff, pcnt, CS.K, metric, max_segs,
                     f"headline {batch} x {nprobe} {metric}")
            tile = PS.tile_for(batch * nprobe, PS.pick_tile(new, CS.DIM, kp,
                                                            True), n_sm)
            keys, order = PS.work_table(poff, pcnt, n_rows=vecs.shape[0],
                                        max_segs=max_segs)
            nd = torch.empty((nprobe, batch, kp), device=dev)
            ni = torch.empty((nprobe, batch, kp), dtype=torch.int32,
                             device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def alone(lib, tq=tile, out=(nd, ni)):
                def launch():
                    if lib.ivf_probe_scan(q.data_ptr(), vecs.data_ptr(),
                                          keys.data_ptr(), order.data_ptr(),
                                          out[0].data_ptr(), out[1].data_ptr(),
                                          batch, nprobe, CS.DIM, kp, 0, 1, 1,
                                          tq, stream):
                        raise SystemExit("new kernel: launch failed")
                return launch
            for name, (lib, check) in cuts.items():
                if check:
                    vd, vi = torch.empty_like(nd), torch.empty_like(ni)
                    alone(new)()
                    alone(lib, out=(vd, vi))()
                    torch.cuda.synchronize()
                    if not (torch.equal(vd, nd) and torch.equal(vi, ni)):
                        raise SystemExit(f"[ab] FAILED: {name} differs from "
                                         f"the package's kernel")
            fits = [t for t in PS.TILES if t <= PS.pick_tile(new, CS.DIM, kp,
                                                             True)]
            *_, old_launch = old_call(q, vecs, poff, pcnt, kp, max_segs,
                                      "sqeuclidean")
            t = CS._turns_ms({
                "new wrapper": lambda: PS.probe_scan(q, vecs, poff, pcnt,
                                                     kp=kp, max_segs=max_segs),
                "new kernel": alone(new), "old kernel": old_launch,
                **{name: alone(lib) for name, (lib, _) in cuts.items()},
                **{f"tile {t}": alone(new, t) for t in (fits if tiles
                                                        else ())}},
                REPS, TURNS)
            print(f"[ab] {batch} x nprobe {nprobe} (tile {tile}): new wrapper {t['new wrapper']:.4f} ms, new "
                  f"kernel {t['new kernel']:.4f} ms, old kernel "
                  f"{t['old kernel']:.4f} ms; old / new kernel "
                  f"{t['old kernel'] / t['new kernel']:.2f}, old / new "
                  f"wrapper {t['old kernel'] / t['new wrapper']:.2f}" +
                  "".join(f"; {name} {v:.4f} ms" for name, v in t.items()
                          if name.startswith(("cut", "variant", "tile "))))
        print(f"[ab] {n_cases} cases in all: bit-identical")


if __name__ == "__main__":
    main(sys.argv[1:])
