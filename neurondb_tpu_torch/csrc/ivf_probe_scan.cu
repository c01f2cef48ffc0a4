// Round-1 IVF probe scan with a running top-kp, for Hopper (sm_90a).
//
// Replaces the TPU kernel neurondb_tpu/ops/pallas/ivf_scan.py
// `_probe_scan_kernel` (run through `ivf_probe_scan`).
//
// What it computes. For every (query b, probe rank p) tuple it scans rows
// [off, off + n) of the cluster-ordered store, off = probes_off[b, p],
// n = min(probes_cnt[b, p], max_segs * 512, rows left in the store), and
// writes the kp smallest (distance, CSR row) pairs, ascending, to
// out[p, b, :]:
//   sq-L2: d = max((|q|^2 + |x|^2) - 2 (q . x), 0)
//   ip:    d = -(q . x)
// q is the f32 query and x the stored row widened to f32 (bf16 or f32
// store); every product and sum is f32; |q|^2 and |x|^2 are summed here
// from q and the stored row. Ties go to the smaller row, which is what the
// TPU kernel's argmin extraction over [running | segment] yields. Unused
// slots, and tuples with n == 0, hold (FLT_MAX, -1). The merge across
// probe ranks runs outside the kernel, in torch, as it ran in XLA.
//
// Precision. The TPU source asks for f32 distances ("compute in f32 for
// accurate distances"), and its CPU interpret run and numpy oracle compute
// them so; on the TPU itself a default-precision f32 dot_general rounds q
// to bf16, an artefact this kernel does not copy. A bf16 x bf16
// tensor-core version would change the numbers (q rounded as the grouped
// kernel rounds it); measuring that trade is later perf work.
//
// What bounds it on the card. The function needs the distinct probed rows
// once (~0.25 GB of bf16 at the 1M x 128 headline: 16,384 queries, nprobe
// 8, ~977 rows a list) and ~33 GFLOP of f32 products (~0.5 ms at 67
// TFLOP/s): it is operation-bound. This design is not: each tuple re-reads
// its whole list, ~33 GB of row reads at the headline, served by L2 (50 MB,
// a fifth of the store) or device memory. The list-grouped kernel
// (ivf_scan_grouped.cu) exists to share one read among many queries.
//
// Design (simple first):
// - one warp per (query, probe) tuple and up to 8 tuples of one probe rank
//   per block: blockIdx.x walks query groups, blockIdx.y the probe ranks
//   (the TPU grid's sequential probe axis). Blocks run in no order and
//   nothing carries between them, so warps never synchronise beyond
//   themselves;
// - a tuple with n == 0 writes (FLT_MAX, -1) and leaves at once;
// - the warp's query sits in shared memory, read as broadcast float4s;
// - lane l scores row c0 + l of each 32-row chunk, reading the row straight
//   from device memory in 16-byte loads (8 bf16, or 2 x 4 f32) where every
//   row start is 16-byte aligned (scalar loads otherwise), and sums q . x
//   and |x|^2 in f32 registers. The TPU kernel's 512-row segments survive
//   only as the max_segs cut: rows past n are never read, which takes the
//   place of its double-buffered DMA and of the clamp of the DMA start;
// - each tuple's running top-kp sits sorted in shared memory, kept by its
//   warp with topk_select.cuh `offer<true>` (exact order: distance, row).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>

#include "topk_select.cuh"

namespace {

constexpr int kSeg = 512;               // rows per segment (the max_segs unit)
constexpr int kMaxWarps = 8;            // tuples per block at most

// words of shared memory one warp holds: its query (rounded up to a float4)
// and its top-kp distances and rows (rounded up to a float4)
__host__ __device__ __forceinline__ int warp_words(int D, int kp) {
  return ((D + 3) & ~3) + ((2 * kp + 3) & ~3);
}

// 8 consecutive elements of a row, widened to f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
probe_scan_kernel(const float* __restrict__ q, const T* __restrict__ vecs,
                  const int* __restrict__ probes_off,
                  const int* __restrict__ probes_cnt,
                  float* __restrict__ out_d, int* __restrict__ out_i, int B,
                  int nprobe, int D, long long n_rows, int kp, int max_segs,
                  int metric_ip, int vec8) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  const int p = blockIdx.y;
  if (b >= B) return;                   // the whole warp: no block barrier follows

  const long long t = static_cast<long long>(b) * nprobe + p;
  const int off = probes_off[t];
  long long cnt = probes_cnt[t];
  if (off < 0 || off >= n_rows) cnt = 0;          // rows past the store are never read
  else cnt = min(cnt, n_rows - off);
  cnt = min(cnt, static_cast<long long>(max_segs) * kSeg);
  const int n = static_cast<int>(max(cnt, 0LL));

  const long long obase = (static_cast<long long>(p) * B + b) * kp;
  float* o_d = out_d + obase;
  int* o_i = out_i + obase;
  if (n == 0) {
    for (int i = lane; i < kp; i += 32) { o_d[i] = FLT_MAX; o_i[i] = -1; }
    return;
  }

  float* q_s = reinterpret_cast<float*>(smem4) + warp * warp_words(D, kp);
  float* lk = q_s + ((D + 3) & ~3);               // [kp] distances
  int* lr = reinterpret_cast<int*>(lk + kp);      // [kp] rows
  const float* qg = q + static_cast<long long>(b) * D;
  float qsq = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = qg[d];
    q_s[d] = v;
    qsq = fmaf(v, v, qsq);
  }
  for (int o = 16; o > 0; o >>= 1) qsq += __shfl_xor_sync(ndb::kFull, qsq, o);
  for (int i = lane; i < kp; i += 32) { lk[i] = FLT_MAX; lr[i] = -1; }
  __syncwarp();

  float wk = FLT_MAX;                   // the list's last entry
  int wr = -1;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int r = c0 + lane;
    const bool valid = r < n;
    float dot = 0.f, xsq = 0.f;
    if (valid) {
      const T* xr = vecs + (static_cast<long long>(off) + r) * D;
      int d = 0;
      if (vec8) {
#pragma unroll 4
        for (; d + 8 <= D; d += 8) {
          float v[8];
          load8(xr + d, v);
          const float4 qa = *reinterpret_cast<const float4*>(q_s + d);
          const float4 qb = *reinterpret_cast<const float4*>(q_s + d + 4);
          dot = fmaf(qa.x, v[0], dot); dot = fmaf(qa.y, v[1], dot);
          dot = fmaf(qa.z, v[2], dot); dot = fmaf(qa.w, v[3], dot);
          dot = fmaf(qb.x, v[4], dot); dot = fmaf(qb.y, v[5], dot);
          dot = fmaf(qb.z, v[6], dot); dot = fmaf(qb.w, v[7], dot);
#pragma unroll
          for (int j = 0; j < 8; ++j) xsq = fmaf(v[j], v[j], xsq);
        }
      }
      for (; d < D; ++d) {
        const float v = load1(xr + d);
        dot = fmaf(q_s[d], v, dot);
        xsq = fmaf(v, v, xsq);
      }
    }
    const float dist = metric_ip ? -dot : fmaxf((qsq + xsq) - 2.f * dot, 0.f);
    ndb::offer<true>(lk, lr, kp, dist, off + r, valid, lane, wk, wr);
  }

  __syncwarp();
  for (int i = lane; i < kp; i += 32) { o_d[i] = lk[i]; o_i[i] = lr[i]; }
}

template <typename T>
int launch(const float* q, const void* vecs, const int* poff, const int* pcnt,
           float* out_d, int* out_i, int B, int nprobe, int D,
           long long n_rows, int kp, int max_segs, int metric_ip, int vec8,
           int warps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + warps - 1) / warps, nprobe);
  probe_scan_kernel<T><<<grid, warps * 32, smem, stream>>>(
      q, static_cast<const T*>(vecs), poff, pcnt, out_d, out_i, B, nprobe, D,
      n_rows, kp, max_segs, metric_ip, vec8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `warps` tuples needs, in bytes.
long long ivf_probe_scan_smem_bytes(int warps, int D, int kp) {
  return 4LL * warps * warp_words(D, kp);
}

// q [B, D] f32; vecs [n_rows, D] (store_bf16 ? bf16 : f32); probes_off and
// probes_cnt [B, nprobe] int32; out_d/out_i [nprobe, B, kp]. vec8: D % 8 == 0
// and vecs 16-byte aligned. Launches on `stream` and returns the CUDA error
// code of the launch (0 = success).
int ivf_probe_scan(const void* q, const void* vecs, const void* probes_off,
                   const void* probes_cnt, void* out_d, void* out_i, int B,
                   int nprobe, int D, long long n_rows, int kp, int max_segs,
                   int metric_ip, int store_bf16, int vec8, int warps,
                   void* stream) {
  if (B <= 0 || nprobe <= 0) return 0;
  if (D < 1 || kp < 1 || kp > kSeg || max_segs < 0 || warps < 1 ||
      warps > kMaxWarps || nprobe > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(ivf_probe_scan_smem_bytes(warps, D, kp));
  auto qf = static_cast<const float*>(q);
  auto po = static_cast<const int*>(probes_off);
  auto pc = static_cast<const int*>(probes_cnt);
  auto od = static_cast<float*>(out_d);
  auto oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  if (store_bf16)
    return launch<__nv_bfloat16>(qf, vecs, po, pc, od, oi, B, nprobe, D, n_rows,
                                 kp, max_segs, metric_ip, vec8, warps, smem, s);
  return launch<float>(qf, vecs, po, pc, od, oi, B, nprobe, D, n_rows, kp,
                       max_segs, metric_ip, vec8, warps, smem, s);
}

}  // extern "C"
