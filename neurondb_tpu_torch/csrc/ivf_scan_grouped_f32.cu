// List-grouped IVF probe scan with top-kp selection over an f32 store,
// for Hopper (sm_90a): the FMA kernel of the port's first design.
//
// Replaces the TPU kernel neurondb_tpu/ops/pallas/ivf_scan_grouped.py
// `_grouped_scan_kernel` where the store is f32, which only
// `configure(store_dtype="float32")` selects on the card; the bf16 store
// (the main path's) has the tensor-core kernel of ivf_scan_grouped.cu.
// Both libraries export the same C entry (`ivf_grouped_scan`,
// `ivf_grouped_scan_smem_bytes`); each refuses the other's store. The
// function, the three selection modes and the fill values are those
// stated at the head of ivf_scan_grouped.cu.
//
// Design: one block (8 warps) per sub-tile of qs <= 64 queries; the rows
// staged as f32 in 64-row x 128-dim slabs (stride 129 floats, so the
// lanes' column reads hit distinct banks); warp w owns queries w, w + 8,
// ...; lane l scores rows l and l + 32 from registers with f32 FMA; the
// top-kp lists in shared memory through topk_select.cuh `offer`;
// blockmin's 128 class minima a query in shared memory, folded over a
// segment and offered when the segment or the list ends. Rows past the
// list's count are not read.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "topk_select.cuh"

namespace {

using ndb::kFull;
using ndb::kIntFill;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;               // rows per staged chunk
constexpr int kSeg = 1024;              // blockmin segment (list positions)
constexpr int kClasses = 128;           // blockmin classes per segment
constexpr int kQsMax = 64;              // queries per block at most

enum Mode { kExact = 0, kPacked = 1, kBlockMin = 2 };

constexpr int kSlab = 128;              // dims per staged slab
constexpr int kStride = kSlab + 1;      // padded smem row stride (floats)
constexpr int kQW = 8;                  // queries per warp at most (qs <= 64)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
grouped_scan_kernel(const float* __restrict__ qpad, const T* __restrict__ vecs,
                    const int* __restrict__ tile_off,
                    const int* __restrict__ tile_cnt,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    int sub_per_tile, int qs, int D, long long n_rows, int kp,
                    int metric_ip, int pb) {
  constexpr bool kRowsKept = kMode == kExact;
  using K = std::conditional_t<kRowsKept, float, int>;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long sub = blockIdx.x;
  const int t = static_cast<int>(sub / sub_per_tile);
  const int off = tile_off[t];
  // rows past the store are never read
  int cnt = tile_cnt[t];
  if (off < 0 || off >= n_rows) cnt = 0;
  else if (cnt > n_rows - off) cnt = static_cast<int>(n_rows - off);

  const long long qbase = sub * qs;
  float* o_d = out_d + qbase * kp;
  int* o_i = out_i + qbase * kp;
  if (cnt <= 0) {
    for (int i = tid; i < qs * kp; i += kThreads) { o_d[i] = FLT_MAX; o_i[i] = -1; }
    return;
  }

  float* q_s = smem;                                // [qs][D] rounded queries
  float* qsq_s = q_s + qs * D;                      // [qs] |q|^2 (f32 query)
  float* x_s = qsq_s + ((qs + 3) & ~3);             // [kRows][kStride]
  K* top_k = reinterpret_cast<K*>(x_s + kRows * kStride);   // [qs][kp]
  int* top_r = reinterpret_cast<int*>(top_k + qs * kp);     // [qs][kp] exact
  int* cm_s = top_r;                                // [qs][kClasses] blockmin

  K kEmpty;
  if constexpr (kRowsKept) kEmpty = FLT_MAX;
  else kEmpty = kIntFill;
  const float* qg = qpad + qbase * D;
  for (int i = tid; i < qs * D; i += kThreads) q_s[i] = round_to(qg[i], vecs);
  for (int i = tid; i < qs * kp; i += kThreads) {
    top_k[i] = kEmpty;
    if constexpr (kRowsKept) top_r[i] = -1;
  }
  if constexpr (kMode == kBlockMin)
    for (int i = tid; i < qs * kClasses; i += kThreads) cm_s[i] = kIntFill;
  for (int qi = warp; qi < qs; qi += kWarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) { const float v = qg[qi * D + d]; s = fmaf(v, v, s); }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) qsq_s[qi] = s;
  }
  __syncthreads();

  K wk[kQW];
  int wr[kQW];
#pragma unroll
  for (int j = 0; j < kQW; ++j) { wk[j] = kEmpty; wr[j] = -1; }

  for (int c0 = 0; c0 < cnt; c0 += kRows) {
    const int nrow = min(kRows, cnt - c0);
    const T* xg = vecs + (static_cast<long long>(off) + c0) * D;
    float acc[kQW][2];
#pragma unroll
    for (int j = 0; j < kQW; ++j) { acc[j][0] = 0.f; acc[j][1] = 0.f; }
    float xsq0 = 0.f, xsq1 = 0.f;

    for (int d0 = 0; d0 < D; d0 += kSlab) {
      const int ds = min(kSlab, D - d0);
      __syncthreads();                              // previous slab consumed
      for (int r = warp; r < kRows; r += kWarps) {
        float* dst = x_s + r * kStride;
        if (r < nrow) {
          const T* src = xg + static_cast<long long>(r) * D + d0;
          for (int dd = lane; dd < ds; dd += 32) dst[dd] = load_f32(src + dd);
        } else {
          for (int dd = lane; dd < ds; dd += 32) dst[dd] = 0.f;
        }
      }
      __syncthreads();
      const float* xa = x_s + lane * kStride;
      const float* xb = x_s + (lane + 32) * kStride;
      for (int dd = 0; dd < ds; ++dd) {
        const float x0 = xa[dd], x1 = xb[dd];
        xsq0 = fmaf(x0, x0, xsq0);
        xsq1 = fmaf(x1, x1, xsq1);
#pragma unroll
        for (int j = 0; j < kQW; ++j) {
          // queries past qs read a valid slot; their sums are never used
          const float qv = q_s[min(warp + kWarps * j, qs - 1) * D + d0 + dd];
          acc[j][0] = fmaf(qv, x0, acc[j][0]);
          acc[j][1] = fmaf(qv, x1, acc[j][1]);
        }
      }
    }

    // blockmin: this chunk closes a segment, or the list
    const bool flush = ((c0 + kRows) % kSeg == 0) || (c0 + kRows >= cnt);
#pragma unroll
    for (int j = 0; j < kQW; ++j) {
      const int qi = warp + kWarps * j;
      if (qi < qs) {                                // warp-uniform
        const float qsq = qsq_s[qi];
        K* lk = top_k + qi * kp;
        int* lr = top_r + qi * kp;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h;
          const float dot = acc[j][h];
          const float xsq = h ? xsq1 : xsq0;
          const float d = metric_ip ? -dot : fmaxf((qsq + xsq) - 2.f * dot, 0.f);
          if constexpr (kMode == kExact) {
            ndb::offer<true>(lk, lr, kp, d, off + c0 + r, r < nrow, lane,
                             wk[j], wr[j]);
          } else {
            const int key = r < nrow ? ndb::pack_key(d, c0 + r, pb) : kIntFill;
            if constexpr (kMode == kPacked) {
              ndb::offer<false>(lk, lr, kp, key, 0, true, lane, wk[j], wr[j]);
            } else {
              int* cm = cm_s + qi * kClasses + (c0 & 64) + r;
              *cm = min(*cm, key);
            }
          }
        }
        if constexpr (kMode == kBlockMin) {
          if (flush) {
            __syncwarp();
            int* cm = cm_s + qi * kClasses;
#pragma unroll
            for (int u = 0; u < kClasses / 32; ++u) {
              const int key = cm[u * 32 + lane];
              cm[u * 32 + lane] = kIntFill;
              ndb::offer<false>(lk, lr, kp, key, 0, true, lane, wk[j], wr[j]);
            }
          }
        }
      }
    }
  }

  __syncwarp();
  for (int qi = warp; qi < qs; qi += kWarps) {
    for (int i = lane; i < kp; i += 32) {
      if constexpr (kRowsKept) {
        o_d[qi * kp + i] = top_k[qi * kp + i];
        o_i[qi * kp + i] = top_r[qi * kp + i];
      } else {
        const int key = top_k[qi * kp + i];
        const bool empty = key == kIntFill;
        o_d[qi * kp + i] = empty ? FLT_MAX : ndb::key_dist(key, pb);
        o_i[qi * kp + i] = empty ? -1 : off + ndb::key_pos(key, pb);
      }
    }
  }
}

template <typename T, int kMode>
int launch(const float* qpad, const void* vecs, const int* tile_off,
           const int* tile_cnt, float* out_d, int* out_i, int n_sub,
           int sub_per_tile, int qs, int D, long long n_rows, int kp,
           int metric_ip, int pb, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_scan_kernel<T, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_scan_kernel<T, kMode><<<n_sub, kThreads, smem, stream>>>(
      qpad, static_cast<const T*>(vecs), tile_off, tile_cnt, out_d, out_i,
      sub_per_tile, qs, D, n_rows, kp, metric_ip, pb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mode(int mode, const float* qpad, const void* vecs,
                const int* tile_off, const int* tile_cnt, float* out_d,
                int* out_i, int n_sub, int sub_per_tile, int qs, int D,
                long long n_rows, int kp, int metric_ip, int pb, size_t smem,
                cudaStream_t stream) {
  if (mode == kExact)
    return launch<T, kExact>(qpad, vecs, tile_off, tile_cnt, out_d, out_i,
                             n_sub, sub_per_tile, qs, D, n_rows, kp,
                             metric_ip, pb, smem, stream);
  if (mode == kPacked)
    return launch<T, kPacked>(qpad, vecs, tile_off, tile_cnt, out_d, out_i,
                              n_sub, sub_per_tile, qs, D, n_rows, kp,
                              metric_ip, pb, smem, stream);
  return launch<T, kBlockMin>(qpad, vecs, tile_off, tile_cnt, out_d, out_i,
                              n_sub, sub_per_tile, qs, D, n_rows, kp,
                              metric_ip, pb, smem, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes (-1: not this
// library's store). mode: 0 exact, 1 packed, 2 blockmin.
long long ivf_grouped_scan_smem_bytes(int qs, int D, int kp, int mode,
                                      int store_bf16) {
  if (store_bf16) return -1;
  long long words = static_cast<long long>(qs) * D + ((qs + 3) & ~3) +
                    static_cast<long long>(kRows) * kStride +
                    static_cast<long long>(qs) * kp;
  if (mode == kExact) words += static_cast<long long>(qs) * kp;
  if (mode == kBlockMin) words += static_cast<long long>(qs) * kClasses;
  return 4 * words;
}

// qpad [n_sub * qs, D] f32; vecs [n_rows, D] f32 (store_bf16 must be 0);
// tile_off/tile_cnt [n_sub / sub_per_tile] int32; out_d/out_i
// [n_sub * qs, kp]. mode 1 and 2 take pos_bits pb in [1, 30]. Launches on
// `stream` and returns the CUDA error code of the launch (0 = success).
int ivf_grouped_scan(const void* qpad, const void* vecs, const void* tile_off,
                     const void* tile_cnt, void* out_d, void* out_i, int n_sub,
                     int sub_per_tile, int qs, int D, long long n_rows, int kp,
                     int metric_ip, int store_bf16, int mode, int pb,
                     void* stream) {
  if (n_sub <= 0) return 0;
  if (store_bf16 || qs < 1 || qs > kQsMax || kp < 1 || D < 1 ||
      sub_per_tile < 1 || mode < kExact || mode > kBlockMin ||
      (mode != kExact && (pb < 1 || pb > 30)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(
      ivf_grouped_scan_smem_bytes(qs, D, kp, mode, 0));
  return launch_mode<float>(
      mode, static_cast<const float*>(qpad), vecs,
      static_cast<const int*>(tile_off), static_cast<const int*>(tile_cnt),
      static_cast<float*>(out_d), static_cast<int*>(out_i), n_sub,
      sub_per_tile, qs, D, n_rows, kp, metric_ip, pb, smem,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
