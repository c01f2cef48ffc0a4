// List-grouped IVF-PQ probe scan (ADC lookup tables), for Hopper (sm_90a).
//
// Replaces the TPU kernel neurondb_tpu/ops/pallas/ivfpq_scan.py
// `_pq_scan_kernel` (run through `grouped_pq_scan`) in both of its
// selection modes, exact (pos_bits = 0) and packed (pos_bits = pb), and
// absorbs `build_luts` (the same file), which on the TPU ran as XLA
// outside the kernel and wrote every tuple's table to device memory.
//
// What it computes. A tile t holds up to qt query slots that all probe one
// posting list: code columns [tile_off[t], tile_off[t] + tile_cnt[t]) of
// the subspace-major codes_t [n_sub, ncols] (uint8). Slot s carries an ADC
// table lut [n_sub * ks] f32 (ks <= 256 codewords per subspace), and a
// row's distance is
//   d = sum over j = 0..n_sub-1 of lut[j * ks + code_j]
// summed in f32 in the order of j, from 0. Two entries:
// - fused (`ivfpq_fused_scan`): slot s holds tuple g = slot_tuple[s], or
//   is empty (g = -1). Its table is built in shared memory,
//     lut[j*ks + k] = ((scale * dot) + sq[j, k]) + cn[g],
//     dot = sum over d = 0..ds-1, in order, of qc[g, j*ds + d] * cb[j, k, d],
//   each product and sum rounded on its own (__fmul_rn / __fadd_rn: no
//   FMA), the expression and order of the plain `adc_tables`. An empty
//   slot gets no table and no scan;
// - table-fed (`ivfpq_table_fed_scan`): the table is lutpad's row, every
//   slot is scored (the TPU kernel's interface).
// Per slot the kernel writes kp (distance, CSR row) pairs, ascending:
// - exact: the kp smallest in the order (d, row): ties go to the smaller
//   row, as the TPU kernel's argmin rounds give;
// - packed: the kp smallest keys pack_key(d, pos, pb) (topk_select.cuh),
//   pos = the row's in-list position, decoded to (rounded d, off + pos).
// Empty slots, unfilled places and every slot of a tile with
// tile_cnt == 0 hold (FLT_MAX, -1).
//
// What bounds it on the card. Not device memory: at the IVF-PQ headline
// (8,192 queries, nprobe 8, n_sub 32, ~977 rows per list) the fused
// entry reads 33.5 MB of residual queries and 32 MB of codes and writes
// 42 MB of top-kp, ~0.03 ms at 3.35 TB/s. Its ~7.4 GFLOP (2.05 G table
// lookups and adds, 5.4 GFLOP of table build) take ~0.11 ms at the f32
// peak. The floor is shared memory: 2.05 G lookups at random banks plus
// 0.54 G table stores, ~0.3 ms without bank conflicts and ~1 ms at the
// ~3.5-way conflicts of random addresses.
//
// Design, against the four costs of this kernel's first form (tables in
// device memory, padding slots scanned, one insertion at a time, 6 warps
// per SM):
// 1. tables in shared memory, built inside the kernel: a block serves
//    qs <= 3 slots of one tile (qs * n_sub KB of tables). It stages its
//    live slots' residual queries and constants in shared memory, then
//    each thread builds whole codebook rows, 4 rows' 16-byte loads in
//    flight at once, each row read once for all of the block's slots. No
//    table touches device memory, and the [t_max * qt, n_sub * ks] buffer
//    of `build_luts` is not needed;
// 2. live slots only: a block counts its slots with a tuple, builds and
//    scans only those, writes (FLT_MAX, -1) for the rest, and exits at
//    once when none is live or the tile is empty;
// 3. batched selection (topk_select.cuh `offer_batch`): each warp keeps a
//    sorted top-kp list and its last entry; candidates that beat that
//    entry go to a 64-entry buffer (ballot + popc); a full buffer is
//    sorted by a bitonic network in registers and merged into the list by
//    rank (binary search), in place of an insertion, a shift and up to
//    five barriers per candidate;
// 4. occupancy: 4 warps per slot, spread over the live slots when some
//    are empty (warp w serves live slot w % n_live and scans every
//    (warps of the slot)-th 128-row chunk of the list into its own list);
//    the slot's lists are then merged by rank straight into the output.
//    The wrapper takes the most slots with which two blocks share an SM
//    (3 at n_sub 32, kp 80: 2 x 12 = 24 resident warps), so one block's
//    table build overlaps the other's scan; `__launch_bounds__(384, 2)`
//    holds a thread to 80 registers.
// Per lane and chunk: 4 consecutive rows, one 4-byte code load per
// subspace (coalesced; the list's codes, 32 B a row, stay in L2), 4
// byte-indexed table lookups. Columns past the list's count are scored
// from the store's tail and never offered; loads past ncols are not made.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "topk_select.cuh"

namespace {

using ndb::kBatch;
using ndb::kIntFill;

constexpr int kKsMax = 256;             // codewords per subspace, at most
constexpr int kChunk = 128;             // rows per warp step (4 per lane)
constexpr int kQsMax = 3;               // slots (tables) per block
constexpr int kWarpsPerSlot = 4;
constexpr int kMaxThreads = kQsMax * kWarpsPerSlot * 32;
constexpr int kRowsInFlight = 4;        // codebook rows a thread loads at once
// Stage cuts, for measurement only (scripts/pq_ab.py --stages builds with
// -DNDB_PQ_CUT=1 or 2; the package never sets it): 1 offers a candidate
// only behind a test that never holds, so the ADC sums stay (table build
// and sums); 2 scans no row (table build only).
#ifndef NDB_PQ_CUT
#define NDB_PQ_CUT 0
#endif
constexpr int kCut = NDB_PQ_CUT;

struct Args {
  const float* lutpad;                  // table-fed: [n_tiles * qt, L]
  const float* qc;                      // fused: [G, D], D = ns * ds
  const float* cn;                      // fused: [G]
  const float* cb;                      // fused: [ns, ks, ds]
  const float* sq;                      // fused: [ns, ks]
  const int* slot_tuple;                // fused: [n_tiles * qt], -1 empty
  const uint8_t* codes_t;
  const int* tile_off;
  const int* tile_cnt;
  float* out_d;
  int* out_i;
  long long ncols;
  float scale;
  int sub_per_tile, qs, qt, ns, ks, ds, kp, pb;
  int vec;                              // fused: 16-byte loads of cb
};

// Words of shared memory ahead of the tables: in the fused entry (ds > 0)
// the slots' residual queries [qs][ns * ds] and constants [qs], rounded up
// to 16 bytes.
__host__ __device__ inline int staged_words(int qs, int ns, int ds) {
  return ds > 0 ? (qs * (ns * ds + 1) + 3) & ~3 : 0;
}

// The block's shared memory, in bytes: the staged words, qs tables of
// ns * ks floats, then per warp a top-kp list and a kBatch buffer (keys;
// rows in exact mode).
__host__ __device__ inline long long smem_bytes(int qs, int ns, int ks,
                                                int ds, int kp, int packed) {
  const long long warps = static_cast<long long>(qs) * kWarpsPerSlot;
  return 4 * (staged_words(qs, ns, ds) + static_cast<long long>(qs) * ns * ks +
              warps * (kp + kBatch) * (packed ? 1 : 2));
}

template <int kPacked, int kFused>
__global__ void __launch_bounds__(kMaxThreads, 2)
pq_scan_kernel(const Args a) {
  constexpr bool kRows = !kPacked;
  using K = std::conditional_t<kRows, float, int>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int kp = a.kp;
  const int t = blockIdx.x / a.sub_per_tile;
  const int q0 = (blockIdx.x % a.sub_per_tile) * a.qs;
  const int nq = min(a.qs, a.qt - q0);
  const int L = a.ns * a.ks;
  const int off = a.tile_off[t];
  int cnt = a.tile_cnt[t];
  if (off < 0 || off >= a.ncols) cnt = 0;
  else if (cnt > a.ncols - off) cnt = static_cast<int>(a.ncols - off);
  const long long slot0 = static_cast<long long>(t) * a.qt + q0;

  // live slots: bit s of `live` (every slot in the table-fed entry)
  unsigned live = 0;
  if (cnt > 0) {
    for (int s = 0; s < nq; ++s)
      if (!kFused || a.slot_tuple[slot0 + s] >= 0) live |= 1u << s;
  }
  const int nlive = __popc(live);
  float* o_d = a.out_d + slot0 * kp;
  int* o_i = a.out_i + slot0 * kp;
  for (int i = tid; i < nq * kp; i += blockDim.x) {
    if (!((live >> (i / kp)) & 1u)) {
      o_d[i] = FLT_MAX;
      o_i[i] = -1;
    }
  }
  if (nlive == 0) return;                     // block-uniform

  float* qc_s = smem;                            // fused: [qs][D], then cn
  float* lut_s = smem + staged_words(a.qs, a.ns, kFused ? a.ds : 0);
  K* lists_k = reinterpret_cast<K*>(lut_s + static_cast<long long>(a.qs) * L);
  K* buf_k = lists_k + nw * kp;                           // [nw][kBatch]
  int* lists_r = reinterpret_cast<int*>(buf_k + nw * kBatch);  // exact only
  int* buf_r = lists_r + nw * kp;

  if constexpr (kFused) {
    // the live slots' residual queries and constants, staged once
    const int D = a.ns * a.ds;
    float* cn_s = qc_s + a.qs * D;
    for (int i = tid; i < nlive * (D + 1); i += blockDim.x) {
      const int li = i / (D + 1), d = i % (D + 1);
      unsigned m = live;
      for (int r = 0; r < li; ++r) m &= m - 1;
      const int g = a.slot_tuple[slot0 + __ffs(m) - 1];
      if (d < D) qc_s[li * D + d] = a.qc[static_cast<long long>(g) * D + d];
      else cn_s[li] = a.cn[g];
    }
    __syncthreads();
    // codebook rows e = (j, k), kRowsInFlight at a time per thread: their
    // 16-byte loads are issued together, then every live slot's dot
    const int stride = blockDim.x;
    for (int e0 = tid; e0 < L; e0 += kRowsInFlight * stride) {
      float dot[kRowsInFlight][kQsMax];
      if (a.vec) {
        for (int d = 0; d < a.ds; d += 4) {
          float4 c[kRowsInFlight];
#pragma unroll
          for (int u = 0; u < kRowsInFlight; ++u) {
            const int e = min(e0 + u * stride, L - 1);
            c[u] = __ldg(reinterpret_cast<const float4*>(
                a.cb + static_cast<long long>(e) * a.ds + d));
          }
#pragma unroll
          for (int u = 0; u < kRowsInFlight; ++u) {
            const int j = min(e0 + u * stride, L - 1) / a.ks;
#pragma unroll
            for (int li = 0; li < kQsMax; ++li) {
              if (li < nlive) {
                const float4 q = *reinterpret_cast<const float4*>(
                    qc_s + li * D + j * a.ds + d);
                const float x = __fmul_rn(q.x, c[u].x);
                float acc = d == 0 ? x : __fadd_rn(dot[u][li], x);
                acc = __fadd_rn(acc, __fmul_rn(q.y, c[u].y));
                acc = __fadd_rn(acc, __fmul_rn(q.z, c[u].z));
                dot[u][li] = __fadd_rn(acc, __fmul_rn(q.w, c[u].w));
              }
            }
          }
        }
      } else {
        for (int d = 0; d < a.ds; ++d) {
#pragma unroll
          for (int u = 0; u < kRowsInFlight; ++u) {
            const int e = min(e0 + u * stride, L - 1);
            const float c = __ldg(a.cb + static_cast<long long>(e) * a.ds + d);
            const int j = e / a.ks;
#pragma unroll
            for (int li = 0; li < kQsMax; ++li) {
              if (li < nlive) {
                const float x = __fmul_rn(qc_s[li * D + j * a.ds + d], c);
                dot[u][li] = d == 0 ? x : __fadd_rn(dot[u][li], x);
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int e = e0 + u * stride;
        if (e < L) {
          const float sqv = __ldg(a.sq + e);
#pragma unroll
          for (int li = 0; li < kQsMax; ++li)
            if (li < nlive)
              lut_s[li * L + e] = __fadd_rn(
                  __fadd_rn(__fmul_rn(a.scale, dot[u][li]), sqv), cn_s[li]);
        }
      }
    }
  } else {                                    // every slot live: li == s
    const float* src = a.lutpad + slot0 * L;
    if ((L & 3) == 0) {                       // rows of 16-byte multiples
      for (int i = tid; i < nq * L / 4; i += blockDim.x)
        reinterpret_cast<float4*>(lut_s)[i] =
            reinterpret_cast<const float4*>(src)[i];
    } else {
      for (int i = tid; i < nq * L; i += blockDim.x) lut_s[i] = src[i];
    }
  }
  K kEmpty;
  if constexpr (kRows) kEmpty = FLT_MAX;
  else kEmpty = kIntFill;
  for (int i = tid; i < nw * kp; i += blockDim.x) {
    lists_k[i] = kEmpty;
    if constexpr (kRows) lists_r[i] = -1;
  }
  __syncthreads();

  // warp -> (live slot ls, member m of the nm warps that serve it)
  const int ls = warp % nlive;
  const int mem = warp / nlive;
  const int nm = (nw - 1 - ls) / nlive + 1;
  const float* lq = lut_s + static_cast<long long>(ls) * L;
  K* lk = lists_k + warp * kp;
  int* lr = lists_r + warp * kp;
  K* bk = buf_k + warp * kBatch;
  int* br = buf_r + warp * kBatch;
  K tk = kEmpty;
  int tr = -1, nbuf = 0;
  const bool word_aligned = (off & 3) == 0;
  for (int c0 = mem * kChunk; c0 < (kCut == 2 ? 0 : cnt);
       c0 += nm * kChunk) {
    const int r0 = c0 + 4 * lane;                   // in-list position
    const long long col = static_cast<long long>(off) + r0;
    const bool whole = word_aligned && col + 4 <= a.ncols;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < a.ns; ++j) {
      const uint8_t* cj = a.codes_t + j * a.ncols + col;
      unsigned w = 0;
      if (whole) {
        w = __ldg(reinterpret_cast<const unsigned*>(cj));
      } else {
        for (int b = 0; b < 4; ++b)
          if (col + b < a.ncols) w |= static_cast<unsigned>(cj[b]) << (8 * b);
      }
      const float* lj = lq + j * a.ks;
      acc[0] += lj[w & 255u];
      acc[1] += lj[(w >> 8) & 255u];
      acc[2] += lj[(w >> 16) & 255u];
      acc[3] += lj[w >> 24];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = r0 + b;
      if (kCut == 1 && !__any_sync(~0u, acc[b] == -1.f)) continue;
      if constexpr (kRows) {
        ndb::offer_batch<true>(lk, lr, kp, bk, br, acc[b], off + p, p < cnt,
                               kEmpty, lane, nbuf, tk, tr);
      } else {
        const int key = p < cnt ? ndb::pack_key(acc[b], p, a.pb) : kIntFill;
        ndb::offer_batch<false>(lk, lr, kp, bk, br, key, 0, p < cnt, kEmpty,
                                lane, nbuf, tk, tr);
      }
    }
  }
  ndb::flush_batch<kRows>(lk, lr, kp, bk, br, nbuf, kEmpty, lane, tk, tr);

  // the slot's lists merged by rank straight into the output: an entry
  // of member m goes to its index plus, for every other member v, the
  // count of v's entries before it (v < m: or equal to it)
  __syncthreads();
  unsigned m = live;
  for (int i = 0; i < ls; ++i) m &= m - 1;
  const int slot = __ffs(m) - 1;
  float* od = o_d + slot * kp;
  int* oi = o_i + slot * kp;
  for (int i = lane; i < kp; i += 32) {
    const K xk = lk[i];
    const int xr = kRows ? lr[i] : 0;
    int p = i;
    for (int v = 0; v < nm && p < kp; ++v) {
      if (v == mem) continue;
      const K* vk = lists_k + (ls + v * nlive) * kp;
      const int* vr = lists_r + (ls + v * nlive) * kp;
      p += v < mem ? ndb::count_below<kRows, true>(vk, vr, kp, xk, xr)
                   : ndb::count_below<kRows, false>(vk, vr, kp, xk, xr);
    }
    if (p >= kp) continue;
    if constexpr (kRows) {
      od[p] = xk;
      oi[p] = xr;
    } else {
      const bool empty = xk == kIntFill;
      od[p] = empty ? FLT_MAX : ndb::key_dist(xk, a.pb);
      oi[p] = empty ? -1 : off + ndb::key_pos(xk, a.pb);
    }
  }
}

template <int kPacked, int kFused>
int launch(const Args& a, int n_blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pq_scan_kernel<kPacked, kFused>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pq_scan_kernel<kPacked, kFused>
      <<<n_blocks, a.qs * kWarpsPerSlot * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& a, int n_tiles, bool fused, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (a.qs < 1 || a.qs > kQsMax || a.qt < 1 || a.ns < 1 || a.ks < 1 ||
      a.ks > kKsMax || a.kp < 1 || a.pb < 0 || a.pb > 30 || a.ncols < 1 ||
      (fused && a.ds < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(
      smem_bytes(a.qs, a.ns, a.ks, fused ? a.ds : 0, a.kp, a.pb > 0));
  const int n_blocks = n_tiles * a.sub_per_tile;
  if (fused)
    return a.pb > 0 ? launch<1, 1>(a, n_blocks, smem, stream)
                    : launch<0, 1>(a, n_blocks, smem, stream);
  return a.pb > 0 ? launch<1, 0>(a, n_blocks, smem, stream)
                  : launch<0, 0>(a, n_blocks, smem, stream);
}

template <int kPacked, int kFused>
int occupancy(int threads, size_t smem) {
  auto kern = pq_scan_kernel<kPacked, kFused>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Resident blocks per SM for blocks of qs slots (ds = 0: the table-fed
// entry), from cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 if one
// block does not fit, a negative CUDA error code on failure. A block has
// qs * 4 warps.
int ivfpq_scan_resident_blocks(int qs, int ns, int ks, int ds, int kp,
                               int packed) {
  if (qs < 1 || qs > kQsMax) return 0;
  const int threads = qs * kWarpsPerSlot * 32;
  const long long bytes = smem_bytes(qs, ns, ks, ds, kp, packed);
  if (bytes > 232448) return 0;               // sm_90's opt-in maximum
  const size_t smem = static_cast<size_t>(bytes);
  return ds > 0 ? (packed ? occupancy<1, 1>(threads, smem)
                          : occupancy<0, 1>(threads, smem))
                : (packed ? occupancy<1, 0>(threads, smem)
                          : occupancy<0, 0>(threads, smem));
}

// Table-fed entry. lutpad [n_tiles * qt, n_sub * ks] f32; codes_t
// [n_sub, ncols] uint8 (codes < ks); tile_off/tile_cnt [n_tiles] int32;
// out_d/out_i [n_tiles * qt, kp]. A tile is served by ceil(qt / qs)
// blocks. pos_bits pb = 0 selects exactly, pb in [1, 30] by packed keys.
// Launches on `stream` and returns the CUDA error code of the launch.
int ivfpq_table_fed_scan(const void* lutpad, const void* codes_t,
                         const void* tile_off, const void* tile_cnt,
                         void* out_d, void* out_i, int n_tiles, int qt,
                         int qs, int ns, int ks, long long ncols, int kp,
                         int pb, void* stream) {
  Args a{};
  a.lutpad = static_cast<const float*>(lutpad);
  a.codes_t = static_cast<const uint8_t*>(codes_t);
  a.tile_off = static_cast<const int*>(tile_off);
  a.tile_cnt = static_cast<const int*>(tile_cnt);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.ncols = ncols;
  a.sub_per_tile = qs > 0 ? (qt + qs - 1) / qs : 1;
  a.qs = qs;
  a.qt = qt;
  a.ns = ns;
  a.ks = ks;
  a.kp = kp;
  a.pb = pb;
  return dispatch(a, n_tiles, false, static_cast<cudaStream_t>(stream));
}

// Fused entry: the tables are built in shared memory from qc [G, n_sub *
// ds] f32, cn [G] f32, codebooks [n_sub, ks, ds] f32, sq [n_sub, ks] f32
// and `scale`; slot_tuple [n_tiles * qt] int32 holds each slot's tuple
// in [0, G), or -1 for an empty slot. The rest as the table-fed entry.
int ivfpq_fused_scan(const void* qc, const void* cn, const void* codebooks,
                     const void* sq, float scale, const void* slot_tuple,
                     const void* codes_t, const void* tile_off,
                     const void* tile_cnt, void* out_d, void* out_i,
                     int n_tiles, int qt, int qs, int ns, int ks, int ds,
                     long long ncols, int kp, int pb, void* stream) {
  Args a{};
  a.qc = static_cast<const float*>(qc);
  a.cn = static_cast<const float*>(cn);
  a.cb = static_cast<const float*>(codebooks);
  a.sq = static_cast<const float*>(sq);
  a.slot_tuple = static_cast<const int*>(slot_tuple);
  a.codes_t = static_cast<const uint8_t*>(codes_t);
  a.tile_off = static_cast<const int*>(tile_off);
  a.tile_cnt = static_cast<const int*>(tile_cnt);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.ncols = ncols;
  a.scale = scale;
  a.sub_per_tile = qs > 0 ? (qt + qs - 1) / qs : 1;
  a.qs = qs;
  a.qt = qt;
  a.ns = ns;
  a.ks = ks;
  a.ds = ds;
  a.kp = kp;
  a.pb = pb;
  a.vec = (ds & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(codebooks) & 15) == 0;
  return dispatch(a, n_tiles, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
