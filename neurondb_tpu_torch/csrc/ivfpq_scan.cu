// List-grouped IVF-PQ probe scan (ADC lookup tables), for Hopper (sm_90a).
//
// Replaces the TPU kernel neurondb_tpu/ops/pallas/ivfpq_scan.py
// `_pq_scan_kernel` (run through `grouped_pq_scan`), in both of its
// selection modes: exact (pos_bits = 0) and packed (pos_bits = pb).
//
// What it computes. A tile t holds up to qt query slots that all probe one
// posting list: code columns [tile_off[t], tile_off[t] + tile_cnt[t]) of
// the subspace-major codes_t [n_sub, ncols] (uint8). Slot s of the tile
// carries its ADC table lut [n_sub * ks] f32 (ks <= 256 codewords per
// subspace, the per-slot constant already folded into every entry), and
// a row's distance is
//   d = sum over j = 0..n_sub-1 of lut[j * ks + code_j]
// summed in f32 in the order of j, from 0. Per slot the kernel writes kp
// (distance, CSR row) pairs, ascending:
// - exact: the kp smallest in the order (d, row): ties go to the smaller
//   row, as the TPU kernel's argmin rounds give;
// - packed: the kp smallest keys pack_key(d, pos, pb) (topk_select.cuh),
//   pos = the row's in-list position, decoded to (rounded d, off + pos).
// Empty slots, and every slot of a tile with tile_cnt == 0, hold
// (FLT_MAX, -1).
//
// What bounds it on the card. The tables: one slot's table is
// n_sub * 1 KB (32 KB at n_sub 32), read once. At the IVF-PQ headline
// (8,192 queries, nprobe 8, n_sub 32, ~977 rows per list) the real
// tuples' tables are 65,536 x 32 KB = 2.15 GB, about 0.64 ms at
// 3.35 TB/s; the codes (32 B per row) add ~0.07 GB per pass over the
// lists. The ~2 G table lookups are shared-memory reads at random banks,
// which a conflict-free card would serve in about 0.3 ms.
//
// Design (simple first):
// - the TPU kernel keeps a 64-query tile's tables in VMEM and evaluates
//   the lookups as a one-hot f32 matmul. A block here has at most 227 KB
//   of shared memory, and one table is up to 32 KB, so the wrapper splits
//   a tile into sub-tiles of qs <= 8 slots (qs = 6 at n_sub 32) whose
//   tables are staged in shared memory once (16-byte loads); the last
//   sub-tile may hold fewer. Each sub-tile reads the list's codes again;
//   they are 32 B per row and stay in L2;
// - one warp per slot; lane l scores the 4 consecutive rows 4l..4l+3 of
//   each 128-row chunk: one 4-byte code load per subspace (consecutive
//   lanes, consecutive words: coalesced), then 4 byte-indexed lookups
//   into the slot's table. The lookups hit random banks; their conflicts
//   are recorded, not optimised, here;
// - tables stay f32, as on the TPU, so the sums are the plain version's
//   bit for bit;
// - each slot's running top-kp (kp <= 256) is a sorted list in shared
//   memory beside the tables (topk_select.cuh `offer`); packed mode keeps
//   int32 keys only;
// - columns past the list's count are scored from the store's tail and
//   never offered; loads past ncols are not made. The TPU kernel's double
//   buffering and prefetch baton have no counterpart (blocks run in no
//   order).

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "topk_select.cuh"

namespace {

using ndb::kIntFill;

constexpr int kKsMax = 256;             // codewords per subspace, at most
constexpr int kChunk = 128;             // rows per warp step (4 per lane)
constexpr int kQsMax = 8;               // slots (warps) per block

template <int kPacked>
__global__ void __launch_bounds__(kQsMax * 32)
pq_scan_kernel(const float* __restrict__ lutpad,
               const uint8_t* __restrict__ codes_t,
               const int* __restrict__ tile_off,
               const int* __restrict__ tile_cnt, float* __restrict__ out_d,
               int* __restrict__ out_i, int sub_per_tile, int qs, int qt,
               int ns, int ks, long long ncols, int kp, int pb) {
  constexpr bool kRowsKept = !kPacked;
  using K = std::conditional_t<kRowsKept, float, int>;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x / sub_per_tile;
  const int q0 = (blockIdx.x % sub_per_tile) * qs;
  const int nq = min(qs, qt - q0);
  const int L = ns * ks;
  const int off = tile_off[t];
  int cnt = tile_cnt[t];
  if (off < 0 || off >= ncols) cnt = 0;
  else if (cnt > ncols - off) cnt = static_cast<int>(ncols - off);

  const long long slot0 = static_cast<long long>(t) * qt + q0;
  float* o_d = out_d + slot0 * kp;
  int* o_i = out_i + slot0 * kp;
  if (cnt <= 0) {
    for (int i = tid; i < nq * kp; i += blockDim.x) { o_d[i] = FLT_MAX; o_i[i] = -1; }
    return;
  }

  float* lut_s = smem;                                        // [qs][L]
  K* top_k = reinterpret_cast<K*>(lut_s + static_cast<long long>(qs) * L);
  int* top_r = reinterpret_cast<int*>(top_k + qs * kp);       // exact only

  K kEmpty;
  if constexpr (kRowsKept) kEmpty = FLT_MAX;
  else kEmpty = kIntFill;
  const float* src = lutpad + slot0 * L;
  if ((L & 3) == 0) {                        // rows of 16-byte multiples
    for (int i = tid; i < nq * L / 4; i += blockDim.x)
      reinterpret_cast<float4*>(lut_s)[i] =
          reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = tid; i < nq * L; i += blockDim.x) lut_s[i] = src[i];
  }
  for (int i = tid; i < nq * kp; i += blockDim.x) {
    top_k[i] = kEmpty;
    if constexpr (kRowsKept) top_r[i] = -1;
  }
  __syncthreads();
  if (warp >= nq) return;                    // no block barrier follows

  const float* lq = lut_s + warp * L;
  K* lk = top_k + warp * kp;
  int* lr = top_r + warp * kp;
  K wk = kEmpty;
  int wr = -1;
  const bool word_aligned = (off & 3) == 0;
  for (int c0 = 0; c0 < cnt; c0 += kChunk) {
    const int r0 = c0 + 4 * lane;                   // in-list position
    const long long col = static_cast<long long>(off) + r0;
    const bool whole = word_aligned && col + 4 <= ncols;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < ns; ++j) {
      const uint8_t* cj = codes_t + j * ncols + col;
      unsigned w = 0;
      if (whole) {
        w = __ldg(reinterpret_cast<const unsigned*>(cj));
      } else {
        for (int b = 0; b < 4; ++b)
          if (col + b < ncols) w |= static_cast<unsigned>(cj[b]) << (8 * b);
      }
      const float* lj = lq + j * ks;
      acc[0] += lj[w & 255u];
      acc[1] += lj[(w >> 8) & 255u];
      acc[2] += lj[(w >> 16) & 255u];
      acc[3] += lj[w >> 24];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = r0 + b;
      if constexpr (kRowsKept) {
        ndb::offer<true>(lk, lr, kp, acc[b], off + p, p < cnt, lane, wk, wr);
      } else {
        const int key = p < cnt ? ndb::pack_key(acc[b], p, pb) : kIntFill;
        ndb::offer<false>(lk, lr, kp, key, 0, true, lane, wk, wr);
      }
    }
  }

  __syncwarp();
  float* od = o_d + warp * kp;
  int* oi = o_i + warp * kp;
  for (int i = lane; i < kp; i += 32) {
    if constexpr (kRowsKept) {
      od[i] = lk[i];
      oi[i] = lr[i];
    } else {
      const int key = lk[i];
      const bool empty = key == kIntFill;
      od[i] = empty ? FLT_MAX : ndb::key_dist(key, pb);
      oi[i] = empty ? -1 : off + ndb::key_pos(key, pb);
    }
  }
}

template <int kPacked>
int launch(const float* lutpad, const uint8_t* codes_t, const int* tile_off,
           const int* tile_cnt, float* out_d, int* out_i, int n_blocks,
           int sub_per_tile, int qs, int qt, int ns, int ks, long long ncols,
           int kp, int pb, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pq_scan_kernel<kPacked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pq_scan_kernel<kPacked><<<n_blocks, qs * 32, smem, stream>>>(
      lutpad, codes_t, tile_off, tile_cnt, out_d, out_i, sub_per_tile, qs, qt,
      ns, ks, ncols, kp, pb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes: qs tables of n_sub *
// ks floats and qs top-kp lists (keys, plus rows in exact mode).
long long ivfpq_scan_smem_bytes(int qs, int ns, int ks, int kp, int packed) {
  const long long words = static_cast<long long>(qs) * ns * ks +
                          static_cast<long long>(qs) * kp * (packed ? 1 : 2);
  return 4 * words;
}

// lutpad [n_tiles * qt, n_sub * ks] f32; codes_t [n_sub, ncols] uint8
// (codes < ks);
// tile_off/tile_cnt [n_tiles] int32; out_d/out_i [n_tiles * qt, kp].
// A tile is served by sub_per_tile = ceil(qt / qs) blocks. pos_bits pb = 0
// selects exactly, pb in [1, 30] by packed keys. Launches on `stream` and
// returns the CUDA error code of the launch (0 = success).
int ivfpq_grouped_scan(const void* lutpad, const void* codes_t,
                       const void* tile_off, const void* tile_cnt, void* out_d,
                       void* out_i, int n_tiles, int qt, int qs, int ns,
                       int ks, long long ncols, int kp, int pb,
                       void* stream) {
  if (n_tiles <= 0) return 0;
  if (qs < 1 || qs > kQsMax || qt < 1 || ns < 1 || ks < 1 || ks > kKsMax ||
      kp < 1 || pb < 0 || pb > 30 || ncols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub_per_tile = (qt + qs - 1) / qs;
  const size_t smem =
      static_cast<size_t>(ivfpq_scan_smem_bytes(qs, ns, ks, kp, pb > 0));
  auto lut = static_cast<const float*>(lutpad);
  auto codes = static_cast<const uint8_t*>(codes_t);
  auto to = static_cast<const int*>(tile_off);
  auto tc = static_cast<const int*>(tile_cnt);
  auto od = static_cast<float*>(out_d);
  auto oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  const int n_blocks = n_tiles * sub_per_tile;
  if (pb > 0)
    return launch<1>(lut, codes, to, tc, od, oi, n_blocks, sub_per_tile, qs,
                     qt, ns, ks, ncols, kp, pb, smem, s);
  return launch<0>(lut, codes, to, tc, od, oi, n_blocks, sub_per_tile, qs, qt,
                   ns, ks, ncols, kp, pb, smem, s);
}

}  // extern "C"
