// Flash attention (tiled online softmax), for Hopper (sm_90a).
//
// Replaces the TPU kernel neurondb_tpu/ops/pallas/flash_attention.py
// `_flash_kernel` (run through `flash_attention`), with and without its
// key mask, in both of its product types: bf16 x bf16 -> f32 (bf16 = 1,
// the default) and f32 (bf16 = 0).
//
// What it computes. For one (batch b, head h) and query row i of
// q, k, v [B, H, S, Dh] (f32, any strides with a unit last stride):
//   s_ij = (q_i . k_j) * scale,  scale = log2(e) / sqrt(Dh)
//   s_ij = -1e30 where mask[b, j] <= 0 (the mask is optional)
//   out_i = sum_j 2^(s_ij - m_i) v_j / sum_j 2^(s_ij - m_i)
// as an online softmax over KV tiles of kBk keys, in the exp2 domain:
//   m' = max(m, max_j s_ij)       (m starts at -1e30)
//   p_ij = exp2(s_ij - m'),  alpha = exp2(m - m')
//   l' = alpha l + sum_j p_ij,  acc' = alpha acc + round(p) @ round(v)
//   out = acc / max(l, 1e-30)
// In the bf16 mode q, k and v are rounded to bf16 as they are staged, and
// p is rounded to bf16 before the PV product (the TPU kernel's
// `p.astype(vt.dtype)`); in the f32 mode nothing is rounded. A key index
// >= S contributes nothing (not even as a -1e30 logit), so a row whose
// every key is masked gets the mean of v over the S keys, as
// `attention_reference` gives (the TPU kernel averages over its padded
// length). Masked logits take -1e30, never -inf, so no row becomes NaN.
// The output is f32, written through its own strides. Only the KV tile
// fixes the numbers (p is rounded relative to each tile's running
// maximum); the query tile, the warps and the staging do not.
//
// What bounds it on the card. At the cross-encoder's shape (B 64, H 12,
// S 512, Dh 64, ragged mask) a call must read 0.30 GB of f32 q, k, v and
// write 0.10 GB: 0.403 GB, 0.120 ms at 3.35 TB/s. The bf16 mode's 51.5
// GFLOP of products take 0.052 ms at the 989 TFLOP/s bf16 tensor-core
// peak, so it is byte-bound there, and operation-bound at long S (S 8192,
// Dh 128: 275 GFLOP, 0.278 ms). The f32 mode does the same products to
// f32 accuracy as three TF32 products each (below), so its least time is
// 3 x the products at the 495 TFLOP/s dense TF32 rate: 0.234 ms at the
// cross-encoder's shape (38.7 GFLOP of real (query, key) pairs), 1.666 ms
// at S 8192, Dh 128; operation-bound at every shape served.
//
// Both modes share one skeleton (mma.sync, f32 accumulate):
// - one block per (query tile, batch x head), the query tile fastest, so a
//   head's blocks run together and share its K and V in L2; a loop over
//   KV tiles inside the block in place of the TPU's sequential grid axis;
// - 128 query rows per block, 8 warps x 16 rows. A 64-row tile fetched
//   each head's K and V once per 64 rows: 1.67 GB of reads per call at S
//   512; 128 rows cut that to ~0.88 GB (3,072 blocks x (32 KB of Q + 256
//   KB of K, V)), most of the re-reads hitting L2;
// - K and V go through a two-stage ring in shared memory, 64 keys a
//   stage. At the top of tile j every thread starts its 16-byte cp.async
//   copies of tile j + 1 (K, V and the mask's slice); tile j's Q K^T,
//   softmax and P V run from stage j & 1 while they are in flight; then
//   each thread waits for its own copies. One __syncthreads per tile, at
//   its end: it orders tile j's reads of stage j & 1 before the copies
//   into that stage during tile j + 1, and the copies of tile j + 1
//   before its reads. Loads held in registers across the tile instead
//   spilled at 128 registers (Dh 64, two blocks per SM), and the compiler
//   sank them to the end of the tile, next to their stores, so nothing
//   overlapped; cp.async holds no register;
// - the row max and sum through quad shuffles; P taken straight from the
//   S accumulators into the A fragments of the PV product, no shared
//   memory between the two products;
// - the mask is read per batch row (b = bh / H), no copy per head, staged
//   with K and V and kept as two words of key bits per stage (a ballot
//   per 32 keys); the no-mask case is its own instantiation;
// - rows past S (the last query tile, the last KV tile) are staged as
//   zeros and never written.
//
// bf16 mode (m16n8k16, bf16 in): the ring holds bf16 rows padded by 8
// (16-byte aligned, 8 rows on 8 distinct bank groups for ldmatrix); the
// cp.async copies land in an f32 staging buffer and each thread rounds
// its own pieces to bf16 into the other stage before the barrier (no
// barrier on the staging: a thread reads back only what it copied). Q is
// staged once and its A fragments (ldmatrix.x4) stay in registers for the
// whole KV loop; K's B fragments by ldmatrix.x4 (two 8-key tiles x two
// 8-column halves), V's by ldmatrix.x4.trans (two 8-column output tiles);
// p is rounded to bf16 as it is packed into the A fragments.
//
// f32 mode (m16n8k8, 3xTF32): every product is f32-accurate on the
// tensor cores. An operand x splits into hi = x & 0xffffe000, its top 19
// bits, exactly a TF32 value, and lo = x - hi, exact in f32 (one LOP, one
// FSUB, no cvt). Each product is lo.hi + hi.lo + hi.hi, three mma into
// the same accumulator, the small terms first; the dropped lo.lo and the
// hardware's truncation of lo to TF32 leave ~2^-21 relative per product,
// f32 noise. Both products take the split, p like any operand. The ring
// holds the cp.async'd f32 rows as they are, padded by 4 floats (ld = Dh
// + 4 = 4 mod 32 words), so the 32-bit fragment loads are conflict-free:
// bank 4g + t for Q's A and K's B fragments (row g, column t), 8t + g for
// V's (key 2t, column g). Q stays in shared memory and is split as its
// fragments are loaded each tile: held as hi/lo pairs it would take Dh
// registers a thread. The S accumulator holds keys 2t, 2t + 1 of each
// 8-key tile, but an m16n8k8 A fragment wants columns t, t + 4; so the PV
// product permutes its keys: k-slot t of key tile j is key 8j + 2t and
// k-slot t + 4 is key 8j + 2t + 1, the A fragment is {c0, c2, c1, c3} of
// the S accumulator and V's B fragment is rows 8j + 2t, 8j + 2t + 1. The
// sum over keys is the same.
//
// wgmma with a TMA-fed ring and warp specialisation, and split-KV for long
// S with few heads, are left for later (wgmma with TF32 needs both
// operands K-major, so V would be transposed in shared memory).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using ndb::ldmatrix_x4;
using ndb::ldmatrix_x4_trans;
using ndb::mma_bf16;
using ndb::pack_bf16;

constexpr float kNegInf = -1e30f;       // the masked logit, as on the TPU
constexpr int kThreads = 8 * 32;        // 8 warps x 16 query rows
constexpr int kBq = 128;                // query rows per block
constexpr int kBk = 64;                 // keys per KV tile (ring stage)
constexpr int kMaskWords = kBk / 32;    // key bits per tile
static_assert(kBk == 64, "a tile's key bits are read as one uint64");

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;                      // [B, S] or null
  float* out;
  int H, S;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale;
};

// x = hi + lo: hi its top 19 bits (a TF32 value), lo = x - hi (exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D += A B: A 16x8 tf32 (row), B 8x8 tf32 (col), D 16x8 f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B to f32 accuracy (3xTF32): lo.hi + hi.lo, then hi.hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The 16-byte pieces of rows [0, kRows) of an f32 [*, kDh] tile that
// this thread moves: piece n is row r0 + n * kRowStep, columns c .. c + 3.
// Consecutive threads take consecutive 16 bytes of a row. Copies land in
// rows of kLd floats.
template <int kDh, int kRows, int kLd = kDh>
struct Pieces {
  static constexpr int kC4 = kDh / 4;                   // pieces per row
  static constexpr int kN = kRows * kC4 / kThreads;   // pieces per thread
  static constexpr int kRowStep = kThreads / kC4;
  int r0, c;
  __device__ __forceinline__ Pieces()
      : r0(threadIdx.x / kC4), c((threadIdx.x % kC4) * 4) {}

  // Rows row0 + r of src (row stride rs) into dst [kRows][kLd] f32 by
  // cp.async, rows >= S as zeros (nothing read).
  __device__ __forceinline__ void copy_async(float* dst, const float* src,
                                             long long rs, int row0, int S) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int r = r0 + n * kRowStep;
      const bool real = row0 + r < S;
      const float* g = real ? src + (row0 + r) * rs + c : src;
      const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * kLd + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(d), "l"(g), "r"(real ? 16 : 0) : "memory");
    }
  }

  // This thread's pieces of an f32 [kRows][kDh] tile, rounded to bf16 into
  // dst [kRows][kDh + 8].
  __device__ __forceinline__ void round_into(__nv_bfloat16* dst, const float* src) const {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int r = r0 + n * kRowStep;
      const float4 x = *reinterpret_cast<const float4*>(src + r * kDh + c);
      *reinterpret_cast<uint2*>(dst + r * (kDh + 8) + c) =
          make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
    }
  }

  // Rows row0 + r of src straight through registers into dst [kRows][kDh
  // + 8] bf16, rows >= S as zeros.
  __device__ __forceinline__ void load_round(__nv_bfloat16* dst, const float* src,
                                             long long rs, int row0, int S) const {
    float4 x[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int r = r0 + n * kRowStep;
      x[n] = row0 + r < S
                 ? __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * rs + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<uint2*>(dst + (r0 + n * kRowStep) * (kDh + 8) + c) =
          make_uint2(pack_bf16(x[n].x, x[n].y), pack_bf16(x[n].z, x[n].w));
  }
};

// The mask's slice for keys key0 .. key0 + kBk - 1 into dst [kBk] int32
// by 4-byte cp.async (mask rows have no 16-byte alignment), keys >= S as 0.
__device__ __forceinline__ void copy_mask_async(int* dst, const int* mb, int key0, int S) {
  const int i = threadIdx.x;
  if (i < kBk) {
    const bool real = key0 + i < S;
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(real ? mb + key0 + i : mb), "r"(real ? 4 : 0) : "memory");
  }
}

// This thread's cp.async copies have landed (others' need a barrier).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bit i of word w: key 32 w + i of the tile is kept (mask > 0). Warps
// 0 .. kMaskWords - 1 each ballot their 32 keys from the staged slice
// (each thread its own copy); the others leave.
__device__ __forceinline__ void store_mask_bits(uint32_t* dst, const int* staged) {
  if ((threadIdx.x >> 5) < kMaskWords) {
    const uint32_t bits = __ballot_sync(0xffffffffu, staged[threadIdx.x] > 0);
    if ((threadIdx.x & 31) == 0) dst[threadIdx.x >> 5] = bits;
  }
}

// Shared memory of the bf16 kernel: Q [kBq], then the ring K[2], V[2]
// [kBk] of rows of kDh + 8 bf16; the f32 staging of the next K and V
// tiles [kBk][kDh] each and of its mask slice [kBk]; the mask ring
// [2][kMaskWords] of key bits.
template <int kDh>
constexpr size_t smem_bf16() {
  return static_cast<size_t>(kBq + 4 * kBk) * (kDh + 8) * 2 +
         static_cast<size_t>(2 * kBk) * kDh * 4 + kBk * 4 + 2 * kMaskWords * 4;
}

// Two blocks per SM up to Dh 64 (at most 128 registers a thread). At Dh
// 128 the output accumulators and Q fragments alone take 96 registers and
// a block 170,256 bytes of shared memory, so one.
template <int kDh, bool kMask>
__global__ void __launch_bounds__(kThreads, kDh == 128 ? 1 : 2)
flash_bf16_kernel(Args a, int q_tiles) {
  constexpr int kLd = kDh + 8;          // bf16 elements per staged row
  constexpr int kKSteps = kDh / 16;     // k-steps of Q K^T over Dh
  constexpr int kNd = kDh / 8;          // 8-column tiles of the output
  constexpr int kNk = kBk / 8;          // 8-key tiles of S
  constexpr int kStage = kBk * kLd;     // bf16 elements of one K or V stage
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBq * kLd;
  __nv_bfloat16* Vs = Ks + 2 * kStage;
  float* Kf = reinterpret_cast<float*>(Vs + 2 * kStage);
  float* Vf = Kf + kBk * kDh;
  int* Mf = reinterpret_cast<int*>(Vf + kBk * kDh);
  uint32_t* Ms = reinterpret_cast<uint32_t*>(Mf + kBk);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBq;
  const int b = bh / a.H, h = bh % a.H;
  const int S = a.S;
  const float* kb = a.k + b * a.ksb + h * a.ksh;
  const float* vb = a.v + b * a.vsb + h * a.vsh;
  const int* mb = kMask ? a.mask + static_cast<long long>(b) * S : nullptr;
  const Pieces<kDh, kBk> kv;

  // prologue: KV tile 0 by cp.async while Q goes through registers into
  // shared memory; then tile 0 rounded into stage 0
  kv.copy_async(Kf, kb, a.kss, 0, S);
  kv.copy_async(Vf, vb, a.vss, 0, S);
  if constexpr (kMask) copy_mask_async(Mf, mb, 0, S);
  Pieces<kDh, kBq>().load_round(Qs, a.q + b * a.qsb + h * a.qsh, a.qss, q0, S);
  cp_async_wait_all();
  kv.round_into(Ks, Kf);
  kv.round_into(Vs, Vf);
  if constexpr (kMask) store_mask_bits(Ms, Mf);
  __syncthreads();
  // the warp's 16 rows as A fragments: lanes 0-15 address rows 0-15 at
  // column 16 kk, lanes 16-31 the same rows at column 16 kk + 8
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldmatrix_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                            (lane >> 4) * 8);
  // K: lanes address key 8j + (lane & 7) (+ 8 for lanes 16-31) at column
  // 16 kk (+ 8 for lanes 8-15, 24-31): B fragments of key tiles j, j + 1.
  // V (.trans): lanes address key 16 ks + (lane & 15) at column 8 nd (+ 8
  // for lanes 16-31): B fragments of output tiles nd, nd + 1.
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 8;
  const int v_lane = (lane & 15) * kLd + (lane >> 4) * 8;

  // rows g and g + 8 of the warp's 16: running max, this lane's share of
  // the running sum, and the output accumulators
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[kNd][4];
#pragma unroll
  for (int nd = 0; nd < kNd; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  const int n_tiles = (S + kBk - 1) / kBk;
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = it * kBk, st = it & 1;
    const bool more = it + 1 < n_tiles;
    // tile it + 1 into the f32 staging, in flight while tile it's products
    // run (this thread converted its pieces of the staging last tile)
    if (more) {
      kv.copy_async(Kf, kb, a.kss, kv0 + kBk, S);
      kv.copy_async(Vf, vb, a.vss, kv0 + kBk, S);
      if constexpr (kMask) copy_mask_async(Mf, mb, kv0 + kBk, S);
    }

    const __nv_bfloat16* Kt = Ks + st * kStage;
    const __nv_bfloat16* Vt = Vs + st * kStage;
    float s[kNk][4];
#pragma unroll
    for (int j = 0; j < kNk; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kNk; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + 8 * j * kLd + kk * 16 + k_lane);
        mma_bf16(s[j], qa[kk], kf[0], kf[1]);
        mma_bf16(s[j + 1], qa[kk], kf[2], kf[3]);
      }
    }
    // s[j][e] is row g, key 8j + 2t + e; s[j][2 + e] is row g + 8
    uint64_t keep_bits = ~0ull;         // bit 8j + e: key 8j + 2t + e kept
    if constexpr (kMask)
      keep_bits = (static_cast<uint64_t>(Ms[st * kMaskWords + 1]) << 32 |
                   Ms[st * kMaskWords]) >> (2 * t);
    const int live = S - kv0;           // keys of this tile below S
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = 8 * j + 2 * t + e;
        const bool keep = (keep_bits >> (8 * j + e)) & 1;
        float a0 = keep ? s[j][e] * a.scale : kNegInf;
        float a1 = keep ? s[j][2 + e] * a.scale : kNegInf;
        if (kj >= live) a0 = a1 = -INFINITY;  // past S: no weight at all
        s[j][e] = a0;
        s[j][2 + e] = a1;
        mx0 = fmaxf(mx0, a0);
        mx1 = fmaxf(mx1, a1);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - mn0);
        s[j][2 + e] = exp2f(s[j][2 + e] - mn1);
        rs0 += s[j][e];
        rs1 += s[j][2 + e];
      }
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) {
      o[nd][0] *= al0;
      o[nd][1] *= al0;
      o[nd][2] *= al1;
      o[nd][3] *= al1;
    }
    // P (bf16) @ V: the accumulators of key tiles 2ks and 2ks + 1 are the
    // A fragment of the k-step over keys 16ks .. 16ks + 15
#pragma unroll
    for (int ks = 0; ks < kBk / 16; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int nd = 0; nd < kNd; nd += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + 16 * ks * kLd + 8 * nd + v_lane);
        mma_bf16(o[nd], pa, vf[0], vf[1]);
        mma_bf16(o[nd + 1], pa, vf[2], vf[3]);
      }
    }

    // tile it + 1 rounded into the other stage: its last readers were
    // tile it - 1, done before the barrier that ended that tile
    if (more) {
      cp_async_wait_all();
      kv.round_into(Ks + (st ^ 1) * kStage, Kf);
      kv.round_into(Vs + (st ^ 1) * kStage, Vf);
      if constexpr (kMask) store_mask_bits(Ms + (st ^ 1) * kMaskWords, Mf);
    }
    __syncthreads();
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float* ob = a.out + b * a.osb + h * a.osh;
#pragma unroll
  for (int nd = 0; nd < kNd; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (r0 < S)
      *reinterpret_cast<float2*>(ob + r0 * a.oss + c) =
          make_float2(o[nd][0] / d0, o[nd][1] / d0);
    if (r1 < S)
      *reinterpret_cast<float2*>(ob + r1 * a.oss + c) =
          make_float2(o[nd][2] / d1, o[nd][3] / d1);
  }
}

// Shared memory of the f32 kernel: Q [kBq], then the ring K[2], V[2]
// [kBk] of rows of kDh + 4 floats; the mask's staged slice [kBk]; the
// mask ring [2][kMaskWords] of key bits.
template <int kDh>
constexpr size_t smem_f32() {
  return static_cast<size_t>(kBq + 4 * kBk) * (kDh + 4) * 4 + kBk * 4 +
         2 * kMaskWords * 4;
}

// Two blocks per SM up to Dh 64 (at most 128 registers a thread; 104,720
// bytes of shared memory each at Dh 64); one at Dh 128 (203,024 bytes).
template <int kDh, bool kMask>
__global__ void __launch_bounds__(kThreads, kDh == 128 ? 1 : 2)
flash_f32_kernel(Args a, int q_tiles) {
  constexpr int kLd = kDh + 4;          // floats per staged row
  constexpr int kKSteps = kDh / 8;      // k-steps of Q K^T over Dh
  constexpr int kNd = kDh / 8;          // 8-column tiles of the output
  constexpr int kNk = kBk / 8;          // 8-key tiles of S
  constexpr int kStage = kBk * kLd;     // floats of one K or V stage
  static_assert(kLd % 32 == 4, "fragment loads rely on ld = 4 mod 32 banks");
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBq * kLd;
  float* Vs = Ks + 2 * kStage;
  int* Mf = reinterpret_cast<int*>(Vs + 2 * kStage);
  uint32_t* Ms = reinterpret_cast<uint32_t*>(Mf + kBk);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBq;
  const int b = bh / a.H, h = bh % a.H;
  const int S = a.S;
  const float* kb = a.k + b * a.ksb + h * a.ksh;
  const float* vb = a.v + b * a.vsb + h * a.vsh;
  const int* mb = kMask ? a.mask + static_cast<long long>(b) * S : nullptr;
  const Pieces<kDh, kBk, kLd> kv;

  // prologue: Q and KV tile 0 (stage 0) by cp.async
  kv.copy_async(Ks, kb, a.kss, 0, S);
  kv.copy_async(Vs, vb, a.vss, 0, S);
  if constexpr (kMask) copy_mask_async(Mf, mb, 0, S);
  Pieces<kDh, kBq, kLd>().copy_async(Qs, a.q + b * a.qsb + h * a.qsh, a.qss, q0, S);
  cp_async_wait_all();
  if constexpr (kMask) store_mask_bits(Ms, Mf);
  __syncthreads();
  // A fragments of the warp's 16 rows: (g, t), (g + 8, t), (g, t + 4),
  // (g + 8, t + 4) of each 8-column step. B of Q K^T: key g of an 8-key
  // tile at dims t, t + 4. B of P V (keys permuted, see the note): keys
  // 2t, 2t + 1 of an 8-key tile at column g.
  const float* qw = Qs + (warp * 16 + g) * kLd + t;
  const int k_lane = g * kLd + t;
  const int v_lane = 2 * t * kLd + g;

  // rows g and g + 8 of the warp's 16: running max, this lane's share of
  // the running sum, and the output accumulators
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[kNd][4];
#pragma unroll
  for (int nd = 0; nd < kNd; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  const int n_tiles = (S + kBk - 1) / kBk;
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = it * kBk, st = it & 1;
    const bool more = it + 1 < n_tiles;
    // tile it + 1 into the other stage, in flight while tile it's
    // products run (its last readers were tile it - 1, before the barrier)
    if (more) {
      kv.copy_async(Ks + (st ^ 1) * kStage, kb, a.kss, kv0 + kBk, S);
      kv.copy_async(Vs + (st ^ 1) * kStage, vb, a.vss, kv0 + kBk, S);
      if constexpr (kMask) copy_mask_async(Mf, mb, kv0 + kBk, S);
    }

    const float* Kt = Ks + st * kStage + k_lane;
    const float* Vt = Vs + st * kStage + v_lane;
    float s[kNk][4];
#pragma unroll
    for (int j = 0; j < kNk; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qh[4], ql[4];
      split_tf32(qw[8 * kk], qh[0], ql[0]);
      split_tf32(qw[8 * kk + 8 * kLd], qh[1], ql[1]);
      split_tf32(qw[8 * kk + 4], qh[2], ql[2]);
      split_tf32(qw[8 * kk + 8 * kLd + 4], qh[3], ql[3]);
#pragma unroll
      for (int j = 0; j < kNk; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(Kt[8 * j * kLd + 8 * kk], bh0, bl0);
        split_tf32(Kt[8 * j * kLd + 8 * kk + 4], bh1, bl1);
        mma_3xtf32(s[j], qh, ql, bh0, bh1, bl0, bl1);
      }
    }
    // s[j][e] is row g, key 8j + 2t + e; s[j][2 + e] is row g + 8
    uint64_t keep_bits = ~0ull;         // bit 8j + e: key 8j + 2t + e kept
    if constexpr (kMask)
      keep_bits = (static_cast<uint64_t>(Ms[st * kMaskWords + 1]) << 32 |
                   Ms[st * kMaskWords]) >> (2 * t);
    const int live = S - kv0;           // keys of this tile below S
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = 8 * j + 2 * t + e;
        const bool keep = (keep_bits >> (8 * j + e)) & 1;
        float a0 = keep ? s[j][e] * a.scale : kNegInf;
        float a1 = keep ? s[j][2 + e] * a.scale : kNegInf;
        if (kj >= live) a0 = a1 = -INFINITY;  // past S: no weight at all
        s[j][e] = a0;
        s[j][2 + e] = a1;
        mx0 = fmaxf(mx0, a0);
        mx1 = fmaxf(mx1, a1);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - mn0);
        s[j][2 + e] = exp2f(s[j][2 + e] - mn1);
        rs0 += s[j][e];
        rs1 += s[j][2 + e];
      }
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) {
      o[nd][0] *= al0;
      o[nd][1] *= al0;
      o[nd][2] *= al1;
      o[nd][3] *= al1;
    }
    // P @ V over key tile j, k-slots t and t + 4 standing for keys 2t and
    // 2t + 1: the A fragment is {c0, c2, c1, c3} of s[j]
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(Vt[8 * j * kLd + 8 * nd], bh0, bl0);
        split_tf32(Vt[8 * j * kLd + kLd + 8 * nd], bh1, bl1);
        mma_3xtf32(o[nd], ph, pl, bh0, bh1, bl0, bl1);
      }
    }

    if (more) {
      cp_async_wait_all();
      if constexpr (kMask) store_mask_bits(Ms + (st ^ 1) * kMaskWords, Mf);
    }
    __syncthreads();
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float* ob = a.out + b * a.osb + h * a.osh;
#pragma unroll
  for (int nd = 0; nd < kNd; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (r0 < S)
      *reinterpret_cast<float2*>(ob + r0 * a.oss + c) =
          make_float2(o[nd][0] / d0, o[nd][1] / d0);
    if (r1 < S)
      *reinterpret_cast<float2*>(ob + r1 * a.oss + c) =
          make_float2(o[nd][2] / d1, o[nd][3] / d1);
  }
}

using Kernel = void (*)(Args, int);

int launch(Kernel kernel, int q_tiles, int bh, int threads,
           size_t smem, cudaStream_t stream, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<q_tiles * bh, threads, smem, stream>>>(a, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of one launch, and its dynamic shared memory.
template <int kDh>
Kernel kernel_for(bool masked, bool bf16) {
  if (bf16) return masked ? flash_bf16_kernel<kDh, true> : flash_bf16_kernel<kDh, false>;
  return masked ? flash_f32_kernel<kDh, true> : flash_f32_kernel<kDh, false>;
}

template <int kDh>
size_t smem_for(bool bf16) { return bf16 ? smem_bf16<kDh>() : smem_f32<kDh>(); }

template <int kDh>
int dispatch(const Args& a, int bh, bool masked, bool bf16, cudaStream_t s) {
  return launch(kernel_for<kDh>(masked, bf16), (a.S + kBq - 1) / kBq, bh, kThreads,
                smem_for<kDh>(bf16), s, a);
}

// Resident blocks per SM of an instantiation (-1 on a CUDA error).
template <int kDh>
int occupancy(bool masked, bool bf16) {
  const Kernel kernel = kernel_for<kDh>(masked, bf16);
  const size_t smem = smem_for<kDh>(bf16);
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

// KV tile of the bf16 and f32 instantiations: the ring's stage in both.
int flash_attention_kv_tile(int /*bf16*/) { return kBk; }

// Resident blocks per SM of the instantiation for head width dh (32, 64,
// 128), with or without the mask, in the bf16 or f32 mode; -1 for
// another dh or an error.
int flash_attention_occupancy(int dh, int masked, int bf16) {
  switch (dh) {
    case 32: return occupancy<32>(masked != 0, bf16 != 0);
    case 64: return occupancy<64>(masked != 0, bf16 != 0);
    case 128: return occupancy<128>(masked != 0, bf16 != 0);
    default: return -1;
  }
}

// q, k, v [B, H, S, dh] f32 with element strides (sb, sh, ss) and a unit
// last stride, 16-byte aligned rows; mask [B, S] int32 (> 0 = attend) or
// null; out [B, H, S, dh] f32 through its strides. dh in {32, 64, 128}.
// Launches on `stream`; returns the CUDA error code (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* mask, void* out, int B, int H, int S,
                        int dh, long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss,
                        float scale, int bf16, void* stream) {
  if (B < 0 || H < 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || S == 0) return 0;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const int*>(mask),
         static_cast<float*>(out), H, S, qsb, qsh, qss, ksb, ksh, kss,
         vsb, vsh, vss, osb, osh, oss, scale};
  const int bh = B * H;
  const bool masked = mask != nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return dispatch<32>(a, bh, masked, bf16 != 0, s);
    case 64: return dispatch<64>(a, bh, masked, bf16 != 0, s);
    case 128: return dispatch<128>(a, bh, masked, bf16 != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
