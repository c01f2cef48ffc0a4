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
// The output is f32, written through its own strides.
//
// What bounds it on the card. At the cross-encoder's shape (B 64, H 12,
// S 512, Dh 64) a call reads 0.30 GB of f32 q, k, v and writes 0.10 GB:
// ~0.12 ms at 3.35 TB/s, against 51.5 GFLOP of products, ~0.05 ms at the
// bf16 tensor-core peak. It is byte-bound there, and operation-bound at
// long S (S 8192, Dh 128: 275 GFLOP, ~0.28 ms).
//
// Design (simple first):
// - one block per (query tile, batch x head), a loop over KV tiles inside
//   the block in place of the TPU's sequential grid axis; K and V tiles
//   staged in shared memory, rounded to bf16 as they are stored (so no
//   cast pass over q, k, v in device memory, and the strided views of
//   the dense layers' outputs are read in place);
// - bf16 mode: 4 warps x 16 query rows, mma.sync m16n8k16 (bf16 in, f32
//   accumulate): S = Q K^T into registers, the row max and sum through
//   quad shuffles, P repacked from the S accumulators straight into the
//   A fragments of the PV product (no trip through shared memory), V's B
//   fragments by ldmatrix.trans. Rows are padded by 8 bf16 so the
//   fragment loads hit 32 distinct banks. 64 x 64 tiles keep a block at
//   52 KB of shared memory at Dh 128, several blocks per SM;
// - f32 mode: plain FMA loops, 32 x 32 tiles, 4 threads per query row;
// - the mask is read per batch row (b = bh / H), no copy per head; the
//   no-mask case is its own instantiation. wgmma, TMA and a pipelined
//   K/V ring are for a later PR.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;       // the masked logit, as on the TPU
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBq = 64;                 // bf16 mode: query rows per block
constexpr int kBk = 64;                 // bf16 mode: keys per KV tile
constexpr int kBqF = 32;                // f32 mode: query rows per block
constexpr int kBkF = 32;                // f32 mode: keys per KV tile

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x low, .y high
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A B: A 16x16 bf16 (row), B 16x8 bf16 (col), D 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragment (16 keys x 8 columns) of a row-major [key][col] tile:
// lanes 0-15 give the addresses of rows 0-15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Rows [row0, row0 + kRows) of an f32 [S, kDh] slab (row stride rs) into a
// bf16 tile with rows of kDh + 8; rows >= S are zero.
template <int kDh, int kRows>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const float* src,
                                           long long rs, int row0, int S) {
  constexpr int kLd = kDh + 8, kC4 = kDh / 4;
  for (int i = threadIdx.x; i < kRows * kC4; i += kThreads) {
    const int r = i / kC4, c = (i % kC4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      x = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * rs + c));
    uint2 pk;
    pk.x = pack_bf16(x.x, x.y);
    pk.y = pack_bf16(x.z, x.w);
    *reinterpret_cast<uint2*>(dst + r * kLd + c) = pk;
  }
}

template <int kDh, bool kMask>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(Args a, int q_tiles) {
  constexpr int kLd = kDh + 8;          // bf16 elements per staged row
  constexpr int kKSteps = kDh / 16;     // k-steps of Q K^T over Dh
  constexpr int kNd = kDh / 8;          // 8-column tiles of the output
  constexpr int kNk = kBk / 8;          // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBq * kLd;
  __nv_bfloat16* Vs = Ks + kBk * kLd;
  int* Ms = reinterpret_cast<int*>(Vs + kBk * kLd);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBq;
  const int b = bh / a.H, h = bh % a.H;
  const int S = a.S;
  const float* kb = a.k + b * a.ksb + h * a.ksh;
  const float* vb = a.v + b * a.vsb + h * a.vsh;

  stage_bf16<kDh, kBq>(Qs, a.q + b * a.qsb + h * a.qsh, a.qss, q0, S);
  __syncthreads();
  uint32_t qa[kKSteps][4];
  const __nv_bfloat16* qw = Qs + warp * 16 * kLd;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld32(qw + g * kLd + c);
    qa[kk][1] = ld32(qw + (g + 8) * kLd + c);
    qa[kk][2] = ld32(qw + g * kLd + c + 8);
    qa[kk][3] = ld32(qw + (g + 8) * kLd + c + 8);
  }

  // rows g and g + 8 of the warp's 16: running max, this lane's share of
  // the running sum, and the output accumulators
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[kNd][4];
#pragma unroll
  for (int nd = 0; nd < kNd; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += kBk) {
    __syncthreads();                    // the last tile's readers are done
    stage_bf16<kDh, kBk>(Ks, kb, a.kss, kv0, S);
    stage_bf16<kDh, kBk>(Vs, vb, a.vss, kv0, S);
    if constexpr (kMask) {
      const int* mb = a.mask + static_cast<long long>(b) * S;
      for (int i = threadIdx.x; i < kBk; i += kThreads)
        Ms[i] = kv0 + i < S ? mb[kv0 + i] : 0;
    }
    __syncthreads();

    float s[kNk][4];
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const __nv_bfloat16* kr = Ks + (8 * j + g) * kLd + kk * 16 + 2 * t;
        const uint32_t kf[2] = {ld32(kr), ld32(kr + 8)};
        mma_bf16(s[j], qa[kk], kf);
      }
    }
    // s[j][e] is row g, key 8j + 2t + e; s[j][2 + e] is row g + 8
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = 8 * j + 2 * t + e;
        bool keep = true;
        if constexpr (kMask) keep = Ms[kj] > 0;
        const bool real = kv0 + kj < S;
        const float a0 = keep ? s[j][e] * a.scale : kNegInf;
        const float a1 = keep ? s[j][2 + e] * a.scale : kNegInf;
        s[j][e] = real ? a0 : -INFINITY;      // past S: no weight at all
        s[j][2 + e] = real ? a1 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
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
      const __nv_bfloat16* vr = Vs + (16 * ks + (lane & 15)) * kLd;
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd) {
        uint32_t vf[2];
        ldmatrix_x2_trans(vf, vr + 8 * nd);
        mma_bf16(o[nd], pa, vf);
      }
    }
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

// f32 mode: 4 threads per query row; thread (r, c) scores keys c + 4j of
// each tile and owns output columns c + 4i.
template <int kDh, bool kMask>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(Args a, int q_tiles) {
  constexpr int kLd = kDh + 1;          // padded rows: distinct banks
  constexpr int kLdp = kBkF + 1;
  constexpr int kPer = kDh / 4;
  constexpr int kKeys = kBkF / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kBqF][kLd]
  float* Ks = Qs + kBqF * kLd;                 // [kBkF][kLd]
  float* Vs = Ks + kBkF * kLd;                 // [kBkF][kDh]
  float* Ps = Vs + kBkF * kDh;                 // [kBqF][kLdp]
  int* Ms = reinterpret_cast<int*>(Ps + kBqF * kLdp);

  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBqF;
  const int b = bh / a.H, h = bh % a.H;
  const int S = a.S;
  const float* qb = a.q + b * a.qsb + h * a.qsh;
  const float* kb = a.k + b * a.ksb + h * a.ksh;
  const float* vb = a.v + b * a.vsb + h * a.vsh;

  for (int i = threadIdx.x; i < kBqF * kDh; i += kThreads) {
    const int rr = i / kDh, d = i % kDh;
    Qs[rr * kLd + d] = q0 + rr < S ? qb[(q0 + rr) * a.qss + d] : 0.f;
  }
  float m = kNegInf, l = 0.f, o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += kBkF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBkF * kDh; i += kThreads) {
      const int rr = i / kDh, d = i % kDh;
      const bool real = kv0 + rr < S;
      Ks[rr * kLd + d] = real ? kb[(kv0 + rr) * a.kss + d] : 0.f;
      Vs[rr * kDh + d] = real ? vb[(kv0 + rr) * a.vss + d] : 0.f;
    }
    if constexpr (kMask) {
      const int* mb = a.mask + static_cast<long long>(b) * S;
      for (int i = threadIdx.x; i < kBkF; i += kThreads)
        Ms[i] = kv0 + i < S ? mb[kv0 + i] : 0;
    }
    __syncthreads();

    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kDh; ++d) {
      const float qv = Qs[r * kLd + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[j] = fmaf(qv, Ks[(c + 4 * j) * kLd + d], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int kj = c + 4 * j;
      bool keep = true;
      if constexpr (kMask) keep = Ms[kj] > 0;
      const float x = keep ? s[j] * a.scale : kNegInf;
      s[j] = kv0 + kj < S ? x : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx), al = exp2f(m - mn);
    m = mn;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = exp2f(s[j] - mn);
      rs += p;
      Ps[r * kLdp + c + 4 * j] = p;
    }
    l = l * al + rs;
    __syncwarp();                       // row r's 4 threads share a warp
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[i] *= al;
    for (int key = 0; key < kBkF; ++key) {
      const float p = Ps[r * kLdp + key];
#pragma unroll
      for (int i = 0; i < kPer; ++i) o[i] = fmaf(p, Vs[key * kDh + c + 4 * i], o[i]);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (q0 + r < S) {
    float* orow = a.out + b * a.osb + h * a.osh + (q0 + r) * a.oss;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) orow[c + 4 * i] = o[i] / den;
  }
}

template <int kDh>
constexpr size_t smem_bytes(bool bf16) {
  return bf16 ? static_cast<size_t>(kBq + 2 * kBk) * (kDh + 8) * 2 + kBk * 4
              : (static_cast<size_t>(kBqF + kBkF) * (kDh + 1) + kBkF * kDh +
                 kBqF * (kBkF + 1) + kBkF) * 4;
}

int launch(void (*kernel)(Args, int), int q_tiles, int bh, size_t smem,
           cudaStream_t stream, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<q_tiles * bh, kThreads, smem, stream>>>(a, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh>
int dispatch(const Args& a, int bh, bool masked, bool bf16, cudaStream_t s) {
  const size_t smem = smem_bytes<kDh>(bf16);
  if (bf16) {
    const int qt = (a.S + kBq - 1) / kBq;
    return masked ? launch(flash_bf16_kernel<kDh, true>, qt, bh, smem, s, a)
                  : launch(flash_bf16_kernel<kDh, false>, qt, bh, smem, s, a);
  }
  const int qt = (a.S + kBqF - 1) / kBqF;
  return masked ? launch(flash_f32_kernel<kDh, true>, qt, bh, smem, s, a)
                : launch(flash_f32_kernel<kDh, false>, qt, bh, smem, s, a);
}

}  // namespace

extern "C" {

// Query and KV tile of the bf16 (mma.sync) and f32 instantiations.
int flash_attention_kv_tile(int bf16) { return bf16 ? kBk : kBkF; }

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
