// Hopper (sm_90a) building blocks shared by the kernels: cp.async copies
// into a shared-memory ring, ldmatrix fragment loads, the bf16 mma.sync
// product and the f32-accurate product of three TF32 mma.sync (3xTF32).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace ndb {

// ---- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's pieces of a chunk of rows: the piece (row r0, column c0)
// first, then every kThreads-th, each step dr rows and dc columns on (no
// division in the copy loop). A piece is 16 bytes (vec8) or one element.
struct Copier {
  int per_row, r0, c0, dr, dc;
};

template <int kThreads>
__device__ __forceinline__ Copier copier(int per_row) {
  Copier k;
  k.per_row = per_row;
  k.r0 = threadIdx.x / per_row;
  k.c0 = threadIdx.x - k.r0 * per_row;
  k.dr = kThreads / per_row;
  k.dc = kThreads - k.dr * per_row;
  return k;
}

// Rows [c0, min(c0 + kChunk, n)), dims [d0, d0 + width) of the [*, D] rows
// at `src` into a ring stage of rows x_ld bytes apart, width = k.per_row
// pieces: 16-byte cp.async copies (vec8: D and d0 times the element size
// multiples of 16 and `src` 16-byte aligned), else element by element.
// Columns past the width are not written.
template <int kChunk, typename T>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const T* src,
                                           int c0, int n, int D, int x_ld,
                                           bool vec8, const Copier& k,
                                           int d0 = 0) {
  const int rows = min(kChunk, n - c0);
  const T* s = src + static_cast<long long>(c0) * D + d0;
  int r = k.r0, c = k.c0;
  if (vec8) {
    for (; r < rows; r += k.dr, c += k.dc) {
      if (c >= k.per_row) {
        c -= k.per_row;
        ++r;
        if (r >= rows) break;
      }
      cp_async16(dst + r * x_ld + c * 16,
                 reinterpret_cast<const unsigned char*>(
                     s + static_cast<long long>(r) * D) + c * 16);
    }
  } else {
    for (; r < rows; r += k.dr, c += k.dc) {
      if (c >= k.per_row) {
        c -= k.per_row;
        ++r;
        if (r >= rows) break;
      }
      reinterpret_cast<T*>(dst + r * x_ld)[c] = s[static_cast<long long>(r) * D + c];
    }
  }
}

// ---- bf16 tensor-core products ---------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x low, .y high
  return *reinterpret_cast<uint32_t*>(&h);
}

// D += A B: A 16x16 bf16 (row), B 16x8 bf16 (col), D 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] is this lane's pair of it (.trans: of its transpose).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two 8x8 bf16 matrices; lanes 0 .. 15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// ---- f32-accurate tensor-core products (3xTF32) -----------------------------

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero):
// the bits cvt.rna.tf32.f32 gives, made by an integer add of half a step
// to the magnitude and a mask. Conversions issue at a quarter of the
// integer ops' rate (16 against 64 a cycle an SM); with cvt, two a split,
// the grouped scan's f32 products took 12-16% longer.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact); the
// part of x that lo drops is at most 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// x = hi + lo: hi its top 19 bits (a TF32 value), lo = x - hi, exact in
// f32 (one LOP, one FSUB); the mma reads lo's top 19 bits. Flash's f32
// mode takes this split: it passes its tolerance and costs fewer issue
// slots than the rounded one.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
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

// D += A B to f32 accuracy (3xTF32): lo.hi + hi.lo, then hi.hi (lo.lo,
// below 2^-22 of the product, is dropped).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace ndb
