// Running top-kp selection shared by the grouped scan kernels.
//
// Two orders, as the TPU kernels select:
// - exact: (distance, CSR row) pairs, lexicographic, so on equal distance
//   the smaller row wins (what the TPU kernels' argmin rounds yield);
// - packed (the TPU kernels' pos_bits mode): one int32 key per candidate,
//   the distance's monotone bits rounded to a multiple of 2^pb with the
//   in-list position in the low pb bits. Positions are unique within a
//   tile, so keys are too (INT_FILL marks an empty slot).
//
// A list is kp entries in shared memory, sorted ascending, owned by one
// warp. The key arithmetic wraps as XLA's int32 arithmetic does: the
// rounding add runs in uint32 (signed overflow is undefined in C++), and
// `>> 31` on a signed int is an arithmetic shift under nvcc.

#pragma once

#include <cuda_runtime.h>

namespace ndb {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntFill = 0x7FFFFFFF;      // INT_FILL of the TPU kernels

// key = ((monotone(d) + 2^(pb-1)) & -(2^pb)) | pos
__device__ __forceinline__ int pack_key(float d, int pos, int pb) {
  const int b = __float_as_int(d);
  const int mono = b ^ ((b >> 31) & 0x7FFFFFFF);
  const unsigned hi = (static_cast<unsigned>(mono) + (1u << (pb - 1))) &
                      (~0u << pb);
  return static_cast<int>(hi | static_cast<unsigned>(pos));
}

// distance of a key: unmonotone(key & -(2^pb))
__device__ __forceinline__ float key_dist(int key, int pb) {
  const int kb = static_cast<int>(static_cast<unsigned>(key) & (~0u << pb));
  return __int_as_float(kb ^ ((kb >> 31) & 0x7FFFFFFF));
}

__device__ __forceinline__ int key_pos(int key, int pb) {
  return key & ((1 << pb) - 1);
}

// (ka, ra) sorts before (kb, rb); packed keys are unique, rows unused
template <bool kRows, typename K>
__device__ __forceinline__ bool before(K ka, int ra, K kb, int rb) {
  if constexpr (kRows) return ka < kb || (ka == kb && ra < rb);
  return ka < kb;
}

// Offer each lane's candidate (key, row) to one sorted top-kp list (lk and,
// with kRows, lr, in shared memory, owned by this warp). (wk, wr) caches
// the list's last entry and is updated. All 32 lanes call this together.
// Lanes whose candidate beats the last entry are found with one ballot;
// each is inserted by the warp: a counting pass finds its place and the
// tail shifts up by one.
template <bool kRows, typename K>
__device__ __forceinline__ void offer(K* lk, int* lr, int kp, K key, int row,
                                      bool valid, int lane, K& wk, int& wr) {
  unsigned m = __ballot_sync(kFull, valid && before<kRows>(key, row, wk, wr));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const K ck = __shfl_sync(kFull, key, src);
    const int cr = kRows ? __shfl_sync(kFull, row, src) : 0;
    if (!before<kRows>(ck, cr, wk, wr)) continue;     // warp-uniform
    int n_before = 0;
    for (int i = lane; i < kp; i += 32)
      n_before += before<kRows>(lk[i], kRows ? lr[i] : 0, ck, cr);
    const int pos = __reduce_add_sync(kFull, n_before);   // < kp
    // shift [pos, kp-2] up by one, highest 32-entry block first, so each
    // write lands on an entry that has already been moved
    for (int b = (kp - 2) >> 5; b >= (pos >> 5); --b) {
      const int i = (b << 5) + lane;
      const bool mv = i >= pos && i <= kp - 2;
      K vk{};
      int vr = 0;
      if (mv) {
        vk = lk[i];
        if (kRows) vr = lr[i];
      }
      __syncwarp();
      if (mv) {
        lk[i + 1] = vk;
        if (kRows) lr[i + 1] = vr;
      }
      __syncwarp();
    }
    if (lane == 0) {
      lk[pos] = ck;
      if (kRows) lr[pos] = cr;
    }
    __syncwarp();
    wk = lk[kp - 1];
    if (kRows) wr = lr[kp - 1];
  }
}

}  // namespace ndb
