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
// warp. Two ways to fill it: `offer` inserts one candidate at a time
// (the flat kernel's f32 store); `offer_batch` gathers the candidates that
// beat the list's last entry in a per-warp buffer and merges the sorted
// buffer into the list by rank when it fills (the PQ kernel, and the probe
// and flat kernels at kp > 16). For kp <= kRegK a query's candidates are
// spread over several lanes, each keeping a `RegList` in registers (the
// probe kernel, and the flat kernel's bf16 store).
//
// The key arithmetic wraps as XLA's int32 arithmetic does: the rounding
// add runs in uint32 (signed overflow is undefined in C++), and `>> 31`
// on a signed int is an arithmetic shift under nvcc.

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

// ---- batched selection ----------------------------------------------------
//
// A merge by rank: in the merged order an entry's place is its index in
// its own sorted run plus the count of the other run's entries that go
// before it, found by binary search. Ties (only the fill entries can tie)
// go to the list: a run entry counts the list entries not after it, a
// list entry the run entries strictly before it, so the places are a
// permutation. Entries placed at kp or beyond drop out.

constexpr int kBatch = 64;                // candidates a warp's buffer holds

// Entries of the sorted s[0, n) that go before x (kAfterToo: or equal
// it), by binary lifting: every lane takes the same number of steps.
template <bool kRows, bool kAfterToo, typename K>
__device__ __forceinline__ int count_below(const K* sk, const int* sr, int n,
                                           K xk, int xr) {
  int pos = 0;
  for (int step = n > 0 ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1) {
    const int i = pos + step - 1;
    if (i < n) {
      const bool below =
          kAfterToo ? !before<kRows>(xk, xr, sk[i], kRows ? sr[i] : 0)
                    : before<kRows>(sk[i], kRows ? sr[i] : 0, xk, xr);
      if (below) pos += step;
    }
  }
  return pos;
}

// Merge the sorted run (sk, sr)[0, n), n <= kBatch, read only, into the
// warp's sorted list (lk, lr)[0, kp], in place. The run's places are
// found first, from the list as it stands; then the list's entries move
// up, 32 at a time from the top, each block read before it is written
// (a place is never below the entry's index); the run's entries land
// last. The list's entries below the run's first place stay.
template <bool kRows, typename K>
__device__ __forceinline__ void merge_sorted(K* lk, int* lr, int kp,
                                             const K* sk, const int* sr,
                                             int n, int lane) {
  if (n <= 0) return;                                   // warp-uniform
  K rk[2];
  int rr[2], rp[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = lane + 32 * e;
    rk[e] = K{};
    rr[e] = 0;
    rp[e] = kp;
    if (i < n) {
      rk[e] = sk[i];
      if (kRows) rr[e] = sr[i];
      rp[e] = i + count_below<kRows, true>(lk, lr, kp, rk[e], rr[e]);
    }
  }
  const int low = __shfl_sync(kFull, rp[0], 0);         // the run's first
  for (int b = (kp - 1) >> 5; b >= (low >> 5); --b) {
    const int i = (b << 5) + lane;
    K vk{};
    int vr = 0, p = kp;
    if (i >= low && i < kp) {
      vk = lk[i];
      if (kRows) vr = lr[i];
      p = i + count_below<kRows, false>(sk, sr, n, vk, vr);
    }
    __syncwarp();
    if (p < kp) {
      lk[p] = vk;
      if (kRows) lr[p] = vr;
    }
    __syncwarp();
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (rp[e] < kp) {
      lk[rp[e]] = rk[e];
      if (kRows) lr[rp[e]] = rr[e];
    }
  }
  __syncwarp();
}

// Sort the buffer (bk, br)[0, n), n <= kBatch, in place: a bitonic
// network over 64 entries in registers (entry e = lane + 32 h in h-th
// register), places past n padded with `pad`, which goes after every
// buffered candidate; stages with a partner 32 apart swap within a lane,
// the others exchange with lane ^ j by shuffles.
template <bool kRows, typename K>
__device__ __forceinline__ void sort_batch(K* bk, int* br, int n, K pad,
                                           int lane) {
  K k[2];
  int r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    k[h] = i < n ? bk[i] : pad;
    r[h] = (kRows && i < n) ? br[i] : 0x7FFFFFFF;
  }
#pragma unroll
  for (int size = 2; size <= 2 * 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j == 32) {                      // only at size 64: ascending
        if (before<kRows>(k[1], r[1], k[0], r[0])) {
          const K tk = k[0];
          const int tr = r[0];
          k[0] = k[1];
          r[0] = r[1];
          k[1] = tk;
          r[1] = tr;
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const K ok = __shfl_xor_sync(kFull, k[h], j);
        const int orr = kRows ? __shfl_xor_sync(kFull, r[h], j) : 0;
        const bool up = ((lane + 32 * h) & size) == 0;  // ascending run
        const bool low = (lane & j) == 0;               // lower of the pair
        const bool take = low == up ? before<kRows>(ok, orr, k[h], r[h])
                                    : before<kRows>(k[h], r[h], ok, orr);
        if (take) {
          k[h] = ok;
          r[h] = orr;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    if (i < n) {
      bk[i] = k[h];
      if (kRows) br[i] = r[h];
    }
  }
  __syncwarp();
}

// Merge the warp's buffer into its list and empty it; (tk, tr), the
// list's last entry, is updated.
template <bool kRows, typename K>
__device__ __forceinline__ void flush_batch(K* lk, int* lr, int kp, K* bk,
                                            int* br, int& nbuf, K pad,
                                            int lane, K& tk, int& tr) {
  __syncwarp();
  if (nbuf == 0) return;                                // warp-uniform
  sort_batch<kRows>(bk, br, nbuf, pad, lane);
  merge_sorted<kRows>(lk, lr, kp, bk, br, nbuf, lane);
  nbuf = 0;
  tk = lk[kp - 1];
  if (kRows) tr = lr[kp - 1];
}

// Offer each lane's candidate (key, row) to the warp's list through its
// buffer (bk, br)[0, kBatch) in shared memory. A candidate that beats the
// list's last entry (tk, tr) is appended at the buffer's count plus the
// count of lower lanes appending (ballot + popc); a buffer that would
// overflow is merged first, and the candidates are tested again against
// the new last entry. All 32 lanes call this together.
template <bool kRows, typename K>
__device__ __forceinline__ void offer_batch(K* lk, int* lr, int kp, K* bk,
                                            int* br, K key, int row,
                                            bool valid, K pad, int lane,
                                            int& nbuf, K& tk, int& tr) {
  bool want = valid && before<kRows>(key, row, tk, tr);
  unsigned m = __ballot_sync(kFull, want);
  if (m == 0) return;
  if (nbuf + __popc(m) > kBatch) {
    flush_batch<kRows>(lk, lr, kp, bk, br, nbuf, pad, lane, tk, tr);
    want = want && before<kRows>(key, row, tk, tr);
    m = __ballot_sync(kFull, want);
  }
  if (want) {
    const int at = nbuf + __popc(m & ((1u << lane) - 1u));
    bk[at] = key;
    if (kRows) br[at] = row;
  }
  nbuf += __popc(m);
}

// ---- selection in registers (kp <= kRegK) --------------------------------
//
// A query's candidates are split over a few lanes; each lane keeps the
// kRegK best it is given, sorted, in registers. Where a lane's candidates
// come in ascending row order, on equal keys an entry already in the list
// goes first, so keys alone place a candidate and the list is in (key, row)
// order; packed keys are unique and may come in any order. A candidate is
// given to its lane only if it goes before tau, the least over the query's
// lanes of their kp-th entries: tau's lane holds kp entries not after tau,
// so nothing after it can be in the query's top-kp, and every entry of the
// top-kp stays in its lane's list. The lists are merged at the end, kp
// times the least head over the query's lanes.

constexpr int kRegK = 16;                 // kp at most for lists in registers

template <typename K, bool kRows>
struct RegList {
  K k[kRegK];
  int r[kRows ? kRegK : 1];               // rows, kept with kRows
};

template <typename K, bool kRows>
__device__ __forceinline__ void reg_fill(RegList<K, kRows>& L, K fill) {
#pragma unroll
  for (int i = 0; i < kRegK; ++i) {
    L.k[i] = fill;
    if constexpr (kRows) L.r[i] = -1;
  }
}

// the candidate into the sorted list; the last entry drops out
template <typename K, bool kRows>
__device__ __forceinline__ void reg_insert(RegList<K, kRows>& L, K k, int r) {
#pragma unroll
  for (int i = kRegK - 1; i > 0; --i) {
    const bool up = k < L.k[i - 1];     // entry i takes entry i - 1
    const bool here = k < L.k[i];
    L.k[i] = up ? L.k[i - 1] : (here ? k : L.k[i]);
    if constexpr (kRows) L.r[i] = up ? L.r[i - 1] : (here ? r : L.r[i]);
  }
  if (k < L.k[0]) {
    L.k[0] = k;
    if constexpr (kRows) L.r[0] = r;
  }
}

// entry i (0 <= i < kRegK, known at run time only) into (k, r)
template <typename K, bool kRows>
__device__ __forceinline__ void reg_at(const RegList<K, kRows>& L, int i,
                                       K& k, int& r) {
  k = L.k[0];
  r = kRows ? L.r[0] : 0;
#pragma unroll
  for (int j = 1; j < kRegK; ++j)
    if (j == i) {
      k = L.k[j];
      if constexpr (kRows) r = L.r[j];
    }
}

// the head out; `fill` (row -1) enters at the end
template <typename K, bool kRows>
__device__ __forceinline__ void reg_pop(RegList<K, kRows>& L, K fill) {
#pragma unroll
  for (int i = 0; i < kRegK - 1; ++i) {
    L.k[i] = L.k[i + 1];
    if constexpr (kRows) L.r[i] = L.r[i + 1];
  }
  L.k[kRegK - 1] = fill;
  if constexpr (kRows) L.r[kRegK - 1] = -1;
}

// the least (k, r) over the lane groups of `width` lanes, or over lanes
// `step` apart within them (xor butterfly; equal pairs, only fills, may
// leave lanes with different `who`)
template <bool kRows, typename K>
__device__ __forceinline__ void group_min(K& k, int& r, int& who, int width,
                                          int step = 1) {
  for (int o = width >> 1; o >= step; o >>= 1) {
    const K ok = __shfl_xor_sync(kFull, k, o);
    const int orr = kRows ? __shfl_xor_sync(kFull, r, o) : 0;
    const int ow = __shfl_xor_sync(kFull, who, o);
    if (before<kRows>(ok, orr, k, r)) {
      k = ok;
      r = orr;
      who = ow;
    }
  }
}

}  // namespace ndb
