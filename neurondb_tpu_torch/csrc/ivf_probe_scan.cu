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
// store). q . x and |x|^2 are f32 fmaf chains over d = 0 .. D-1 in order;
// |q|^2 is lane-strided fmaf partials summed by an xor butterfly. Ties go
// to the smaller row, which is what the TPU kernel's argmin extraction
// over [running | segment] yields. Unused slots, and tuples with n == 0,
// hold (FLT_MAX, -1). The merge across probe ranks runs outside the
// kernel, in torch, as it ran in XLA.
//
// The numbers are those of the first kernel (one warp per tuple), bit for
// bit: the same chains in the same order, and the same distance
// expression. nvcc did not contract `(qsq + xsq) - 2.f * dot` there: its
// SASS adds dot + dot and subtracts that from qsq + xsq, two roundings
// that this source writes out with __fadd_rn / __fsub_rn, which nvcc
// never contracts.
//
// Precision. The TPU source asks for f32 distances ("compute in f32 for
// accurate distances"), and its CPU interpret run and numpy oracle compute
// them so; on the TPU itself a default-precision f32 dot_general rounds q
// to bf16, an artefact this kernel does not copy. Tensor cores would
// change the numbers (2xTF32 with q split into hi + lo is the candidate).
//
// What bounds it on the card. At the 1M x 128 headline (16,384 queries,
// nprobe 8, ~977 bf16 rows a list) the function needs ~33.0 GFLOP of f32
// products and norms (0.493 ms at 67 TFLOP/s) and 0.276 GB of distinct
// rows, queries and partials (0.082 ms at 3.35 TB/s): it is
// operation-bound. The first kernel served one tuple per warp, so each
// tuple re-read its whole list (32.8 GB at the headline), lanes loaded
// rows 256 B apart, every tuple recomputed |x|^2, and candidates entered
// the list one at a time.
//
// Design. One read of a list serves every tuple that probes it:
// - the work table (built on the card by the wrapper, in torch, with no
//   host synchronisation): each tuple t = b * nprobe + p gets the key
//   off << 32 | n (below 0 or with n == 0: nothing to read), and the
//   tuples are sorted stably by key. With the launch's query tile TQ (32,
//   or 16, 8, 4 where fewer tuples would leave SMs idle, and narrower where
//   kp > 16 needs the shared memory), block i takes the sorted positions
//   [i * TQ, i * TQ + TQ); an item is a run of equal keys inside one
//   block's positions: one list, at most TQ tuples. The grid is
//   ceil(B * nprobe / TQ), from shapes alone; B * nprobe < 2^31;
// - per item, a query tile of W = 4, 8, 16 or 32 tuples, the narrowest
//   that holds the item, so an item of 1-4 tuples does not pay for 32;
//   the item's f32 queries and their |q|^2 sit in shared memory;
// - the list streams through a ring in shared memory (3 stages for bf16, 2
//   for f32) whose stage holds one 128-dim slab of a 64-row chunk, filled
//   by coalesced 16-byte cp.async copies (element copies where D % 8 or the
//   store's alignment forbid) while the slabs before are scored; rows stay
//   as stored and are widened on read; a staged row's stride is an odd
//   number of 16-byte units, so the 8 rows of a quarter warp fall in
//   different banks. The register tile's sums carry across a chunk's slabs
//   in d order, so each product and norm is the first kernel's fmaf chain
//   at every D, and the ring's size does not grow with D;
// - a register tile: 4 warps of 128 threads; a lane holds the products of
//   R rows x Q queries (2 x 8 at W = 32, 1 x 2 at W = 4), its rows 32 apart
//   and the queries broadcast, and loads R + 2Q 16-byte vectors for 8RQ
//   fmaf (the first kernel loaded one value per two fmaf); one lane per row
//   also sums |x|^2, so a row's norm is computed once per chunk; a warp
//   whose queries are all padding skips the slab;
// - the products of chunk c go to one of two buffers, and at chunk c's
//   first slab each warp selects from chunk c - 1's: one barrier a slab,
//   and the warps drift apart between barriers, so some multiply while
//   others select;
// - selection, kp <= 16 (the main path's k 10): a query's 128 / W lanes
//   each keep their 16 best pairs sorted in registers, take the candidates
//   that go before the query's bound (the least of its lanes' kp-th
//   entries), queue them in shared memory and insert them in row order,
//   so the warp runs the insertion as often as its longest queue; the
//   lists are merged at the end of the item. kp > 16: each query's sorted
//   list in shared memory, fed through topk_select.cuh `offer_batch<true>`
//   (a 64-entry buffer per query, merged by rank when it fills). Both keep
//   exact (distance, row) order. out[p, b, :] is written at the tuple's
//   own place;
// - four kernels per store type: tiles 4 and 8 without the wide tiles'
//   registers (three blocks to an SM), tiles 16 and 32 (two), each for
//   D <= 128, where a chunk is one stage and its sums never outlive it,
//   and for wider D.
//
// Limits: kp in [1, 512]; bf16 and f32 stores; the wrapper picks the
// widest query tile whose shared memory fits 227 KB. The queries are staged
// at full width, so a 4-query tile fits up to D 9,940 (bf16 store) or
// 8,980 (f32) at kp 512; wider D raises in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "topk_select.cuh"

// Stage cuts for measurement only (scripts/probe_ab.py --stages builds
// them): 1 skips the selection, 2 the products and the selection too. The
// package builds the whole kernel (0).
#ifndef NDB_PROBE_CUT
#define NDB_PROBE_CUT 0
#endif

namespace {

constexpr int kWarps = 4;               // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;              // list rows per ring stage
constexpr int kSlab = 128;              // dims a ring stage holds of a row
constexpr int kSeg = 512;               // the per-probe kp cap
constexpr int kMaxTile = 32;            // queries per block at most
using ndb::kRegK;                       // kp at most for lists in registers
using RegList = ndb::RegList<float, true>;

// Query-tile geometry. Products: a lane holds kR rows x kQ queries, the
// rows 32 apart; the warps split the chunk's rows in kWR blocks of 32 and
// the queries in kQG groups. Selection: warp w keeps the lists of queries
// [w * kQW, (w + 1) * kQW).
template <int W>
struct Tile {
  static_assert(W % kWarps == 0 && W <= kMaxTile, "query tile width");
  static constexpr int kQW = W / kWarps;
  static constexpr int kR = W >= 16 ? 2 : 1;
  static constexpr int kWR = kChunk / 32 / kR;
  static constexpr int kQG = kWarps / kWR;
  static constexpr int kQ = W / kQG;
};

// Dynamic shared memory of a block with a query tile of tq, in bytes from
// its start; every region 16-byte aligned.
struct Layout {
  int q_ld;                             // floats per staged query row
  int tile_sz;                          // floats of one chunk's products
  int x_ld;                             // bytes per staged row (one slab)
  long long ring, q, tile, lk, lr, bk, br, qsq, xsq, nb, tk, tr, key, ord,
      cq, bytes;
};

__host__ __device__ __forceinline__ long long take(long long& at,
                                                   long long bytes) {
  const long long here = at;
  at += (bytes + 15) & ~15LL;
  return here;
}

// ring stages: three of bf16 rows, two of f32
__host__ __device__ constexpr int stages_for(int esize) {
  return esize == 2 ? 3 : 2;
}

__host__ __device__ __forceinline__ Layout layout(int tq, int D, int kp,
                                                  int esize) {
  Layout L;
  L.q_ld = (((D + 3) / 4) | 1) * 4;
  L.x_ld = ((((D < kSlab ? D : kSlab) * esize + 15) / 16) | 1) * 16;
  L.tile_sz = tq * kChunk;
  long long at = 0;
  L.ring = take(at, static_cast<long long>(stages_for(esize)) * kChunk * L.x_ld);
  L.q = take(at, 4LL * tq * L.q_ld);
  L.tile = take(at, 2 * 4LL * tq * kChunk);      // two chunks' products
  const int lists = kp > kRegK ? tq : 0;  // lists in shared memory
  L.lk = take(at, 4LL * lists * kp);
  L.lr = take(at, 4LL * lists * kp);
  L.bk = take(at, 4LL * lists * ndb::kBatch);
  L.br = take(at, 4LL * lists * ndb::kBatch);
  L.nb = take(at, 4LL * lists);                  // the buffers' counts
  L.tk = take(at, 4LL * lists);                  // the lists' last entries
  L.tr = take(at, 4LL * lists);
  L.qsq = take(at, 4LL * tq);
  L.xsq = take(at, 2 * 4LL * kChunk);
  L.key = take(at, 8LL * tq);
  L.ord = take(at, 8LL * tq);
  // each lane's candidates of a chunk, (distance, row), for kp <= kRegK
  L.cq = take(at, kp > kRegK ? 0 : 8LL * kThreads * (tq / 2));
  L.bytes = at;
  return L;
}

struct Smem {
  int tile_sz;                          // floats of one chunk's products
  unsigned char* ring;
  float *q, *tile, *lk, *bk, *qsq, *xsq, *tk;
  int *lr, *br, *nb, *tr;
  long long *key, *ord;
  float* cq;
};

__device__ __forceinline__ Smem carve(unsigned char* base, const Layout& L) {
  Smem s;
  s.tile_sz = L.tile_sz;
  s.ring = base + L.ring;
  s.q = reinterpret_cast<float*>(base + L.q);
  s.tile = reinterpret_cast<float*>(base + L.tile);
  s.lk = reinterpret_cast<float*>(base + L.lk);
  s.lr = reinterpret_cast<int*>(base + L.lr);
  s.bk = reinterpret_cast<float*>(base + L.bk);
  s.br = reinterpret_cast<int*>(base + L.br);
  s.qsq = reinterpret_cast<float*>(base + L.qsq);
  s.xsq = reinterpret_cast<float*>(base + L.xsq);
  s.nb = reinterpret_cast<int*>(base + L.nb);
  s.tk = reinterpret_cast<float*>(base + L.tk);
  s.tr = reinterpret_cast<int*>(base + L.tr);
  s.key = reinterpret_cast<long long*>(base + L.key);
  s.ord = reinterpret_cast<long long*>(base + L.ord);
  s.cq = reinterpret_cast<float*>(base + L.cq);
  return s;
}

// 8 consecutive elements of a staged row, widened to f32 (bf16 -> f32 is
// the 16 bits moved up, as __bfloat162float does)
__device__ __forceinline__ void widen8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ float widen1(const float* p) { return *p; }
__device__ __forceinline__ float widen1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// This warp's accumulators of one chunk (a lane's kR rows x kQ queries,
// and with l2 the norm of its row i == qg for the warps of query group
// qg < kR), zeroed before the chunk's first slab.
template <int W>
struct Acc {
  float dot[Tile<W>::kR][Tile<W>::kQ];
  float xs;
};

// The products of one staged slab, dims [d0, d0 + w) of the chunk's rows,
// summed onto acc in d order: over a chunk's slabs each product and norm is
// one fmaf chain over d = 0 .. D-1, the first kernel's. A warp whose
// queries are all past the item's nq and that sums no norm does nothing.
template <int W, typename T>
__device__ __forceinline__ void slab_dots(const unsigned char* stage,
                                          int x_ld, const Smem& s, int q_ld,
                                          int d0, int w, bool l2, int nq,
                                          int warp, int lane, Acc<W>& a) {
  using C = Tile<W>;
  const int qg = warp / C::kWR;
  const int r0 = (warp % C::kWR) * 32 + lane;         // rows r0 + 32 kWR i
  const int q0 = qg * C::kQ;
  const bool sums_x = l2 && qg < C::kR;               // of row i == qg
  if (q0 >= nq && !sums_x) return;
  const T* xr[C::kR];
#pragma unroll
  for (int i = 0; i < C::kR; ++i)
    xr[i] = reinterpret_cast<const T*>(stage + (r0 + 32 * C::kWR * i) * x_ld);
  const float* qs = s.q + q0 * q_ld + d0;
  const int w8 = w & ~7;
#pragma unroll 4
  for (int d = 0; d < w8; d += 8) {
    float xv[C::kR][8];
#pragma unroll
    for (int i = 0; i < C::kR; ++i) widen8(xr[i] + d, xv[i]);
    if (sums_x) {
#pragma unroll
      for (int i = 0; i < C::kR; ++i)
        if (i == qg) {
#pragma unroll
          for (int e = 0; e < 8; ++e) a.xs = fmaf(xv[i][e], xv[i][e], a.xs);
        }
    }
#pragma unroll
    for (int j = 0; j < C::kQ; ++j) {
      const float* qp = qs + j * q_ld + d;
      const float4 u = *reinterpret_cast<const float4*>(qp);
      const float4 v = *reinterpret_cast<const float4*>(qp + 4);
      const float qv[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < C::kR; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          a.dot[i][j] = fmaf(qv[e], xv[i][e], a.dot[i][j]);
    }
  }
  for (int d = w8; d < w; ++d) {
    float xv[C::kR];
#pragma unroll
    for (int i = 0; i < C::kR; ++i) xv[i] = widen1(xr[i] + d);
    if (sums_x) {
#pragma unroll
      for (int i = 0; i < C::kR; ++i)
        if (i == qg) a.xs = fmaf(xv[i], xv[i], a.xs);
    }
#pragma unroll
    for (int j = 0; j < C::kQ; ++j) {
      const float qv = qs[j * q_ld + d];
#pragma unroll
      for (int i = 0; i < C::kR; ++i) a.dot[i][j] = fmaf(qv, xv[i], a.dot[i][j]);
    }
  }
}

// A chunk's sums, after its last slab: the products to tile[query][row] of
// buffer buf; with l2, |x|^2 of each row to xsq, once.
template <int W>
__device__ __forceinline__ void store_dots(const Smem& s, int buf, bool l2,
                                           int nq, int warp, int lane,
                                           const Acc<W>& a) {
  using C = Tile<W>;
  const int qg = warp / C::kWR;
  const int r0 = (warp % C::kWR) * 32 + lane;
  const int q0 = qg * C::kQ;
  const bool sums_x = l2 && qg < C::kR;
  if (q0 >= nq && !sums_x) return;
#pragma unroll
  for (int i = 0; i < C::kR; ++i)
#pragma unroll
    for (int j = 0; j < C::kQ; ++j)
      s.tile[buf * s.tile_sz + (q0 + j) * kChunk + r0 + 32 * C::kWR * i] =
          a.dot[i][j];
  if (sums_x) s.xsq[buf * kChunk + r0 + 32 * C::kWR * qg] = a.xs;
}

// The distance of query qi to row r of the chunk whose products are in
// buffer buf: the first kernel's expression and roundings.
__device__ __forceinline__ float dist_of(const Smem& s, int buf, int qi,
                                         int r, bool ip) {
  const float dot = s.tile[buf * s.tile_sz + qi * kChunk + r];
  if (ip) return -dot;
  return fmaxf(__fsub_rn(__fadd_rn(s.qsq[qi], s.xsq[buf * kChunk + r]),
                         __fadd_rn(dot, dot)),
               0.f);
}

// ---- selection in registers (kp <= kRegK) --------------------------------
//
// A query's 32 / kQW lanes each keep a topk_select.cuh `RegList` of the
// rows they score. A lane scores rows sub, sub + 32 / kQW, ... of each
// chunk, so its rows only grow and distances alone place a candidate. tau
// is the least over the query's lanes of their kp-th entries at the
// chunk's start. The lists are merged at the end of the item, kp times the
// least head over the query's lanes.

template <int W>
__device__ __forceinline__ void reg_select(const Smem& s, int buf,
                                           RegList& L, int kp, int c0, int n,
                                           int off, int nq, bool ip, int warp,
                                           int lane) {
  constexpr int kLanes = 32 / Tile<W>::kQW;          // lanes per query
  const int qi = warp * Tile<W>::kQW + lane / kLanes;
  const int sub = lane % kLanes;
  float td;
  int tr;
  ndb::reg_at(L, kp - 1, td, tr);
  int who = lane;
  ndb::group_min<true>(td, tr, who, kLanes);
  // the lane's rows that go before tau, queued in shared memory (slot i of
  // lane t at i * kThreads + t), then inserted in row order: the warp runs
  // the insertion as often as its longest queue, not once per row that
  // some lane keeps
  float* cd = s.cq;
  int* cr = reinterpret_cast<int*>(s.cq + kThreads * (kChunk / kLanes));
  int nc = 0;
  if (qi < nq) {
#pragma unroll
    for (int m = 0; m < kChunk / kLanes; ++m) {
      const int r = sub + kLanes * m;
      if (c0 + r >= n) break;
      const float d = dist_of(s, buf, qi, r, ip);
      if (ndb::before<true>(d, off + c0 + r, td, tr)) {
        cd[nc * kThreads + threadIdx.x] = d;
        cr[nc * kThreads + threadIdx.x] = off + c0 + r;
        ++nc;
      }
    }
  }
  const int most = __reduce_max_sync(ndb::kFull, nc);
  for (int i = 0; i < most; ++i)
    if (i < nc) ndb::reg_insert(L, cd[i * kThreads + threadIdx.x],
                                cr[i * kThreads + threadIdx.x]);
}

// the query's lists merged: its kp least pairs, ascending, to o_d / o_i
template <int W>
__device__ __forceinline__ void reg_out(RegList& L, int kp, int nq, int warp,
                                        int lane, const long long* tup,
                                        int B, int nprobe, float* out_d,
                                        int* out_i) {
  constexpr int kLanes = 32 / Tile<W>::kQW;
  const int qi = warp * Tile<W>::kQW + lane / kLanes;
  long long o = 0;
  if (qi < nq) {
    const long long t = tup[qi];
    const long long b = t / nprobe, p = t - b * nprobe;
    o = (p * B + b) * kp;
  }
  for (int e = 0; e < kp; ++e) {
    float hd = L.k[0];
    int hr = L.r[0], who = lane;
    ndb::group_min<true>(hd, hr, who, kLanes);
    if (who == lane) ndb::reg_pop(L, FLT_MAX);        // pop the head
    if (qi < nq && lane % kLanes == e % kLanes) {
      out_d[o + e] = hd;
      out_i[o + e] = hr;
    }
  }
}

// ---- selection in shared memory (kp > kRegK) -----------------------------

// This warp's queries of the item: the chunk's distances against each
// query's kp-th entry, the ones that beat it into the query's buffer.
template <int W>
__device__ __forceinline__ void chunk_select(const Smem& s, int buf, int kp,
                                             int c0, int n, int off, int nq,
                                             bool ip, int warp, int lane) {
  constexpr int kQW = Tile<W>::kQW;
#pragma unroll 1
  for (int jl = 0; jl < kQW; ++jl) {
    const int qi = warp * kQW + jl;
    if (qi >= nq) break;                              // warp-uniform
    int nbuf = s.nb[qi];
    float tk = s.tk[qi];
    int tr = s.tr[qi];
#pragma unroll
    for (int h = 0; h < kChunk / 32; ++h) {
      const int r = lane + 32 * h;
      const float dist = dist_of(s, buf, qi, r, ip);
      ndb::offer_batch<true>(s.lk + qi * kp, s.lr + qi * kp, kp,
                             s.bk + qi * ndb::kBatch, s.br + qi * ndb::kBatch,
                             dist, off + c0 + r, c0 + r < n, FLT_MAX, lane,
                             nbuf, tk, tr);
    }
    __syncwarp();
    if (lane == 0) {
      s.nb[qi] = nbuf;
      s.tk[qi] = tk;
      s.tr[qi] = tr;
    }
  }
}

// One item: sorted tuples tup[0, nq), nq <= W, all over rows [off, off + n).
// kSlabs: D > kSlab, a chunk staged in several slabs; without it a chunk is
// one stage, and the walk's chunk, slab and sums are known at compile time.
template <int W, typename T, bool kReg, bool kSlabs>
__device__ __forceinline__ void scan_item(const Smem& s, const Layout& L,
                                          const float* __restrict__ q,
                                          const T* __restrict__ vecs,
                                          const long long* tup, int nq,
                                          int off, int n, float* out_d,
                                          int* out_i, int B, int nprobe,
                                          int D, int kp, bool ip, bool vec8) {
  constexpr int kStages = stages_for(sizeof(T));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* src = vecs + static_cast<long long>(off) * D;
  const int nch = (n + kChunk - 1) / kChunk;
  // the ring holds one slab of kSlab dims of a chunk's rows a stage: step
  // k of the list's walk is slab k % nsl of chunk k / nsl
  const int nsl = kSlabs ? (D + kSlab - 1) / kSlab : 1, nst = nch * nsl;
  const int sw = min(D, kSlab);           // dims of every slab but the last
  const int lw = D - (nsl - 1) * kSlab;   // dims of the last
  // the next step to stage (its copier, chunk and slab made anew each
  // time, so the loop holds no more registers than with whole rows; a full
  // slab's copier folds to shifts)
  int ik = 0;
  auto stage_next = [&]() {
    if (ik < nst) {
      const int ic = kSlabs ? ik / nsl : ik, isl = ik - ic * nsl;
      const int w = isl == nsl - 1 ? lw : sw;
      constexpr int kFull = kSlab * static_cast<int>(sizeof(T)) / 16;
      const int per = vec8 ? w * static_cast<int>(sizeof(T)) / 16 : w;
      const ndb::Copier cp =
          per == kFull ? ndb::copier<kThreads>(kFull)
                       : (per == kSlab ? ndb::copier<kThreads>(kSlab)
                                       : ndb::copier<kThreads>(per));
      ndb::stage_chunk<kChunk, T>(s.ring + (ik % kStages) * kChunk * L.x_ld,
                                  src, ic * kChunk, n, D, L.x_ld, vec8, cp,
                                  isl * kSlab);
      ++ik;
    }
    ndb::cp_async_commit();
  };
  // the ring's first stages start filling before the queries are staged
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) stage_next();
  // queries, |q|^2 (the first kernel's lane-strided partials and xor
  // butterfly), empty lists
  for (int j = warp; j < nq; j += kWarps) {
    const int b = static_cast<int>(tup[j] / nprobe);
    const float* qg = q + static_cast<long long>(b) * D;
    float* qs = s.q + j * L.q_ld;
    float qsq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = qg[d];
      qs[d] = v;
      qsq = fmaf(v, v, qsq);
    }
    for (int o = 16; o > 0; o >>= 1) qsq += __shfl_xor_sync(ndb::kFull, qsq, o);
    if (lane == 0) s.qsq[j] = qsq;
    if constexpr (!kReg) {
      for (int i = lane; i < kp; i += 32) {
        s.lk[j * kp + i] = FLT_MAX;
        s.lr[j * kp + i] = -1;
      }
      if (lane == 0) {
        s.nb[j] = 0;
        s.tk[j] = FLT_MAX;
        s.tr[j] = -1;
      }
    }
  }
  RegList regs;
  if constexpr (kReg) ndb::reg_fill(regs, FLT_MAX);
  // chunk c's products go to buffer c & 1, and at chunk c's first slab
  // each warp selects from chunk c - 1's: one barrier a slab, and the warps
  // of a block drift apart between barriers, so some multiply while others
  // select
  auto select = [&](int c) {
    if (NDB_PROBE_CUT >= 1) return;
    if constexpr (kReg)
      reg_select<W>(s, c & 1, regs, kp, c * kChunk, n, off, nq, ip, warp,
                    lane);
    else
      chunk_select<W>(s, c & 1, kp, c * kChunk, n, off, nq, ip, warp, lane);
  };
  Acc<W> acc;
  for (int k = 0; k < nst; ++k) {
    const int c = kSlabs ? k / nsl : k, sl = k - c * nsl;
    ndb::cp_async_wait<kStages - 2>();                // step k has landed
    // ... for every thread; chunk c - 1's products and norms are complete,
    // and chunk c - 2's buffers are read by all
    __syncthreads();
    stage_next();
    if (sl == 0) {
      if (c > 0) select(c - 1);
#pragma unroll
      for (int i = 0; i < Tile<W>::kR; ++i)
#pragma unroll
        for (int j = 0; j < Tile<W>::kQ; ++j) acc.dot[i][j] = 0.f;
      acc.xs = 0.f;
    }
    if (NDB_PROBE_CUT < 2) {
      slab_dots<W, T>(s.ring + (k % kStages) * kChunk * L.x_ld, L.x_ld, s,
                      L.q_ld, sl * kSlab, sl == nsl - 1 ? lw : sw, !ip, nq,
                      warp, lane, acc);
      if (sl == nsl - 1) store_dots<W>(s, c & 1, !ip, nq, warp, lane, acc);
    }
  }
  __syncthreads();                                    // the last chunk's norms
  select(nch - 1);
  if constexpr (kReg) {
    reg_out<W>(regs, kp, nq, warp, lane, tup, B, nprobe, out_d, out_i);
    return;
  }
  // the buffers' last candidates, then the lists out at their tuples' places
  constexpr int kQW = Tile<W>::kQW;
#pragma unroll 1
  for (int jl = 0; jl < kQW; ++jl) {
    const int qi = warp * kQW + jl;
    if (qi >= nq) break;
    int nbuf = s.nb[qi];
    float tk = s.tk[qi];
    int tr = s.tr[qi];
    float* lk = s.lk + qi * kp;
    int* lr = s.lr + qi * kp;
    ndb::flush_batch<true>(lk, lr, kp, s.bk + qi * ndb::kBatch,
                           s.br + qi * ndb::kBatch, nbuf, FLT_MAX, lane, tk, tr);
    const long long t = tup[qi];
    const long long b = t / nprobe, p = t - b * nprobe;
    const long long o = (p * B + b) * kp;
    for (int i = lane; i < kp; i += 32) {
      out_d[o + i] = lk[i];
      out_i[o + i] = lr[i];
    }
  }
}

// An item at the narrowest query tile that holds it.
template <typename T, bool kReg, int kMaxW, bool kSlabs>
__device__ __forceinline__ void scan_width(const Smem& s, const Layout& L,
                                           const float* __restrict__ q,
                                           const T* __restrict__ vecs,
                                           const long long* tup, int nq,
                                           int off, int n, float* out_d,
                                           int* out_i, int B, int nprobe,
                                           int D, int kp, bool ip, bool vec8) {
  if (nq <= 4) {
    scan_item<4, T, kReg, kSlabs>(s, L, q, vecs, tup, nq, off, n, out_d,
                                  out_i, B, nprobe, D, kp, ip, vec8);
  } else if (kMaxW <= 8 || nq <= 8) {
    scan_item<8, T, kReg, kSlabs>(s, L, q, vecs, tup, nq, off, n, out_d,
                                  out_i, B, nprobe, D, kp, ip, vec8);
  } else if constexpr (kMaxW > 8) {
    if (nq <= 16)
      scan_item<16, T, kReg, kSlabs>(s, L, q, vecs, tup, nq, off, n, out_d,
                                     out_i, B, nprobe, D, kp, ip, vec8);
    else
      scan_item<32, T, kReg, kSlabs>(s, L, q, vecs, tup, nq, off, n, out_d,
                                     out_i, B, nprobe, D, kp, ip, vec8);
  }
}

// kMaxW: the widest query tile the kernel holds. Tiles of 4 and 8 (small
// batches) take a kernel without the wide tiles' registers, three blocks
// to an SM; tiles of 16 and 32, two. kSlabs: D > kSlab (scan_item).
template <typename T, int kMaxW, bool kSlabs>
__global__ void __launch_bounds__(kThreads, kMaxW <= 8 ? 3 : 2)
probe_scan_kernel(const float* __restrict__ q, const void* __restrict__ store,
                  const long long* __restrict__ keys,
                  const long long* __restrict__ order,
                  float* __restrict__ out_d, int* __restrict__ out_i, int B,
                  int nprobe, int D, int kp, int tq, int metric_ip, int vec8) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* vecs = static_cast<const T*>(store);
  const Layout L = layout(tq, D, kp, sizeof(T));
  const Smem s = carve(smem, L);
  const int n_tuples = B * nprobe;
  const int s0 = blockIdx.x * tq;
  const int ns = min(tq, n_tuples - s0);
  if (threadIdx.x < ns) {
    s.key[threadIdx.x] = keys[s0 + threadIdx.x];
    s.ord[threadIdx.x] = order[s0 + threadIdx.x];
  }
  __syncthreads();
  const bool ip = metric_ip != 0;
  for (int r0 = 0; r0 < ns;) {
    const long long key = s.key[r0];
    int r1 = r0 + 1;
    while (r1 < ns && s.key[r1] == key) ++r1;
    const int nq = r1 - r0;
    const int off = static_cast<int>(key >> 32);
    const int n = static_cast<int>(key & 0xffffffffLL);
    if (key < 0 || n == 0) {                          // nothing read
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int j = warp; j < nq; j += kWarps) {
        const long long t = s.ord[r0 + j];
        const long long b = t / nprobe, p = t - b * nprobe;
        const long long o = (p * B + b) * kp;
        for (int i = lane; i < kp; i += 32) {
          out_d[o + i] = FLT_MAX;
          out_i[o + i] = -1;
        }
      }
    } else {
      const long long* tup = s.ord + r0;
      if (kp <= kRegK)
        scan_width<T, true, kMaxW, kSlabs>(s, L, q, vecs, tup, nq, off, n,
                                           out_d, out_i, B, nprobe, D, kp, ip,
                                           vec8);
      else
        scan_width<T, false, kMaxW, kSlabs>(s, L, q, vecs, tup, nq, off, n,
                                            out_d, out_i, B, nprobe, D, kp, ip,
                                            vec8);
    }
    r0 = r1;
    __syncthreads();                                  // shared memory reused
  }
}

bool valid_tile(int tq) { return tq == 4 || tq == 8 || tq == 16 || tq == 32; }

using KernelFn = void (*)(const float*, const void*, const long long*,
                         const long long*, float*, int*, int, int, int, int,
                         int, int, int);

template <typename T, bool kSlabs>
KernelFn kernel_of(int tq) {
  return tq <= 8 ? probe_scan_kernel<T, 8, kSlabs>
                 : probe_scan_kernel<T, 32, kSlabs>;
}

// The kernel for a query tile and width, its shared memory set to `smem`
// bytes.
KernelFn kernel_for(int tq, int D, bool bf16, size_t smem, cudaError_t* err) {
  const bool slabs = D > kSlab;
  KernelFn f;
  if (bf16)
    f = slabs ? kernel_of<__nv_bfloat16, true>(tq)
              : kernel_of<__nv_bfloat16, false>(tq);
  else
    f = slabs ? kernel_of<float, true>(tq) : kernel_of<float, false>(tq);
  *err = cudaFuncSetAttribute(reinterpret_cast<const void*>(f),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  return f;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block with a query tile of tq, in bytes.
long long ivf_probe_scan_smem_bytes(int tq, int D, int kp, int store_bf16) {
  return layout(tq, D, kp, store_bf16 ? 2 : 4).bytes;
}

// Resident blocks per SM at that tile (0 if the block does not fit).
int ivf_probe_scan_occupancy(int tq, int D, int kp, int store_bf16) {
  const size_t smem =
      static_cast<size_t>(ivf_probe_scan_smem_bytes(tq, D, kp, store_bf16));
  cudaError_t err;
  const KernelFn f = kernel_for(tq, D, store_bf16 != 0, smem, &err);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, reinterpret_cast<const void*>(f), kThreads, smem);
  return err == cudaSuccess ? blocks : 0;
}

// q [B, D] f32; vecs [n_rows, D] (store_bf16 ? bf16 : f32); keys and order
// [B * nprobe] int64, the work table sorted by key (off << 32 | n; below 0
// or with n == 0: nothing to read) and each sorted position's tuple
// b * nprobe + p;
// out_d/out_i [nprobe, B, kp]. tq: the block's query tile (4, 8, 16, 32),
// also its share of sorted positions. vec8: D % 8 == 0 and vecs 16-byte
// aligned. Launches on `stream` and returns the CUDA error code of
// the launch (0 = success).
int ivf_probe_scan(const void* q, const void* vecs, const void* keys,
                   const void* order, void* out_d, void* out_i, int B,
                   int nprobe, int D, int kp, int metric_ip, int store_bf16,
                   int vec8, int tq, void* stream) {
  if (B <= 0 || nprobe <= 0) return 0;
  if (D < 1 || kp < 1 || kp > kSeg || !valid_tile(tq) ||
      static_cast<long long>(B) * nprobe > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(ivf_probe_scan_smem_bytes(tq, D, kp, store_bf16));
  cudaError_t err;
  const KernelFn f = kernel_for(tq, D, store_bf16 != 0, smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tuples = static_cast<long long>(B) * nprobe;
  const dim3 grid(static_cast<unsigned>((n_tuples + tq - 1) / tq));
  f<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), vecs, static_cast<const long long*>(keys),
      static_cast<const long long*>(order), static_cast<float*>(out_d),
      static_cast<int*>(out_i), B, nprobe, D, kp, tq, metric_ip, vec8);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
