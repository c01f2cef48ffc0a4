// List-grouped IVF probe scan with top-kp selection over a bf16 store, for
// Hopper (sm_90a); the f32 store's kernel is ivf_scan_grouped_f32.cu.
//
// Replaces the TPU kernel neurondb_tpu/ops/pallas/ivf_scan_grouped.py
// `_grouped_scan_kernel` in its three selection modes: exact
// (pos_bits = 0), packed (pos_bits = pb) and blockmin (pos_bits = pb,
// block_min = True).
//
// What it computes. A tile t holds up to qt queries that all probe one
// posting list: rows [tile_off[t], tile_off[t] + tile_cnt[t]) of the
// cluster-ordered store. For every query slot of every tile it writes kp
// (distance, CSR row) pairs over that list, ascending, where
//   sq-L2: d = max((|q|^2 + |x^|^2) - 2 (q^ . x^), 0)
//   ip:    d = -(q^ . x^)
// q^ is the f32 query rounded to the store type, x^ the stored row, every
// product and sum is f32, |q|^2 comes from the f32 query and |x^|^2 from
// the stored row. Unused slots and tiles with tile_cnt == 0 hold
// (FLT_MAX, -1).
// - exact: the kp smallest pairs in the order (d, row), so ties go to the
//   smaller row, which is what the TPU kernel's argmin extraction yields;
// - packed: the kp smallest keys pack_key(d, pos, pb) (topk_select.cuh),
//   pos = the row's position in its list; the output decodes each key to
//   (its rounded distance, tile_off + pos);
// - blockmin: as packed, but only one key per (query, 1024-row segment of
//   list positions, class pos % 128) competes: the minimum of its class.
//   The TPU kernel folds a segment's keys into these 128 class minima
//   before its kp rounds; the result is the kp smallest class minima over
//   all segments, which is what this kernel keeps. The TPU kernel's clamp
//   of the segment start never moves a segment that holds live rows (the
//   store ends in a >= 1024-row tail), so the in-list position is the
//   right frame for segments and classes.
//
// What bounds it on the card. At the 1M x 128 headline (16,384 queries,
// nprobe 8, nlists 1024, ~1k rows per list, 64 queries per tile) a batch
// needs ~33 GFLOP of bf16 x bf16 products (0.034 ms at the 989 TFLOP/s
// tensor-core peak) and ~0.33 GB of distinct rows, queries and outputs
// (0.0996 ms at 3.35 TB/s): it is byte-bound, and each list is read by
// its two tiles, mostly from L2. bf16 x bf16 products are exact in f32,
// so the tensor cores compute the TPU's MXU products; only the order of
// the f32 sums differs from the plain version's (on integer data the
// kernel equals it bit for bit). Around the products each candidate costs
// a distance, a test against its query's bound and, rarely, an insertion:
// ~128M candidates at the headline, which with the products and the
// staging of each chunk set the kernel's time.
//
// Design, bf16 store (the main path's):
// - one block (8 warps) per sub-tile of qs <= 64 queries; the wrapper
//   splits a tile of qt queries into qt/qs sub-tiles so that the per-query
//   lists fit in shared memory when kp > 16. The queries are padded to
//   m-tiles of 16 (1, 2 or 4 of them); each m-tile gets 8, 4 or 2 warps,
//   which split every 64-row chunk of the list into n-tiles of 8 rows
//   (1, 2 or 4 a warp);
// - products by mma.sync m16n8k16 (bf16 in, f32 accumulate): A is the
//   warp's 16 queries, rounded to bf16 and staged once at full width, held
//   in registers as ldmatrix.x4 fragments for the whole list (D <= 128;
//   wider D reloads them for each 128-dim slab); B is the staged slab's
//   rows, by ldmatrix.x4 (two k-steps a load). D is padded with zeros to a
//   multiple of 16 in shared memory, never read past the row;
// - the list streams through a 4-stage ring whose stage holds one slab of
//   <= 128 dims of a 64-row chunk (D <= 128: the whole chunk), bf16 as
//   stored, filled by 16-byte cp.async copies (element copies where D % 8
//   or the store's alignment forbid) while earlier slabs are scored; the
//   chunk's products sum over its slabs in the accumulators, so the ring
//   takes 70 KB at any D and only the queries grow with it (wide D fits by
//   fewer queries a block). A row's stride is an odd number of 16-byte
//   units, so ldmatrix's 8 row addresses fall in 8 distinct bank groups.
//   Rows past the list's count are neither read nor scored, which takes
//   the place of the TPU kernel's clamped DMA window. One barrier a slab;
//   |x|^2 of the next slab is summed (once a row, from the staged bf16)
//   while this one is multiplied;
// - the C fragment holds queries g, g + 8 and rows 2t, 2t + 1 of each
//   n-tile (lane 4g + t); lanes t and t ^ 1 trade halves by two shuffles,
//   so a thread keeps one query (g + 8 (t & 1)) and rows 4s .. 4s + 3 of
//   each n-tile (s = t >> 1). Within one thread a query's rows only grow
//   over n-tiles and chunks, and lanes t and t ^ 2 of the warp hold the
//   query's other rows. Distances are made in registers and tested against
//   the query's bound before they touch any list: the lesser of the two
//   lanes' least kp-th entry and their greatest ceil(kp / 2)-th entry
//   (below either lie kp entries);
// - kp <= 16 (the main path's k 10), exact and packed: each thread keeps a
//   topk_select.cuh `RegList`; the candidates that beat the bound are
//   queued in shared memory (key, and a byte for the row) and inserted in
//   row order, so the warp runs the insertion as often as its longest
//   queue. At the end a query's 2 lanes are merged in each warp (kp times
//   the least head) and the warps of its m-tile through shared memory.
//   One query a thread keeps these kernels at <= 128 registers, two blocks
//   an SM;
// - kp > 16: each chunk's distances (packed: keys) go to a shared tile,
//   and the warp that owns a query offers them to its sorted list in
//   shared memory through `offer_batch`, one chunk behind (the tile is
//   double-buffered, so the one barrier a chunk orders both);
// - blockmin: each thread keeps the class minima of its rows (class
//   (c0 & 64) + r of the 1024-position segment), the chunk's half of the
//   classes in registers and the other half in shared memory (swapped each
//   chunk, four 16-byte loads and stores), and offers them when a segment
//   or the list ends, half by half, to its list (kp <= 16) or through a
//   shared tile to `offer_batch`. A per-chunk offer would keep more than
//   one row per class and compute a different, more exact function.
//
// The TPU kernel's double-buffered DMA and its cross-tile prefetch baton
// exist because the TPU grid runs in order. CUDA blocks run in no order;
// the ring hides the load latency inside a block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "topk_select.cuh"

// Stage cuts for measurement only (scripts/grouped_ab.py --stages builds
// them), bf16 store: 1 skips the selection, 2 the norms, the products and
// the selection too. The package builds the whole kernel (0).
#ifndef NDB_GROUPED_CUT
#define NDB_GROUPED_CUT 0
#endif

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

constexpr int kStages = 4;              // ring stages of kRows rows
constexpr int kSlab = 128;              // dims a ring stage holds of a row
constexpr int kKsReg = kSlab / 16;      // k-steps of A held in registers
constexpr int kNtMax = 4;               // n-tiles (8 rows) a warp, a chunk
constexpr int kTileLd = kRows + 8;      // words a query in the distance tile
constexpr int kCmLd = kClasses + 8;     // words a query in the minima tile
// queued candidates: per thread, 4 rows x kNtMax n-tiles
constexpr int kQueue = 4 * kNtMax * kThreads;

__host__ __device__ __forceinline__ long long take(long long& at,
                                                   long long bytes) {
  const long long here = at;
  at += (bytes + 15) & ~15LL;
  return here;
}

// m-tiles of 16 queries for qs queries: 1, 2 or 4 (the warps split evenly)
__host__ __device__ __forceinline__ int m_tiles(int qs) {
  const int m = (qs + 15) / 16;
  return m <= 1 ? 1 : (m <= 2 ? 2 : 4);
}

// bytes a row of `dims` bf16 (padded to 16) takes in shared memory: an odd
// number of 16-byte units, so that ldmatrix's 8 row addresses fall in 8
// distinct bank groups
__host__ __device__ __forceinline__ int row_ld(int dims) {
  return ((((dims + 15) & ~15) * 2 / 16) | 1) * 16;
}

// Dynamic shared memory of the tensor-core kernel, in bytes from its start;
// every region 16-byte aligned.
struct MmaLayout {
  int x_ld;                             // bytes per staged row (one slab)
  int q_ld;                             // bytes per staged query (all of D)
  long long ring, q, qsq, xsq, queue, tile, lk, lr, bk, br, nb, tk, tr,
      bytes;
};

__host__ __device__ __forceinline__ MmaLayout mma_layout(int qs, int D,
                                                         int kp, int mode) {
  MmaLayout L;
  L.x_ld = row_ld(D < kSlab ? D : kSlab);
  L.q_ld = row_ld(D);
  const int mt = m_tiles(qs);
  const bool reg = kp <= ndb::kRegK;
  const bool rows = mode == kExact;
  long long at = 0;
  L.ring = take(at, static_cast<long long>(kStages) * kRows * L.x_ld);
  L.q = take(at, 16LL * mt * L.q_ld);
  L.qsq = take(at, 4LL * 16 * mt);
  L.xsq = take(at, 2 * 4LL * kRows);
  // kp <= kRegK: the queue (a key, and a row's place in its chunk;
  // blockmin: the class minima of the half not in registers), and in the
  // same bytes after the last chunk the lanes' lists merged per warp (128
  // lists: 16 queries an m-tile x the m-tile's warps)
  const long long queue = kQueue * (rows ? 5LL : 4LL);
  const long long merged = 16LL * kWarps * kp * (rows ? 8 : 4);
  L.queue = take(at, reg ? (queue > merged ? queue : merged)
                         : (mode == kBlockMin ? queue : 0));
  // kp > kRegK: the double-buffered tile, then each query's sorted list,
  // its buffer, the buffer's count and the list's last entry
  const int lists = reg ? 0 : qs;
  L.tile = take(at, reg ? 0 : 2 * 4LL * 16 * mt *
                                  (mode == kBlockMin ? kCmLd : kTileLd));
  L.lk = take(at, 4LL * lists * kp);
  L.lr = take(at, rows ? 4LL * lists * kp : 0);
  L.bk = take(at, 4LL * lists * ndb::kBatch);
  L.br = take(at, rows ? 4LL * lists * ndb::kBatch : 0);
  L.nb = take(at, 4LL * lists);
  L.tk = take(at, 4LL * lists);
  L.tr = take(at, 4LL * lists);
  L.bytes = at;
  return L;
}

// |x|^2 over the `D` dims of rows [0, rows) of a staged slab into xsq
// (add: onto the earlier slabs' sums): 4 threads a row, each summing every
// 4th bf16 pair, then two xor shuffles.
__device__ __forceinline__ void row_norms(const unsigned char* stage,
                                          int x_ld, int rows, int D,
                                          float* xsq, bool add) {
  static_assert(kThreads == 4 * kRows, "4 threads a row");
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  float s = 0.f;
  if (r < rows) {
    const __nv_bfloat162* x =
        reinterpret_cast<const __nv_bfloat162*>(stage + r * x_ld);
    for (int i = part; i < D / 2; i += 4) {
      const float2 v = __bfloat1622float2(x[i]);
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
    }
    if ((D & 1) && part == 0) {
      const float v =
          __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[D - 1]);
      s = fmaf(v, v, s);
    }
  }
  s += __shfl_xor_sync(kFull, s, 1);
  s += __shfl_xor_sync(kFull, s, 2);
  if (part == 0) xsq[r] = add ? xsq[r] + s : s;
}

// Rows [c0, min(c0 + kRows, n)), dims [d0, d0 + width) of the [*, D] rows
// at `src` into a ring stage of rows x_ld bytes apart, width = k.per_row
// pieces: 16-byte cp.async copies (vec8: D a multiple of 8 and `src`
// 16-byte aligned), else element by element. `pad` more columns are
// zeroed in every row of the stage (the last slab's tail to a multiple
// of 16, which an earlier, wider slab may have filled).
__device__ __forceinline__ void stage_slab(unsigned char* dst,
                                           const __nv_bfloat16* src, int c0,
                                           int n, int D, int d0, int x_ld,
                                           bool vec8, const ndb::Copier& k,
                                           int pad) {
  const int rows = min(kRows, n - c0);
  const __nv_bfloat16* s = src + static_cast<long long>(c0) * D + d0;
  int r = k.r0, c = k.c0;
  if (vec8) {
    for (; r < rows; r += k.dr, c += k.dc) {
      if (c >= k.per_row) {
        c -= k.per_row;
        ++r;
        if (r >= rows) break;
      }
      ndb::cp_async16(dst + r * x_ld + c * 16,
                      s + static_cast<long long>(r) * D + 8 * c);
    }
  } else {
    for (; r < rows; r += k.dr, c += k.dc) {
      if (c >= k.per_row) {
        c -= k.per_row;
        ++r;
        if (r >= rows) break;
      }
      reinterpret_cast<__nv_bfloat16*>(dst + r * x_ld)[c] =
          s[static_cast<long long>(r) * D + c];
    }
  }
  if (pad > 0) {
    const int w0 = vec8 ? 8 * k.per_row : k.per_row;
    for (int i = threadIdx.x; i < kRows * pad; i += kThreads) {
      const int rr = i / pad;
      reinterpret_cast<__nv_bfloat16*>(dst + rr * x_ld)[w0 + i - rr * pad] =
          __float2bfloat16_rn(0.f);
    }
  }
}

// The bf16 store's kernel: one block per sub-tile of qs queries. kReg:
// kp <= kRegK, the lists in registers (<= 128 registers, two blocks an
// SM); else in shared memory.
template <int kMode, bool kReg>
__global__ void __launch_bounds__(kThreads, kReg ? 2 : 1)
grouped_scan_mma_kernel(const float* __restrict__ qpad,
                        const __nv_bfloat16* __restrict__ vecs,
                        const int* __restrict__ tile_off,
                        const int* __restrict__ tile_cnt,
                        float* __restrict__ out_d, int* __restrict__ out_i,
                        int sub_per_tile, int qs, int D, long long n_rows,
                        int kp, int metric_ip, int pb, int vec8) {
  constexpr bool kRowsKept = kMode == kExact;
  using K = std::conditional_t<kRowsKept, float, int>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long sub = blockIdx.x;
  const int ti = static_cast<int>(sub / sub_per_tile);
  const int off = tile_off[ti];
  // rows past the store are never read
  int cnt = tile_cnt[ti];
  if (off < 0 || off >= n_rows) cnt = 0;
  else if (cnt > n_rows - off) cnt = static_cast<int>(n_rows - off);

  const long long qbase = sub * qs;
  float* o_d = out_d + qbase * kp;
  int* o_i = out_i + qbase * kp;
  if (cnt <= 0) {
    for (int i = tid; i < qs * kp; i += kThreads) {
      o_d[i] = FLT_MAX;
      o_i[i] = -1;
    }
    return;
  }
  K kFill;
  if constexpr (kRowsKept) kFill = FLT_MAX;
  else kFill = kIntFill;

  const MmaLayout L = mma_layout(qs, D, kp, kMode);
  const int x_ld = L.x_ld, q_ld = L.q_ld;
  unsigned char* ring = smem + L.ring;
  unsigned char* q_s = smem + L.q;
  float* qsq_s = reinterpret_cast<float*>(smem + L.qsq);
  float* xsq_s = reinterpret_cast<float*>(smem + L.xsq);
  K* queue_k = reinterpret_cast<K*>(smem + L.queue);
  unsigned char* queue_r = smem + L.queue + 4 * kQueue;
  int4* cmx = reinterpret_cast<int4*>(smem + L.queue);  // [kNtMax][kThreads]
  K* mk = reinterpret_cast<K*>(smem + L.queue);      // after the last chunk
  int* mr = reinterpret_cast<int*>(smem + L.queue) + 16 * kWarps * kp;
  unsigned char* tile = smem + L.tile;
  K* lk = reinterpret_cast<K*>(smem + L.lk);
  int* lr = reinterpret_cast<int*>(smem + L.lr);
  K* bk = reinterpret_cast<K*>(smem + L.bk);
  int* br = reinterpret_cast<int*>(smem + L.br);
  int* nb_s = reinterpret_cast<int*>(smem + L.nb);
  K* tk_s = reinterpret_cast<K*>(smem + L.tk);
  int* tr_s = reinterpret_cast<int*>(smem + L.tr);

  const int mtn = m_tiles(qs);               // m-tiles of 16 queries
  const int wpm = kWarps / mtn;              // warps an m-tile
  const int nt = mtn;                        // n-tiles a warp, a chunk
  const int mt = warp / wpm, rb = warp % wpm;
  const int wr0 = rb * nt * 8;               // the warp's first chunk row
  const bool live = mt * 16 < qs;            // its m-tile holds a query
  const int dp = (D + 15) & ~15, nks = dp >> 4;
  const bool l2 = metric_ip == 0;
  const int nch = (cnt + kRows - 1) / kRows;
  // the ring holds one slab of kSlab dims of a chunk's rows a stage:
  // step k of the list's walk is slab k % nsl of chunk k / nsl
  const int nsl = (D + kSlab - 1) / kSlab, nst = nch * nsl;
  const int sw = min(D, kSlab);           // dims of every slab but the last
  const int lw = D - (nsl - 1) * kSlab;   // dims of the last
  const __nv_bfloat16* src = vecs + static_cast<long long>(off) * D;
  auto stage_of = [&](int k) { return ring + (k % kStages) * kRows * x_ld; };
  // chunk c closes a blockmin segment, or the list
  auto closes = [&](int c) {
    return ((c + 1) * kRows) % kSeg == 0 || (c + 1) * kRows >= cnt;
  };
  // the next step to stage (its copier and its chunk and slab are made
  // anew each time: kept, they cost the loop registers it has not got; a
  // full 16-byte slab's copier, the headline's, folds to shifts)
  int ik = 0;
  auto stage_next = [&]() {
    if (ik < nst) {
      const int ic = nsl == 1 ? ik : ik / nsl, isl = ik - ic * nsl;
      const int w = isl == nsl - 1 ? lw : sw;
      const int per = vec8 ? w / 8 : w;
      stage_slab(stage_of(ik), src, ic * kRows, cnt, D, isl * kSlab, x_ld,
                 vec8 != 0,
                 per == kSlab / 8 ? ndb::copier<kThreads>(kSlab / 8)
                                  : ndb::copier<kThreads>(per),
                 ((w + 15) & ~15) - w);
      ++ik;
    }
    ndb::cp_async_commit();
  };

  // the ring's first stages fill while the queries are staged
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) stage_next();
  // the queries rounded to bf16, zero past qs and D (4 values a piece
  // where D % 4 == 0, no division in the loop); |q|^2 from the f32 query;
  // empty lists
  const float* qg = qpad + qbase * D;
  if (D % 4 == 0) {
    const int per = dp / 4;
    const ndb::Copier k = ndb::copier<kThreads>(per);
    for (int r = k.r0, c = k.c0; r < 16 * mtn; r += k.dr, c += k.dc) {
      if (c >= per) {
        c -= per;
        ++r;
        if (r >= 16 * mtn) break;
      }
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < qs && 4 * c < D)
        v = *reinterpret_cast<const float4*>(
            qg + static_cast<long long>(r) * D + 4 * c);
      *reinterpret_cast<uint2*>(q_s + r * q_ld + 8 * c) =
          make_uint2(ndb::pack_bf16(v.x, v.y), ndb::pack_bf16(v.z, v.w));
    }
  } else {
    for (int i = tid; i < 16 * mtn * dp; i += kThreads) {
      const int r = i / dp, c = i - r * dp;
      const float v =
          r < qs && c < D ? qg[static_cast<long long>(r) * D + c] : 0.f;
      reinterpret_cast<__nv_bfloat16*>(q_s + r * q_ld)[c] =
          __float2bfloat16_rn(v);
    }
  }
  for (int qi = warp; qi < 16 * mtn; qi += kWarps) {
    float s = 0.f;
    if (qi < qs)
      for (int d = lane; d < D; d += 32) {
        const float v = qg[static_cast<long long>(qi) * D + d];
        s = fmaf(v, v, s);
      }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) qsq_s[qi] = s;
  }
  if constexpr (!kReg) {
    for (int i = tid; i < qs * kp; i += kThreads) {
      lk[i] = kFill;
      if constexpr (kRowsKept) lr[i] = -1;
    }
    for (int i = tid; i < qs; i += kThreads) {
      nb_s[i] = 0;
      tk_s[i] = kFill;
      tr_s[i] = -1;
    }
  }
  ndb::cp_async_wait<kStages - 2>();         // step 0 has landed
  __syncthreads();
  if (l2 && NDB_GROUPED_CUT < 2)
    row_norms(ring, x_ld, min(kRows, cnt), sw, xsq_s, false);

  // A fragments of the warp's 16 queries, k-steps [ks0, ks0 + kKsReg)
  uint32_t a[kKsReg][4];
  auto load_a = [&](int ks0) {
    const int r = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const auto* qr = reinterpret_cast<const __nv_bfloat16*>(q_s + r * q_ld);
#pragma unroll
    for (int kk = 0; kk < kKsReg; ++kk)
      if (ks0 + kk < nks)
        ndb::ldmatrix_x4(a[kk], qr + (ks0 + kk) * 16 + (lane >> 4) * 8);
  };
  if (nks <= kKsReg) load_a(0);
  // after `regroup`, this thread scores query qv against rows
  // wr0 + 8 j + 4 s + u (u < 4) of each n-tile j; lane t ^ 2 of its warp
  // holds the query's other rows
  const int s = t >> 1;
  const int qv = mt * 16 + g + 8 * (t & 1);
  const bool mine = qv < qs;
  const float qsq = qsq_s[qv];

  float acc[kNtMax][4];
  ndb::RegList<K, kRowsKept> lst;            // kReg: query qv's best rows
  // blockmin: the class minima of the thread's rows, (c0 & 64) + row of
  // the segment; the chunk's half in registers, the other in cmx
  int cm[kNtMax][4];
  const int4 fill4 = make_int4(kIntFill, kIntFill, kIntFill, kIntFill);
  if constexpr (kReg) ndb::reg_fill(lst, kFill);
  if constexpr (kMode == kBlockMin) {
#pragma unroll
    for (int j = 0; j < kNtMax; ++j) {
      cm[j][0] = cm[j][1] = cm[j][2] = cm[j][3] = kIntFill;
      cmx[j * kThreads + tid] = fill4;
    }
  }
  float sink = 0.f;                          // the stage cuts' products

  // step k's products (slab sl of its chunk) into acc, from zero at sl 0
  auto products = [&](int k, int sl) {
    const unsigned char* stg = stage_of(k);
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < kNtMax; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    const int ks0 = sl * kKsReg;
    const int n = min(nks - ks0, kKsReg);    // the slab's k-steps
    if (nks > kKsReg) load_a(ks0);
#pragma unroll
    for (int kk = 0; kk < kKsReg; kk += 2) {
      if (kk < n) {
#pragma unroll
        for (int j = 0; j < kNtMax; ++j) {
          if (j < nt) {
            // matrix i = lane / 8: rows of n-tile j, dims kk * 16 + 8 i
            const auto* p = reinterpret_cast<const __nv_bfloat16*>(
                                stg + (wr0 + 8 * j + (lane & 7)) * x_ld) +
                            kk * 16 + (lane >> 3) * 8;
            if (kk + 1 < n) {
              uint32_t b[4];
              ndb::ldmatrix_x4(b, p);
              ndb::mma_bf16(acc[j], a[kk], b[0], b[1]);
              ndb::mma_bf16(acc[j], a[kk + 1], b[2], b[3]);
            } else {
              uint32_t b0, b1;
              ndb::ldmatrix_x2(b0, b1, p);
              ndb::mma_bf16(acc[j], a[kk], b0, b1);
            }
          }
        }
      }
    }
  };

  // The C fragment holds queries g and g + 8 x rows 2t, 2t + 1 of each
  // n-tile; lanes t and t ^ 1 trade halves, so that acc[j][u] becomes query
  // qv's product with row 8 j + 4 s + u, and each thread keeps one list.
  auto regroup = [&]() {
    const bool odd = t & 1;
#pragma unroll
    for (int j = 0; j < kNtMax; ++j) {
      const float r0 = __shfl_xor_sync(kFull, odd ? acc[j][0] : acc[j][2], 1);
      const float r1 = __shfl_xor_sync(kFull, odd ? acc[j][1] : acc[j][3], 1);
      if (odd) {
        acc[j][0] = r0;
        acc[j][1] = r1;
      } else {
        acc[j][2] = r0;
        acc[j][3] = r1;
      }
    }
  };

  // distances of query qv to the thread's 4 rows of n-tile j
  auto dists = [&](const float* xs, int j, float (&d)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(xs + wr0 + 8 * j + 4 * s);
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      d[u] = l2 ? fmaxf(__fsub_rn(__fadd_rn(qsq, xv[u]), 2.f * acc[j][u]), 0.f)
                : -acc[j][u];
  };

  // the bound of query qv: the lesser of its two lanes' least kp-th entry
  // and their greatest ceil(kp / 2)-th entry (below either lie kp entries)
  auto bound = [&](K& tk, int& tr) {
    K k1, k2;
    int r1, r2;
    ndb::reg_at(lst, kp - 1, k1, r1);
    ndb::reg_at(lst, (kp + 1) / 2 - 1, k2, r2);
    const K o1 = __shfl_xor_sync(kFull, k1, 2);
    const K o2 = __shfl_xor_sync(kFull, k2, 2);
    const int p1 = kRowsKept ? __shfl_xor_sync(kFull, r1, 2) : 0;
    const int p2 = kRowsKept ? __shfl_xor_sync(kFull, r2, 2) : 0;
    if (ndb::before<kRowsKept>(o1, p1, k1, r1)) {
      k1 = o1;
      r1 = p1;
    }
    if (ndb::before<kRowsKept>(k2, r2, o2, p2)) {
      k2 = o2;
      r2 = p2;
    }
    if (ndb::before<kRowsKept>(k2, r2, k1, r1)) {
      k1 = k2;
      r1 = r2;
    }
    tk = k1;
    tr = r1;
  };

  // kp <= 16: the thread's queue (slot i at i * kThreads + tid: the key,
  // and the row's place in its chunk), inserted in row order; the warp
  // runs as many rounds as its longest queue
  auto enqueue = [&](int& n, K key, int r, bool ok) {
    if (ok) {
      queue_k[n * kThreads + tid] = key;
      if constexpr (kRowsKept)
        queue_r[n * kThreads + tid] = static_cast<unsigned char>(r);
      ++n;
    }
  };
  auto drain = [&](int n, int c0) {
    const int most = __reduce_max_sync(kFull, n);
    for (int i = 0; i < most; ++i)
      if (i < n) {
        const int at = i * kThreads + tid;
        ndb::reg_insert(lst, queue_k[at], kRowsKept ? off + c0 + queue_r[at] : 0);
      }
  };

  // blockmin: the class minima to the lists, one half of the classes at a
  // time (kp <= 16: those that beat the bound, into the thread's list;
  // else to the shared tile), then reset
  auto flush_minima = [&](int c) {
    if constexpr (kMode == kBlockMin) {
      int* cmt = reinterpret_cast<int*>(tile) + ((c & 1) * 16 * mtn + qv) * kCmLd;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int tk = kIntFill, tr;
        if constexpr (kReg) bound(tk, tr);
        const bool in_regs = h == (c & 1);
#pragma unroll
        for (int j = 0; j < kNtMax; ++j) {
          const int4 o = cmx[j * kThreads + tid];
          const int m[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int v = in_regs ? cm[j][u] : m[u];
            if constexpr (kReg) {
              if (v < tk) ndb::reg_insert(lst, v, 0);
            } else {
              if (j < nt) cmt[h * 64 + wr0 + 8 * j + 4 * s + u] = v;
            }
          }
          if (in_regs) cm[j][0] = cm[j][1] = cm[j][2] = cm[j][3] = kIntFill;
          else cmx[j * kThreads + tid] = fill4;
        }
      }
    }
  };

  // this warp's part of chunk c: distances, then selection
  auto epilogue = [&](int c) {
    const int c0 = c * kRows;
    const int nrow = min(kRows, cnt - c0);
    const float* xs = xsq_s + (c & 1) * kRows;
    regroup();
    if constexpr (NDB_GROUPED_CUT >= 1) {
#pragma unroll
      for (int j = 0; j < kNtMax; ++j) {
        float d[4];
        dists(xs, j, d);
        sink += (d[0] + d[1]) + (d[2] + d[3]);
      }
      return;
    }
    K tk = kFill;
    int tr = -1, n = 0;
    if constexpr (kReg && kMode != kBlockMin) bound(tk, tr);
    if constexpr (kMode == kBlockMin) {
      if (c > 0) {                              // the other half to registers
#pragma unroll
        for (int j = 0; j < kNtMax; ++j) {
          const int4 o = cmx[j * kThreads + tid];
          cmx[j * kThreads + tid] =
              make_int4(cm[j][0], cm[j][1], cm[j][2], cm[j][3]);
          cm[j][0] = o.x;
          cm[j][1] = o.y;
          cm[j][2] = o.z;
          cm[j][3] = o.w;
        }
      }
    }
    K* tl = reinterpret_cast<K*>(tile) + ((c & 1) * 16 * mtn + qv) * kTileLd;
#pragma unroll
    for (int j = 0; j < kNtMax; ++j) {
      float d[4];
      dists(xs, j, d);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = wr0 + 8 * j + 4 * s + u;
        const bool ok = j < nt && r < nrow && mine;
        K key;
        if constexpr (kRowsKept) key = d[u];
        else key = ndb::pack_key(d[u], c0 + r, pb);
        if constexpr (kMode == kBlockMin) {
          cm[j][u] = min(cm[j][u], ok ? key : kIntFill);
        } else if constexpr (kReg) {
          enqueue(n, key, r,
                  ok && ndb::before<kRowsKept>(key, off + c0 + r, tk, tr));
        } else {
          if (j < nt) tl[r] = r < nrow ? key : kFill;
        }
      }
    }
    if constexpr (kMode == kBlockMin) {
      if (closes(c)) flush_minima(c);
    } else if constexpr (kReg) {
      drain(n, c0);
    }
  };

  // kp > 16: the warp's queries offered chunk c's tile entries (blockmin:
  // the class minima, where chunk c closed a segment)
  auto smem_select = [&](int c) {
    if (NDB_GROUPED_CUT >= 1) return;
    if (kMode == kBlockMin && !closes(c)) return;
    const int c0 = c * kRows;
    for (int qi = warp; qi < qs; qi += kWarps) {
      int nbuf = nb_s[qi];
      K tk = tk_s[qi];
      int tr = tr_s[qi];
      K* l_k = lk + qi * kp;
      int* l_r = kRowsKept ? lr + qi * kp : nullptr;
      K* b_k = bk + qi * ndb::kBatch;
      int* b_r = kRowsKept ? br + qi * ndb::kBatch : nullptr;
      if constexpr (kMode == kBlockMin) {
        const int* m = reinterpret_cast<const int*>(tile) +
                       ((c & 1) * 16 * mtn + qi) * kCmLd;
#pragma unroll
        for (int u = 0; u < kClasses / 32; ++u)
          ndb::offer_batch<false>(l_k, l_r, kp, b_k, b_r, m[u * 32 + lane], 0,
                                  true, kFill, lane, nbuf, tk, tr);
      } else {
        const K* d = reinterpret_cast<const K*>(tile) +
                     ((c & 1) * 16 * mtn + qi) * kTileLd;
#pragma unroll
        for (int h = 0; h < kRows / 32; ++h) {
          const int r = lane + 32 * h;
          ndb::offer_batch<kRowsKept>(l_k, l_r, kp, b_k, b_r, d[r], off + c0 + r,
                                      c0 + r < cnt, kFill, lane, nbuf, tk, tr);
        }
      }
      __syncwarp();
      if (lane == 0) {
        nb_s[qi] = nbuf;
        tk_s[qi] = tk;
        tr_s[qi] = tr;
      }
    }
  };

  for (int k = 0, c = 0, sl = 0; k < nst; ++k) {
    ndb::cp_async_wait<kStages - 3>();       // step k + 1 has landed
    // ... for every thread; step k - 1's products, chunk c - 1's tile and
    // minima are done with, and chunk c's norms are complete at its last
    // slab
    __syncthreads();
    stage_next();                            // step k + kStages - 1
    // step k + 1: chunk c1, slab s1
    const int s1 = sl + 1 < nsl ? sl + 1 : 0, c1 = s1 ? c : c + 1;
    if (NDB_GROUPED_CUT < 2) {
      if (l2 && k + 1 < nst)
        row_norms(stage_of(k + 1), x_ld, min(kRows, cnt - c1 * kRows),
                  s1 == nsl - 1 ? lw : sw, xsq_s + (c1 & 1) * kRows, s1 > 0);
      if constexpr (!kReg)
        if (c > 0 && sl == 0) smem_select(c - 1);
      if (live) {
        products(k, sl);
        if (sl == nsl - 1) epilogue(c);
      }
    }
    c = c1;
    sl = s1;
  }
  __syncthreads();
  if constexpr (NDB_GROUPED_CUT >= 1)
    if (sink == -1.f) o_d[0] = sink;         // keeps the products live

  if constexpr (!kReg) {
    smem_select(nch - 1);
    for (int qi = warp; qi < qs; qi += kWarps) {
      int nbuf = nb_s[qi];
      K tk = tk_s[qi];
      int tr = tr_s[qi];
      K* l_k = lk + qi * kp;
      int* l_r = kRowsKept ? lr + qi * kp : nullptr;
      ndb::flush_batch<kRowsKept>(l_k, l_r, kp, bk + qi * ndb::kBatch,
                                  kRowsKept ? br + qi * ndb::kBatch : nullptr,
                                  nbuf, kFill, lane, tk, tr);
      for (int i = lane; i < kp; i += 32) {
        if constexpr (kRowsKept) {
          o_d[qi * kp + i] = l_k[i];
          o_i[qi * kp + i] = l_r[i];
        } else {
          const int key = l_k[i];
          const bool empty = key == kIntFill;
          o_d[qi * kp + i] = empty ? FLT_MAX : ndb::key_dist(key, pb);
          o_i[qi * kp + i] = empty ? -1 : off + ndb::key_pos(key, pb);
        }
      }
    }
    return;
  }

  // kp <= 16: each query's 2 lanes merged in its warp, kp times the least
  // head, into the warp's list (mk, mr); then the m-tile's warps' lists
  if (live) {
    for (int e = 0; e < kp; ++e) {
      K hk = lst.k[0];
      int hr = kRowsKept ? lst.r[0] : 0, who = lane;
      ndb::group_min<kRowsKept>(hk, hr, who, 4, 2);
      if (who == lane) ndb::reg_pop(lst, kFill);
      if (s == (e & 1)) {
        const int at = (qv * wpm + rb) * kp + e;
        mk[at] = hk;
        if constexpr (kRowsKept) mr[at] = hr;
      }
    }
  }
  __syncthreads();
  if (tid < qs) {
    const K* m_k = mk + tid * wpm * kp;
    const int* m_r = mr + tid * wpm * kp;
    int at[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) at[w] = w * kp;
    for (int e = 0; e < kp; ++e) {
      K hk = m_k[at[0]];
      int hr = kRowsKept ? m_r[at[0]] : 0, hw = 0;
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        if (w < wpm) {
          const K k = m_k[at[w]];
          const int r = kRowsKept ? m_r[at[w]] : 0;
          if (ndb::before<kRowsKept>(k, r, hk, hr)) {
            hk = k;
            hr = r;
            hw = w;
          }
        }
#pragma unroll
      for (int w = 0; w < kWarps; ++w) at[w] += w == hw;
      if constexpr (kRowsKept) {
        o_d[tid * kp + e] = hk;
        o_i[tid * kp + e] = hr;
      } else {
        const bool empty = hk == kIntFill;
        o_d[tid * kp + e] = empty ? FLT_MAX : ndb::key_dist(hk, pb);
        o_i[tid * kp + e] = empty ? -1 : off + ndb::key_pos(hk, pb);
      }
    }
  }
}

// The tensor-core kernel of a mode, lists in registers or not.
using MmaFn = void (*)(const float*, const __nv_bfloat16*, const int*,
                       const int*, float*, int*, int, int, int, long long,
                       int, int, int, int);

MmaFn mma_kernel(int mode, bool reg) {
  if (mode == kExact)
    return reg ? grouped_scan_mma_kernel<kExact, true>
               : grouped_scan_mma_kernel<kExact, false>;
  if (mode == kPacked)
    return reg ? grouped_scan_mma_kernel<kPacked, true>
               : grouped_scan_mma_kernel<kPacked, false>;
  return reg ? grouped_scan_mma_kernel<kBlockMin, true>
             : grouped_scan_mma_kernel<kBlockMin, false>;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes (-1: not this
// library's store). mode: 0 exact, 1 packed, 2 blockmin.
long long ivf_grouped_scan_smem_bytes(int qs, int D, int kp, int mode,
                                      int store_bf16) {
  return store_bf16 ? mma_layout(qs, D, kp, mode).bytes : -1;
}

// qpad [n_sub * qs, D] f32; vecs [n_rows, D] bf16 (store_bf16 must be 1;
// the f32 store's kernel is ivf_scan_grouped_f32.cu);
// tile_off/tile_cnt [n_sub / sub_per_tile] int32; out_d/out_i
// [n_sub * qs, kp]. mode 1 and 2 take pos_bits pb in [1, 30]. Launches on
// `stream` and returns the CUDA error code of the launch (0 = success).
int ivf_grouped_scan(const void* qpad, const void* vecs, const void* tile_off,
                     const void* tile_cnt, void* out_d, void* out_i, int n_sub,
                     int sub_per_tile, int qs, int D, long long n_rows, int kp,
                     int metric_ip, int store_bf16, int mode, int pb,
                     void* stream) {
  if (n_sub <= 0) return 0;
  if (!store_bf16 || qs < 1 || qs > kQsMax || kp < 1 || D < 1 ||
      sub_per_tile < 1 || mode < kExact || mode > kBlockMin ||
      (mode != kExact && (pb < 1 || pb > 30)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(mma_layout(qs, D, kp, mode).bytes);
  const MmaFn f = mma_kernel(mode, kp <= ndb::kRegK);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(f),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec8 =
      D % 8 == 0 && reinterpret_cast<uintptr_t>(vecs) % 16 == 0 ? 1 : 0;
  f<<<n_sub, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qpad),
      static_cast<const __nv_bfloat16*>(vecs),
      static_cast<const int*>(tile_off), static_cast<const int*>(tile_cnt),
      static_cast<float*>(out_d), static_cast<int*>(out_i), sub_per_tile, qs,
      D, n_rows, kp, metric_ip, pb, vec8);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
