// HNSW beam search at one graph level, one query a thread block, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: it replaces the JAX package's
// `lax.while_loop` in `_beam_search` (neurondb_tpu/index/hnsw.py:195),
// which the port first ran as a Python loop of ~60 torch launches a step
// over the whole batch in lockstep (`_beam_search_plain` in
// neurondb_tpu_torch/index/hnsw.py, kept as the plain version).
//
// What it computes, per query b (exactly what the plain version computes):
// - entries: the R entry rows of b, each dropped if negative or equal to
//   an earlier entry of the row, scored, set in the visited bitmap and
//   sorted into the beam by (distance, entry position);
// - each step: pop the E first unexpanded entries of the sorted beam (all
//   beam entries have finite distances); read their adjacency rows
//   (nbr [Nc, deg], -1 pad); test and set each neighbour's bit in the
//   query's visited bitmap (visited [B, words] uint32, zeroed by the
//   caller) with atomicOr, so a node already visited, and a repeat within
//   the step, is not fresh; score the fresh neighbours from the store:
//     sq-L2: d = max((|q|^2 + |x|^2) - 2 (q . x), 0)   (|x|^2: sqnorms)
//     ip:    d = -(q . x)
//   and merge them into the ef beam, ascending, ties to beam entries
//   before fresh ones and among fresh ones to the smaller row id: the
//   plain version's stable sort of [beam | fresh in id order];
// - stop when no beam entry is unexpanded, or after max_steps steps. A
//   step on a converged query changes nothing, so stopping each query on
//   its own gives the lockstep loop's answers.
// Rows are local ids of the level; rowmap (null at level 0) maps a local
// id to its store row. Output: dists [B, ef] f32, rows [B, ef] int64,
// ascending, padded with (FLT_MAX, -1); fresh [B] (rows scored after the
// entries) and steps [B] int32. Products and sums are f32: q . x a chain
// of fmaf over each lane's 4-element chunks in order, then an xor
// butterfly over the lanes of a row; |q|^2 lane partials summed the same
// way. The distance expression is written with __fadd_rn / __fsub_rn /
// __fmul_rn, which nvcc never contracts, so it rounds where the plain
// version's torch ops round.
//
// What bounds it on the card. The work is a dependent chain per query and
// step (pop, adjacency read, bitmap atomics, row reads, merge) over data
// that fits no cache: at the GloVe cell (1.18M rows of 100 bf16 dims,
// 4,096 queries, ef 128, E 4, deg 32) a search scores ~8.7M fresh rows,
// 1.76 GB of rows and norms, 0.52 ms at 3.35 TB/s; the bitmap's ~21M
// atomics and the adjacency rows add ~1.5 GB of sector traffic. It is
// bound by bytes and by the latency of each step's four dependent
// device-memory round trips, never by operations (2 x dim FLOP a row).
//
// Design:
// - one block of 128 threads a query, ~5 KB of shared memory at ef 128,
//   launch bounds for 8 blocks an SM: ~1,000 queries walk at once, each
//   hiding the others' latency;
// - the query, the beam (double-buffered, with its expanded flags) and
//   the step's fresh candidates sit in shared memory; the beam is kept
//   sorted, so a pop scans it from the first unexpanded position (kept
//   with the merge) by ballot;
// - at E 4, deg 32 a warp reads one popped node's adjacency row, a lane a
//   neighbour (coalesced), and each lane's atomicOr returns whether the
//   bit was new: no sort dedups the step;
// - fresh rows are compacted by a block prefix sum and scored G lanes a
//   row (G the least power of two that covers a row in 8 chunks a lane:
//   4 at 100 bf16 dims, 32 rows at once), each lane issuing its chunk
//   loads together (8-byte chunks of a bf16 row, 16-byte of an f32 row:
//   the rows of 100 bf16 dims are 200 bytes, 8-byte aligned, not 16;
//   element loads where dim % 4 or the store's alignment forbid);
// - once the beam is full, a fresh row at or past its last entry cannot
//   enter it (ties go to the beam), and every row that can ranks before
//   it: such rows are dropped before the merge, which changes no kept
//   row's place and spares the ranking most rows late in a walk;
// - the merge ranks each kept row among the others by (d, id), then
//   places beam entries and kept rows by binary search in each other's
//   sorted lists: no sorting network.
// Measured (NVIDIA H100 80GB HBM3, 700 W; the GloVe cell's beam: 4,096
// queries, 8.65M fresh rows, 38 steps at most, 33.7 on average): 2.15 ms
// a launch with the bitmap's memset; without the drop 2.35 ms. By thread
// 0's clock the step's time goes to scoring the rows (55%) and the
// adjacency read with the bitmap's atomics (29%), two dependent trips to
// device memory each; ranking, dropping and merging take 12%. Tried and
// slower: the visited set in a shared-memory hash table (8,192 slots:
// 2.52 ms, six blocks an SM; 4,096 slots, the bitmap past half load:
// 2.15 ms with no memset against the bitmap's 2.36 with its 0.33 ms
// memset, both before the drop), 16 chunks a lane (one scoring pass,
// spills), 80 registers at six blocks an SM, and L2 prefetches of the
// fresh rows and the kept rows' adjacency (2.36 / 2.43 ms): more requests
// slow the card's random reads, which run near their rate.
// ptxas: 64 registers in each instantiation; 0 spills in the bf16 ones
// and f32 with dim % 4 != 0, 32 bytes with f32 chunks of 4.
// Limits (the wrapper's `kernel_takes`): ef <= 1024, E * deg <= 256,
// dim <= 32,768, 1 <= R <= ef, max_steps >= 1, bf16 or f32 store; at
// those limits `smem_bytes` is at most 155,648 bytes, within the SM's
// 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCand = 256;          // E * deg: two slots a thread
constexpr int kInFlight = 8;           // chunk loads a lane issues together
constexpr float kInf = 3.402823466e38f;  // FLT_MAX: the plain version's pad
constexpr unsigned kFull = 0xffffffffu;

// One chunk of a stored row: V elements widened to f32 and multiplied
// into the lane's running sum, in order.
template <typename T, int V>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16, 4> {
  using raw = uint2;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* row,
                                             int c) {
    return __ldg(reinterpret_cast<const uint2*>(row) + c);
  }
  static __device__ __forceinline__ float fma(raw v, const float* q,
                                              float acc) {
    acc = fmaf(q[0], __uint_as_float(v.x << 16), acc);
    acc = fmaf(q[1], __uint_as_float(v.x & 0xffff0000u), acc);
    acc = fmaf(q[2], __uint_as_float(v.y << 16), acc);
    return fmaf(q[3], __uint_as_float(v.y & 0xffff0000u), acc);
  }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
  using raw = unsigned short;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* row,
                                             int c) {
    return __ldg(reinterpret_cast<const unsigned short*>(row) + c);
  }
  static __device__ __forceinline__ float fma(raw v, const float* q,
                                              float acc) {
    return fmaf(q[0], __uint_as_float(static_cast<unsigned>(v) << 16), acc);
  }
};

template <>
struct Chunk<float, 4> {
  using raw = float4;
  static __device__ __forceinline__ raw load(const float* row, int c) {
    return __ldg(reinterpret_cast<const float4*>(row) + c);
  }
  static __device__ __forceinline__ float fma(raw v, const float* q,
                                              float acc) {
    acc = fmaf(q[0], v.x, acc);
    acc = fmaf(q[1], v.y, acc);
    acc = fmaf(q[2], v.z, acc);
    return fmaf(q[3], v.w, acc);
  }
};

template <>
struct Chunk<float, 1> {
  using raw = float;
  static __device__ __forceinline__ raw load(const float* row, int c) {
    return __ldg(row + c);
  }
  static __device__ __forceinline__ float fma(raw v, const float* q,
                                              float acc) {
    return fmaf(q[0], v, acc);
  }
};

// q . row over the G lanes of a row group (lane gl of G): each lane takes
// chunks gl, gl + G, ... (cpr chunks a row; cpr 0 for an idle group), then
// an xor butterfly over the group. Every lane of the warp calls it.
template <typename T, int V>
__device__ __forceinline__ float group_dot(const T* row, const float* s_q,
                                           int cpr, int gl, int G) {
  using C = Chunk<T, V>;
  float acc = 0.f;
  for (int base = gl; base < cpr; base += G * kInFlight) {
    typename C::raw v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int c = base + k * G;
      if (c < cpr) v[k] = C::load(row, c);
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int c = base + k * G;
      if (c < cpr) acc = C::fma(v[k], s_q + c * V, acc);
    }
  }
  for (int off = G >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

__device__ __forceinline__ float distance(float dot, float q_sq, float x_sq,
                                          bool ip) {
  if (ip) return -dot;
  return fmaxf(__fsub_rn(__fadd_rn(q_sq, x_sq), __fmul_rn(2.f, dot)), 0.f);
}

// Exclusive prefix sum of v over the block, and its total. One barrier:
// the caller's last reads of s_warp lie behind an earlier one.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int at = incl - v;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    if (w < warp) at += c;
    total += c;
  }
  return at;
}

// Entries of a sorted float list below v (lower) or at most v (!lower).
__device__ __forceinline__ int count_before(const float* a, int n, float v,
                                            bool lower) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool left = lower ? (a[mid] < v) : (a[mid] <= v);
    if (left) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Params {
  const float* q;          // [B, D] f32
  const int* entry;        // [B, R] int32
  const void* vecs;        // [Nv, D] bf16 or f32
  const float* sqnorms;    // [Nv] f32
  const int* nbr;          // [Nc, deg] int32
  const int* rowmap;       // [Nc] int32, or null (identity)
  unsigned* visited;       // [B, words], zero
  float* out_d;            // [B, ef]
  long long* out_i;        // [B, ef]
  int* out_fresh;          // [B]
  int* out_steps;          // [B]
  long long words;
  int D, R, deg, ef, E, max_steps, ip, G;
};

// Dynamic shared memory: the query (dim rounded up to 4), two beams of ef
// (d, id), five candidate arrays of E * deg, E popped ids, two beams of
// ef expanded flags.
__host__ __device__ __forceinline__ size_t smem_bytes(int D, int ef,
                                                      int cand, int E) {
  const size_t d4 = (static_cast<size_t>(D) + 3) / 4 * 4;
  return 4 * (d4 + 4 * static_cast<size_t>(ef) + 5 * static_cast<size_t>(cand)
              + E) + 2 * static_cast<size_t>(ef);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 8)
hnsw_beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_len, s_lo, s_warp[kWarps];
  __shared__ float s_red[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.D, ef = p.ef, E = p.E, deg = p.deg;
  const int cand = E * deg;
  const int cpr = D / V;                 // chunks a row
  const bool ip = p.ip != 0;

  // the beam (bd, bi, bx: d, id, expanded) and the merge's output (nd,
  // ni, nx), swapped by pointer after each merge
  float* s_q = reinterpret_cast<float*>(smem);
  float* bd = s_q + (D + 3) / 4 * 4;
  float* nd = bd + ef;
  int* bi = reinterpret_cast<int*>(nd + ef);
  int* ni = bi + ef;
  int* s_fi = ni + ef;                   // fresh ids, compacted
  int* s_fv = s_fi + cand;               // their store rows
  float* s_fd = reinterpret_cast<float*>(s_fv + cand);   // their distances
  float* s_sd = s_fd + cand;             // fresh (d, id) sorted
  int* s_si = reinterpret_cast<int*>(s_sd + cand);
  int* s_pop = s_si + cand;
  unsigned char* bx = reinterpret_cast<unsigned char*>(s_pop + E);
  unsigned char* nx = bx + ef;

  const T* vecs = static_cast<const T*>(p.vecs);
  unsigned* vis = p.visited + static_cast<long long>(b) * p.words;

  // ---- the query and |q|^2 ----
  const float* qb = p.q + static_cast<long long>(b) * D;
  float part = 0.f;
  for (int i = tid; i < D; i += kThreads) {
    const float v = qb[i];
    s_q[i] = v;
    part = fmaf(v, v, part);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  if (lane == 0) s_red[warp] = part;
  if (tid == 0) s_len = 0;
  __syncthreads();
  const float q_sq = (s_red[0] + s_red[1]) + (s_red[2] + s_red[3]);

  // ---- entries: dedup within the row, score, mark, sort by (d, slot) ----
  const int R = p.R;
  const int* ent = p.entry + static_cast<long long>(b) * R;
  float* tmp_d = nd;                     // R <= ef: the other beam as scratch
  int* tmp_i = ni;
  int n_ok = 0;
  for (int t = tid; t < R; t += kThreads) {
    const int e = ent[t];
    bool ok = e >= 0;
    for (int j = 0; ok && j < t; ++j) ok = ent[j] != e;
    float d = kInf;
    if (ok) {
      const long long vr = p.rowmap ? p.rowmap[e] : e;
      const float dot = group_dot<T, V>(vecs + vr * D, s_q, cpr, 0, 1);
      d = distance(dot, q_sq, ip ? 0.f : p.sqnorms[vr], ip);
      atomicOr(vis + (e >> 5), 1u << (e & 31));
      ++n_ok;
    }
    tmp_d[t] = d;
    tmp_i[t] = ok ? e : -1;
  }
  if (n_ok) atomicAdd(&s_len, n_ok);
  __syncthreads();
  for (int t = tid; t < R; t += kThreads) {
    if (tmp_i[t] < 0) continue;
    const float d = tmp_d[t];
    int rank = 0;
    for (int j = 0; j < R; ++j)
      rank += tmp_i[j] >= 0 && (tmp_d[j] < d || (tmp_d[j] == d && j < t));
    bd[rank] = d;
    bi[rank] = tmp_i[t];
    bx[rank] = 0;
  }
  if (tid == 0) s_lo = 0;
  __syncthreads();

  // ---- the walk ----
  int steps = 0, fresh_total = 0;
  while (steps < p.max_steps) {
    const int len = s_len;
    // pop: the first E unexpanded positions, from the chunk holding s_lo
    int found = 0;
    for (int base = (s_lo / kThreads) * kThreads; base < len && found < E;
         base += kThreads) {
      const int pos = base + tid;
      const bool u = pos < len && !bx[pos];
      const unsigned bal = __ballot_sync(kFull, u);
      if (lane == 0) s_warp[warp] = __popc(bal);
      __syncthreads();
      int before = found, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_warp[w];
        if (w < warp) before += c;
        total += c;
      }
      const int mine = before + __popc(bal & ((1u << lane) - 1u));
      if (u && mine < E) {
        s_pop[mine] = bi[pos];
        bx[pos] = 1;
      }
      found += total;
      __syncthreads();
    }
    const int npop = found < E ? found : E;
    if (npop == 0) break;

    // gather the popped rows' neighbours and test-and-set their bits:
    // slots tid and tid + 128 of [npop, deg]
    const int n_slots = npop * deg;
    int nb[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = tid + k * kThreads;
      nb[k] = -1;
      if (c < n_slots) {
        const int pp = c / deg;
        nb[k] = __ldg(p.nbr + static_cast<long long>(s_pop[pp]) * deg
                      + (c - pp * deg));
      }
    }
    bool fr[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      fr[k] = false;
      if (nb[k] >= 0) {
        const unsigned bit = 1u << (nb[k] & 31);
        fr[k] = !(atomicOr(vis + (nb[k] >> 5), bit) & bit);
      }
    }
    // compact the fresh ones: a block prefix sum of 0-2 a thread
    int nfresh;
    int at = block_scan(static_cast<int>(fr[0]) + static_cast<int>(fr[1]),
                        s_warp, nfresh);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (fr[k]) {
        s_fi[at] = nb[k];
        s_fv[at] = p.rowmap ? __ldg(p.rowmap + nb[k]) : nb[k];
        ++at;
      }
    }
    __syncthreads();

    // score the fresh rows, G lanes a row
    const int G = p.G, per_pass = kThreads / G, gl = tid & (G - 1);
    for (int r0 = 0; r0 < nfresh; r0 += per_pass) {
      const int r = r0 + tid / G;
      const bool act = r < nfresh;
      const long long vr = act ? s_fv[r] : 0;
      float x_sq = 0.f;
      if (act && !ip && gl == 0) x_sq = __ldg(p.sqnorms + vr);
      const float dot = group_dot<T, V>(vecs + vr * D, s_q, act ? cpr : 0,
                                        gl, G);
      if (act && gl == 0) s_fd[r] = distance(dot, q_sq, x_sq, ip);
    }
    __syncthreads();

    // keep the fresh rows that can enter the beam: all while it has room,
    // else those before its last entry (ties go to the beam). The rest sort
    // after every beam entry, so no kept row's place changes.
    const float last = len < ef ? __int_as_float(0x7f800000) : bd[len - 1];
    float kd[2];
    int ki[2];
    bool keep[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = tid + k * kThreads;
      keep[k] = false;
      if (r < nfresh) {
        kd[k] = s_fd[r];
        ki[k] = s_fi[r];
        keep[k] = kd[k] < last;
      }
    }
    int nkeep;
    at = block_scan(static_cast<int>(keep[0]) + static_cast<int>(keep[1]),
                    s_warp, nkeep);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (keep[k]) {
        s_fd[at] = kd[k];
        s_fi[at] = ki[k];
        ++at;
      }
    }
    __syncthreads();

    // rank each kept row by (d, id); the next pop's start is reset
    for (int i = tid; i < nkeep; i += kThreads) {
      const float d = s_fd[i];
      const int id = s_fi[i];
      int rank = 0;
      for (int j = 0; j < nkeep; ++j) {
        const float dj = s_fd[j];
        rank += (dj < d) | ((dj == d) & (s_fi[j] < id));
      }
      s_sd[rank] = d;
      s_si[rank] = id;
    }
    if (tid == 0) s_lo = ef;
    __syncthreads();

    // merge into the other beam: a beam entry goes after the fresh ones
    // below it, a fresh one after the beam entries at or below it
    for (int i = tid; i < len; i += kThreads) {
      const float d = bd[i];
      const int pos = i + count_before(s_sd, nkeep, d, true);
      if (pos < ef) {
        const unsigned char x = bx[i];
        nd[pos] = d;
        ni[pos] = bi[i];
        nx[pos] = x;
        if (!x) atomicMin(&s_lo, pos);
      }
    }
    for (int i = tid; i < nkeep; i += kThreads) {
      const float d = s_sd[i];
      const int pos = i + count_before(bd, len, d, false);
      if (pos < ef) {
        nd[pos] = d;
        ni[pos] = s_si[i];
        nx[pos] = 0;
        atomicMin(&s_lo, pos);
      }
    }
    if (tid == 0) s_len = len + nkeep < ef ? len + nkeep : ef;
    fresh_total += nfresh;
    ++steps;
    {
      float* t = bd; bd = nd; nd = t;
      int* u = bi; bi = ni; ni = u;
      unsigned char* v = bx; bx = nx; nx = v;
    }
    __syncthreads();
  }

  // ---- output ----
  const int len = s_len;
  float* od = p.out_d + static_cast<long long>(b) * ef;
  long long* oi = p.out_i + static_cast<long long>(b) * ef;
  for (int i = tid; i < ef; i += kThreads) {
    const bool in = i < len;
    od[i] = in ? bd[i] : kInf;
    oi[i] = in ? static_cast<long long>(bi[i]) : -1LL;
  }
  if (tid == 0) {
    p.out_fresh[b] = fresh_total;
    p.out_steps[b] = steps;
  }
}

template <typename T, int V>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D, p.ef, p.E * p.deg, p.E);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hnsw_beam_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hnsw_beam_kernel<T, V><<<B, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, D] f32; entry [B, R] int32; vecs [Nv, D] (bf16 != 0: bf16, else
// f32); sqnorms [Nv] f32; nbr [Nc, deg] int32; rowmap [Nc] int32 or null;
// visited [B, words] uint32, zero; out_d [B, ef] f32; out_i [B, ef] int64;
// out_fresh, out_steps [B] int32. vec4: dim % 4 == 0 and the store 16-byte
// aligned (chunks of 4 elements).
int hnsw_beam_search(const void* q, int B, int D, const void* entry, int R,
                     const void* vecs, int bf16, int vec4,
                     const void* sqnorms, const void* nbr, int deg,
                     const void* rowmap, void* visited, long long words,
                     int ef, int E, int max_steps, int ip,
                     void* out_d, void* out_i, void* out_fresh,
                     void* out_steps, void* stream) {
  if (B <= 0) return 0;
  if (E * deg > kMaxCand) return -1;
  // G, the lanes that score a row: the least power of two (at most a
  // warp) whose lanes cover the row's chunks in kInFlight loads each
  const int chunks = vec4 ? (D + 3) / 4 : D;
  int G = 1;
  while (G < 32 && G * kInFlight < chunks) G *= 2;
  Params p;
  p.q = static_cast<const float*>(q);
  p.entry = static_cast<const int*>(entry);
  p.vecs = vecs;
  p.sqnorms = static_cast<const float*>(sqnorms);
  p.nbr = static_cast<const int*>(nbr);
  p.rowmap = static_cast<const int*>(rowmap);
  p.visited = static_cast<unsigned*>(visited);
  p.out_d = static_cast<float*>(out_d);
  p.out_i = static_cast<long long*>(out_i);
  p.out_fresh = static_cast<int*>(out_fresh);
  p.out_steps = static_cast<int*>(out_steps);
  p.words = words;
  p.D = D;
  p.R = R;
  p.deg = deg;
  p.ef = ef;
  p.E = E;
  p.max_steps = max_steps;
  p.ip = ip;
  p.G = G;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec4 ? launch<__nv_bfloat16, 4>(p, B, s)
                : launch<__nv_bfloat16, 1>(p, B, s);
  return vec4 ? launch<float, 4>(p, B, s) : launch<float, 1>(p, B, s);
}

}  // extern "C"
