// Sequential recurrences of the ML runtime, one thread each: offline
// Q-learning over logged transitions and additive Holt-Winters smoothing.
//
// Counterparts of two lax.scan loops of the JAX package:
//   q_learning      neurondb_tpu/ml/rl.py:33-41 (a scan over transitions
//                   inside a fori_loop over epochs)
//   holt_winters    neurondb_tpu/ml/timeseries.py:62-74
// Each step depends on the one before, so one thread of one block runs the
// recurrence; the block's other threads stage the inputs into shared memory
// in tiles (coalesced) and write the outputs back. The state lives in shared
// memory where it fits (Q [S, A], the seasonal ring), else in global memory.
//
// Every expression is evaluated in the JAX package's order with f32
// round-to-nearest intrinsics (__fadd_rn / __fsub_rn / __fmul_rn), which the
// compiler never contracts into an FMA, so the result equals the plain torch
// loop (ops/kernels/ml_recurrence.py) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;          // steps staged a tile
constexpr size_t kSmemMax = 227 * 1024;

// jnp.max semantics: a NaN anywhere in the row gives NaN.
__device__ __forceinline__ float row_max(const float* row, int A) {
  float m = row[0];
  for (int j = 1; j < A; ++j) {
    const float v = row[j];
    m = (v > m || v != v) ? v : m;
  }
  return m;
}

// kQInSmem: Q [S, A] lives in shared memory beside the tiles (the compiler
// then addresses it with shared loads), else in global memory.
template <bool kQInSmem>
__global__ void __launch_bounds__(kThreads)
q_learning_kernel(const int* __restrict__ s, const int* __restrict__ a,
                  const float* __restrict__ r, const int* __restrict__ s2,
                  float* Q, long long T, int S, int A, float alpha,
                  float one_minus_alpha, float gamma, int epochs) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ts = reinterpret_cast<int*>(smem);
  int* ta = ts + kTile;
  int* ts2 = ta + kTile;
  float* tr = reinterpret_cast<float*>(ts2 + kTile);
  float* q = kQInSmem ? tr + kTile : Q;
  const int tid = threadIdx.x;
  const long long SA = static_cast<long long>(S) * A;
  if (kQInSmem) {
    for (long long i = tid; i < SA; i += kThreads) q[i] = Q[i];
  }
  __syncthreads();
  for (int e = 0; e < epochs; ++e) {
    for (long long base = 0; base < T; base += kTile) {
      const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                         T - base));
      for (int i = tid; i < n; i += kThreads) {
        ts[i] = s[base + i];
        ta[i] = a[base + i];
        ts2[i] = s2[base + i];
        tr[i] = r[base + i];
      }
      __syncthreads();
      if (tid == 0) {
        // the next transition's fields do not depend on Q: read them
        // before this step's update, so only the Q round trip is serial
        int si = ts[0], ai = ta[0], s2i = ts2[0];
        float ri = tr[0];
        for (int i = 0; i < n; ++i) {
          const int j = i + 1 < n ? i + 1 : i;
          const int sn = ts[j], an = ta[j], s2n = ts2[j];
          const float rn = tr[j];
          float* cell = q + static_cast<long long>(si) * A + ai;
          const float old = *cell;
          const float m = row_max(q + static_cast<long long>(s2i) * A, A);
          const float target = __fadd_rn(ri, __fmul_rn(gamma, m));
          *cell = __fadd_rn(__fmul_rn(one_minus_alpha, old),
                            __fmul_rn(alpha, target));
          si = sn;
          ai = an;
          s2i = s2n;
          ri = rn;
        }
      }
      __syncthreads();
    }
  }
  if (kQInSmem) {
    for (long long i = tid; i < SA; i += kThreads) Q[i] = q[i];
  }
}

// state [2] = (level, trend) in and out; seas [season] the seasonal terms in
// their logical order, in and out; fitted [n].
__global__ void __launch_bounds__(kThreads)
holt_winters_kernel(const float* __restrict__ y, float* __restrict__ fitted,
                    float* state, float* seas, long long n, int season,
                    float alpha, float one_minus_alpha, float beta,
                    float one_minus_beta, float gamma, float one_minus_gamma,
                    int ring_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ty = reinterpret_cast<float*>(smem);
  float* tf = ty + kTile;
  float* ring = ring_in_smem ? tf + kTile : seas;
  const int tid = threadIdx.x;
  if (ring_in_smem) {
    for (int i = tid; i < season; i += kThreads) ring[i] = seas[i];
  }
  float level = state[0];
  float trend = state[1];
  int head = 0;                        // ring[head] is the logical seas[0]
  __syncthreads();
  for (long long base = 0; base < n; base += kTile) {
    const int cnt = static_cast<int>(min(static_cast<long long>(kTile),
                                         n - base));
    for (int i = tid; i < cnt; i += kThreads) ty[i] = y[base + i];
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < cnt; ++i) {
        const float yt = ty[i];
        const float s0 = ring[head];
        const float lt = __fadd_rn(level, trend);
        const float new_level = __fadd_rn(
            __fmul_rn(alpha, __fsub_rn(yt, s0)),
            __fmul_rn(one_minus_alpha, lt));
        const float new_trend = __fadd_rn(
            __fmul_rn(beta, __fsub_rn(new_level, level)),
            __fmul_rn(one_minus_beta, trend));
        const float new_s = __fadd_rn(
            __fmul_rn(gamma, __fsub_rn(yt, new_level)),
            __fmul_rn(one_minus_gamma, s0));
        tf[i] = __fadd_rn(lt, s0);
        ring[head] = new_s;
        head = head + 1 == season ? 0 : head + 1;
        level = new_level;
        trend = new_trend;
      }
    }
    __syncthreads();
    for (int i = tid; i < cnt; i += kThreads) fitted[base + i] = tf[i];
    __syncthreads();
  }
  if (tid == 0) {
    state[0] = level;
    state[1] = trend;
  }
  // every thread knows head: n % season
  const int h = static_cast<int>(n % season);
  if (ring_in_smem) {
    for (int j = tid; j < season; j += kThreads)
      seas[j] = ring[(h + j) % season];
  } else if (tid == 0 && h != 0) {
    // rotate the global ring in place so seas[j] = ring[(h + j) % season]
    // (three reversals)
    auto rev = [&](int lo, int hi) {
      for (--hi; lo < hi; ++lo, --hi) {
        const float t = seas[lo];
        seas[lo] = seas[hi];
        seas[hi] = t;
      }
    };
    rev(0, h);
    rev(h, season);
    rev(0, season);
  }
}

size_t q_smem(int S, int A, bool q_in_smem) {
  return static_cast<size_t>(kTile) * 16 +
         (q_in_smem ? static_cast<size_t>(S) * A * sizeof(float) : 0);
}

size_t hw_smem(int season, bool ring_in_smem) {
  return static_cast<size_t>(kTile) * 8 +
         (ring_in_smem ? static_cast<size_t>(season) * sizeof(float) : 0);
}

}  // namespace

extern "C" {

// 1 if Q [S, A] f32 lives in shared memory beside the transition tiles.
int ml_q_in_smem(int S, int A) {
  return q_smem(S, A, true) <= kSmemMax ? 1 : 0;
}

int ml_ring_in_smem(int season) {
  return hw_smem(season, true) <= kSmemMax ? 1 : 0;
}

// s, a, s2 [T] int32; r [T] f32; Q [S, A] f32, updated in place.
int ml_q_learning(const void* s, const void* a, const void* r, const void* s2,
                  void* Q, long long T, int S, int A, float alpha,
                  float one_minus_alpha, float gamma, int epochs,
                  void* stream) {
  const int in_smem = ml_q_in_smem(S, A);
  const size_t smem = q_smem(S, A, in_smem != 0);
  const auto kernel =
      in_smem ? q_learning_kernel<true> : q_learning_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s), static_cast<const int*>(a),
      static_cast<const float*>(r), static_cast<const int*>(s2),
      static_cast<float*>(Q), T, S, A, alpha, one_minus_alpha, gamma, epochs);
  return static_cast<int>(cudaGetLastError());
}

// y, fitted [n] f32; state [2] (level, trend) and seas [season] f32,
// updated in place.
int ml_holt_winters(const void* y, void* fitted, void* state, void* seas,
                    long long n, int season, float alpha,
                    float one_minus_alpha, float beta, float one_minus_beta,
                    float gamma, float one_minus_gamma, void* stream) {
  const int in_smem = ml_ring_in_smem(season);
  const size_t smem = hw_smem(season, in_smem != 0);
  cudaError_t err = cudaFuncSetAttribute(
      holt_winters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  holt_winters_kernel<<<1, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<float*>(fitted),
      static_cast<float*>(state), static_cast<float*>(seas), n, season,
      alpha, one_minus_alpha, beta, one_minus_beta, gamma, one_minus_gamma,
      in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
