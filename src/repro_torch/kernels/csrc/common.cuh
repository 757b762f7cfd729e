// Building blocks shared by the BackPACK reduction kernels (fp32, CUDA cores).
//
// tile64 is the one contraction: a 64x64 tile of XᵀY over the rows of X and
// Y, 4x4 outputs a thread, rows staged through shared memory 16 at a time
// with the next 16 fetched into registers while the current ones are used,
// and float4 shared-memory reads.  One kernel is built on it:
//   * sq_stats_kernel: per-sample products t = X_nᵀY_cn squared and reduced
//     in registers, Σ_cn t² per element and Σ_c,elements t² per sample, so t
//     never reaches device memory (ggn_diag, batch_l2's G form); or, in
//     its variance mode, Σ_elements t² [· Σ] per (c, n) (the GLM predictive
//     variance).
// Sums across blocks never use atomics: each block writes its own partial and
// sum_partials adds them in a fixed order, so every result is the same from
// run to run.
#pragma once

#include <cuda_runtime.h>

namespace bp {

constexpr int BT = 64;       // tile side
constexpr int BK = 16;       // rows staged per step
constexpr int THREADS = 256; // every kernel here runs 256 threads a block

inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

inline long long cdiv(long long x, long long y) { return (x + y - 1) / y; }

// Blocks that cover the card twice over, spread over `tiles` output tiles:
// how many pieces to cut the rest of the work into (at least 1, at most most).
inline long long fill_splits(long long tiles, long long most) {
  long long s = cdiv(2LL * num_sms(), tiles);
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}

// Items per block: the count whose blocks finish soonest, waves × (items ×
// per_item + overhead), a block's ring fill and epilogue costing `overhead`
// stages and an item `per_item` (the larger count on a tie).  Without the
// overhead a block of one item looks best, and a 64-row item never fills
// its ring.
inline int wave_chunk(long long items, long long others, int slots, long long per_item,
                      long long overhead) {
  int best = 1;
  long long best_cost = -1;
  for (long long c = 1; c <= items; ++c) {
    if (c > 1 && bp::cdiv(items, c) == bp::cdiv(items, c - 1)) continue;
    const long long cost = bp::cdiv(others * bp::cdiv(items, c), slots) * (c * per_item + overhead);
    if (best_cost < 0 || cost <= best_cost) best = (int)c, best_cost = cost;
  }
  return best;
}

struct Stage {
  float x[BK][BT];
  float y[BK][BT];
};

// acc[i][j] += Σ_r X[r, x0+4·ty+i] · Y[r, y0+4·tx+j] over r < R, for the
// calling thread's (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16).  X is
// [R, nx] and Y is [R, ny], row-major; columns past nx / ny read as zero.
// Every thread of the block must call it.
__device__ __forceinline__ void tile64(const float* __restrict__ X, int nx, int x0,
                                       const float* __restrict__ Y, int ny, int y0, long long R,
                                       Stage& st, float acc[4][4]) {
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  float px[4], py[4];
  auto fetch = [&](long long r0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = t + THREADS * q, c = e % BT;
      const long long r = r0 + e / BT;
      px[q] = (r < R && x0 + c < nx) ? X[r * nx + x0 + c] : 0.f;
      py[q] = (r < R && y0 + c < ny) ? Y[r * ny + y0 + c] : 0.f;
    }
  };
  fetch(0);
  for (long long r0 = 0; r0 < R; r0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = t + THREADS * q;
      st.x[e / BT][e % BT] = px[q];
      st.y[e / BT][e % BT] = py[q];
    }
    __syncthreads();
    if (r0 + BK < R) fetch(r0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&st.x[k][4 * ty]);
      const float4 yv = *reinterpret_cast<const float4*>(&st.y[k][4 * tx]);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ya[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Writes the thread's 4x4 of a 64x64 tile at (m0, n0) of out [M, N].
__device__ __forceinline__ void store_tile(float* __restrict__ out, int M, int N, int m0, int n0,
                                           const float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block; the result is valid in thread 0.  red holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  if (w == 0) {
    s = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    s = warp_sum(s);
  }
  __syncthreads();
  return s;
}

// out[e, m] = Σ_p part[e, p, m], p in increasing order.
__global__ void sum_partials(const float* __restrict__ part, float* __restrict__ out, int E,
                             int P, long long M) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)E * M) return;
  const long long e = idx / M, m = idx % M;
  const float* p = part + e * P * M + m;
  float s = 0.f;
  for (int k = 0; k < P; ++k) s += p[(long long)k * M];
  out[idx] = s;
}

inline void launch_sum_partials(const float* part, float* out, int E, int P, long long M,
                                cudaStream_t stream) {
  const long long total = (long long)E * M;
  sum_partials<<<(unsigned)cdiv(total, THREADS), THREADS, 0, stream>>>(part, out, E, P, M);
}

// ---------------------------------------------------------------------------
// sq_stats: reductions of t[e,c,n] = X[e,n]ᵀ Y[e,c,n]
//   diag[e]  = Σ_cn t∘t        [E, a, b]
//   trace[e,n] = Σ_c Σ t∘t     [E, N]
//   var[e,c,n] = Σ t∘t [∘ W]   [E, C, N]   (VAR = 1 unweighted, 2 weighted by W [a, b])
// X is [E, N, R, a], Y is [E, C, N, R, b].
// ---------------------------------------------------------------------------

// Grid (tiles_a, tiles_b, E·groups); block (·, ·, e·groups + g) takes the
// samples [g·group_size, (g+1)·group_size).  diag_part is [E, groups, a, b]
// (the diag output itself when groups == 1); trace_part is [E, tiles, N];
// var_part is [E, tiles, C, N].
template <bool DIAG, bool TRACE, int VAR = 0>
__global__ void __launch_bounds__(THREADS)
sq_stats_kernel(const float* __restrict__ X, const float* __restrict__ Y, int C, int N, int R,
                int a, int b, int groups, int group_size, float* __restrict__ diag_part,
                float* __restrict__ trace_part, const float* __restrict__ W,
                float* __restrict__ var_part) {
  __shared__ __align__(16) Stage st;
  __shared__ float red[32];
  const int e = blockIdx.z / groups, g = blockIdx.z % groups;
  const int tiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int a0 = blockIdx.x * BT, b0 = blockIdx.y * BT;
  const int n_lo = g * group_size, n_hi = min(N, n_lo + group_size);
  float diag[4][4];
  zero(diag);
  float w[4][4];  // this thread's weights (VAR == 2); 0 past the edges, where t is 0 too
  if (VAR == 2) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = a0 + 4 * ty + i, c = b0 + 4 * tx + j;
        w[i][j] = (r < a && c < b) ? W[(size_t)r * b + c] : 0.f;
      }
  }
  for (int n = n_lo; n < n_hi; ++n) {
    const float* Xn = X + ((size_t)e * N + n) * R * a;
    float tr = 0.f;
    for (int c = 0; c < C; ++c) {
      const float* Yn = Y + (((size_t)e * C + c) * N + n) * R * b;
      float acc[4][4];
      zero(acc);
      tile64(Xn, a, a0, Yn, b, b0, R, st, acc);
      float vs = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = acc[i][j] * acc[i][j];
          diag[i][j] += v;
          tr += v;
          if (VAR == 1) vs += v;
          if (VAR == 2) vs = fmaf(v, w[i][j], vs);
        }
      if (VAR) {
        const float s = block_sum(vs, red);
        if (threadIdx.x == 0) var_part[(((size_t)e * tiles + tile) * C + c) * N + n] = s;
      }
    }
    if (TRACE) {
      const float s = block_sum(tr, red);
      if (threadIdx.x == 0) trace_part[((size_t)e * tiles + tile) * N + n] = s;
    }
  }
  if (DIAG) store_tile(diag_part + ((size_t)e * groups + g) * a * b, a, b, a0, b0, diag);
}

struct SqStatsPlan {
  int tiles_a, tiles_b, groups, group_size;
};

inline SqStatsPlan sq_stats_plan(int E, int N, int a, int b) {
  SqStatsPlan p;
  p.tiles_a = (int)cdiv(a, BT);
  p.tiles_b = (int)cdiv(b, BT);
  const long long g = fill_splits((long long)E * p.tiles_a * p.tiles_b, N);
  p.group_size = (int)cdiv(N, g);
  p.groups = (int)cdiv(N, p.group_size);
  return p;
}

inline long long sq_stats_scratch_floats(int E, int N, int a, int b, bool diag, bool trace) {
  const SqStatsPlan p = sq_stats_plan(E, N, a, b);
  const long long tiles = (long long)p.tiles_a * p.tiles_b;
  return (diag && p.groups > 1 ? (long long)E * p.groups * a * b : 0) +
         (trace ? (long long)E * tiles * N : 0);
}

template <bool DIAG, bool TRACE>
inline cudaError_t sq_stats_launch(const float* X, const float* Y, int E, int C, int N, int R,
                                   int a, int b, float* diag, float* trace, float* scratch,
                                   cudaStream_t stream) {
  const SqStatsPlan p = sq_stats_plan(E, N, a, b);
  const long long tiles = (long long)p.tiles_a * p.tiles_b;
  float* diag_part = p.groups > 1 ? scratch : diag;
  float* trace_part = scratch + (DIAG && p.groups > 1 ? (size_t)E * p.groups * a * b : 0);
  dim3 grid(p.tiles_a, p.tiles_b, E * p.groups);
  sq_stats_kernel<DIAG, TRACE><<<grid, THREADS, 0, stream>>>(
      X, Y, C, N, R, a, b, p.groups, p.group_size, diag_part, trace_part, nullptr, nullptr);
  if (DIAG && p.groups > 1)
    launch_sum_partials(diag_part, diag, E, p.groups, (long long)a * b, stream);
  if (TRACE) launch_sum_partials(trace_part, trace, E, (int)tiles, N, stream);
  return cudaGetLastError();
}

// diag/trace as the mask asks (at least one of them).
inline cudaError_t sq_stats(bool want_diag, bool want_trace, const float* X, const float* Y,
                            int E, int C, int N, int R, int a, int b, float* diag, float* trace,
                            float* scratch, cudaStream_t stream) {
  if (want_diag && want_trace)
    return sq_stats_launch<true, true>(X, Y, E, C, N, R, a, b, diag, trace, scratch, stream);
  if (want_diag)
    return sq_stats_launch<true, false>(X, Y, E, C, N, R, a, b, diag, trace, scratch, stream);
  return sq_stats_launch<false, true>(X, Y, E, C, N, R, a, b, diag, trace, scratch, stream);
}

}  // namespace bp
