// Building blocks shared by the BackPACK reduction kernels: the tile sizes
// of batch_l2's CUDA-core Gram form (BT, BK, THREADS, zero), warp and block
// sums, the wave sizing, and sum_partials.  Sums across blocks never use
// atomics: each block writes its own partial and sum_partials adds them in a
// fixed order, so every result is the same from run to run.
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

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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

}  // namespace bp
