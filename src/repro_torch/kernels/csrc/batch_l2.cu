// Per-sample squared gradient norms: l2[n] = ‖A[n]ᵀ B[n]‖²_F, A [N, R, a],
// B [N, R, b], float32 and contiguous.  BatchL2 on the per-extension route.
//
// Replaces the Pallas kernel batch_l2_pallas (src/repro/kernels/batch_l2.py:40),
// which computes it by the Gram trick
//   l2[n] = Σ_rs (A_n A_nᵀ)[r,s] · (B_n B_nᵀ)[r,s],
// at N·R(R+1)·(a+b+1) operations when only the upper triangle of the
// symmetric R x R Grams is formed, against 2·N·(R+1)·a·b for forming the
// gradient G_n = A_nᵀB_n and squaring it.  Two forms, both here:
//   form 0, the Gram trick (the TPU kernel's algorithm): one block per sample
//     and 64x64 tile pair (i ≤ j) of the R x R Grams.  The block forms the
//     tile of A_nA_nᵀ and of B_nB_nᵀ in registers (4x4 a thread, contracting
//     over a and then over b, 16 columns staged at a time, transposed into
//     shared memory with rows padded to 68 floats), multiplies them
//     elementwise, sums the block and writes one partial, twice for an
//     off-diagonal pair.  The Grams never reach device memory.
//   form 1, the gradient: xty.cuh's one-class per-sample product with the
//     ROWSUM epilogue, G_n on the tensor cores in 3xTF32 (mma.sync, each 16
//     rows' sum promoted into float32 registers), squared and summed over
//     each (a, b) tile after the sample's last stage; the l2-only launch of
//     fused_first_order.cu, the same code, so the two agree bit for bit.
// The rule (the wrapper's batch_l2_form): the Gram trick where it needs fewer
// operations, R·(a+b+1) < 2·a·b.  At 3C3D's conv layers that takes the
// gradient at conv1 (R = 1024, a = 75, b = 64) and conv2 (R = 256, a = 576,
// b = 96), and the Gram trick at conv3 (R = 64, a = 864, b = 128).  The
// bounds agree: at conv3 the gradient's 3xTF32 bound, 3 × 1.81 GFLOP / 495
// TFLOP/s = 0.0110 ms, stays above the Gram trick's bytes bound, 32.5 MB /
// 3.35 TB/s = 0.0097 ms; at conv1 and conv2 the Gram trick needs 15× and
// 1.6× the gradient's operations on the CUDA cores alone.
// Bound on the H100: operations for the Gram trick (fp32, CUDA cores); bytes
// at conv1 and conv2 for the gradient in 3xTF32.  Sums across blocks never
// use atomics: partials per (sample, tile pair) or per (tile, sample) are
// added in a fixed order by a second pass, so every result repeats exactly.
#include "common.cuh"
#include "xty.cuh"

namespace {

constexpr int GP = bp::BT + 4;  // padded staged row: the transposed store has 2-way conflicts

struct GramStage {
  float r[bp::BK][GP];
  float s[bp::BK][GP];
};

// acc[i][j] += Σ_k X[r0 + 4·ty + i, k] · X[s0 + 4·tx + j, k] over k < K for the
// calling thread's (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16).  X is
// [R, K] row-major; rows past R read as zero.  Every thread must call it.
__device__ __forceinline__ void gram_tile(const float* __restrict__ X, int R, int K, int r0,
                                          int s0, GramStage& st, float acc[4][4]) {
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  float pr[4], ps[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = t + bp::THREADS * q, c = e / bp::BK, k = k0 + e % bp::BK;
      pr[q] = (r0 + c < R && k < K) ? X[(size_t)(r0 + c) * K + k] : 0.f;
      ps[q] = (s0 + c < R && k < K) ? X[(size_t)(s0 + c) * K + k] : 0.f;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += bp::BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = t + bp::THREADS * q;
      st.r[e % bp::BK][e / bp::BK] = pr[q];
      st.s[e % bp::BK][e / bp::BK] = ps[q];
    }
    __syncthreads();
    if (k0 + bp::BK < K) fetch(k0 + bp::BK);
#pragma unroll
    for (int k = 0; k < bp::BK; ++k) {
      const float4 rv = *reinterpret_cast<const float4*>(&st.r[k][4 * ty]);
      const float4 sv = *reinterpret_cast<const float4*>(&st.s[k][4 * tx]);
      const float ra[4] = {rv.x, rv.y, rv.z, rv.w};
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ra[i], sa[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Block x = n·pairs + p takes sample n and the p-th tile pair (ti ≤ tj) of the
// upper triangle; part is [N, pairs].
__global__ void __launch_bounds__(bp::THREADS)
gram_l2_kernel(const float* __restrict__ A, const float* __restrict__ B, int R, int a, int b,
               int tiles, int pairs, float* __restrict__ part) {
  __shared__ __align__(16) GramStage st;
  __shared__ float red[32];
  const long long n = blockIdx.x / pairs;
  int p = blockIdx.x % pairs, ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  float ga[4][4], gb[4][4];
  bp::zero(ga);
  bp::zero(gb);
  gram_tile(A + n * R * a, R, a, ti * bp::BT, tj * bp::BT, st, ga);
  gram_tile(B + n * R * b, R, b, ti * bp::BT, tj * bp::BT, st, gb);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s = fmaf(ga[i][j], gb[i][j], s);
  s = bp::block_sum(s, red);
  if (threadIdx.x == 0) part[blockIdx.x] = (ti == tj ? 1.f : 2.f) * s;
}

int gram_pairs(int R) {
  const int tiles = (int)bp::cdiv(R, bp::BT);
  return tiles * (tiles + 1) / 2;
}

}  // namespace

extern "C" long long batch_l2_scratch_floats(int N, int R, int a, int b, int form) {
  if (form == 0) return (long long)N * gram_pairs(R);
  return tf32x3::per_sample_scratch_floats<tf32x3::XTY_ROWSUM>(
      tf32x3::per_sample_args(nullptr, nullptr, 1, N, R, a, b));
}

extern "C" int batch_l2_launch(const float* A, const float* B, int N, int R, int a, int b,
                               int form, float* l2, float* scratch, cudaStream_t stream) {
  if (form == 1)
    return (int)tf32x3::per_sample_launch<tf32x3::XTY_ROWSUM>(
        tf32x3::per_sample_args(A, B, 1, N, R, a, b), nullptr, 0, nullptr, l2, scratch, stream);
  if (form != 0) return (int)cudaErrorInvalidValue;
  const int tiles = (int)bp::cdiv(R, bp::BT), pairs = gram_pairs(R);
  const long long blocks = (long long)N * pairs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  gram_l2_kernel<<<(unsigned)blocks, bp::THREADS, 0, stream>>>(A, B, R, a, b, tiles, pairs,
                                                               scratch);
  bp::launch_sum_partials(scratch, l2, N, pairs, 1, stream);
  return (int)cudaGetLastError();
}
