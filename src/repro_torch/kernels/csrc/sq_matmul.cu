// (A∘A)ᵀ(B∘B) for A [K, M] and B [K, N]: out [M, N] = Σ_k A[k,m]² B[k,n]².
//
// Replaces the Pallas kernel sq_matmul_pallas (src/repro/kernels/sq_matmul.py:36).
// It is the rank-1 second moment of the paper's App. A.1: the dense layers'
// SecondMoment/Variance (K = N samples) and their DiagGGN(MC) (K = C·N rows
// of the broadcast input).
//
// Bound on the H100: at the 3C3D shapes (K = 128 or 1280, M = 2048, N = 512)
// each input element is reused across a 512- or 2048-wide output, so the
// product is bound by float32 operations (67 TFLOP/s without tensor cores),
// not bytes; at the small shapes a call is bound by its launch.  Float32
// FFMA tiles (128x64, 8x8 outputs a thread) ran the K = 1280 shape at 30
// TFLOP/s on an H100 80GB HBM3 at 700 W, below cuBLAS's FFMA GEMM there (47),
// so the product runs on the tensor cores in 3xTF32: each
// squared value x splits into x_hi = tf32(x) and x_lo = tf32(x − x_hi), and
// a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (within ≈ 2^-22 of a·b), each
// product exact in the float32 accumulator; at the 3C3D shapes the result
// stays within 1e-5 of the largest output.  The design, one launch a call:
//   * 128x64 output tiles, 4 warps of 64x32, mma.sync m16n8k8 TF32;
//   * rows staged 16 at a time through a 3-stage cp.async ring (16-byte
//     copies where the widths allow, 4-byte ones else, zeros past the edges;
//     rows padded by 8 floats, so the fragment loads are conflict-free); each
//     thread squares in shared memory the elements it copied, once, so A² and
//     B² never reach device memory; the hi/lo split happens as the
//     fragments are loaded;
//   * each stage's 16 rows are summed into a zeroed accumulator tile, a row
//     of tiles at a time, and added into float32 registers on the CUDA cores
//     (tf32x3::promote): carried through K = 1280 in the tensor cores'
//     accumulator, the sum read 7.3e-6 against float64 (H100 80GB HBM3, 700
//     W), above the 3e-6 the other 3xTF32 kernels meet;
//   * when the output has too few tiles to fill the 132 SMs, K is split over
//     the blocks of a thread-block cluster (2–8, cudaLaunchKernelEx).  Each
//     block leaves its partial tile in its shared memory; after a cluster
//     barrier block r adds the rows r·128/c… of every block's partial, in
//     rank order, through distributed shared memory, and writes them.  The
//     sum is the same bits from run to run: no atomics, no scratch, no
//     second kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "common.cuh"  // bp::cdiv, bp::num_sms
#include "tf32x3.cuh"  // cp.async, the hi/lo split, mma.sync m16n8k8

namespace cg = cooperative_groups;

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_commit;
using tf32x3::cp_wait;
using tf32x3::frag_a_mk;
using tf32x3::frag_b_kn;
using tf32x3::mma3;
using tf32x3::promote;
using tf32x3::zero;

constexpr int BM = 128, BN = 64;  // output tile
constexpr int PA = BM + 8, PB = BN + 8;  // padded rows of the staged A and B
constexpr int RS = 16;            // rows a stage: two k-steps of 8
constexpr int STAGES = 3;
constexpr int THREADS = 128;      // warps 2 (m) x 2 (n), each 64x32 of the tile
constexpr int MAX_CLUSTER = 8;
constexpr int STAGE_FLOATS = RS * (PA + PB);
// The ring, and after the main loop the block's partial tile [BM][BN].
constexpr int SMEM_FLOATS = STAGES * STAGE_FLOATS > BM * BN ? STAGES * STAGE_FLOATS : BM * BN;

// One stage: rows [k0, k0 + RS) ∩ [k0, k_end) of the tile's A columns [m0, m0
// + BM) into as [RS][PA] and B columns [n0, n0 + BN) into bs [RS][PB], zeros
// outside; `square` squares in place what this thread copied (after its
// copies landed).  VEC: 16-byte copies and 8-byte stores (M and N multiples
// of 4; A, B and out 16-byte aligned).
template <bool VEC>
struct Stager {
  const float* A;
  const float* B;
  int M, N, m0, n0;
  long long k_end;

  // f(shared offset, global source or null) for each group of 4 (VEC) or 1
  // elements this thread stages.
  template <typename F>
  __device__ __forceinline__ void each(long long k0, F f) const {
    constexpr int W = VEC ? 4 : 1;
#pragma unroll
    for (int q = 0; q < RS * BM / W / THREADS; ++q) {
      const int e = threadIdx.x + THREADS * q, r = e / (BM / W), c = W * (e % (BM / W));
      const long long k = k0 + r;
      const bool in = k < k_end && m0 + c < M;
      f(r * PA + c, in ? A + k * M + m0 + c : nullptr);
    }
#pragma unroll
    for (int q = 0; q < RS * BN / W / THREADS; ++q) {
      const int e = threadIdx.x + THREADS * q, r = e / (BN / W), c = W * (e % (BN / W));
      const long long k = k0 + r;
      const bool in = k < k_end && n0 + c < N;
      f(RS * PA + r * PB + c, in ? B + k * N + n0 + c : nullptr);
    }
  }

  __device__ __forceinline__ void copy(float* st, long long k0) const {
    each(k0, [&](int off, const float* src) {
      if (VEC)
        cp_async16(st + off, src ? src : A, src != nullptr);
      else
        cp_async4(st + off, src ? src : A, src != nullptr);
    });
  }

  __device__ __forceinline__ void square(float* st) const {
    each(0, [&](int off, const float*) {
      if (VEC) {
        float4 x = *reinterpret_cast<float4*>(st + off);
        x.x *= x.x;
        x.y *= x.y;
        x.z *= x.z;
        x.w *= x.w;
        *reinterpret_cast<float4*>(st + off) = x;
      } else {
        st[off] *= st[off];
      }
    });
  }
};

// Grid (N tiles, M tiles, splits); with splits > 1 the launch forms clusters
// of (1, 1, splits) and block z takes rows [z·chunk, (z+1)·chunk).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
sq_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B, long long K, int M,
                 int N, long long chunk, float* __restrict__ out) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const long long k_begin = (long long)blockIdx.z * chunk;
  const long long k_end = k_begin + chunk < K ? k_begin + chunk : K;
  const Stager<VEC> stg{A, B, M, N, m0, n0, k_end};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = 64 * (warp / 2), wn = 32 * (warp % 2);  // the warp's corner in the tile
  const int g = lane / 4, t = lane % 4;

  // acc[mi][ni][c]: row wm + 16mi + g + 8(c/2), column wn + 8ni + 2t + c%2.
  float acc[4][4][4];
  zero(acc);

  const int steps = k_end > k_begin ? (int)((k_end - k_begin + RS - 1) / RS) : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stg.copy(smem + s * STAGE_FLOATS, k_begin + (long long)s * RS);
    cp_commit();
  }
  for (int step = 0; step < steps; ++step) {
    float* st = smem + (step % STAGES) * STAGE_FLOATS;
    cp_wait<STAGES - 2>();  // this thread's copies of `step` have landed
    stg.square(st);
    __syncthreads();  // everyone's squares are in; the stage of step − 1 is free
    const int next = step + STAGES - 1;
    if (next < steps)
      stg.copy(smem + (next % STAGES) * STAGE_FLOATS, k_begin + (long long)next * RS);
    cp_commit();
    const float* as = st;
    const float* bs = st + RS * PA;
    // The stage's 16 rows into a zeroed tile a row of tiles at a time, then
    // promoted into the float32 registers (tf32x3::promote's reason).
    uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
    for (int kq = 0; kq < 2; ++kq)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) frag_b_kn(bs, PB, 8 * kq, wn + 8 * ni, bh[kq][ni], bl[kq][ni]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      float tc[1][4][4];
      zero(tc);
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        uint32_t ah[1][4], al[1][4];
        frag_a_mk(as, PA, 8 * kq, wm + 16 * mi, ah[0], al[0]);
        mma3(tc, ah, al, bh[kq], bl[kq]);
      }
      promote(acc[mi], tc[0]);
    }
  }
  cp_wait<0>();

  if (gridDim.z == 1) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * mi + g + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + wn + 8 * ni + 2 * t;
          const float x0 = acc[mi][ni][2 * h], x1 = acc[mi][ni][2 * h + 1];
          if (VEC) {  // N % 4 == 0 and n even: the pair is in or out together
            if (n < N) *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(x0, x1);
          } else {
            if (n < N) out[(size_t)m * N + n] = x0;
            if (n + 1 < N) out[(size_t)m * N + n + 1] = x1;
          }
        }
      }
    return;
  }

  // Split K: the partial tile to shared memory, then each block adds a
  // slice of rows over the cluster's blocks in rank order.
  __syncthreads();  // the ring is no longer read
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(smem + (wm + 16 * mi + g + 8 * h) * BN + wn + 8 * ni + 2 * t) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)gridDim.z, rank = (int)blockIdx.z;
  auto part = [&](int p) {  // block p's partial tile, through the cluster's shared memory
    return reinterpret_cast<const float4*>(cluster.map_shared_rank(smem, p));
  };
  const int rows_per = BM / splits;  // splits is a power of two ≤ 8
  for (int e = threadIdx.x; e < rows_per * BN / 4; e += THREADS) {
    const int r = rank * rows_per + e / (BN / 4), c = 4 * (e % (BN / 4));
    const int idx = r * (BN / 4) + c / 4;
    float4 s = part(0)[idx];
    for (int p = 1; p < splits; ++p) {
      const float4 x = part(p)[idx];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    const int m = m0 + r, n = n0 + c;
    if (m >= M) continue;
    if (VEC) {
      if (n < N) *reinterpret_cast<float4*>(out + (size_t)m * N + n) = s;
    } else {
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n + q < N) out[(size_t)m * N + n + q] = sv[q];
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

struct Plan {
  int splits;
  long long chunk;
};

// Splits (a power of two ≤ 8) so that the tiles·splits blocks are one wave of
// at most two blocks an SM, with at least 64 rows a block.
Plan plan(long long K, int M, int N) {
  const long long tiles = bp::cdiv(M, BM) * bp::cdiv(N, BN);
  int s = 1;
  while (s < MAX_CLUSTER && tiles * 2 * s <= 2LL * bp::num_sms() && K >= 2LL * s * 64) s *= 2;
  const long long chunk = bp::cdiv(bp::cdiv(K, s), RS) * RS;
  return {s, chunk};
}

template <bool VEC>
cudaError_t launch(const float* A, const float* B, long long K, int M, int N, float* out,
                   cudaStream_t stream) {
  const Plan p = plan(K, M, N);
  const dim3 grid((unsigned)bp::cdiv(N, BN), (unsigned)bp::cdiv(M, BM), (unsigned)p.splits);
  if (p.splits == 1) {
    sq_matmul_kernel<VEC><<<grid, THREADS, 0, stream>>>(A, B, K, M, N, p.chunk, out);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)p.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, sq_matmul_kernel<VEC>, A, B, K, M, N, p.chunk,
                                             out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// A [K, M], B [K, N] float32 row-major on the card; out [M, N].  Returns a
// cudaError_t.
extern "C" int sq_matmul_launch(const float* A, const float* B, long long K, int M, int N,
                                float* out, cudaStream_t stream) {
  if (K <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = M % 4 == 0 && N % 4 == 0 &&
                   ((uintptr_t)A | (uintptr_t)B | (uintptr_t)out) % 16 == 0;
  return (int)(vec ? launch<true>(A, B, K, M, N, out, stream)
                   : launch<false>(A, B, K, M, N, out, stream));
}
