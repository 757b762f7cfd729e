// Cross-block pairwise dots of per-sample gradients (Gram / empirical NTK):
//   out[e,n,m] = ⟨G1[e,n], G2[e,m]⟩,   G1[e,n] = A1ᵀB1[e,n],  G2[e,m] = A2ᵀB2[e,m],
// A1 rows [R, a], B1 [E, N1, R, b], A2 rows [R, a], B2 [E, N2, R, b], all
// float32 and contiguous; out [E, N1, N2].
//
// Replaces the Pallas kernel cross_dot_pallas (src/repro/kernels/cross_dot.py:64,
// body _kernel :35).  The A side may be shared: with a_per_group = 0 one A
// serves every group e (the class-wise NTK, E = C, reads the layer input once
// for all classes through an indexed class axis), and with a_rows < N a row p
// of B pairs with row p mod a_rows of A (GGNGram's class-major (c, n) rows,
// N1 = C·N, read against the N input rows).  No broadcast copy is made.
//
// Bound on the H100: fp32 operations.  Forming G costs 2·E·N·R·a·b and the
// Gram 2·E·N1·N2·a·b (half of it when both sides are one row set); at the
// 3C3D conv shapes with N1 = 1280 the Gram dominates.  Design, in two passes:
//   * form_g_kernel: one block owns one 64x64 (a, b) tile of one sample's
//     G = AᵀB (common.cuh's tile64, 4x4 outputs a thread) and writes it to a
//     row of the scratch G [E, N, a·b].  The TPU kernel kept G of all rows in
//     VMEM; here 1280 rows of G need megabytes, far beyond the 227 KB of
//     shared memory, so G is staged through device memory once.
//   * gram_kernel: out[e] = G1[e] G2[e]ᵀ, a 64x64 tile product over the a·b
//     axis with the rows staged transposed into shared memory (padded to 68
//     floats, so the float4 reads stay aligned and the stores conflict at most
//     2-way).  When A1/B1 and A2/B2 are one row set (every call of the NTK and
//     GGNGram), only the upper-triangle tiles are computed and each is
//     written twice, so the result is symmetric bit for bit.  The a·b axis is
//     split over blocks when the tiles alone cannot fill the card; each split
//     writes its own partial and a second pass adds them in a fixed order:
//     deterministic, no atomics.
#include "common.cuh"

namespace {

constexpr int PAD = bp::BT + 4;  // shared row length of the transposed stage

struct StageNT {
  float x[bp::BK][PAD];
  float y[bp::BK][PAD];
};

// acc[i][j] += Σ_{k_lo ≤ k < k_hi} X[x0+4·ty+i, k] · Y[y0+4·tx+j, k] for the
// calling thread's (ty, tx).  X is [nx, K] and Y is [ny, K], row-major; rows
// past nx / ny read as zero.  Every thread of the block must call it.
__device__ __forceinline__ void tile64_nt(const float* __restrict__ X, int nx, int x0,
                                          const float* __restrict__ Y, int ny, int y0,
                                          long long K, long long k_lo, long long k_hi,
                                          StageNT& st, float acc[4][4]) {
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  float px[4], py[4];
  auto fetch = [&](long long k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // element e: row e / 16, column k0 + e % 16
      const int e = t + bp::THREADS * q, row = e / bp::BK;
      const long long k = k0 + e % bp::BK;
      px[q] = (k < k_hi && x0 + row < nx) ? X[(long long)(x0 + row) * K + k] : 0.f;
      py[q] = (k < k_hi && y0 + row < ny) ? Y[(long long)(y0 + row) * K + k] : 0.f;
    }
  };
  fetch(k_lo);
  for (long long k0 = k_lo; k0 < k_hi; k0 += bp::BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = t + bp::THREADS * q;
      st.x[e % bp::BK][e / bp::BK] = px[q];
      st.y[e % bp::BK][e / bp::BK] = py[q];
    }
    __syncthreads();
    if (k0 + bp::BK < k_hi) fetch(k0 + bp::BK);
#pragma unroll
    for (int k = 0; k < bp::BK; ++k) {
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

// G[z, i·b + j] = (A_zᵀ B[z])[i, j] for the E·N rows z = e·N + p, where A_z is
// row (a_per_group ? e : 0)·a_rows + p mod a_rows of A.  Grid (tiles_a,
// tiles_b, ≤ E·N); block z-strides over the rows.
__global__ void __launch_bounds__(bp::THREADS)
form_g_kernel(const float* __restrict__ A, const float* __restrict__ B, int E, int N, int R,
              int a, int b, int a_per_group, int a_rows, float* __restrict__ G) {
  __shared__ __align__(16) bp::Stage st;
  const int a0 = blockIdx.x * bp::BT, b0 = blockIdx.y * bp::BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long K = (long long)a * b, rows = (long long)E * N;
  for (long long z = blockIdx.z; z < rows; z += gridDim.z) {
    const int e = (int)(z / N), p = (int)(z % N);
    const float* X = A + ((long long)(a_per_group ? e : 0) * a_rows + p % a_rows) * R * a;
    const float* Y = B + z * R * b;
    float acc[4][4];
    bp::zero(acc);
    bp::tile64(X, a, a0, Y, b, b0, R, st, acc);
    float* g = G + z * K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = a0 + 4 * ty + i;
      if (r >= a) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = b0 + 4 * tx + j;
        if (c < b) g[(long long)r * b + c] = acc[i][j];
      }
    }
  }
}

struct GramPlan {
  int tiles1, tiles2, tiles, splits;
  long long kchunk;
};

// SYM: only the tiles on and above the diagonal.  The a·b axis is split
// until the blocks cover the card twice over (at least 64 columns a split).
GramPlan gram_plan(int E, int N1, int N2, long long K, bool sym) {
  GramPlan p;
  p.tiles1 = (int)bp::cdiv(N1, bp::BT);
  p.tiles2 = (int)bp::cdiv(N2, bp::BT);
  p.tiles = sym ? p.tiles1 * (p.tiles1 + 1) / 2 : p.tiles1 * p.tiles2;
  long long most = bp::cdiv(K, 64);
  if (most > 65535 / E) most = 65535 / E;  // gridDim.z = E · splits
  const long long s = bp::fill_splits((long long)E * p.tiles, most);
  p.kchunk = bp::cdiv(bp::cdiv(K, s), bp::BK) * bp::BK;
  p.splits = (int)bp::cdiv(K, p.kchunk);
  return p;
}

// Block (x, ·, e·splits + s) computes output tile x of group e over the
// columns [s·kchunk, (s+1)·kchunk) into partial s of out [E, splits, N1, N2]
// (out itself when splits == 1).
template <bool SYM>
__global__ void __launch_bounds__(bp::THREADS)
gram_kernel(const float* __restrict__ G1, const float* __restrict__ G2, int N1, int N2,
            long long K, int tiles2, int splits, long long kchunk, float* __restrict__ out) {
  __shared__ __align__(16) StageNT st;
  const int e = blockIdx.z / splits, sp = blockIdx.z % splits;
  int ti, tj;
  if (SYM) {  // the x-th tile of the upper triangle, row by row
    int rem = blockIdx.x;
    ti = 0;
    while (rem >= tiles2 - ti) {
      rem -= tiles2 - ti;
      ++ti;
    }
    tj = ti + rem;
  } else {
    ti = blockIdx.x / tiles2;
    tj = blockIdx.x % tiles2;
  }
  const int m0 = ti * bp::BT, n0 = tj * bp::BT;
  const long long k_lo = (long long)sp * kchunk;
  const long long k_hi = k_lo + kchunk < K ? k_lo + kchunk : K;
  float acc[4][4];
  bp::zero(acc);
  tile64_nt(G1 + (long long)e * N1 * K, N1, m0, G2 + (long long)e * N2 * K, N2, n0, K, k_lo, k_hi,
            st, acc);
  float* dst = out + ((long long)e * splits + sp) * N1 * N2;
  bp::store_tile(dst, N1, N2, m0, n0, acc);
  if (SYM && ti != tj) {  // the mirrored tile (N1 == N2)
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m >= N1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (n < N2) dst[(size_t)n * N1 + m] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" long long cross_dot_scratch_floats(int E, int N1, int N2, int a, int b, int sym) {
  const long long K = (long long)a * b;
  const GramPlan p = gram_plan(E, N1, N2, K, sym != 0);
  return (long long)E * N1 * K + (sym ? 0 : (long long)E * N2 * K) +
         (p.splits > 1 ? (long long)E * p.splits * N1 * N2 : 0);
}

extern "C" int cross_dot_launch(const float* A1, const float* B1, const float* A2,
                                const float* B2, int E, int N1, int N2, int R, int a, int b,
                                int a1_per_group, int a1_rows, int a2_per_group, int a2_rows,
                                int sym, float* out, float* scratch, cudaStream_t stream) {
  if (sym && N1 != N2) return (int)cudaErrorInvalidValue;
  const long long K = (long long)a * b;
  float* G1 = scratch;
  float* G2 = sym ? G1 : G1 + (long long)E * N1 * K;
  float* part = G2 + (sym ? (long long)E * N1 * K : (long long)E * N2 * K);
  auto form = [&](const float* A, const float* B, int N, int per_group, int rows, float* G) {
    const long long z = (long long)E * N;
    dim3 grid((unsigned)bp::cdiv(a, bp::BT), (unsigned)bp::cdiv(b, bp::BT),
              (unsigned)(z < 65535 ? z : 65535));
    form_g_kernel<<<grid, bp::THREADS, 0, stream>>>(A, B, E, N, R, a, b, per_group, rows, G);
  };
  form(A1, B1, N1, a1_per_group, a1_rows, G1);
  if (!sym) form(A2, B2, N2, a2_per_group, a2_rows, G2);
  const GramPlan p = gram_plan(E, N1, N2, K, sym != 0);
  float* dst = p.splits > 1 ? part : out;
  dim3 grid((unsigned)p.tiles, 1, (unsigned)(E * p.splits));
  if (sym)
    gram_kernel<true><<<grid, bp::THREADS, 0, stream>>>(G1, G2, N1, N2, K, p.tiles2, p.splits,
                                                        p.kchunk, dst);
  else
    gram_kernel<false><<<grid, bp::THREADS, 0, stream>>>(G1, G2, N1, N2, K, p.tiles2, p.splits,
                                                         p.kchunk, dst);
  if (p.splits > 1) bp::launch_sum_partials(part, out, E, p.splits, (long long)N1 * N2, stream);
  return (int)cudaGetLastError();
}
