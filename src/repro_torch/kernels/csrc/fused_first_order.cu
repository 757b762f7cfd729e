// Fused first-order statistics: one pass over (A, B) emits the requested
// reductions of the per-sample gradients G[e,n] = A[e,n]ᵀ B[e,n]:
//   l2[e,n]     = Σ_ab G²            (BatchL2)
//   moment[e]   = Σ_n G∘G            (SecondMoment / Variance)
//   dot[e,n,m]  = ⟨G[e,n], G[e,m]⟩   (BatchDot)
// A is [E, N, R, a], B is [E, N, R, b], all float32 and contiguous.
//
// Replaces the Pallas kernel fused_first_order_pallas
// (src/repro/kernels/fused_first_order.py:87, body _make_kernel :47).
//
// Bound on the H100: fp32 operations.  Forming G costs 2·N·R·a·b operations
// against N·R·(a+b) input floats, and dot another 2·N²·a·b; at the 3C3D conv
// shapes that is hundreds of operations a byte.  G never reaches device
// memory.  Two kernels, chosen by the mask:
//   * Without dot, l2 and moment are the trace and diag of common.cuh's
//     sq_stats_kernel with one class (64x64 register tiles, sample groups
//     spread over blocks).
//   * dot needs every sample's G at once.  One block owns a 16x16 (a, b) tile
//     and keeps the G rows of all samples in shared memory (row stride 257,
//     so the Gram reads are free of bank conflicts): all N at once for
//     N ≤ 128 (132 KB), else chunks of 80 in two buffers, recomputing the
//     column chunk for each chunk pair.  G is formed 16 samples at a time,
//     16 threads a sample, 4x4 outputs a thread.  moment needs no cross-block
//     sum (the block holds every sample of its tile).
// l2 and dot sum across tiles.  The TPU grid ran in order and carried them
// from tile to tile; blocks here run in no order, so each block writes its
// own partial ([E, tiles, N] and [E, tiles, N, N]) and a second pass adds the
// tiles in a fixed order: deterministic, no atomics.  The mask selects
// template instances: an unrequested output costs nothing.
#include "common.cuh"

namespace {

constexpr int DT = 16;                   // feature tile side of the dot kernel
constexpr int DS = 16;                   // samples formed together
constexpr int DK = 16;                   // rows staged per step
constexpr int GS = DT * DT + 1;          // shared row stride of a G tile
constexpr int ONE_CHUNK_MAX = 128;       // all samples in one buffer up to here
constexpr int PAIR_CHUNK = 80;           // chunk size beyond that (two buffers)

struct DotPlan {
  int chunk, buffers, tiles_a, tiles_b;
  size_t smem;
};

DotPlan dot_plan(int N, int a, int b) {
  DotPlan p;
  p.tiles_a = (int)bp::cdiv(a, DT);
  p.tiles_b = (int)bp::cdiv(b, DT);
  p.chunk = N <= ONE_CHUNK_MAX ? N : PAIR_CHUNK;
  p.buffers = N <= ONE_CHUNK_MAX ? 1 : 2;
  p.smem = sizeof(float) * (2 * DS * DK * DT + (size_t)p.buffers * p.chunk * GS);
  return p;
}

// G rows of samples [n0, n0 + count), count ≤ DS, into G (row stride GS,
// element i·16 + j ↔ (a0 + i, b0 + j)).  Thread t forms sample t / 16's 4x4
// block (ty, tx) = ((t % 16) / 4, t % 4).  Every thread must call it.
__device__ void form_g(const float* __restrict__ A, const float* __restrict__ B, int R, int a,
                       int b, int a0, int b0, int n0, int count, float* xs, float* ys,
                       float* __restrict__ G) {
  const int t = threadIdx.x, s = t / 16, sub = t % 16, ty = sub / 4, tx = sub % 4;
  const bool live = s < count;
  const float* X = A + (size_t)(n0 + s) * R * a;
  const float* Y = B + (size_t)(n0 + s) * R * b;
  float* xss = xs + s * DK * DT;
  float* yss = ys + s * DK * DT;
  float acc[4][4];
  bp::zero(acc);
  for (int r0 = 0; r0 < R; r0 += DK) {
#pragma unroll
    for (int q = 0; q < DK; ++q) {  // row q of the stage, column sub
      const int r = r0 + q;
      xss[q * DT + sub] = (live && r < R && a0 + sub < a) ? X[(size_t)r * a + a0 + sub] : 0.f;
      yss[q * DT + sub] = (live && r < R && b0 + sub < b) ? Y[(size_t)r * b + b0 + sub] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&xss[k * DT + 4 * ty]);
      const float4 yv = *reinterpret_cast<const float4*>(&yss[k * DT + 4 * tx]);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ya[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) G[(size_t)s * GS + (4 * ty + i) * DT + 4 * tx + j] = acc[i][j];
  }
}

// out[(p0+n), (q0+m)] = Σ_c Gp[n][c]·Gq[m][c] (and the mirrored entry when the
// chunks differ); out is this (e, tile)'s [N, N] partial.
__device__ void dot_block(const float* Gp, const float* Gq, int pn, int qn, int p0, int q0,
                          int N, float* __restrict__ out) {
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  for (int nb = 0; nb < pn; nb += 64) {
    for (int mb = 0; mb < qn; mb += 64) {
      const float* rp[4];
      const float* rq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rp[i] = Gp + (size_t)min(nb + ty + 16 * i, pn - 1) * GS;
        rq[i] = Gq + (size_t)min(mb + tx + 16 * i, qn - 1) * GS;
      }
      float acc[4][4];
      bp::zero(acc);
      for (int c = 0; c < DT * DT; ++c) {
        float xv[4], yv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xv[i] = rp[i][c];
          yv[i] = rq[i][c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nb + ty + 16 * i;
        if (n >= pn) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = mb + tx + 16 * j;
          if (m >= qn) continue;
          out[(size_t)(p0 + n) * N + q0 + m] = acc[i][j];
          if (p0 != q0) out[(size_t)(q0 + m) * N + p0 + n] = acc[i][j];
        }
      }
    }
  }
}

template <bool L2, bool MOM>
__global__ void __launch_bounds__(bp::THREADS)
fused_dot_kernel(const float* __restrict__ A, const float* __restrict__ B, int N, int R, int a,
                 int b, int chunk, float* __restrict__ l2_part, float* __restrict__ moment,
                 float* __restrict__ dot_part) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ys = xs + DS * DK * DT;
  float* G0 = ys + DS * DK * DT;
  float* G1 = G0 + (size_t)chunk * GS;

  const int t = threadIdx.x;
  const int e = blockIdx.z;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int a0 = blockIdx.x * DT, b0 = blockIdx.y * DT;
  const float* Ae = A + (size_t)e * N * R * a;
  const float* Be = B + (size_t)e * N * R * b;
  float* out = dot_part + ((size_t)e * tiles + tile) * N * N;

  auto form_chunk = [&](int p0, int pn, float* G) {
    for (int g0 = 0; g0 < pn; g0 += DS)
      form_g(Ae, Be, R, a, b, a0, b0, p0 + g0, min(DS, pn - g0), xs, ys, G + (size_t)g0 * GS);
    __syncthreads();
  };

  float mom = 0.f;
  for (int p0 = 0; p0 < N; p0 += chunk) {
    const int pn = min(chunk, N - p0);
    form_chunk(p0, pn, G0);
    if (MOM) {
      for (int k = 0; k < pn; ++k) {
        const float v = G0[(size_t)k * GS + t];
        mom = fmaf(v, v, mom);
      }
    }
    if (L2) {
      const int w = t >> 5, lane = t & 31;
      for (int k = w; k < pn; k += bp::THREADS / 32) {
        float s = 0.f;
        for (int c = lane; c < DT * DT; c += 32) {
          const float v = G0[(size_t)k * GS + c];
          s = fmaf(v, v, s);
        }
        s = bp::warp_sum(s);
        if (lane == 0) l2_part[((size_t)e * tiles + tile) * N + p0 + k] = s;
      }
    }
    dot_block(G0, G0, pn, pn, p0, p0, N, out);
    for (int q0 = p0 + chunk; q0 < N; q0 += chunk) {
      const int qn = min(chunk, N - q0);
      __syncthreads();
      form_chunk(q0, qn, G1);
      dot_block(G0, G1, pn, qn, p0, q0, N, out);
    }
    __syncthreads();
  }
  if (MOM) {
    const int i = t / DT, j = t % DT;
    if (a0 + i < a && b0 + j < b) moment[((size_t)e * a + a0 + i) * b + b0 + j] = mom;
  }
}

template <bool L2, bool MOM>
cudaError_t launch_dot(const float* A, const float* B, int E, int N, int R, int a, int b,
                       float* l2, float* moment, float* dot, float* scratch,
                       cudaStream_t stream) {
  const DotPlan p = dot_plan(N, a, b);
  auto kernel = fused_dot_kernel<L2, MOM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)p.tiles_a * p.tiles_b;
  float* l2_part = scratch;
  float* dot_part = scratch + (L2 ? (size_t)E * tiles * N : 0);
  dim3 grid(p.tiles_a, p.tiles_b, E);
  kernel<<<grid, bp::THREADS, p.smem, stream>>>(A, B, N, R, a, b, p.chunk, l2_part, moment,
                                                 dot_part);
  if (L2) bp::launch_sum_partials(l2_part, l2, E, (int)tiles, N, stream);
  bp::launch_sum_partials(dot_part, dot, E, (int)tiles, (long long)N * N, stream);
  return cudaGetLastError();
}

long long dot_scratch_floats(int E, int N, int a, int b, bool l2) {
  const DotPlan p = dot_plan(N, a, b);
  const long long tiles = (long long)p.tiles_a * p.tiles_b;
  return (l2 ? (long long)E * tiles * N : 0) + (long long)E * tiles * N * N;
}

}  // namespace

extern "C" long long fused_first_order_scratch_floats(int E, int N, int a, int b, int want_l2,
                                                      int want_moment, int want_dot) {
  if (want_dot) return dot_scratch_floats(E, N, a, b, want_l2 != 0);
  return bp::sq_stats_scratch_floats(E, N, a, b, want_moment != 0, want_l2 != 0);
}

extern "C" int fused_first_order_launch(const float* A, const float* B, int E, int N, int R,
                                        int a, int b, int want_l2, int want_moment, int want_dot,
                                        float* l2, float* moment, float* dot, float* scratch,
                                        cudaStream_t stream) {
  cudaError_t err;
  if (!want_dot) {
    if (!want_l2 && !want_moment) return (int)cudaErrorInvalidValue;
    // moment = Σ_n G∘G and l2[n] = Σ G∘G: sq_stats' diag and trace, one class.
    err = bp::sq_stats(want_moment, want_l2, A, B, E, 1, N, R, a, b, moment, l2, scratch, stream);
  } else if (want_l2 && want_moment) {
    err = launch_dot<true, true>(A, B, E, N, R, a, b, l2, moment, dot, scratch, stream);
  } else if (want_l2) {
    err = launch_dot<true, false>(A, B, E, N, R, a, b, l2, moment, dot, scratch, stream);
  } else if (want_moment) {
    err = launch_dot<false, true>(A, B, E, N, R, a, b, l2, moment, dot, scratch, stream);
  } else {
    err = launch_dot<false, false>(A, B, E, N, R, a, b, l2, moment, dot, scratch, stream);
  }
  return (int)err;
}
