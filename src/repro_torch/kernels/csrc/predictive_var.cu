// GLM predictive variance of one layer (the Laplace predictive's hot path):
//   var[c,n] = Σ_ab (A[n]ᵀ S[c,n])²_ab [· Sigma[a,b]],
// A [N, R, a], S [C, N, R, b], Sigma [a, b] (optional), all float32 and
// contiguous; out [C, N].
//
// Replaces the Pallas kernel predictive_var_pallas
// (src/repro/kernels/predictive_var.py:81, body _make_kernel :51).  A diagonal
// posterior passes its covariance diagonal as Sigma; a Kronecker posterior
// half-transforms A and S outside the kernel and passes no Sigma.
//
// Bound on the H100: fp32 operations.  The per-sample Jacobian tile t = A_nᵀS_cn
// costs 2·C·N·R·a·b operations against N·R·a + C·N·R·b input floats, hundreds
// of operations a byte at the 3C3D conv shapes.  Design: the variance
// epilogue of common.cuh's sq_stats_kernel, the tile product the curvature
// kernels use.  One block owns one 64x64 (a, b) tile and a group of samples;
// t is a 4x4 register tile a thread and never reaches device memory; each
// thread squares its 16 entries, weights them by its 16 Sigma entries (held
// in registers for the whole block), and a block sum gives the tile's share
// of var[c,n].  The TPU grid carried var across the (a, b) tiles in order;
// here each tile writes its own partial [tiles, C, N] and a second pass adds
// them in a fixed order: deterministic, no atomics.
#include "common.cuh"

using bp::SqStatsPlan;

// One partial per feature tile: [tiles, C, N].
extern "C" long long predictive_var_scratch_floats(int C, int N, int a, int b) {
  const SqStatsPlan p = bp::sq_stats_plan(1, N, a, b);
  return (long long)p.tiles_a * p.tiles_b * C * N;
}

// The sq_stats blocks with the variance epilogue (Sigma == nullptr:
// unweighted), then the partials added in a fixed order.
extern "C" int predictive_var_launch(const float* A, const float* S, const float* Sigma, int C,
                                     int N, int R, int a, int b, float* var, float* scratch,
                                     cudaStream_t stream) {
  const SqStatsPlan p = bp::sq_stats_plan(1, N, a, b);
  dim3 grid(p.tiles_a, p.tiles_b, p.groups);
  if (Sigma)
    bp::sq_stats_kernel<false, false, 2><<<grid, bp::THREADS, 0, stream>>>(
        A, S, C, N, R, a, b, p.groups, p.group_size, nullptr, nullptr, Sigma, scratch);
  else
    bp::sq_stats_kernel<false, false, 1><<<grid, bp::THREADS, 0, stream>>>(
        A, S, C, N, R, a, b, p.groups, p.group_size, nullptr, nullptr, nullptr, scratch);
  bp::launch_sum_partials(scratch, var, 1, p.tiles_a * p.tiles_b, (long long)C * N, stream);
  return (int)cudaGetLastError();
}
