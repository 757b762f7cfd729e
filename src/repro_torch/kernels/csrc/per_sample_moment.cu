// Sequence second moment: out[a,b] = Σ_n (A[n]ᵀ B[n])∘², A [N, R, a], B [N, R, b],
// float32 and contiguous.  The R > 1 SecondMoment/Variance of the per-extension
// route, and its DiagGGN/DiagGGNMC on the broadcast [C·N, R, a] input.
//
// Replaces the Pallas kernel per_sample_moment_pallas
// (src/repro/kernels/per_sample_moment.py:38).
//
// Bound on the H100: fp32 operations.  Forming G_n = A_nᵀB_n costs 2·N·R·a·b
// operations against N·R·(a+b) input floats: hundreds of operations a byte at
// the 3C3D conv shapes.  The point of the TPU kernel is that the N [a, b]
// gradients never reach device memory, and that is kept: this is the diag of
// common.cuh's sq_stats_kernel with one class.  One block owns a 64x64 (a, b)
// tile and a group of samples; G_n is a 4x4 register tile a thread, squared
// and summed in registers.  The sample groups put about two blocks on every SM
// when the feature tiles are few (conv1: 2 tiles; N = 1280 in the exact
// sweep: 128 groups of 10 samples), and their partials are added in a fixed
// order by a second pass: deterministic, no atomics.
#include "common.cuh"

extern "C" long long per_sample_moment_scratch_floats(int N, int a, int b) {
  return bp::sq_stats_scratch_floats(1, N, a, b, true, false);
}

extern "C" int per_sample_moment_launch(const float* A, const float* B, int N, int R, int a,
                                        int b, float* out, float* scratch, cudaStream_t stream) {
  return (int)bp::sq_stats(true, false, A, B, 1, 1, N, R, a, b, out, nullptr, scratch, stream);
}
