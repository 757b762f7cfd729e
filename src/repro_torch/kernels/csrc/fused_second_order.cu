// Fused second-order (curvature) statistics: one pass over (A, S) emits the
// requested reductions of t[c,n] = A[n]ᵀ S[c,n]:
//   diag[a,b]  = Σ_cn t∘t              (DiagGGN / DiagGGNMC)
//   trace[n]   = Σ_cab t∘t             (GGNTrace)
//   kron[b,b]  = Σ_cnr S Sᵀ            (KFLR / KFAC B-factor, unscaled)
// A is [N, R, a], S is [C, N, R, b], all float32 and contiguous.
//
// Replaces the Pallas kernel fused_second_order_pallas
// (src/repro/kernels/fused_second_order.py:109, body _make_kernel :52).
//
// Bound on the H100: fp32 operations.  t costs 2·C·N·R·a·b operations and
// kron 2·C·N·R·b² against C·N·R·b + N·R·a input floats.  Design:
//   * diag/trace (common.cuh sq_stats_kernel): one block owns one 64x64
//     (a, b) tile and a group of samples, and loops over (n, c) inside the
//     block; t is a 4x4 register tile a thread, squared and summed in
//     registers, so it never reaches device memory.  The sample groups exist
//     to put enough blocks on the card when the feature tiles are few.  The
//     TPU grid carried diag over the class axis and trace over every tile in
//     order; here each block writes its own partial (diag per group, trace
//     per tile) and a second pass adds them in a fixed order: deterministic,
//     no atomics.
//   * kron is S_flatᵀS_flat over the C·N·R rows: a second kernel (the shared
//     64x64 tile product), split over rows when b×b is too small to fill the
//     card.  It reads only S: kron-only launches never touch A.
//   * The mask selects template instances: an unrequested output costs nothing.
#include "common.cuh"

extern "C" long long fused_second_order_scratch_floats(int C, int N, int R, int a, int b,
                                                       int want_diag, int want_kron,
                                                       int want_trace) {
  long long n = 0;
  if (want_diag || want_trace) n += bp::sq_stats_scratch_floats(1, N, a, b, want_diag, want_trace);
  if (want_kron) n += bp::atb_scratch_floats((long long)C * N * R, b, b);
  return n;
}

extern "C" int fused_second_order_launch(const float* A, const float* S, int C, int N, int R,
                                         int a, int b, int want_diag, int want_kron,
                                         int want_trace, float* diag, float* kron, float* trace,
                                         float* scratch, cudaStream_t stream) {
  float* kron_scratch = scratch;
  if (want_diag || want_trace) {
    const cudaError_t err = bp::sq_stats(want_diag, want_trace, A, S, 1, C, N, R, a, b, diag,
                                         trace, scratch, stream);
    if (err != cudaSuccess) return (int)err;
    kron_scratch += bp::sq_stats_scratch_floats(1, N, a, b, want_diag, want_trace);
  }
  if (want_kron) bp::atb_launch(S, S, (long long)C * N * R, b, b, kron, kron_scratch, stream);
  return (int)cudaGetLastError();
}
