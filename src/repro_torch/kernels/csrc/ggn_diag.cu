// GGN diagonal from backpropagated factors (paper Eq. 19/22):
//   diag[a,b] = Σ_cn (A[n]ᵀ S[c,n])∘²,  A [N, R, a], S [C, N, R, b],
// float32 and contiguous.
//
// Replaces the Pallas kernel ggn_diag_pallas (src/repro/kernels/ggn_diag.py:34).
// Neither package's engine calls it: the fused second-order kernel computes
// the same diagonal beside its kron and trace.  It is kept as its own entry so
// that the function stays available, counted, and held against its plain
// version at the exact sweep's shapes.
//
// Bound on the H100: fp32 operations (2·C·N·R·a·b for t = A_nᵀS_cn against
// N·R·a + C·N·R·b input floats).  It is the diag-only launch of common.cuh's
// sq_stats_kernel, the one fused_second_order.cu makes when only the diagonal
// is asked for: t is a 4x4 register tile a thread and never reaches device
// memory; sample groups fill the card; partials add in a fixed order.
#include "common.cuh"

extern "C" long long ggn_diag_scratch_floats(int N, int a, int b) {
  return bp::sq_stats_scratch_floats(1, N, a, b, true, false);
}

extern "C" int ggn_diag_launch(const float* A, const float* S, int C, int N, int R, int a, int b,
                               float* diag, float* scratch, cudaStream_t stream) {
  return (int)bp::sq_stats(true, false, A, S, 1, C, N, R, a, b, diag, nullptr, scratch, stream);
}
