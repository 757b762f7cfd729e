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
// Bound on the H100: operations (2·C·N·R·a·b for t = A_nᵀS_cn against
// N·R·a + C·N·R·b input floats).  It is fused_second_order's diag-only
// launch: rowprod.cuh's t kernel in 3xTF32 on the tensor cores with the DIAG
// epilogue, through the plan and launch the two share (rowprod::sq_plan,
// rowprod::sq_launch; the design is in fused_second_order.cu's source note).
// t never reaches device memory; A_n is staged and split once for the ten
// classes of a class block; each warpgroup's diag partial is added in a
// fixed order.
#include "rowprod.cuh"

extern "C" long long ggn_diag_scratch_floats(int C, int N, int R, int a, int b) {
  return rowprod::sq_plan(C, N, R, a, b, true, false).scratch(N, a, b);
}

extern "C" int ggn_diag_launch(const float* A, const float* S, int C, int N, int R, int a, int b,
                               float* diag, float* scratch, cudaStream_t stream) {
  rowprod::sq_launch(rowprod::sq_plan(C, N, R, a, b, true, false), A, S, C, N, R, a, b, diag,
                     nullptr, scratch, stream);
  return (int)cudaGetLastError();
}
