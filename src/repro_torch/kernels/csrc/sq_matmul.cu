// (A∘A)ᵀ(B∘B) for A [K, M] and B [K, N]: out [M, N] = Σ_k A[k,m]² B[k,n]².
//
// Replaces the Pallas kernel sq_matmul_pallas (src/repro/kernels/sq_matmul.py:36).
// It is the rank-1 second moment of the paper's App. A.1: the dense layers'
// SecondMoment/Variance (K = N samples) and their DiagGGN(MC) (K = C·N rows
// of the broadcast input).
//
// Bound on the H100: at the 3C3D shapes (K = 128 or 1280, M = 2048, N = 512)
// each input element is reused across a 512- or 2048-wide output, so the
// product is bound by fp32 operations, not bytes.  The design squares on the
// load into shared memory (no A², B² in device memory), computes 4x4 outputs a
// thread from 64x64 tiles, and splits K over blocks only when the output has
// too few tiles to fill the card, adding the partials in a fixed order.
#include "common.cuh"

extern "C" long long sq_matmul_scratch_floats(long long K, int M, int N) {
  return bp::atb_scratch_floats(K, M, N);
}

extern "C" int sq_matmul_launch(const float* A, const float* B, long long K, int M, int N,
                                float* out, float* scratch, cudaStream_t stream) {
  bp::atb_launch<true>(A, B, K, M, N, out, scratch, stream);
  return (int)cudaGetLastError();
}
