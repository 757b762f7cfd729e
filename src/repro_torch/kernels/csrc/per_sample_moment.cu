// Sequence second moment: out[a,b] = Σ_n (A[n]ᵀ B[n])∘², A [N, R, a], B [N, R, b],
// float32 and contiguous.  The R > 1 SecondMoment/Variance of the per-extension
// route, and its DiagGGN/DiagGGNMC on the broadcast [C·N, R, a] input.
//
// Replaces the Pallas kernel per_sample_moment_pallas
// (src/repro/kernels/per_sample_moment.py:38).
//
// Bound on the H100: operations in float32, and in 3xTF32 bytes where the
// rows are many (the exact diagonal's 1280 rows read ≈ 1.9 GB over the three
// conv layers).  Forming G_n = A_nᵀB_n costs 2·N·R·a·b operations against
// N·R·(a+b) input floats.  The point of the TPU kernel is that the N [a, b]
// gradients never reach device memory, and that is kept: this is
// fused_first_order's moment without a group axis, xty.cuh's one-class
// per-sample product with the SQUARE epilogue.  G_n runs on the tensor cores
// in 3xTF32 by mma.sync (three TF32 products a k-step, each 16 rows' sum
// promoted into float32 registers on the CUDA cores), a block owning an
// (a, b) tile and walking a group of samples through one cp.async ring;
// after a sample's last stage the promoted tile is squared into float32
// moment registers.  The blocks of one sample group are issued tile-fastest,
// so each row of A and B comes from device memory once and from L2 for the
// other tiles.  The sample groups fill whole waves, each block writes its own
// moment partial, and a second pass adds them in a fixed order:
// deterministic, no atomics.
#include "xty.cuh"

extern "C" long long per_sample_moment_scratch_floats(int N, int R, int a, int b) {
  return tf32x3::per_sample_scratch_floats<tf32x3::XTY_SQUARE>(
      tf32x3::per_sample_args(nullptr, nullptr, 1, N, R, a, b));
}

extern "C" int per_sample_moment_launch(const float* A, const float* B, int N, int R, int a,
                                        int b, float* out, float* scratch, cudaStream_t stream) {
  return (int)tf32x3::per_sample_launch<tf32x3::XTY_SQUARE>(
      tf32x3::per_sample_args(A, B, 1, N, R, a, b), nullptr, 0, out, nullptr, scratch, stream);
}
