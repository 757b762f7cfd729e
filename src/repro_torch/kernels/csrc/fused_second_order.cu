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
// Bound on the H100: operations.  t costs 2·C·N·R·a·b and kron 2·C·N·R·b²
// (half of it by symmetry) against C·N·R·b + N·R·a input floats.  Both run on
// the tensor cores in 3xTF32 (tf32x3.cuh: hi/lo splits, three products a
// k-step, within ≈ 2^-22 of float32 products), so the bound is 3 ×
// operations / 495 TFLOP/s rather than operations / 67.  Design:
//   * diag/trace (rowprod.cuh, its sq_launch, which ggn_diag shares): t_cᵀ = S_cnᵀ A_n by wgmma m64n48k8, S's 64
//     b-columns as M, 48 a-columns as N, R as K.  A block of two
//     warpgroups takes a (64 b x 48 a) tile and a group of samples; for each
//     sample it streams R in stages of 32 rows through a 2-stage ring: every
//     class's S rows by TMA from one thread (128-byte swizzled, zeros past
//     the edges), A_n's rows by the threads' own 4-byte copies (a = 75 rows
//     are not 16-byte aligned).  A_n's stage is split once into hi/lo,
//     transposed into the K-major swizzled tiles wgmma reads from shared
//     memory, and serves every class (the CUDA-core kernel restaged A_n for
//     each class); each class's S rows go to registers as wgmma's A
//     operand, split there.  The two warpgroups take classes 0–4 and 5–9
//     (the MC sweep's one class: a-columns 0–47 and 48–95), so one's
//     fragment loads overlap the other's products.  A stage's products are
//     summed in the
//     tensor cores and added into float32 registers (tf32x3::promote's
//     reason); t of five classes stays in registers (24 a class and
//     thread), so the tile is 48 a-columns: S is read a/48 times, from L2.
//     After a sample's last stage each thread squares its accumulators into
//     diag registers and its trace sum, a block sum gives the sample's
//     trace over the tile, and the accumulators restart at 0.  The sample
//     groups fill whole waves; each warpgroup writes its own diag partial
//     and each tile its trace partial, added in a fixed order by a second
//     pass: deterministic, no atomics.  Where TMA cannot read S (b not a
//     multiple of 4) the threads copy it into the same layout.
//   * kron (tf32x3::xty_kernel) is S_flatᵀS_flat over the C·N·R rows, a
//     separate product: a block holds 64 b-columns against 48 a-columns,
//     not all b columns of S, so the TPU kernel's one pass over S cannot
//     give kron here.  Its rows are cut into pieces that fill the card, each
//     written as a partial and added in a fixed order.  It reads only S:
//     kron-only launches (KFAC) never touch A.
//   * The mask selects template instances: an unrequested output costs nothing.
#include "common.cuh"
#include "rowprod.cuh"
#include "xty.cuh"

namespace {

struct Plan {
  rowprod::SqPlan sq;  // diag and trace
  int kron_splits;
  long long kron_chunk;
};

Plan plan(int C, int N, int R, int a, int b, bool diag, bool trace, bool kron) {
  Plan p{};
  if (diag || trace) p.sq = rowprod::sq_plan(C, N, R, a, b, diag, trace);
  if (kron) {  // pieces of at least 512 rows, about two blocks an SM
    const long long rows = (long long)C * N * R;
    const tf32x3::XtyTile t = tf32x3::xty_tile(b, b);
    const long long tiles = bp::cdiv(b, 32 * t.mi) * bp::cdiv(b, 16 * t.ni);
    long long s = 2LL * bp::num_sms() / tiles;
    if (s > bp::cdiv(rows, 512)) s = bp::cdiv(rows, 512);
    if (s < 1) s = 1;
    p.kron_chunk = bp::cdiv(rows, s);
    p.kron_splits = (int)bp::cdiv(rows, p.kron_chunk);
  }
  return p;
}

// Scratch floats: the t kernel's partials (none without diag or trace), then
// kron's.
long long kron_scratch(const Plan& p, int b) {
  return p.kron_splits > 1 ? (long long)p.kron_splits * b * b : 0;
}

}  // namespace

extern "C" long long fused_second_order_scratch_floats(int C, int N, int R, int a, int b,
                                                       int want_diag, int want_kron,
                                                       int want_trace) {
  const Plan p = plan(C, N, R, a, b, want_diag, want_trace, want_kron);
  return p.sq.scratch(N, a, b) + kron_scratch(p, b);
}

extern "C" int fused_second_order_launch(const float* A, const float* S, int C, int N, int R,
                                         int a, int b, int want_diag, int want_kron,
                                         int want_trace, float* diag, float* kron, float* trace,
                                         float* scratch, cudaStream_t stream) {
  const Plan p = plan(C, N, R, a, b, want_diag, want_trace, want_kron);
  float* kron_part = scratch + p.sq.scratch(N, a, b);
  if (want_diag || want_trace)
    rowprod::sq_launch(p.sq, A, S, C, N, R, a, b, diag, trace, scratch, stream);
  if (want_kron) {
    tf32x3::XtyArgs x{};
    x.X = x.Y = S;
    x.out = p.kron_splits > 1 ? kron_part : kron;
    x.M = x.N = b;
    x.Z = p.kron_splits;
    x.K = p.kron_chunk;
    x.k_total = (long long)C * N * R;
    x.xs = x.ys = p.kron_chunk * b;
    x.os = (long long)b * b;
    x.yd = x.yr = p.kron_splits;
    x.yg = 0;
    x.vx = x.vy = tf32x3::vec_ok(S, b, x.xs);
    const cudaError_t err = tf32x3::xty_launch(x, stream);
    if (err != cudaSuccess) return (int)err;
    if (p.kron_splits > 1)
      bp::launch_sum_partials(kron_part, kron, 1, p.kron_splits, (long long)b * b, stream);
  }
  return (int)cudaGetLastError();
}
