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
//   * diag/trace (rowprod.cuh): t_cᵀ = S_cnᵀ A_n by wgmma m64n48k8, S's 64
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

using rowprod::Args;
using rowprod::Shape;

template <int CW, bool SPLIT_A>
rowprod::Fn sqt_masked(bool diag, bool trace) {
  using rowprod::DIAG, rowprod::TRACE, rowprod::kernel;
  return diag && trace ? kernel<CW, SPLIT_A, DIAG | TRACE>
         : diag        ? kernel<CW, SPLIT_A, DIAG>
                       : kernel<CW, SPLIT_A, TRACE>;
}

rowprod::Fn sqt_instance(const Shape& sh, bool diag, bool trace) {
  return sh.split_a ? sqt_masked<1, true>(diag, trace) : sqt_masked<5, false>(diag, trace);
}

struct Plan {
  Shape shape;
  int tiles, groups, group_size, diag_parts;
  int kron_splits;
  long long kron_chunk;
};

Plan plan(int C, int N, int R, int a, int b, bool diag, bool trace, bool kron) {
  Plan p{};
  if (diag || trace) {
    p.shape = rowprod::shape_for(C);
    p.tiles = (int)(bp::cdiv(b, rowprod::BS) * bp::cdiv(a, p.shape.na()));
    p.group_size = rowprod::group_size(sqt_instance(p.shape, diag, trace), p.shape, p.tiles, N,
                                       bp::cdiv(C, p.shape.classes()) * bp::cdiv(R, rowprod::RS));
    p.groups = (int)bp::cdiv(N, p.group_size);
    p.diag_parts = p.groups * (p.shape.split_a ? 1 : 2);
  }
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

struct Scratch {
  long long diag, trace, kron;
};

Scratch scratch_floats(const Plan& p, int N, int a, int b, bool diag, bool trace, bool kron) {
  return {diag && p.diag_parts > 1 ? (long long)p.diag_parts * a * b : 0,
          trace ? (long long)p.tiles * N : 0,
          kron && p.kron_splits > 1 ? (long long)p.kron_splits * b * b : 0};
}

}  // namespace

extern "C" long long fused_second_order_scratch_floats(int C, int N, int R, int a, int b,
                                                       int want_diag, int want_kron,
                                                       int want_trace) {
  const Plan p = plan(C, N, R, a, b, want_diag, want_trace, want_kron);
  const Scratch s = scratch_floats(p, N, a, b, want_diag, want_trace, want_kron);
  return s.diag + s.trace + s.kron;
}

extern "C" int fused_second_order_launch(const float* A, const float* S, int C, int N, int R,
                                         int a, int b, int want_diag, int want_kron,
                                         int want_trace, float* diag, float* kron, float* trace,
                                         float* scratch, cudaStream_t stream) {
  const Plan p = plan(C, N, R, a, b, want_diag, want_trace, want_kron);
  const Scratch s = scratch_floats(p, N, a, b, want_diag, want_trace, want_kron);
  float* diag_part = p.diag_parts > 1 ? scratch : diag;
  float* trace_part = scratch + s.diag;
  float* kron_part = scratch + s.diag + s.trace;
  if (want_diag || want_trace) {
    const Shape& sh = p.shape;
    const dim3 grid((unsigned)p.tiles, (unsigned)p.groups);
    const rowprod::Fn fn = sqt_instance(sh, want_diag, want_trace);
    Args args{};
    args.A = A;
    args.S = S;
    args.C = C;
    args.N = N;
    args.R = R;
    args.a = a;
    args.b = b;
    args.group_size = p.group_size;
    args.diag_part = diag_part;
    args.trace_part = trace_part;
    CUtensorMap smap{};
    args.tma = rowprod::s_map(&smap, S, C, N, R, b);
    fn<<<grid, rowprod::THREADS, sh.smem_bytes(), stream>>>(smap, args);
    if (want_diag && p.diag_parts > 1)
      bp::launch_sum_partials(diag_part, diag, 1, p.diag_parts, (long long)a * b, stream);
    if (want_trace) bp::launch_sum_partials(trace_part, trace, 1, p.tiles, N, stream);
  }
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
