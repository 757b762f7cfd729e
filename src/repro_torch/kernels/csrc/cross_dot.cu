// Cross-block pairwise dots of per-sample gradients (Gram / empirical NTK):
//   out[e,n,m] = ⟨G1[e,n], G2[e,m]⟩,   G1[e,n] = A1ᵀB1[e,n],  G2[e,m] = A2ᵀB2[e,m],
// A1 rows [R, a], B1 [E, N1, R, b], A2 rows [R, a], B2 [E, N2, R, b], all
// float32 and contiguous; out [E, N1, N2].
//
// Replaces the Pallas kernel cross_dot_pallas (src/repro/kernels/cross_dot.py:64,
// body _kernel :35).  The A side may be shared: with a_per_group = 0 one A
// serves every group e (the class-wise NTK, E = C, reads the layer input once
// for all classes through an indexed class axis), and with a_rows < N a row p
// of B pairs with row p mod a_rows of A (GGNGram's class-major (c, n) rows,
// N1 = C·N, read against the N input rows).  No broadcast copy is made.
//
// Bound on the H100: operations.  Forming G costs 2·E·N·R·a·b and the Gram
// 2·E·N1·N2·a·b (half of it when both sides are one row set); at the 3C3D
// conv shapes with N1 = 1280 the Gram dominates (181 of the 442 GFLOP a Gram
// `run` needs are conv3's GGNGram).  Both stages run on the tensor cores in
// 3xTF32 (tf32x3.cuh: hi/lo splits, three TF32 products a k-step, within
// ≈ 2^-22 of float32 products), so the bound is 3 × operations / 495 TFLOP/s
// rather than operations / 67.  Two passes:
//   * Form: G[z] = A_zᵀB_z over the R patch rows, stored as G[z, i·b + j].
//     The NTK's ten classes and GGNGram's class-major rows share one layer
//     input A_p: rowprod.cuh's kernel (fused_second_order's t, with a store)
//     stages and splits A_p once for all ten classes and runs wgmma with
//     B's rows by TMA.  One row set against its own A (BatchDot's cross block
//     in the accumulated lane's pair passes), or an A a group, takes
//     xty.cuh's mma.sync ring:
//     the tiles that pad least (xty_tile), a block walking its rows z
//     through one cp.async ring.  The TPU kernel kept G of all rows in VMEM;
//     1280 rows × 110,592 floats (566 MB at conv3) cannot stay on chip, so G
//     is staged once through device memory, its rows padded to a multiple
//     of 4 floats for 16-byte TMA strides.
//   * Gram (gram.cuh's gram_kernel): out[e] = G1[e]·G2[e]ᵀ over K = a·b.  Both operands
//     are K-contiguous, the layout TF32 wgmma takes: 128x128 tiles, thread 0
//     keeps a 4-stage ring of TMA loads (32 k of each side's 128 rows, one
//     128-byte-swizzled row each), two warpgroups of 64 rows run wgmma
//     m64n128k8 with A (G1's rows) split into hi/lo registers and B (G2's
//     rows) split once a stage in shared memory (hi in place, lo beside it,
//     by all 256 threads), three products a k-step.  Each stage's sum is
//     added into float32 registers on the CUDA cores (tf32x3::promote's
//     reason).  When both sides are one row set (every NTK and GGNGram
//     call but the accumulated lane's pair passes) only the tiles on and above the diagonal are computed and every
//     value is written from the one product that made it, to (m, n) and
//     (n, m) (on a diagonal tile, from m ≤ n), so the result is symmetric bit
//     for bit.  K is split over blocks until the blocks fill whole waves (the
//     NTK's E = 10 groups have one tile each: 13 splits), each split writing
//     its own partial, and a second pass adds the partials in a fixed order:
//     deterministic, no atomics.  The blocks are issued tile-fastest, so the
//     blocks in flight are the tiles of one or two splits, which stream the
//     same K range of G: each stage's rows come from device memory once and
//     from L2 for the other tiles (55 upper tiles of 128 rows over conv3's K
//     would read 6.2 GB if each went to device memory).
#include "common.cuh"
#include "gram.cuh"
#include "rowprod.cuh"
#include "xty.cuh"

namespace {

// G[z] for the E·N rows of one side: z = e·N + p pairs row p of B[e] with
// row p mod a_rows of A[a_per_group ? e : 0], stored as G[z, i·b + j] in
// rows of ld floats.  Where one A serves several groups or class-major row
// blocks (the NTK's ten classes, GGNGram's), the rows are the C = E·N /
// a_rows classes of a_rows samples and rowprod's kernel computes them with
// A_p staged once; else (one row set against its own A, or an A a group)
// the mma.sync product of xty.cuh.
cudaError_t form(const float* A, const float* B, int E, int N, int R, int a, int b,
                 int a_per_group, int a_rows, float* G, long long ld, cudaStream_t stream) {
  const int C = E * N / a_rows;
  if (!a_per_group && C > 1) {
    const rowprod::Shape sh = rowprod::shape_for(C);
    const rowprod::Fn fn = rowprod::kernel<5, false, rowprod::STORE>;
    rowprod::Args p{};
    p.A = A;
    p.S = B;
    p.C = C;
    p.N = a_rows;
    p.R = R;
    p.a = a;
    p.b = b;
    p.out = G;
    p.out_ld = ld;
    const long long tiles = bp::cdiv(b, rowprod::BS) * bp::cdiv(a, sh.na());
    p.group_size = rowprod::group_size(fn, sh, tiles, a_rows,
                                       bp::cdiv(C, sh.classes()) * bp::cdiv(R, rowprod::RS));
    CUtensorMap smap{};
    p.tma = rowprod::s_map(&smap, B, C, a_rows, R, b);
    const dim3 grid((unsigned)tiles, (unsigned)bp::cdiv(a_rows, p.group_size));
    fn<<<grid, rowprod::THREADS, sh.smem_bytes(), stream>>>(smap, p);
    return cudaGetLastError();
  }
  tf32x3::XtyArgs p{};
  p.X = B;
  p.Y = A;
  p.out = G;
  p.M = b;
  p.N = a;
  p.Z = E * N;
  p.K = R;
  p.k_total = (long long)p.Z * R;
  p.xs = (long long)R * b;
  p.ys = (long long)R * a;
  p.os = ld;
  p.yd = N;
  p.yr = a_rows;
  p.yg = a_per_group;
  p.vx = tf32x3::vec_ok(B, b, p.xs);
  p.vy = tf32x3::vec_ok(A, a, p.ys);
  return tf32x3::xty_launch(p, stream);
}

}  // namespace

extern "C" long long cross_dot_scratch_floats(int E, int N1, int N2, int a, int b, int sym) {
  const long long K = (long long)a * b, ld = gram::row_stride(K);
  return (long long)E * N1 * ld + (sym ? 0 : (long long)E * N2 * ld) +
         gram::partial_floats(E, N1, N2, K, sym != 0);
}

extern "C" int cross_dot_launch(const float* A1, const float* B1, const float* A2,
                                const float* B2, int E, int N1, int N2, int R, int a, int b,
                                int a1_per_group, int a1_rows, int a2_per_group, int a2_rows,
                                int sym, float* out, float* scratch, cudaStream_t stream) {
  if (sym && N1 != N2) return (int)cudaErrorInvalidValue;
  const long long K = (long long)a * b, ld = gram::row_stride(K);
  float* G1 = scratch;
  float* G2 = sym ? G1 : G1 + (long long)E * N1 * ld;
  float* part = G2 + (sym ? (long long)E * N1 * ld : (long long)E * N2 * ld);
  cudaError_t err = form(A1, B1, E, N1, R, a, b, a1_per_group, a1_rows, G1, ld, stream);
  if (err == cudaSuccess && !sym)
    err = form(A2, B2, E, N2, R, a, b, a2_per_group, a2_rows, G2, ld, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)gram::launch(G1, G2, E, N1, N2, K, ld, sym != 0, out, part, stream);
}
