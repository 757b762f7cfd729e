// GLM predictive variance of one layer (the Laplace predictive's hot path):
//   var[c,n] = Σ_ab (A[n]ᵀ S[c,n])²_ab [· Sigma[a,b]],
// A [N, R, a], S [C, N, R, b], Sigma [a, b] (optional), all float32 and
// contiguous; out [C, N].
//
// Replaces the Pallas kernel predictive_var_pallas
// (src/repro/kernels/predictive_var.py:81, body _make_kernel :46).  A diagonal
// posterior passes its covariance diagonal as Sigma; a Kronecker posterior
// half-transforms A and S outside the kernel and passes no Sigma.
//
// Bound on the H100: operations.  The per-sample Jacobian tile t = A_nᵀS_cn
// costs 2·C·N·R·a·b operations against N·R·a + C·N·R·b input floats, hundreds
// of operations a byte at the 3C3D conv shapes.  t runs on the tensor cores
// in 3xTF32 (tf32x3.cuh), so the bound is 3 × operations / 495 TFLOP/s.
// Design: rowprod.cuh's t kernel, fused_second_order's product (its source
// note), with the VAR epilogue: a block of two warpgroups takes a (64 b x 48
// a) tile and a group of samples, A_n is staged and split once for the ten
// classes of a class block (the CUDA-core kernel re-read it for every class),
// and t never reaches device memory.  Each thread loads its 24 Sigma entries
// of the tile once (1 where there is no Sigma, 0 past the edges); after a
// sample's last stage it sums each of its classes' promoted t² · Sigma, a
// warp shuffle sums the warp's share, and lane 0 writes one partial per
// (tile, warp, c, n): no block barrier a sample.  A second pass adds the
// partials in a fixed order: deterministic, no atomics.  Class counts other
// than ten take blocks of ten with zeros past C (one class: the two
// warpgroups split the a-columns, rowprod::shape_for).
#include "rowprod.cuh"

namespace {

using rowprod::Shape;

rowprod::Fn instance(const Shape& sh) {
  return sh.split_a ? rowprod::kernel<1, true, rowprod::VAR>
                    : rowprod::kernel<5, false, rowprod::VAR>;
}

int tiles(const Shape& sh, int a, int b) {
  return (int)(bp::cdiv(b, rowprod::BS) * bp::cdiv(a, sh.na()));
}

}  // namespace

// One partial per (tile, warp): [tiles, var_warps, C, N].
extern "C" long long predictive_var_scratch_floats(int C, int N, int a, int b) {
  const Shape sh = rowprod::shape_for(C);
  return (long long)tiles(sh, a, b) * rowprod::var_warps(sh.split_a) * C * N;
}

// The t kernel with the VAR epilogue (Sigma == nullptr: unweighted), then
// the partials added in a fixed order.
extern "C" int predictive_var_launch(const float* A, const float* S, const float* Sigma, int C,
                                     int N, int R, int a, int b, float* var, float* scratch,
                                     cudaStream_t stream) {
  const Shape sh = rowprod::shape_for(C);
  const rowprod::Fn fn = instance(sh);
  const int nt = tiles(sh, a, b);
  const int group_size = rowprod::group_size(
      fn, sh, nt, N, bp::cdiv(C, sh.classes()) * bp::cdiv(R, rowprod::RS));
  rowprod::Args args{};
  args.A = A;
  args.S = S;
  args.C = C;
  args.N = N;
  args.R = R;
  args.a = a;
  args.b = b;
  args.group_size = group_size;
  args.sigma = Sigma;
  args.var_part = scratch;
  CUtensorMap smap{};
  args.tma = rowprod::s_map(&smap, S, C, N, R, b);
  const dim3 grid((unsigned)nt, (unsigned)bp::cdiv(N, group_size));
  fn<<<grid, rowprod::THREADS, sh.smem_bytes(), stream>>>(smap, args);
  bp::launch_sum_partials(scratch, var, 1, nt * rowprod::var_warps(sh.split_a),
                          (long long)C * N, stream);
  return (int)cudaGetLastError();
}
