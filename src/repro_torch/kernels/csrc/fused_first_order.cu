// Fused first-order statistics: one pass over (A, B) emits the requested
// reductions of the per-sample gradients G[e,n] = A[e,n]ᵀ B[e,n]:
//   l2[e,n]     = Σ_ab G²            (BatchL2)
//   moment[e]   = Σ_n G∘G            (SecondMoment / Variance)
//   dot[e,n,m]  = ⟨G[e,n], G[e,m]⟩   (BatchDot)
// A is [E, N, R, a], B is [E, N, R, b], all float32 and contiguous.
//
// Replaces the Pallas kernel fused_first_order_pallas
// (src/repro/kernels/fused_first_order.py:87, body _make_kernel :47).
//
// Bound on the H100: operations.  Forming G costs 2·N·R·a·b operations
// against N·R·(a+b) input floats, and dot another N²·a·b (half of the
// 2·N²·a·b by symmetry); at the 3C3D conv shapes that is hundreds of
// operations a byte.  Both products run on the tensor cores in 3xTF32
// (tf32x3.cuh: hi/lo splits, three TF32 products a k-step, within ≈ 2^-22 of
// float32 products), so the bound is 3 × product operations / 495 TFLOP/s
// rather than operations / 67.  Two passes at most:
//   * Form (xty.cuh's per_sample, tf32x3::xty_kernel): G_z over the R rows
//     of sample z = e·N + n by mma.sync m16n8k8, a block owning an (a, b)
//     tile that pads the widths least and walking its samples through one
//     cp.async ring; each 16 rows' products are summed in the tensor cores
//     and added into float32 registers (tf32x3::promote's reason).  After a
//     sample's last stage the epilogues the mask asks for run on the
//     promoted tile: SQUARE adds G∘G into float32 moment registers, ROWSUM
//     sums G∘G over the tile (a block sum), STORE writes G.  The blocks of
//     one sample group are issued tile-fastest, so each sample's rows come
//     from device memory once and from L2 for the other tiles.  Each block
//     writes its own moment partial, each tile its l2 partial, added in a
//     fixed order by a second pass: deterministic, no atomics.  The group
//     axis E (a mixture of experts' experts) is the samples' outer axis; a
//     block's samples lie in one group.
//   * dot needs every sample's G at once: the form stores G (rows of
//     gram::row_stride(a·b) floats, 56.6 MB at conv3 for N = 128) with the
//     moment squared in the same pass, and gram.cuh's symmetric Gram (TMA +
//     wgmma m64n128k8, the upper triangle written to both places, split-K
//     partials in a fixed order: cross_dot's Gram stage) gives dot[e] =
//     G[e]·G[e]ᵀ.  l2 is then dot's diagonal, copied: equal to it bit for
//     bit, and no ROWSUM in that pass.
// The mask selects template instances: an unrequested output costs nothing.
#include <type_traits>

#include "common.cuh"
#include "gram.cuh"
#include "xty.cuh"

namespace {

using tf32x3::XTY_ROWSUM;
using tf32x3::XTY_SQUARE;
using tf32x3::XTY_STORE;

// The form's epilogues: with dot, G stored (and moment squared); l2 from
// dot's diagonal.  Without, moment and l2 from the promoted tiles.
int epilogues(bool l2, bool moment, bool dot) {
  if (dot) return XTY_STORE | (moment ? XTY_SQUARE : 0);
  return (moment ? XTY_SQUARE : 0) | (l2 ? XTY_ROWSUM : 0);
}

// f(std::integral_constant<int, epi>) for the five masks' epilogues.
template <class F>
auto with_epilogues(int epi, F&& f) {
  switch (epi) {
    case XTY_STORE: return f(std::integral_constant<int, XTY_STORE>());
    case XTY_STORE | XTY_SQUARE: return f(std::integral_constant<int, XTY_STORE | XTY_SQUARE>());
    case XTY_SQUARE | XTY_ROWSUM:
      return f(std::integral_constant<int, XTY_SQUARE | XTY_ROWSUM>());
    case XTY_ROWSUM: return f(std::integral_constant<int, XTY_ROWSUM>());
    default: return f(std::integral_constant<int, XTY_SQUARE>());
  }
}

// Scratch: G [E, N, ld] and the Gram's partials (dot), then the form's partials.
struct Layout {
  long long ld, g, gram, form;
};

Layout layout(const tf32x3::XtyArgs& p, int E, int N, int a, int b, bool dot, int epi) {
  Layout s{};
  const long long K = (long long)a * b;
  if (dot) {
    s.ld = gram::row_stride(K);
    s.g = (long long)E * N * s.ld;
    s.gram = gram::partial_floats(E, N, N, K, true);
  }
  s.form = with_epilogues(epi, [&](auto e) {
    return tf32x3::per_sample_scratch_floats<decltype(e)::value>(p);
  });
  return s;
}

// l2[e, n] = dot[e, n, n].
__global__ void diagonal(const float* __restrict__ dot, float* __restrict__ l2, int E, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)E * N) l2[i] = dot[i * N + i % N];
}

}  // namespace

extern "C" long long fused_first_order_scratch_floats(int E, int N, int R, int a, int b,
                                                      int want_l2, int want_moment,
                                                      int want_dot) {
  const tf32x3::XtyArgs p = tf32x3::per_sample_args(nullptr, nullptr, E, N, R, a, b);
  const Layout s = layout(p, E, N, a, b, want_dot, epilogues(want_l2, want_moment, want_dot));
  return s.g + s.gram + s.form;
}

extern "C" int fused_first_order_launch(const float* A, const float* B, int E, int N, int R,
                                        int a, int b, int want_l2, int want_moment, int want_dot,
                                        float* l2, float* moment, float* dot, float* scratch,
                                        cudaStream_t stream) {
  if (!want_l2 && !want_moment && !want_dot) return (int)cudaErrorInvalidValue;
  const int epi = epilogues(want_l2, want_moment, want_dot);
  const tf32x3::XtyArgs p = tf32x3::per_sample_args(A, B, E, N, R, a, b);
  const Layout s = layout(p, E, N, a, b, want_dot, epi);
  float* G = scratch;
  float* gram_part = scratch + s.g;
  float* form_part = gram_part + s.gram;
  cudaError_t err = with_epilogues(epi, [&](auto e) {
    return tf32x3::per_sample_launch<decltype(e)::value>(p, G, s.ld, moment, l2, form_part,
                                                         stream);
  });
  if (err != cudaSuccess || !want_dot) return (int)err;
  err = gram::launch(G, G, E, N, N, (long long)a * b, s.ld, true, dot, gram_part, stream);
  if (err != cudaSuccess || !want_l2) return (int)err;
  const long long n = (long long)E * N;
  diagonal<<<(unsigned)bp::cdiv(n, bp::THREADS), bp::THREADS, 0, stream>>>(dot, l2, E, N);
  return (int)cudaGetLastError();
}
