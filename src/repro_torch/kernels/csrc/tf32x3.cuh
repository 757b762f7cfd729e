// 3xTF32 on the tensor cores: float32-accurate products from TF32 ones.
//
// Each float32 operand x splits into x_hi = tf32(x) and x_lo = tf32(x − x_hi)
// (cvt.rna: 10-bit mantissas, |x − x_hi − x_lo| ≤ 2^-22·|x|), and
//   a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
// each TF32 product exact in the float32 accumulator; a_lo·b_lo (≈ 2^-22 of
// a·b) is dropped.  Three TF32 products a k-step (mma.sync m16n8k8 here,
// wgmma m64nNk8 in cross_dot's Gram and rowprod.cuh) for each float32 one,
// so the bound is 3 × operations / 495 TFLOP/s (the H100's dense TF32 rate)
// against 67 TFLOP/s for float32 on the CUDA cores.  1xTF32 (x_hi alone)
// keeps about three decimal digits: at cross_dot's conv3 depth (a·b =
// 110,592 terms) a median off-diagonal entry is off by ≈ 3e-5 of itself
// (tests/test_torch_tf32x3.py), so every kernel here splits both operands.
//
// The mma.sync kernels (sq_matmul, xty.cuh) stage rows by cp.async (16 bytes
// where a row's width and base allow it, 4 else), zero-filled past the
// edges, into rings of shared-memory stages.
//
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32 (10-bit mantissas), |x − hi − lo| ≤ 2^-22·|x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a·b for one m16n8k8 tile: a row-major 16x8, b column-major 8x8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment (row operand) of an m16n8k8 tile from a shared [k][m] stage
// of row stride P, at column m0 and row k0: split into hi and lo.
__device__ __forceinline__ void frag_a_mk(const float* s, int P, int k0, int m0, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* p = s + (k0 + t) * P + m0 + g;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8], hi[1], lo[1]);
  split_tf32(p[4 * P], hi[2], lo[2]);
  split_tf32(p[4 * P + 8], hi[3], lo[3]);
}

// The B fragment (column operand) from a shared [k][n] stage of row stride P.
__device__ __forceinline__ void frag_b_kn(const float* s, int P, int k0, int n0, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* p = s + (k0 + t) * P + n0 + g;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4 * P], hi[1], lo[1]);
}

// The three products of one k-step over an MI x NI grid of tiles: the small
// terms first, a pass over every tile between two products into the same
// accumulator.
template <int MI, int NI>
__device__ __forceinline__ void mma3(float (&acc)[MI][NI][4], const uint32_t (&ah)[MI][4],
                                     const uint32_t (&al)[MI][4], const uint32_t (&bh)[NI][2],
                                     const uint32_t (&bl)[NI][2]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
}

// acc += tc on the CUDA cores.  A float32 sum carried in the tensor cores'
// accumulator through thousands of products drifts: carried through a whole
// split (3,456 products at conv3), cross_dot's Gram reads 1e-4 of its
// largest entry against float64 and 6e-5 of a median entry (H100,
// tools/cross_dot_fault.py's "unpromoted"; sq_matmul, unpromoted, read
// 7.3e-6 at K = 1280).  So the kernels built on these add a stage (16 or 32
// k) into a zeroed tc and promote it: 7e-7 and 5e-7.
template <int NI>
__device__ __forceinline__ void promote(float (&acc)[NI][4], const float (&tc)[NI][4]) {
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[ni][c] += tc[ni][c];
}

template <int MI, int NI>
__device__ __forceinline__ void zero(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
}

// Copies rows [k0, k0 + rs) of columns [c0, c0 + w) of a row-major [k_end,
// cols] matrix (row stride ld) into a shared [rs][w + 8] stage, zeros
// outside: 16-byte copies when `vec` (cols, ld and the base multiples of 4
// floats, 16-byte aligned; w and c0 multiples of 4), 4-byte ones else.
// Every thread of the block (`threads` of them) calls it.
__device__ __forceinline__ void stage_rows(float* st, const float* src, long long ld, int cols,
                                           int c0, int w, int rs, long long k0, long long k_end,
                                           bool vec, int threads) {
  const int P = w + 8;
  if (vec) {
    const int wq = w / 4;
    for (int e = threadIdx.x; e < rs * wq; e += threads) {
      const int r = e / wq, c = 4 * (e % wq);
      const long long k = k0 + r;
      const bool in = k < k_end && c0 + c < cols;
      cp_async16(st + r * P + c, in ? src + k * ld + c0 + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < rs * w; e += threads) {
      const int r = e / w, c = e % w;
      const long long k = k0 + r;
      const bool in = k < k_end && c0 + c < cols;
      cp_async4(st + r * P + c, in ? src + k * ld + c0 + c : src, in);
    }
  }
}

}  // namespace tf32x3
