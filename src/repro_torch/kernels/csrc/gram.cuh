// gram: out[e] = G1[e]·G2[e]ᵀ over K, both operands K-contiguous rows of
// float32, on the tensor cores in 3xTF32: TMA + wgmma m64n128k8, split-K
// partials added in a fixed order, and, where both sides are one row set, the
// upper triangle alone, written to both places (symmetric bit for bit).
// cross_dot's Gram stage and fused_first_order's dot; the design is in
// cross_dot.cu's source note.
#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace gram {

constexpr int GT = 128;        // Gram output tile side: two warpgroups of 64 rows x 128
constexpr int GK = 32;         // k a stage: one 128-byte swizzled row of each tile
constexpr int GSTAGES = 4;
// A block's k stages at most where the scratch allows it: one float32
// accumulator summed over ~100K stages at the LM head's K = 2048 · 100352
// (softmax − onehot cotangents: a few large squares among many small ones)
// stopped taking the small ones in, 2.5e-4 off float64; at ≤ 1024 stages
// 1.1e-6 (PERF.md §6).  No 3C3D shape's plan changes.
constexpr long long GMAX_STEPS = 1024;
constexpr long long GMAX_PARTIAL_FLOATS = 1LL << 28;  // the split-K scratch: 1 GiB
constexpr int GTHREADS = 256;  // two warpgroups; thread 0 also issues the copies
constexpr int TILE_BYTES = GT * GK * 4;        // 16 KB
constexpr int STAGE_BYTES = 3 * TILE_BYTES;    // G1 rows, G2 rows (hi in place), G2 lo
constexpr int BAR_OFF = GSTAGES * STAGE_BYTES;
// +1024: the window is aligned by hand to the swizzle's 1024-byte repeat.
constexpr int GSMEM = BAR_OFF + 2 * GSTAGES * 8 + 1024;  // 197,696 bytes: one block an SM

// G rows are padded to a multiple of 4 floats (16-byte TMA strides).
inline long long row_stride(long long K) { return bp::cdiv(K, 4) * 4; }

struct GramPlan {
  int tiles1, tiles2, tiles, splits;
  long long kchunk;
};

// SYM: only the tiles on and above the diagonal.  K is cut into the number
// of splits (at least 256 k each, and at least enough that a block takes
// ≤ GMAX_STEPS stages while the partials fit GMAX_PARTIAL_FLOATS) whose
// blocks fill the card's waves best (one block an SM): the fewest waves a
// split's work, the fewest splits on a tie.
inline GramPlan gram_plan(int E, int N1, int N2, long long K, bool sym) {
  GramPlan p;
  p.tiles1 = (int)bp::cdiv(N1, GT);
  p.tiles2 = (int)bp::cdiv(N2, GT);
  p.tiles = sym ? p.tiles1 * (p.tiles1 + 1) / 2 : p.tiles1 * p.tiles2;
  long long least = bp::cdiv(K, GMAX_STEPS * GK);
  const long long fit = GMAX_PARTIAL_FLOATS / ((long long)E * N1 * N2);
  if (least > fit) least = fit > 1 ? fit : 1;
  long long most = bp::cdiv(K, 8 * GK);
  if (most > 64) most = 64;
  if (most < least) most = least;
  if (most > 65535 / E) most = 65535 / E;  // gridDim.z = E · splits
  if (least > most) least = most;
  const long long blocks = (long long)E * p.tiles, slots = bp::num_sms();
  long long best = least > 1 ? least : 1;
  double best_cost = (double)bp::cdiv(blocks * best, slots) / (double)best;
  for (long long s = best + 1; s <= most; ++s) {
    const double cost = (double)bp::cdiv(blocks * s, slots) / (double)s;
    if (cost < best_cost) best = s, best_cost = cost;
  }
  p.kchunk = bp::cdiv(bp::cdiv(K, best), GK) * GK;
  p.splits = (int)bp::cdiv(K, p.kchunk);
  return p;
}

#define WG_D64                                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63])
#define WG_REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A·B for 64 rows x 128 columns and 8 of K in TF32: A in registers, in
// mma.m16n8k8's A layout for each warp's 16 rows; B (128 x 8) K-major in
// 128-byte-swizzled shared memory.  acc = 0 overwrites d.  d[4j + 2i + c] is
// row 16·warp + lane/4 + 8i, column 8j + 2·(lane%4) + c.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// Block (x, ·, e·splits + s) computes output tile x of group e over k in
// [s·kchunk, (s+1)·kchunk) into partial s of out [E, splits, N1, N2] (out
// itself when splits == 1); map1 and map2 are G1 [E, N1, K] and G2 [E, N2,
// K] (rows ld floats apart), in boxes of {32 k, 128 rows, 1 group}.
template <bool SYM>
__global__ void __launch_bounds__(GTHREADS, 1)
gram_kernel(const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2,
            int N1, int N2, long long K, int tiles2, int splits, long long kchunk,
            float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t full_bar = base + BAR_OFF, empty_bar = full_bar + 8 * GSTAGES;
  const int e = blockIdx.z / splits, sp = blockIdx.z % splits;
  int ti, tj;
  if (SYM) {  // the x-th tile of the upper triangle, row by row
    int rem = blockIdx.x;
    ti = 0;
    while (rem >= tiles2 - ti) {
      rem -= tiles2 - ti;
      ++ti;
    }
    tj = ti + rem;
  } else {
    ti = blockIdx.x / tiles2;
    tj = blockIdx.x % tiles2;
  }
  const int m0 = ti * GT, n0 = tj * GT;
  const long long k_lo = (long long)sp * kchunk;
  const long long k_hi = k_lo + kchunk < K ? k_lo + kchunk : K;
  const int steps = k_hi > k_lo ? (int)((k_hi - k_lo + GK - 1) / GK) : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      hopper::mbar_init(full_bar + 8 * s, 1);
      hopper::mbar_init(empty_bar + 8 * s, 8);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage `it` ← k in [k_lo + 32·it, +32) of both row tiles, once every warp
  // released what the stage held (thread 0 only).  Past K or past the last
  // row, TMA fills zeros.
  auto load = [&](int it) {
    const int stage = it % GSTAGES;
    if (it >= GSTAGES) hopper::mbar_wait(empty_bar + 8 * stage, ((it / GSTAGES) & 1) ^ 1);
    const uint32_t fb = full_bar + 8 * stage, st = base + stage * STAGE_BYTES;
    hopper::mbar_expect_tx(fb, 2 * TILE_BYTES);
    const int k0 = (int)(k_lo + (long long)it * GK);
    hopper::tma_load_3d(st, &map1, fb, k0, m0, e);
    hopper::tma_load_3d(st + TILE_BYTES, &map2, fb, k0, n0, e);
  };
  if (tid == 0)
    for (int it = 0; it < GSTAGES - 1 && it < steps; ++it) load(it);

  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[64], tc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = tc[x] = 0.f;

  // G2's tile of stage `it` → hi (rounded) in place and lo beside it: the
  // swizzle moves 16-byte chunks, so an elementwise split keeps it.
  auto split_b = [&](int it) {
    const int stage = it % GSTAGES;
    hopper::mbar_wait(full_bar + 8 * stage, (it / GSTAGES) & 1);
    uint8_t* st = sbase + stage * STAGE_BYTES;
#pragma unroll
    for (int q = 0; q < TILE_BYTES / 16 / GTHREADS; ++q) {
      const int off = 16 * (tid + GTHREADS * q);
      float4* hi = reinterpret_cast<float4*>(st + TILE_BYTES + off);
      float4* lo = reinterpret_cast<float4*>(st + 2 * TILE_BYTES + off);
      const float4 x = *hi;
      uint32_t h[4], l[4];
      tf32x3::split_tf32(x.x, h[0], l[0]);
      tf32x3::split_tf32(x.y, h[1], l[1]);
      tf32x3::split_tf32(x.z, h[2], l[2]);
      tf32x3::split_tf32(x.w, h[3], l[3]);
      *hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                        __uint_as_float(h[3]));
      *lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                        __uint_as_float(l[3]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  if (steps > 0) split_b(0);
  __syncthreads();

  for (int it = 0; it < steps; ++it) {
    const int stage = it % GSTAGES;
    if (tid == 0 && it + GSTAGES - 1 < steps) load(it + GSTAGES - 1);
    const uint8_t* st = sbase + stage * STAGE_BYTES;
    // G1's rows for this warpgroup as register A fragments, split: row r =
    // 64wg + 16warp + g (+8), columns 8kk + t (+4) of the swizzled tile.
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 64 * wg + 16 * warp + g + 8 * (i % 2), c = 8 * kk + t + 4 * (i / 2);
        const float x = *reinterpret_cast<const float*>(
            st + r * 128 + (((c / 4) ^ (r % 8)) << 4) + 4 * (c % 4));
        tf32x3::split_tf32(x, ah[kk][i], al[kk][i]);
      }
    // The stage's three products a k-step on the tensor cores into tc (the
    // first overwrites it); the next stage's split runs while they do; then
    // acc += tc on the CUDA cores (tf32x3::promote's reason).
    const uint32_t bhi = base + stage * STAGE_BYTES + TILE_BYTES, blo = bhi + TILE_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32(tc, al[kk], hopper::sw128_desc(bhi + 32 * kk), kk > 0);
      wgmma_tf32(tc, ah[kk], hopper::sw128_desc(blo + 32 * kk), 1);
      wgmma_tf32(tc, ah[kk], hopper::sw128_desc(bhi + 32 * kk), 1);
    }
    hopper::wgmma_commit();
    if (it + 1 < steps) split_b(it + 1);
    hopper::wgmma_wait_all();
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      asm volatile("" : "+f"(tc[x])::"memory");  // no read of tc before the wait
      acc[x] += tc[x];
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty_bar + 8 * stage);
    __syncthreads();  // every thread's split of stage it + 1 is in
  }

  float* dst = out + ((long long)e * splits + sp) * N1 * N2;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = m0 + 64 * wg + 16 * warp + g + 8 * i;
        const int n = n0 + 8 * j + 2 * t + c;
        const float v = acc[4 * j + 2 * i + c];
        if (m >= N1 || n >= N2) continue;
        if (SYM && ti == tj && m > n) continue;  // written from (n, m)
        dst[(long long)m * N2 + n] = v;
        if (SYM && m != n) dst[(long long)n * N1 + m] = v;
      }
}

// The map of G [E, N, K] (rows ld floats apart) in boxes of {32, 128, 1},
// 128-byte swizzle, zeros past K and past N.
inline bool g_map(CUtensorMap* map, const float* G, int E, int N, long long K, long long ld) {
  hopper::EncodeTiled enc = hopper::encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)N * ld * 4};
  const cuuint32_t box[3] = {GK, GT, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(G), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Scratch floats for the split-K partials of out [E, N1, N2] (0 when K is
// not split).
inline long long partial_floats(int E, int N1, int N2, long long K, bool sym) {
  const GramPlan p = gram_plan(E, N1, N2, K, sym);
  return p.splits > 1 ? (long long)E * p.splits * N1 * N2 : 0;
}

// out [E, N1, N2] = G1·G2ᵀ, G1 [E, N1, K] and G2 [E, N2, K] in rows of ld
// floats (ld = row_stride(K); G2 = G1 when sym); part holds partial_floats.
inline cudaError_t launch(const float* G1, const float* G2, int E, int N1, int N2, long long K,
                          long long ld, bool sym, float* out, float* part, cudaStream_t stream) {
  const GramPlan p = gram_plan(E, N1, N2, K, sym);
  float* dst = p.splits > 1 ? part : out;
  CUtensorMap map1, map2;
  if (!g_map(&map1, G1, E, N1, K, ld) || !g_map(&map2, G2, E, N2, K, ld))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.tiles, 1, (unsigned)(E * p.splits));
  auto kernel = sym ? gram_kernel<true> : gram_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, GTHREADS, GSMEM, stream>>>(map1, map2, N1, N2, K, p.tiles2, p.splits, p.kchunk,
                                            dst);
  if (p.splits > 1) bp::launch_sum_partials(part, out, E, p.splits, (long long)N1 * N2, stream);
  return cudaGetLastError();
}

}  // namespace gram
