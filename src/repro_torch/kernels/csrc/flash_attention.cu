// Causal, optionally sliding-window GQA attention with an online softmax:
//   out[n,t,h] = Σ_s softmax_s(q[n,t,h]·k[n,s,kv(h)] · scale, masked) v[n,s,kv(h)],
// q [N,T,H,dh], k [N,S,KV,dh], v [N,S,KV,dv], H = KV·g, out [N,T,H,dv] in q's
// type.  q and k/v are each float32 or bfloat16 (decode reads a float32 KV
// cache with bfloat16 queries).
//
// Replaces the Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:78, body _kernel :25), and computes
// what nn/functional.sdpa computes: the key s is seen by the query t when
// qp[t] ≥ kp[s] (causal), qp[t] − kp[s] < window and kp[s] ≥ 0 (ring slots not
// yet written), with the positions arange unless given (the decode path's
// ring cache gives them).  A masked logit is −1e30 in sdpa: it adds exactly
// 0 to a row that sees any key, and a row that sees none is the uniform
// average of all S values.
//
// Bound on the H100: operations (2·dh + 2·dv per seen (query, key) pair).  At
// Hymba-1.5B's prefill (4×2048 tokens, 25 heads, dh 64) that is 53.7 GFLOP a
// global layer and 40.3 GFLOP a window-1024 one: 0.054 and 0.041 ms at 989
// TFLOP/s bf16.  Three designs; the wrapper picks one (flash_attention.design):
//
// "wgmma" — bf16 q, k, v, positions arange, dh = dv ∈ {64, 128}, T ≤ S and
// T·g ≥ 64 rows a KV head (prefill).  Every row then sees its own key, so no
// row is fully masked.  The tensor cores are the bound's only way in:
//   * one block per (n, kv head, 128 query rows (t, j) of the g query heads
//     of that KV head), so each K/V tile in shared memory serves all g heads;
//     two warpgroups of 64 rows (wgmma's M), two blocks an SM at dh 64;
//   * Q is read once, with 16-byte loads, into a 128-byte-swizzled tile (the
//     (t, j) rows of g = 5 heads are no rectangular TMA box);
//   * K and V tiles of 64 keys come by TMA (cp.async.bulk.tensor, 4-d maps of
//     [N, S, KV, dh], 128-byte swizzle, one 64-wide column half a copy) into
//     a ring of 3 stages, each with a "full" mbarrier (bytes arrived) and an
//     "empty" one (both warpgroups done); thread 0 refills a stage two tiles
//     ahead; past S the copy fills zeros;
//   * S = Q·Kᵀ by wgmma m64n64k16, both operands from shared memory (K
//     K-major), float32 accumulators in registers; the online softmax works
//     on the accumulator fragment (row max by quad shuffles, exp2 with the
//     scale folded in), masking per element only on tiles that straddle the
//     causal or window edge or S; only the tiles between the window start
//     and the causal end of the block's rows are visited;
//   * P goes to bf16 in registers and is wgmma's A operand for O += P·V, V
//     read from shared memory in the transposed (MN-major) form; O stays in
//     float32 registers and is written as bf16 once.
// "split" — T·g < 64 rows a KV head (decode, short prompts), any dtypes,
// positions and widths "simt" takes; bound by bytes; its note is below.
// "simt" — everything else (float32, bf16 queries against a float32 cache,
// given positions, fully masked rows, any dh and dv that are multiples of 4
// up to 256, dh ≠ dv allowed), on CUDA cores, all arithmetic float32:
//   * one block per (n, kv head, tile of query rows), the rows taken as
//     (t, j) for the g = H/KV query heads j of that KV head, so the g heads
//     share each K/V tile, as the Pallas kernel's [bq, g, dh] block does;
//   * unlike the TPU kernel, which takes the whole [S, dh] K and V of a head
//     into VMEM, K/V stream through shared memory 4096/DM keys at a time
//     (4096 floats each, rows padded by 4 floats: float4 reads
//     conflict-free); instances DM = 64, 128 and 256 take dh, dv up to DM;
//   * each row keeps its query, its running max m, sum l and accumulator
//     acc[dv] in registers, and rescales once per 16 keys; above DM = 64 a
//     row's dims are split over DM/32 lanes (32 each), which add their q·k
//     partials by warp shuffle;
//   * with default key positions the block visits only the tiles its rows
//     can see (causal end, window start); with given key positions it visits
//     all S keys and masks each;
//   * a row that saw no key takes the mean of all S values, in a second
//     pass for such rows only.
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::encode_tiled;
using hopper::EncodeTiled;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::sw128_desc;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait_all;

constexpr int THREADS = 128;
constexpr int SIMT_MAX_DIM = 256;  // the widest "simt" instance

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16(x);
}

template <int DM>
struct Tiles {
  static constexpr int BK = 4096 / DM;  // keys a tile
  static constexpr int PAD = DM + 4;
  float k[BK][PAD];
  float v[BK][PAD];
  int kp[BK];
};

// Grid (row tiles, N·KV); rows r = t·g + j of one (n, kv head), THREADS/DS
// of them a block.  DM ≥ dh, dv, padded with zeros: instances DM = 64, 128
// and 256.  A row's DS threads are its dimension lanes.  Each thread keeps
// DPT = DM/DS dims of q and
// of acc in registers, four at a time (dims 4·(dl + DS·i) .. +3 for dimension
// lane dl), and the DS lanes sum their q·k partials by warp shuffle: DS = 1
// at DM = 64 (64 dims a thread), DPT = 32 at the wider instances, which
// would spill 2·DM registers of q and acc a thread.  The launch bounds ask
// for three blocks an SM at the wider instances (168 registers, no spill;
// with no count ptxas holds them to 128 and spills, with one it takes 180
// and two blocks fit), for one at DM = 64 (255 registers, as before).
template <int DM, int DS, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS, DM == 64 ? 1 : 3)
flash_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
             TQ* __restrict__ out, const int* __restrict__ qpos, const int* __restrict__ kpos,
             int T, int S, int H, int KV, int dh, int dv, int causal, int has_window,
             long long window, float scale) {
  using Tl = Tiles<DM>;
  constexpr int BK = Tl::BK;
  constexpr int DPT = DM / DS;
  __shared__ __align__(16) Tl tl;
  __shared__ int q_lo, q_hi;
  const int g = H / KV;
  const int n = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int rows_per_block = THREADS / DS;
  const int dl = threadIdx.x % DS;  // the dimension lane
  // The DS lanes of a row, for their shuffles (aligned, inside a warp).
  static_assert(DS < 32 && (DS & (DS - 1)) == 0, "DS: a power of two below 32");
  const unsigned dmask = ((1u << DS) - 1) << ((threadIdx.x & 31) & ~(DS - 1));
  const long long row = (long long)blockIdx.x * rows_per_block + threadIdx.x / DS;
  const bool valid = row < (long long)T * g;
  const int t = valid ? (int)(row / g) : 0, j = valid ? (int)(row % g) : 0;
  const long long qoff = (((long long)n * T + t) * H + (long long)kvh * g + j);
  const long long qp = qpos ? (long long)qpos[t] : (long long)t;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = 4 * (dl + DS * (i / 4)) + i % 4;
    qr[i] = (valid && d < dh) ? ld(q, qoff * dh + d) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // The keys the block's rows can see, when the key positions are arange.
  if (threadIdx.x == 0) {
    q_lo = INT_MAX;
    q_hi = INT_MIN;
  }
  __syncthreads();
  if (valid && dl == 0) {
    atomicMin(&q_lo, (int)qp);
    atomicMax(&q_hi, (int)qp);
  }
  __syncthreads();
  long long k_lo = 0, k_hi = S;
  if (!kpos) {
    if (causal) k_hi = min((long long)S, (long long)q_hi + 1);
    if (has_window) k_lo = max(0LL, (long long)q_lo - window + 1);
  }

  auto seen = [&](long long kp) {
    return kp >= 0 && (!causal || qp >= kp) && (!has_window || qp - kp < window);
  };
  auto load_tile = [&](long long s0, int len, bool with_k) {
    const long long kvoff = ((long long)n * S + s0) * KV + kvh;
    // Columns past dh / dv are zeros: the unrolled dot and sum read all DM.
    for (int e = threadIdx.x; e < len * DM && with_k; e += THREADS) {
      const int s = e / DM, d = e % DM;
      tl.k[s][d] = d < dh ? ld(k, (kvoff + (long long)s * KV) * dh + d) : 0.f;
    }
    for (int e = threadIdx.x; e < len * DM; e += THREADS) {
      const int s = e / DM, d = e % DM;
      tl.v[s][d] = d < dv ? ld(v, (kvoff + (long long)s * KV) * dv + d) : 0.f;
    }
    for (int s = threadIdx.x; s < len && with_k; s += THREADS)
      tl.kp[s] = kpos ? kpos[s0 + s] : (int)(s0 + s);
  };

  for (long long s0 = k_lo; s0 < k_hi; s0 += BK) {
    const int len = (int)min((long long)BK, k_hi - s0);
    __syncthreads();
    load_tile(s0, len, true);
    __syncthreads();
    if (!valid) continue;
    // 16 keys a step: their logits, one rescale, their values.
    for (int base = 0; base < len; base += 16) {
      float sc[16];
      float mx = m;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int s = base + i;
        sc[i] = -INFINITY;
        if (s < len && seen(tl.kp[s])) {  // the same for the DS lanes of a row
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < DPT; c += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(&tl.k[s][4 * (dl + DS * (c / 4))]);
            dot = fmaf(qr[c], kk.x, dot);
            dot = fmaf(qr[c + 1], kk.y, dot);
            dot = fmaf(qr[c + 2], kk.z, dot);
            dot = fmaf(qr[c + 3], kk.w, dot);
          }
#pragma unroll
          for (int off = DS / 2; off > 0; off /= 2) dot += __shfl_xor_sync(dmask, dot, off);
          sc[i] = dot * scale;
          mx = fmaxf(mx, sc[i]);
        }
      }
      if (mx == -INFINITY) continue;  // nothing seen yet
      const float corr = expf(m - mx);  // 0 when m = −inf
      l *= corr;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[c] *= corr;
      m = mx;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (sc[i] == -INFINITY) continue;
        const int s = base + i;
        const float p = expf(sc[i] - m);
        l += p;
#pragma unroll
        for (int c = 0; c < DPT; c += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&tl.v[s][4 * (dl + DS * (c / 4))]);
          acc[c] = fmaf(p, vv.x, acc[c]);
          acc[c + 1] = fmaf(p, vv.y, acc[c + 1]);
          acc[c + 2] = fmaf(p, vv.z, acc[c + 2]);
          acc[c + 3] = fmaf(p, vv.w, acc[c + 3]);
        }
      }
    }
  }

  // Rows that saw no key: the mean of all S values (softmax over −1e30s).
  const bool none = valid && m == -INFINITY;
  if (__syncthreads_or(none)) {
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] = 0.f;
    for (long long s0 = 0; s0 < S; s0 += BK) {
      const int len = (int)min((long long)BK, (long long)S - s0);
      __syncthreads();
      load_tile(s0, len, false);
      __syncthreads();
      if (!none) continue;
      for (int s = 0; s < len; ++s) {
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[c] += tl.v[s][4 * (dl + DS * (c / 4)) + c % 4];
      }
    }
    if (none) l = (float)S;
  }

  if (valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = 4 * (dl + DS * (c / 4)) + c % 4;
      if (d < dv) st(out, qoff * dv + d, acc[c] * inv);
    }
  }
}

template <int DM, int DS, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out, const int* qpos,
           const int* kpos, int N, int T, int S, int H, int KV, int dh, int dv, int causal,
           int has_window, long long window, float scale, cudaStream_t stream) {
  const long long rows = (long long)T * (H / KV);
  const long long blocks = (rows + THREADS / DS - 1) / (THREADS / DS);
  dim3 grid((unsigned)blocks, (unsigned)(N * KV));
  flash_kernel<DM, DS, TQ, TKV><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), qpos, kpos, T, S, H, KV, dh, dv, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <int DM, int DS>
int dispatch(int q_bf16, int kv_bf16, const void* q, const void* k, const void* v, void* out,
             const int* qpos, const int* kpos, int N, int T, int S, int H, int KV, int dh,
             int dv, int causal, int has_window, long long window, float scale,
             cudaStream_t stream) {
  using BF = __nv_bfloat16;
#define FA_ARGS q, k, v, out, qpos, kpos, N, T, S, H, KV, dh, dv, causal, has_window, window, \
                scale, stream
  if (q_bf16 && kv_bf16) return launch<DM, DS, BF, BF>(FA_ARGS);
  if (q_bf16) return launch<DM, DS, BF, float>(FA_ARGS);
  if (kv_bf16) return launch<DM, DS, float, BF>(FA_ARGS);
  return launch<DM, DS, float, float>(FA_ARGS);
#undef FA_ARGS
}
// ---------------------------------------------------------------------------
// "wgmma": bf16 prefill on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;          // query rows a block: two warpgroups of 64
constexpr int TC_BK = 64;           // keys a tile
constexpr int TC_STAGES = 3;        // K/V ring depth
constexpr int TC_THREADS = 256;     // two warpgroups; thread 0 also issues the copies
constexpr int HALF_ROWS_BYTES = 128;  // one 64-wide bf16 column half of a row

template <int DH>
struct TcSmem {
  static constexpr int HALVES = DH / 64;
  static constexpr int Q_HALF = TC_BM * HALF_ROWS_BYTES;   // 16 KB
  static constexpr int KV_HALF = TC_BK * HALF_ROWS_BYTES;  // 8 KB
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int STAGE_BYTES = 2 * HALVES * KV_HALF;  // K halves, then V halves
  static constexpr int BAR_OFF = Q_BYTES + TC_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * TC_STAGES * 8;
  // +1024: the dynamic window is aligned by hand to the 128-byte swizzle's
  // 1024-byte repeat.
  static constexpr int ALLOC = BYTES + 1024;
};

// One box {64 columns, 1 head, TC_BK keys, 1 sequence} of a [N, S, KV, dh]
// tensor into shared memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Keeps the compiler from moving reads of accumulators across the wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WG_REGS32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A·B for a 64x64 tile and 16 of K, A and B from shared memory, both
// K-major.  d is the m64n64 f32 fragment: d[4j + 2i + c] is row 16·warp +
// lane/4 + 8i, column 8j + 2·(lane%4) + c.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B with A (64x16 bf16) in registers, in the fragment layout of
// mma.m16n8k16's A per warp, and B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x by the special-function unit (relative error ≈ 2^-22; P is rounded to
// bf16 after it).  2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Grid (row tiles, N·KV), TC_THREADS threads.  Rows r = t·g + j of one (n, kv
// head); block x takes rows [128·(tiles − 1 − x), +128): the longest causal
// tiles start first.  At dh 64 two blocks share an SM (≤ 128 registers).
template <int DH>
__global__ void __launch_bounds__(TC_THREADS, DH == 64 ? 2 : 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out, int T,
                int S, int H, int KV, int causal, int has_window, long long window,
                float scale_log2) {
  using L = TcSmem<DH>;
  constexpr int HALVES = L::HALVES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t full_bar = base + L::BAR_OFF, empty_bar = full_bar + 8 * TC_STAGES;

  const int g = H / KV;
  const int n = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const long long rows = (long long)T * g;
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * TC_BM;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q: 16-byte loads into the swizzled tile (chunk c of row r at
  // r·128 + ((c ^ r%8)·16) of its column half); rows past T·g are zeros.
  for (int e = tid; e < TC_BM * (DH / 8); e += TC_THREADS) {
    const int r = e / (DH / 8), c = e % (DH / 8);
    const long long row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const long long t = row / g, j = row % g;
      const long long off = (((long long)n * T + t) * H + (long long)kvh * g + j) * DH + 8 * c;
      val = *reinterpret_cast<const uint4*>(q + off);
    }
    const int h = c / 8, cc = c % 8;
    *reinterpret_cast<uint4*>(sbase + h * L::Q_HALF + r * HALF_ROWS_BYTES +
                              ((cc ^ (r & 7)) << 4)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // The keys the block's rows see: [k_lo, k_hi).
  const long long t_lo = r0 / g;
  const long long t_hi = min((long long)T - 1, (r0 + TC_BM - 1) / g);
  const long long k_lo = has_window ? max(0LL, t_lo - window + 1) : 0;
  const long long k_hi = causal ? min((long long)S, t_hi + 1) : (long long)S;
  const int ntiles = (int)((k_hi - k_lo + TC_BK - 1) / TC_BK);

  // Tile `it` into its stage, once both warpgroups released the tile that
  // stage held before (thread 0 only).
  auto load = [&](int it) {
    const int stage = it % TC_STAGES;
    if (it >= TC_STAGES) mbar_wait(empty_bar + 8 * stage, ((it / TC_STAGES) & 1) ^ 1);
    const uint32_t fb = full_bar + 8 * stage;
    mbar_expect_tx(fb, L::STAGE_BYTES);
    const uint32_t st = base + L::Q_BYTES + stage * L::STAGE_BYTES;
    const int s0 = (int)(k_lo + (long long)it * TC_BK);
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      tma_load_4d(st + h * L::KV_HALF, &kmap, fb, 64 * h, kvh, s0, n);
      tma_load_4d(st + (HALVES + h) * L::KV_HALF, &vmap, fb, 64 * h, kvh, s0, n);
    }
  };
  if (tid == 0)
    for (int it = 0; it < TC_STAGES - 1 && it < ntiles; ++it) load(it);

  // Warpgroup wg takes rows 64·wg… of the block; a thread holds two of them.
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;
  long long trow[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = r0 + 64 * wg + 16 * warp + lane / 4 + 8 * i;
    valid[i] = row < rows;
    trow[i] = row / g;
  }
  float o[HALVES][32];
  float sacc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    sacc[x] = 0.f;
#pragma unroll
    for (int h = 0; h < HALVES; ++h) o[h][x] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t q_wg = base + 64 * wg * HALF_ROWS_BYTES;

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it % TC_STAGES;
    const long long s0 = k_lo + (long long)it * TC_BK;
    const uint32_t st = base + L::Q_BYTES + stage * L::STAGE_BYTES;
    // Refill the stage of tile it − 1 with tile it + STAGES − 1.
    if (tid == 0 && it + TC_STAGES - 1 < ntiles) load(it + TC_STAGES - 1);
    mbar_wait(full_bar + 8 * stage, (it / TC_STAGES) & 1);

    // S = Q·Kᵀ over dh in steps of 16 (32 bytes inside a 128-byte row).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int h = kk / 4, off = 32 * (kk % 4);
      wgmma_ss(sacc, sw128_desc(q_wg + h * L::Q_HALF + off),
               sw128_desc(st + h * L::KV_HALF + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // Online softmax on the fragment; the mask only where the tile straddles.
    const bool inside = (!causal || s0 + TC_BK - 1 <= t_lo) &&
                        (!has_window || t_hi - s0 < window) && s0 + TC_BK <= S;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sacc[4 * jj + 2 * i + c] * scale_log2;
          if (!inside) {
            const long long s = s0 + 8 * jj + 2 * quad + c;
            const bool seen = s < S && (!causal || trow[i] >= s) &&
                              (!has_window || trow[i] - s < window);
            if (!seen) x = -INFINITY;
          }
          sacc[4 * jj + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float mref[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mref[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row with nothing seen yet
      const float corr = fast_exp2(m[i] - mref[i]);  // 0 while m = −inf
      m[i] = mx[i];
      l[i] *= corr;
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          o[h][4 * jj + 2 * i] *= corr;
          o[h][4 * jj + 2 * i + 1] *= corr;
        }
    }
    // P in bf16 as wgmma's register A operand: keys 16kk..16kk+15 are
    // accumulator columns of j = 2kk, 2kk + 1, already in A's layout.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = (e / 2) % 2;
        p[e] = fast_exp2(sacc[8 * kk + e] - mref[i]);
        l[i] += p[e];
      }
      pa[kk][0] = pack_bf16(p[0], p[1]);
      pa[kk][1] = pack_bf16(p[2], p[3]);
      pa[kk][2] = pack_bf16(p[4], p[5]);
      pa[kk][3] = pack_bf16(p[6], p[7]);
    }

    // O += P·V: V [key, dv] is B in MN-major form; 16 keys are two 1024-byte
    // swizzle groups.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        wgmma_rs(o[h], pa[kk], sw128_desc(st + (HALVES + h) * L::KV_HALF + 2048 * kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) fence_regs(o[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
  }

  // Row sums over the quad, then O / l as bf16 pairs.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (!valid[i]) continue;
    const long long row = r0 + 64 * wg + 16 * warp + lane / 4 + 8 * i;
    const long long t = row / g, j = row % g;
    __nv_bfloat16* dst = out + (((long long)n * T + t) * H + (long long)kvh * g + j) * DH;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 64 * h + 8 * jj + 2 * quad;
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(o[h][4 * jj + 2 * i] * inv, o[h][4 * jj + 2 * i + 1] * inv);
      }
  }
}

// The map of a bf16 [N, S, KV, dh] tensor, boxes of {64, 1, TC_BK, 1},
// 128-byte swizzle, zeros past the edges.
bool kv_map(CUtensorMap* map, const void* x, int N, int S, int KV, int dh) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)KV, (cuuint64_t)S, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)KV * dh * 2,
                                 (cuuint64_t)S * KV * dh * 2};
  const cuuint32_t box[4] = {64, 1, TC_BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* out, int N, int T, int S, int H,
              int KV, int causal, int has_window, long long window, float scale,
              cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!kv_map(&kmap, k, N, S, KV, DH) || !kv_map(&vmap, v, N, S, KV, DH))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, TcSmem<DH>::ALLOC);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long rows = (long long)T * (H / KV);
  dim3 grid((unsigned)((rows + TC_BM - 1) / TC_BM), (unsigned)(N * KV));
  flash_tc_kernel<DH><<<grid, TC_THREADS, TcSmem<DH>::ALLOC, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), T, S,
      H, KV, causal, has_window, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// "split": decode and short prompts on CUDA cores, the keys split over blocks
//
// Replaces, for the calls whose T·g rows a KV head are fewer than 64 (decode,
// T = 1; short prompts), the Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:78).  Bound on the H100: bytes.  The
// cache is read once: at Hymba-1.5B's decode (batch 4, 5 KV heads of 64,
// float32 cache) 10.5 MB for a ring of 1024 and 21 MB for a global cache of
// 2048, 3.1 and 6.3 µs at 3.35 TB/s, against 2·(dh + dv) operations a seen
// (query, key) pair for g = 5 query rows: 2 operations a byte, far below the
// ridge, so no tensor cores.  The "simt" design gave decode's 5 rows of a KV
// head 32 threads each: 2 blocks an (n, KV head), each reading that head's
// whole K and V, 40 blocks on 132 SMs, every tile behind a __syncthreads
// pair (7–10× SDPA's device time).  Here:
//   * one block per (n, KV head, split of the S keys, 8 query rows): every
//     query head of the KV head in one block, so each K/V element is read
//     from device memory once; the wrapper sizes the splits
//     (flash_attention.split_keys) so the grid fills the SMs (Hymba's
//     decode: 20 (n, KV head) pairs);
//   * each warp stages its own keys KW at a time (K and V rows, and their
//     positions) by 16-byte cp.async, neighbouring lanes on neighbouring
//     addresses, two stages in flight, and waits on its own copies: no
//     barrier in the key loop; the stage after next goes out as soon as a
//     stage is read;
//   * q·k with a lane on a key (DS lanes a key above dh 64, added by
//     shuffle), P·V with a lane on its dims of V; float32 throughout;
//   * each split writes its partial (m, l, acc[dv]) per query row to scratch
//     (the wrapper's torch.empty); the last block of an (n, KV head, row
//     group) to arrive (an atomic ticket the wrapper's counters hold, back
//     at 0 after each launch) merges its rows' splits in split order, so
//     repeats give the same bits and no second launch waits on the first; a
//     row no split saw a key of takes the mean of all S values there.
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 128;  // four warps, each owning its keys
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;
constexpr int SPLIT_ROWS = 8;       // query rows a block: every g ≤ 8 decode in one
constexpr int QSEG = 36;            // a 32-dim segment of a staged q row, padded

// Dynamic shared memory of an instance: the block's q rows (float32, 32-dim
// segments padded by 4 floats, so the DS dimension lanes of a key read them
// without conflict); then per warp two stages of KW keys (K rows then V rows
// in the cache's type, each padded by 16 bytes, so lanes reading 16 bytes of
// neighbouring rows hit different banks), the stages' key positions, and p
// [KW][ROWS].  After the key loop the same bytes hold the four warps' states.
template <int DM, typename TKV>
struct SplitSmem {
  static constexpr int KW = 1024 / DM;  // keys a warp stages at once: 16, 8, 4
  static constexpr int ROW = DM + 16 / (int)sizeof(TKV);  // elements a staged row
  static constexpr int QROW = (DM / 32) * QSEG;            // floats a staged q row
  static constexpr int Q_BYTES = 4 * SPLIT_ROWS * QROW;
  static constexpr int STAGE_BYTES = 2 * KW * ROW * (int)sizeof(TKV);
  static constexpr int WARP_BYTES = 2 * STAGE_BYTES + 4 * 2 * KW + 4 * KW * SPLIT_ROWS;
  static constexpr int STATE_BYTES = 4 * SPLIT_WARPS * SPLIT_ROWS * (DM + 2);  // m, l, acc[DM]
  static constexpr int BYTES = Q_BYTES + (SPLIT_WARPS * WARP_BYTES > STATE_BYTES
                                              ? SPLIT_WARPS * WARP_BYTES
                                              : STATE_BYTES);
};

// One cp.async of `bytes` ∈ {16, 8, 4} (2: a plain copy, for a bf16 cache
// whose base is not 4-byte aligned); zeros where `in` is false.
__device__ __forceinline__ void copy_chunk(void* dst, const void* src, int bytes, bool in) {
  const uint32_t d = smem_u32(dst);
  const int n = in ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    *static_cast<uint16_t*>(dst) = in ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// 4 consecutive elements of a staged row as floats (8- or 16-byte aligned).
__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void ld2(const float* p, float (&x)[4]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x, x[1] = t.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float (&x)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  x[0] = a.x, x[1] = a.y;
}

// The dimension of V a lane owns at its e-th of DM/32 values: two
// consecutive at DM = 64, four at 128, two groups of four 128 apart at 256
// (neighbouring lanes on neighbouring addresses).
template <int DM>
__device__ __forceinline__ int pv_dim(int lane, int e) {
  return DM == 64 ? 2 * lane + e : 128 * (e / 4) + 4 * lane + e % 4;
}

// Grid (splits, N·KV, row groups of SPLIT_ROWS): block (x, y, z) takes keys
// [x·chunk, (x+1)·chunk) ∩ [0, S) of (n, kv head) y for the query rows r =
// t·g + j in [8z, 8z + 8).  Warp w takes keys base = w·KW, w·KW + 4·KW, …
// of the split, staging them by cp.async two stages ahead into its own
// buffers (no block barrier in the key loop): lane (kl, dl) = (lane % KW,
// lane / KW) takes q·k of key kl over dims [32·dl, 32·dl + 32) for all eight
// rows (rows past the block's are computed and dropped: the rows' chains
// interleave), the DS lanes adding by shuffle; an online softmax per row
// over the warp's keys (the max by shuffles, p to shared memory); then P·V
// with the lane on its DM/32 dims of V.  At the end the four warps' (m, l,
// acc) are merged in warp order and written, unnormalised, as the split's
// partial: part[((y·R + r)·splits + x)·dv + d], and (m, l) at ml[((y·R +
// r)·splits + x)·2]; the last block to arrive merges the splits into out.
template <int DM, typename TQ, typename TKV>
__global__ void __launch_bounds__(SPLIT_THREADS)
flash_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const int* __restrict__ qpos,
                   const int* __restrict__ kpos, float* __restrict__ part, float* __restrict__ ml,
                   unsigned* __restrict__ tickets, TQ* __restrict__ out, int T, int S, int H,
                   int KV, int dh, int dv, int causal, int has_window, long long window,
                   float scale, int chunk, int copy_bytes) {
  using L = SplitSmem<DM, TKV>;
  constexpr int KW = L::KW, ROW = L::ROW, QROW = L::QROW, DPL = DM / 32;
  extern __shared__ __align__(16) uint8_t split_smem[];
  __shared__ int is_last;
  float* qs = reinterpret_cast<float*>(split_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint8_t* own = split_smem + L::Q_BYTES + warp * L::WARP_BYTES;
  TKV* kv_st = reinterpret_cast<TKV*>(own);                         // [2][K rows, V rows]
  int* kp_st = reinterpret_cast<int*>(own + 2 * L::STAGE_BYTES);    // [2][KW]
  float* ps = reinterpret_cast<float*>(own + 2 * L::STAGE_BYTES + 8 * KW);  // [KW][ROWS]

  const int g = H / KV, R = T * g, splits = gridDim.x;
  const int n = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = SPLIT_ROWS * blockIdx.z;
  const int rows = min(SPLIT_ROWS, R - r0);
  long long s_lo = (long long)blockIdx.x * chunk;
  long long s_hi = min((long long)S, s_lo + chunk);

  // Query positions of the block's rows (past its rows: the last row's);
  // with default key positions the keys its rows can see bound the visit
  // (causal end, window start).
  int qp[SPLIT_ROWS];
  long long q_lo = LLONG_MAX, q_hi = LLONG_MIN;
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    const int t = (r0 + min(r, rows - 1)) / g;
    qp[r] = qpos ? qpos[t] : t;
    q_lo = min(q_lo, (long long)qp[r]);
    q_hi = max(q_hi, (long long)qp[r]);
  }
  if (!kpos) {
    if (causal) s_hi = min(s_hi, q_hi + 1);
    if (has_window) s_lo = max(s_lo, q_lo - window + 1);
  }

  // Stage keys [base, base + KW) ∩ [s_lo, s_hi) of this warp into buffer
  // `buf`, zeros past them; columns past dh / dv keep the zeros written
  // below.  A row is `per` copies; lane l takes copies l, l + 32, … of the
  // KW rows in turn.
  const TKV* kh = k + (long long)n * S * KV * dh + (long long)kvh * dh;
  const TKV* vh = v + (long long)n * S * KV * dv + (long long)kvh * dv;
  auto copy_rows = [&](TKV* dst, const TKV* src, long long stride, int per, long long base) {
    const int dk = 32 / per, dc = 32 % per;
    for (int key = lane / per, c = lane % per; key < KW;) {
      const long long s = base + key;
      const bool in = s < s_hi;
      copy_chunk(reinterpret_cast<uint8_t*>(dst + key * ROW) + c * copy_bytes,
                 reinterpret_cast<const uint8_t*>(src + (in ? s : 0) * stride) + c * copy_bytes,
                 copy_bytes, in);
      key += dk;
      c += dc;
      if (c >= per) c -= per, ++key;
    }
  };
  const int kchunks = dh * (int)sizeof(TKV) / copy_bytes, vchunks = dv * (int)sizeof(TKV) / copy_bytes;
  auto stage = [&](long long base, int buf) {
    TKV* st_k = kv_st + buf * 2 * KW * ROW;
    copy_rows(st_k, kh, (long long)KV * dh, kchunks, base);
    copy_rows(st_k + KW * ROW, vh, (long long)KV * dv, vchunks, base);
    if (kpos && lane < KW) {
      const long long s = base + lane;
      copy_chunk(kp_st + buf * KW + lane, kpos + (s < s_hi ? s : 0), 4, s < s_hi);
    }
  };
  const long long step = (long long)SPLIT_WARPS * KW;
  long long base = s_lo + (long long)warp * KW;
  // Two stages in flight while q is read (a group each, empty past the keys).
  if (base < s_hi) stage(base, 0);
  cp_commit();
  if (base + step < s_hi) stage(base + step, 1);
  cp_commit();

  // Zero both stages' columns past dh and dv (never copied into), and read
  // the block's q rows into shared memory as float32, zeros past dh.
  for (int e = lane; e < 2 * KW * (DM - dh); e += 32)
    kv_st[(e / (KW * (DM - dh))) * 2 * KW * ROW + (e % (KW * (DM - dh))) / (DM - dh) * ROW + dh +
          e % (DM - dh)] = TKV(0.f);
  for (int e = lane; e < 2 * KW * (DM - dv); e += 32)
    kv_st[(e / (KW * (DM - dv))) * 2 * KW * ROW + KW * ROW + (e % (KW * (DM - dv))) / (DM - dv) * ROW +
          dv + e % (DM - dv)] = TKV(0.f);
  for (int e = threadIdx.x; e < SPLIT_ROWS * DM; e += SPLIT_THREADS) {
    const int r = e / DM, d = e % DM;
    float x = 0.f;
    if (r < rows && d < dh) {
      const int row = r0 + r, t = row / g, j = row % g;
      x = ld(q, (((long long)n * T + t) * H + (long long)kvh * g + j) * dh + d);
    }
    qs[r * QROW + (d / 32) * QSEG + d % 32] = x;
  }
  __syncthreads();

  const int kl = lane % KW, dl = lane / KW;
  float m[SPLIT_ROWS], l[SPLIT_ROWS], acc[SPLIT_ROWS][DPL];
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  for (int buf = 0; base < s_hi; base += step, buf ^= 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this stage's group is in
    __syncwarp();
    const TKV* ks = kv_st + buf * 2 * KW * ROW;
    const TKV* vs = ks + KW * ROW;
    const long long key = base + kl;
    const int kp = key < s_hi ? (kpos ? kp_st[buf * KW + kl] : (int)key) : -1;

    // q·k of key kl over the lane's 32 dims, for every row.
    float sc[SPLIT_ROWS];
#pragma unroll
    for (int r = 0; r < SPLIT_ROWS; ++r) sc[r] = 0.f;
    const TKV* kr = ks + kl * ROW + 32 * dl;
#pragma unroll
    for (int c = 0; c < 32; c += 4) {
      float kk[4];
      ld4(kr + c, kk);
#pragma unroll
      for (int r = 0; r < SPLIT_ROWS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + r * QROW + dl * QSEG + c);
        sc[r] = fmaf(qq.x, kk[0], fmaf(qq.y, kk[1], fmaf(qq.z, kk[2], fmaf(qq.w, kk[3], sc[r]))));
      }
    }
    // The DS dimension lanes of a key (KW apart) add their partials; then
    // the online softmax over the warp's KW keys, row by row.
#pragma unroll
    for (int r = 0; r < SPLIT_ROWS; ++r) {
#pragma unroll
      for (int off = KW; off < 32; off *= 2) sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
      const bool seen = kp >= 0 && (!causal || qp[r] >= kp) &&
                        (!has_window || (long long)qp[r] - kp < window);
      const float x = seen ? sc[r] * scale : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = KW / 2; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const bool none = mn == -INFINITY;   // nothing seen yet: the state stays zero
      const float corr = none ? 1.f : expf(m[r] - mn);  // 0 while m = −inf
      const float p = none ? 0.f : expf(x - mn);        // 0 for a masked key
      m[r] = mn;
      l[r] = l[r] * corr + (dl == 0 ? p : 0.f);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
      if (dl == 0) ps[kl * SPLIT_ROWS + r] = p;
    }
    __syncwarp();

    // P·V over the stage's keys (p = 0 and zeros past the split), the lane
    // on its dims of V.
#pragma unroll
    for (int s = 0; s < KW; ++s) {
      float pr[SPLIT_ROWS];
      const float4 p0 = *reinterpret_cast<const float4*>(ps + s * SPLIT_ROWS);
      const float4 p1 = *reinterpret_cast<const float4*>(ps + s * SPLIT_ROWS + 4);
      pr[0] = p0.x, pr[1] = p0.y, pr[2] = p0.z, pr[3] = p0.w;
      pr[4] = p1.x, pr[5] = p1.y, pr[6] = p1.z, pr[7] = p1.w;
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; e += 4) {
        float x[4];
        if (DM == 64)
          ld2(vs + s * ROW + pv_dim<DM>(lane, 0), x);
        else
          ld4(vs + s * ROW + pv_dim<DM>(lane, e), x);
#pragma unroll
        for (int i = 0; i < 4 && e + i < DPL; ++i) vv[e + i] = x[i];
      }
#pragma unroll
      for (int r = 0; r < SPLIT_ROWS; ++r)
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pr[r], vv[e], acc[r][e]);
    }
    __syncwarp();  // the stage and p are read: the keys two stages on may land
    if (base + 2 * step < s_hi) stage(base + 2 * step, buf);
    cp_commit();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // The warps' states into shared memory, then merged in warp order.
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r)
#pragma unroll
    for (int off = 16; off > 0; off /= 2) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  __syncthreads();  // every warp is done with its stages
  float* state = reinterpret_cast<float*>(split_smem + L::Q_BYTES);
  float* mine = state + warp * SPLIT_ROWS * (DM + 2);
#pragma unroll
  for (int r = 0; r < SPLIT_ROWS; ++r) {
    if (lane == 0) mine[r * (DM + 2)] = m[r], mine[r * (DM + 2) + 1] = l[r];
#pragma unroll
    for (int e = 0; e < DPL; ++e) mine[r * (DM + 2) + 2 + pv_dim<DM>(lane, e)] = acc[r][e];
  }
  __syncthreads();
  const long long row0 = (long long)blockIdx.y * R + r0;  // the first row's index in ml
  for (int e = threadIdx.x; e < rows * (dv + 1); e += SPLIT_THREADS) {
    const int r = e / (dv + 1), d = e % (dv + 1) - 1;  // d = −1: (m, l)
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) mx = fmaxf(mx, state[(w * SPLIT_ROWS + r) * (DM + 2)]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float* sw = state + (w * SPLIT_ROWS + r) * (DM + 2);
      const float c = mx == -INFINITY ? 0.f : expf(sw[0] - mx);
      sum += c * (d < 0 ? sw[1] : sw[2 + d]);
    }
    const long long slot = (row0 + r) * splits + blockIdx.x;
    if (d < 0) {
      ml[2 * slot] = mx;
      ml[2 * slot + 1] = sum;
    } else {
      part[slot * dv + d] = sum;
    }
  }

  // The last block of (n, kv head, row group) to arrive merges every
  // split's partial: out = Σ_x e^(m_x − M) acc_x / Σ_x e^(m_x − M) l_x with
  // M the largest m_x, summed in split order; a row no split saw a key of
  // takes the mean of all S values.  atomicInc wraps the ticket back to 0.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicInc(&tickets[blockIdx.y * gridDim.z + blockIdx.z], splits - 1) ==
              (unsigned)(splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // A thread a row and 4 dims: every split's (m, l) and acc in one round of
  // loads, then an online merge in split order.
  const int dv4 = dv / 4;
  for (int e = threadIdx.x; e < rows * dv4; e += SPLIT_THREADS) {
    const int r = e / dv4, d = 4 * (e % dv4), row = r0 + r, t = row / g, j = row % g;
    TQ* o = out + (((long long)n * T + t) * H + (long long)kvh * g + j) * dv + d;
    const float2* mlr = reinterpret_cast<const float2*>(ml) + (row0 + r) * splits;
    const float4* pr = reinterpret_cast<const float4*>(part + ((row0 + r) * splits * dv + d));
    float M = -INFINITY, lsum = 0.f, sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
    for (int x = 0; x < splits; ++x) {
      const float2 mlx = __ldcg(mlr + x);
      const float4 a = __ldcg(pr + (long long)x * dv4);
      const float mn = fmaxf(M, mlx.x);
      const float c = mn == -INFINITY ? 1.f : expf(M - mn);  // 0 while M = −inf
      const float w = mlx.x == -INFINITY ? 0.f : expf(mlx.x - mn);
      M = mn;
      lsum = fmaf(w, mlx.y, lsum * c);
      sum[0] = fmaf(w, a.x, sum[0] * c);
      sum[1] = fmaf(w, a.y, sum[1] * c);
      sum[2] = fmaf(w, a.z, sum[2] * c);
      sum[3] = fmaf(w, a.w, sum[3] * c);
    }
    if (M == -INFINITY) {  // no split saw a key: the mean of all S values
      for (long long s = 0; s < S; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[i] += ld(vh, s * KV * dv + d + i);
#pragma unroll
      for (int i = 0; i < 4; ++i) st(o, i, sum[i] / (float)S);
    } else {
      const float inv = 1.f / lsum;
#pragma unroll
      for (int i = 0; i < 4; ++i) st(o, i, sum[i] * inv);
    }
  }
}

template <int DM, typename TQ, typename TKV>
int launch_split(const void* q, const void* k, const void* v, void* out, const int* qpos,
                 const int* kpos, float* part, unsigned* tickets, int N, int T, int S, int H,
                 int KV, int dh, int dv, int causal, int has_window, long long window,
                 float scale, int chunk, cudaStream_t stream) {
  // The widest copy the rows' widths and the bases allow.
  int bytes = 16;
  while (bytes > 2 && ((dh * (int)sizeof(TKV)) % bytes || (dv * (int)sizeof(TKV)) % bytes ||
                       (uintptr_t)k % bytes || (uintptr_t)v % bytes))
    bytes /= 2;
  const int R = T * (H / KV);
  const int splits = (int)(((long long)S + chunk - 1) / chunk);
  float* ml = part + (long long)N * KV * R * splits * dv;
  using L = SplitSmem<DM, TKV>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_split_kernel<DM, TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)splits, (unsigned)(N * KV), (unsigned)((R + SPLIT_ROWS - 1) / SPLIT_ROWS));
  flash_split_kernel<DM, TQ, TKV><<<grid, SPLIT_THREADS, L::BYTES, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), qpos,
      kpos, part, ml, tickets, static_cast<TQ*>(out), T, S, H, KV, dh, dv, causal, has_window,
      window, scale, chunk, bytes);
  return (int)cudaGetLastError();
}

template <int DM>
int dispatch_split(int q_bf16, int kv_bf16, const void* q, const void* k, const void* v, void* out,
                   const int* qpos, const int* kpos, float* part, unsigned* tickets, int N, int T,
                   int S, int H, int KV, int dh, int dv, int causal, int has_window,
                   long long window, float scale, int chunk, cudaStream_t stream) {
  using BF = __nv_bfloat16;
#define FS_ARGS q, k, v, out, qpos, kpos, part, tickets, N, T, S, H, KV, dh, dv, causal, \
                has_window, window, scale, chunk, stream
  if (q_bf16 && kv_bf16) return launch_split<DM, BF, BF>(FS_ARGS);
  if (q_bf16) return launch_split<DM, BF, float>(FS_ARGS);
  if (kv_bf16) return launch_split<DM, float, BF>(FS_ARGS);
  return launch_split<DM, float, float>(FS_ARGS);
#undef FS_ARGS
}

}  // namespace

// The "simt" design: dh, dv multiples of 4, at most SIMT_MAX_DIM; a query
// row takes the instance's dimension lanes (1; 4 above dh, dv = 64; 8 above
// 128).  window ≤ 0 with has_window set masks every key.  Returns a
// cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const int* qpos, const int* kpos, int N, int T, int S,
                                      int H, int KV, int dh, int dv, int causal,
                                      int has_window, long long window, float scale,
                                      int q_bf16, int kv_bf16, cudaStream_t stream) {
  if (KV <= 0 || H % KV || N * KV > 65535 || dh % 4 || dv % 4)
    return (int)cudaErrorInvalidValue;
  if (dh > SIMT_MAX_DIM || dv > SIMT_MAX_DIM) return (int)cudaErrorInvalidValue;
#define FA_ARGS q_bf16, kv_bf16, q, k, v, out, qpos, kpos, N, T, S, H, KV, dh, dv, causal, \
                has_window, window, scale
  const int dm = dh > dv ? dh : dv;
  if (dm <= 64) return dispatch<64, 1>(FA_ARGS, stream);
  if (dm <= 128) return dispatch<128, 4>(FA_ARGS, stream);
  return dispatch<256, 8>(FA_ARGS, stream);
#undef FA_ARGS
}

// The "wgmma" design: q, k, v, out bf16 [N,T,H,dh], [N,S,KV,dh] (twice),
// [N,T,H,dh], dh ∈ {64, 128}, T ≤ S, positions arange, window ≥ 1 when set;
// 16-byte aligned.  Returns a cudaError_t.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out,
                                         int N, int T, int S, int H, int KV, int dh, int causal,
                                         int has_window, long long window, float scale,
                                         cudaStream_t stream) {
  if (KV <= 0 || H % KV || N * KV > 65535 || T > S || (has_window && window < 1) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return launch_tc<64>(q, k, v, out, N, T, S, H, KV, causal, has_window, window, scale, stream);
  if (dh == 128)
    return launch_tc<128>(q, k, v, out, N, T, S, H, KV, causal, has_window, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The "split" design: dh, dv multiples of 4, at most SIMT_MAX_DIM; q and
// k/v each float32 or bf16; `chunk` keys a split (≥ 1), so ⌈S / chunk⌉
// splits; `part` holds N·KV·R·splits·(dv + 2) floats (R =
// T·H/KV), written before they are read; `tickets` N·KV·⌈R / 8⌉ counters
// that are 0, and are 0 again when the launch has run.  window ≤ 0 with
// has_window set masks every key.  One launch.  Returns a cudaError_t.
extern "C" int flash_attention_split_launch(const void* q, const void* k, const void* v,
                                            void* out, const int* qpos, const int* kpos,
                                            float* part, unsigned* tickets, int N, int T, int S,
                                            int H, int KV,
                                            int dh, int dv, int causal, int has_window,
                                            long long window, float scale, int q_bf16,
                                            int kv_bf16, int chunk, cudaStream_t stream) {
  if (KV <= 0 || H % KV || N * KV > 65535 || dh % 4 || dv % 4 || dh <= 0 || dv <= 0 ||
      dh > SIMT_MAX_DIM || dv > SIMT_MAX_DIM || chunk < 1 ||
      ((long long)T * (H / KV) + SPLIT_ROWS - 1) / SPLIT_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
#define FS_ARGS q_bf16, kv_bf16, q, k, v, out, qpos, kpos, part, tickets, N, T, S, H, KV, dh, dv, \
                causal, has_window, window, scale, chunk, stream
  const int dm = dh > dv ? dh : dv;
  if (dm <= 64) return dispatch_split<64>(FS_ARGS);
  if (dm <= 128) return dispatch_split<128>(FS_ARGS);
  return dispatch_split<256>(FS_ARGS);
#undef FS_ARGS
}
