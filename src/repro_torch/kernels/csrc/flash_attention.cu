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
// TFLOP/s bf16.  Two designs; the wrapper picks one (flash_attention.design):
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
// "simt" — everything else (float32, bf16 queries against the float32
// cache, given positions (decode), fully masked rows, any dh and dv that are
// multiples of 4 up to 256, dh ≠ dv allowed), on CUDA cores, all arithmetic
// float32:
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
//   * few rows (decode: T = 1, g = 5) give each row TPR threads, each taking
//     every TPR-th key, merged at the end by warp shuffles;
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

// Grid (row tiles, N·KV); rows r = t·g + j of one (n, kv head), THREADS/tpr
// of them a block.  DM ≥ dh, dv, padded with zeros: instances DM = 64, 128
// and 256.  A row's tpr threads are DS dimension lanes (the low bits of the
// lane) times tpr/DS key lanes.  Each thread keeps DPT = DM/DS dims of q and
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
             long long window, float scale, int tpr) {
  using Tl = Tiles<DM>;
  constexpr int BK = Tl::BK;
  constexpr int DPT = DM / DS;
  __shared__ __align__(16) Tl tl;
  __shared__ int q_lo, q_hi;
  const int g = H / KV;
  const int n = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int rows_per_block = THREADS / tpr;
  const int lane = threadIdx.x % tpr;
  const int kl = lane / DS, dl = lane % DS, kls = tpr / DS;  // key lane, dim lane, key lanes
  // The DS lanes of one key lane, for their shuffles (aligned, inside a warp).
  static_assert(DS < 32 && (DS & (DS - 1)) == 0, "DS: a power of two below 32");
  const unsigned dmask = ((1u << DS) - 1) << ((threadIdx.x & 31) & ~(DS - 1));
  const long long row = (long long)blockIdx.x * rows_per_block + threadIdx.x / tpr;
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
  if (valid && lane == 0) {
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
    // 16 keys a step (every kls-th key of the tile from this key lane):
    // their logits, one rescale, their values.
    for (int base = kl; base < len; base += 16 * kls) {
      float sc[16];
      float mx = m;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int s = base + i * kls;
        sc[i] = -INFINITY;
        if (s < len && seen(tl.kp[s])) {  // the same for the DS lanes of a key lane
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
        const int s = base + i * kls;
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

  // Merge the key lanes of a row (aligned groups inside one warp; the lanes
  // DS·2^i apart hold the same dims).
  for (int off = tpr / 2; off >= DS; off /= 2) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float c1 = mn == -INFINITY ? 0.f : expf(m - mn);
    const float c2 = mn == -INFINITY ? 0.f : expf(mo - mn);
    l = l * c1 + lo * c2;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[c], off);
      acc[c] = acc[c] * c1 + ao * c2;
    }
    m = mn;
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
      for (int s = kl; s < len; s += kls) {
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[c] += tl.v[s][4 * (dl + DS * (c / 4)) + c % 4];
      }
    }
    for (int off = tpr / 2; off >= DS; off /= 2) {
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
    if (none) l = (float)S;
  }

  if (valid && kl == 0) {
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
           int has_window, long long window, float scale, int tpr, cudaStream_t stream) {
  if (tpr < DS) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)T * (H / KV);
  const long long blocks = (rows + THREADS / tpr - 1) / (THREADS / tpr);
  dim3 grid((unsigned)blocks, (unsigned)(N * KV));
  flash_kernel<DM, DS, TQ, TKV><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), qpos, kpos, T, S, H, KV, dh, dv, causal, has_window, window, scale,
      tpr);
  return (int)cudaGetLastError();
}

template <int DM, int DS>
int dispatch(int q_bf16, int kv_bf16, const void* q, const void* k, const void* v, void* out,
             const int* qpos, const int* kpos, int N, int T, int S, int H, int KV, int dh,
             int dv, int causal, int has_window, long long window, float scale, int tpr,
             cudaStream_t stream) {
  using BF = __nv_bfloat16;
#define FA_ARGS q, k, v, out, qpos, kpos, N, T, S, H, KV, dh, dv, causal, has_window, window, \
                scale, tpr, stream
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

}  // namespace

// The "simt" design: dh, dv multiples of 4, at most SIMT_MAX_DIM.  tpr:
// threads a query row, a power of two ≤ 32, raised to the instance's
// dimension lanes (4 above dh, dv = 64, 8 above 128).  window ≤ 0 with
// has_window set masks every key.  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const int* qpos, const int* kpos, int N, int T, int S,
                                      int H, int KV, int dh, int dv, int causal,
                                      int has_window, long long window, float scale,
                                      int q_bf16, int kv_bf16, int tpr, cudaStream_t stream) {
  if (KV <= 0 || H % KV || tpr <= 0 || tpr > 32 || (tpr & (tpr - 1)) || N * KV > 65535 ||
      dh % 4 || dv % 4)
    return (int)cudaErrorInvalidValue;
  if (dh > SIMT_MAX_DIM || dv > SIMT_MAX_DIM) return (int)cudaErrorInvalidValue;
#define FA_ARGS q_bf16, kv_bf16, q, k, v, out, qpos, kpos, N, T, S, H, KV, dh, dv, causal, \
                has_window, window, scale
  const int dm = dh > dv ? dh : dv;
  if (dm <= 64) return dispatch<64, 1>(FA_ARGS, tpr, stream);
  if (dm <= 128) return dispatch<128, 4>(FA_ARGS, tpr < 4 ? 4 : tpr, stream);
  return dispatch<256, 8>(FA_ARGS, tpr < 8 ? 8 : tpr, stream);
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
