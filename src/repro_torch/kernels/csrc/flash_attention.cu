// Causal, optionally sliding-window GQA attention with an online softmax:
//   out[n,t,h] = Σ_s softmax_s(q[n,t,h]·k[n,s,kv(h)] · scale, masked) v[n,s,kv(h)],
// q [N,T,H,dh], k [N,S,KV,dh], v [N,S,KV,dv], H = KV·g, out [N,T,H,dv] in q's
// type.  q and k/v are each float32 or bfloat16 (decode reads a float32 KV
// cache with bfloat16 queries); all arithmetic is float32.
//
// Replaces the Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:78, body _kernel :25), and computes
// what nn/functional.sdpa computes: the key s is seen by the query t when
// qp[t] ≥ kp[s] (causal), qp[t] − kp[s] < window and kp[s] ≥ 0 (ring slots not
// yet written), with the positions arange unless given (the decode path's
// ring cache gives them).  A masked logit is −1e30 in sdpa: it adds exactly
// 0 to a row that sees any key, and a row that sees none is the uniform
// average of all S values; the kernel skips masked keys and computes that
// average in a second pass for such rows only.
//
// Bound on the H100: operations (2·dh + 2·dv per seen (query, key) pair); at
// the prefill shapes (T = S = 2048, g = 5) the K/V tiles are read once per
// 128 query rows.  Design, simple first (CUDA cores, no tensor cores):
//   * one block per (n, kv head, tile of 128 query rows), the rows taken as
//     (t, j) for the g = H/KV query heads j of that KV head, so the g heads
//     share each K/V tile, as the Pallas kernel's [bq, g, dh] block does;
//   * unlike the TPU kernel, which takes the whole [S, dh] K and V of a head
//     into VMEM, K/V stream through shared memory 64 keys at a time (4096
//     floats each, rows padded by 4 floats: float4 reads conflict-free);
//   * each row keeps its query, its running max m, sum l and accumulator
//     acc[dv] in registers, and rescales once per 16 keys;
//   * with default key positions the block visits only the tiles its rows
//     can see (causal end, window start); with given key positions it visits
//     all S keys and masks each;
//   * few rows (decode: T = 1, g = 5) give each row TPR threads, each taking
//     every TPR-th key, merged at the end by warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <math.h>

namespace {

constexpr int THREADS = 128;

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

// Grid (row tiles, N·KV); rows r = t·g + j of one (n, kv head), THREADS/TPR
// of them a block.  DM ≥ dh, dv: the one instance is DM = 64 (wider heads
// would spill the 2·DM registers of q and acc; they come with the archs that
// have them).
template <int DM, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
             TQ* __restrict__ out, const int* __restrict__ qpos, const int* __restrict__ kpos,
             int T, int S, int H, int KV, int dh, int dv, int causal, int has_window,
             long long window, float scale, int tpr) {
  using Tl = Tiles<DM>;
  constexpr int BK = Tl::BK;
  __shared__ __align__(16) Tl tl;
  __shared__ int q_lo, q_hi;
  const int g = H / KV;
  const int n = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int rows_per_block = THREADS / tpr;
  const int lane = threadIdx.x % tpr;
  const long long row = (long long)blockIdx.x * rows_per_block + threadIdx.x / tpr;
  const bool valid = row < (long long)T * g;
  const int t = valid ? (int)(row / g) : 0, j = valid ? (int)(row % g) : 0;
  const long long qoff = (((long long)n * T + t) * H + (long long)kvh * g + j);
  const long long qp = qpos ? (long long)qpos[t] : (long long)t;

  float qr[DM], acc[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    qr[d] = (valid && d < dh) ? ld(q, qoff * dh + d) : 0.f;
    acc[d] = 0.f;
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
    // 16 keys a step (every tpr-th key of the tile from this lane): their
    // logits, one rescale, their values.
    for (int base = lane; base < len; base += 16 * tpr) {
      float sc[16];
      float mx = m;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int s = base + i * tpr;
        sc[i] = -INFINITY;
        if (s < len && seen(tl.kp[s])) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DM; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(&tl.k[s][d]);
            dot = fmaf(qr[d], kk.x, dot);
            dot = fmaf(qr[d + 1], kk.y, dot);
            dot = fmaf(qr[d + 2], kk.z, dot);
            dot = fmaf(qr[d + 3], kk.w, dot);
          }
          sc[i] = dot * scale;
          mx = fmaxf(mx, sc[i]);
        }
      }
      if (mx == -INFINITY) continue;  // nothing seen yet
      const float corr = expf(m - mx);  // 0 when m = −inf
      l *= corr;
#pragma unroll
      for (int d = 0; d < DM; ++d) acc[d] *= corr;
      m = mx;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (sc[i] == -INFINITY) continue;
        const int s = base + i * tpr;
        const float p = expf(sc[i] - m);
        l += p;
#pragma unroll
        for (int d = 0; d < DM; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&tl.v[s][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
    }
  }

  // Merge the tpr lanes of a row (aligned groups inside one warp).
  for (int off = tpr / 2; off > 0; off /= 2) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float c1 = mn == -INFINITY ? 0.f : expf(m - mn);
    const float c2 = mn == -INFINITY ? 0.f : expf(mo - mn);
    l = l * c1 + lo * c2;
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * c1 + ao * c2;
    }
    m = mn;
  }

  // Rows that saw no key: the mean of all S values (softmax over −1e30s).
  const bool none = valid && m == -INFINITY;
  if (__syncthreads_or(none)) {
#pragma unroll
    for (int d = 0; d < DM; ++d) acc[d] = 0.f;
    for (long long s0 = 0; s0 < S; s0 += BK) {
      const int len = (int)min((long long)BK, (long long)S - s0);
      __syncthreads();
      load_tile(s0, len, false);
      __syncthreads();
      if (!none) continue;
      for (int s = lane; s < len; s += tpr) {
#pragma unroll
        for (int d = 0; d < DM; ++d) acc[d] += tl.v[s][d];
      }
    }
    for (int off = tpr / 2; off > 0; off /= 2) {
#pragma unroll
      for (int d = 0; d < DM; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
    }
    if (none) l = (float)S;
  }

  if (valid && lane == 0) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < dv) st(out, qoff * dv + d, acc[d] * inv);
  }
}

template <int DM, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out, const int* qpos,
           const int* kpos, int N, int T, int S, int H, int KV, int dh, int dv, int causal,
           int has_window, long long window, float scale, int tpr, cudaStream_t stream) {
  const long long rows = (long long)T * (H / KV);
  const long long blocks = (rows + THREADS / tpr - 1) / (THREADS / tpr);
  dim3 grid((unsigned)blocks, (unsigned)(N * KV));
  flash_kernel<DM, TQ, TKV><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), qpos, kpos, T, S, H, KV, dh, dv, causal, has_window, window, scale,
      tpr);
  return (int)cudaGetLastError();
}

template <int DM>
int dispatch(int q_bf16, int kv_bf16, const void* q, const void* k, const void* v, void* out,
             const int* qpos, const int* kpos, int N, int T, int S, int H, int KV, int dh,
             int dv, int causal, int has_window, long long window, float scale, int tpr,
             cudaStream_t stream) {
  using BF = __nv_bfloat16;
#define FA_ARGS q, k, v, out, qpos, kpos, N, T, S, H, KV, dh, dv, causal, has_window, window, \
                scale, tpr, stream
  if (q_bf16 && kv_bf16) return launch<DM, BF, BF>(FA_ARGS);
  if (q_bf16) return launch<DM, BF, float>(FA_ARGS);
  if (kv_bf16) return launch<DM, float, BF>(FA_ARGS);
  return launch<DM, float, float>(FA_ARGS);
#undef FA_ARGS
}

}  // namespace

// tpr: threads a query row, a power of two ≤ 32.  window ≤ 0 with
// has_window set masks every key.  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const int* qpos, const int* kpos, int N, int T, int S,
                                      int H, int KV, int dh, int dv, int causal,
                                      int has_window, long long window, float scale,
                                      int q_bf16, int kv_bf16, int tpr, cudaStream_t stream) {
  if (KV <= 0 || H % KV || tpr <= 0 || tpr > 32 || (tpr & (tpr - 1)) || N * KV > 65535 ||
      dh % 4 || dv % 4)
    return (int)cudaErrorInvalidValue;
  if (dh > 64 || dv > 64) return (int)cudaErrorInvalidValue;
  return dispatch<64>(q_bf16, kv_bf16, q, k, v, out, qpos, kpos, N, T, S, H, KV, dh, dv, causal,
                      has_window, window, scale, tpr, stream);
}
