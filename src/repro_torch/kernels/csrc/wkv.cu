// The chunked RWKV6 / SSD recurrence (WKV), one (sample, head) a block:
//   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ ;   y_t = r_tᵀ S_{t-1} + (r·u·k)_t v_t,
// r, k [N,T,H,dk], v [N,T,H,dv], log w [N,T,H,dk] or [N,T,H,1] (a scalar
// decay per head, Hymba's SSD, read with stride 0), u [H,dk] or none, the
// starting state [N,H,dk,dv] or zeros; y [N,T,H,dv] in r's type, the final
// state [N,H,dk,dv] float32.  r, k, v are float32 or bfloat16, log w
// likewise on its own; all arithmetic is float32.
//
// Replaces the Pallas kernel wkv_pallas (src/repro/kernels/wkv.py:61, body
// _kernel :21) and computes nn/functional.wkv_chunked with the algebra of
// src/repro/nn/functional.py:186-208, chunk by chunk with the chunk the model
// passes, so the rounding follows JAX's: log w clipped to [−60, −1e−6],
// P = cumsum(log w) inside the chunk, r̃ = r·exp(P − log w), k̃ = k·exp(−P)
// (its overflow for long chunks kept as JAX has it), A = r̃k̃ᵀ strictly lower,
// y = A v + (r·u·k) v + r̃ S, S ← exp(P_end) S + (k·exp(P_end − P))ᵀ v.
//
// Bound on the H100: bytes at Hymba's widths (dk = 16, dv = 64: about 2·C +
// 4·dk operations per element read).  The chunks of one (n, h) follow one
// another through S, so the parallelism is N·H blocks.  Design, simple first:
//   * one block of 256 threads per (n, h) walks the chunks; the state S
//     [dk, dv] stays in shared memory for the whole sequence (4 KB at
//     Hymba's 16 × 64, 16 KB at RWKV6's 64 × 64);
//   * unlike the TPU kernel, which takes all T rows of a head into VMEM, one
//     chunk [C, dk|dv] is loaded at a time; the per-chunk arrays have rows
//     padded by one float (the A products read columns);
//   * per chunk: load, cumsum (one thread a channel), r̃/k̃/k_end, A and the
//     bonus diagonal, y (written out), then the state update: five barriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16(x);
}

// Shared floats: S [dk·dv], rc/kc/rt/kt/kend [C·(dk+1)] each, vc [C·dv],
// lw/P [C·dw] each, A [C·C], diag [C], decay_end [dk].
long long smem_floats(int C, int dk, int dv, int dw) {
  return (long long)dk * dv + 5LL * C * (dk + 1) + (long long)C * dv + 2LL * C * dw +
         (long long)C * C + C + dk;
}

template <typename TI, typename TW>
__global__ void __launch_bounds__(THREADS)
wkv_kernel(const TI* __restrict__ r, const TI* __restrict__ k, const TI* __restrict__ v,
           const TW* __restrict__ lw, const float* __restrict__ u,
           const float* __restrict__ state0, TI* __restrict__ y, float* __restrict__ state,
           int T, int H, int dk, int dv, int dw, int C) {
  extern __shared__ __align__(16) float sm[];
  const int dkp = dk + 1;
  float* S = sm;
  float* rc = S + dk * dv;
  float* kc = rc + C * dkp;
  float* rt = kc + C * dkp;
  float* kt = rt + C * dkp;
  float* kend = kt + C * dkp;
  float* vc = kend + C * dkp;
  float* lwc = vc + C * dv;
  float* P = lwc + C * dw;
  float* A = P + C * dw;
  float* diag = A + C * C;
  float* dend = diag + C;

  const int nh = blockIdx.x, n = nh / H, h = nh % H;
  const int tid = threadIdx.x;
  const long long sbase = (long long)nh * dk * dv;
  for (int e = tid; e < dk * dv; e += THREADS) S[e] = state0 ? state0[sbase + e] : 0.f;

  for (int t0 = 0; t0 < T; t0 += C) {
    // 1. The chunk's rows (the previous chunk's readers have passed the
    //    barrier at the end of the loop).
    const long long row0 = ((long long)n * T + t0) * H + h;  // row (t0 + t) is row0 + t·H
    for (int e = tid; e < C * dk; e += THREADS) {
      const int t = e / dk, d = e % dk;
      const long long i = (row0 + (long long)t * H) * dk + d;
      rc[t * dkp + d] = ld(r, i);
      kc[t * dkp + d] = ld(k, i);
    }
    for (int e = tid; e < C * dv; e += THREADS) {
      const int t = e / dv, d = e % dv;
      vc[t * dv + d] = ld(v, (row0 + (long long)t * H) * dv + d);
    }
    for (int e = tid; e < C * dw; e += THREADS) {
      const int t = e / dw, d = e % dw;
      lwc[e] = fminf(fmaxf(ld(lw, (row0 + (long long)t * H) * dw + d), -60.f), -1e-6f);
    }
    __syncthreads();
    // 2. Inclusive cumulative log-decay, one thread a channel.
    for (int d = tid; d < dw; d += THREADS) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        run += lwc[t * dw + d];
        P[t * dw + d] = run;
      }
    }
    __syncthreads();
    // 3. r̃ = r·exp(P − log w), k̃ = k·exp(−P), k_end = k·exp(P_end − P).
    for (int e = tid; e < C * dk; e += THREADS) {
      const int t = e / dk, d = e % dk, w = dw == 1 ? t * dw : t * dw + d;
      const int we = dw == 1 ? (C - 1) * dw : (C - 1) * dw + d;
      const float kk = kc[t * dkp + d];
      rt[t * dkp + d] = rc[t * dkp + d] * expf(P[w] - lwc[w]);
      kt[t * dkp + d] = kk * expf(-P[w]);
      kend[t * dkp + d] = kk * expf(P[we] - P[w]);
    }
    for (int d = tid; d < dk; d += THREADS) dend[d] = expf(P[(C - 1) * dw + (dw == 1 ? 0 : d)]);
    __syncthreads();
    // 4. A = r̃k̃ᵀ on the strict lower triangle; the bonus diagonal r·u·k.
    for (int e = tid; e < C * C; e += THREADS) {
      const int t = e / C, s = e % C;
      float a = 0.f;
      if (s < t)
        for (int d = 0; d < dk; ++d) a = fmaf(rt[t * dkp + d], kt[s * dkp + d], a);
      A[e] = a;
    }
    if (u) {
      for (int t = tid; t < C; t += THREADS) {
        float a = 0.f;
        for (int d = 0; d < dk; ++d)
          a = fmaf(rc[t * dkp + d] * u[(long long)h * dk + d], kc[t * dkp + d], a);
        diag[t] = a;
      }
    }
    __syncthreads();
    // 5. y = A v + diag·v + r̃ S.
    for (int e = tid; e < C * dv; e += THREADS) {
      const int t = e / dv, c = e % dv;
      float a = 0.f;
      for (int s = 0; s < t; ++s) a = fmaf(A[t * C + s], vc[s * dv + c], a);
      if (u) a = fmaf(diag[t], vc[t * dv + c], a);
      float b = 0.f;
      for (int d = 0; d < dk; ++d) b = fmaf(rt[t * dkp + d], S[d * dv + c], b);
      st(y, (row0 + (long long)t * H) * dv + c, a + b);
    }
    __syncthreads();
    // 6. S ← exp(P_end) S + k_endᵀ v.
    for (int e = tid; e < dk * dv; e += THREADS) {
      const int d = e / dv, c = e % dv;
      float a = 0.f;
      for (int s = 0; s < C; ++s) a = fmaf(kend[s * dkp + d], vc[s * dv + c], a);
      S[e] = fmaf(dend[d], S[e], a);
    }
    __syncthreads();
  }
  for (int e = tid; e < dk * dv; e += THREADS) state[sbase + e] = S[e];
}

template <typename TI, typename TW>
int launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
           const float* state0, void* y, float* state, int N, int T, int H, int dk, int dv,
           int dw, int C, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(C, dk, dv, dw);
  auto kern = wkv_kernel<TI, TW>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<N * H, THREADS, bytes, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k), static_cast<const TI*>(v),
      static_cast<const TW*>(lw), u, state0, static_cast<TI*>(y), state, T, H, dk, dv, dw, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory a launch needs, in bytes (the wrapper refuses a chunk that
// needs more than the card's 227 KB).
extern "C" long long wkv_smem_bytes(int C, int dk, int dv, int dw) {
  return 4 * smem_floats(C, dk, dv, dw);
}

// dw: 1 (a decay per head) or dk (per channel); C divides T.  Returns a
// cudaError_t.
extern "C" int wkv_launch(const void* r, const void* k, const void* v, const void* lw,
                          const float* u, const float* state0, void* y, float* state, int N,
                          int T, int H, int dk, int dv, int dw, int C, int in_bf16, int lw_bf16,
                          cudaStream_t stream) {
  if (C <= 0 || T % C || (dw != 1 && dw != dk)) return (int)cudaErrorInvalidValue;
  using BF = __nv_bfloat16;
#define WKV_ARGS r, k, v, lw, u, state0, y, state, N, T, H, dk, dv, dw, C, stream
  if (in_bf16 && lw_bf16) return launch<BF, BF>(WKV_ARGS);
  if (in_bf16) return launch<BF, float>(WKV_ARGS);
  if (lw_bf16) return launch<float, BF>(WKV_ARGS);
  return launch<float, float>(WKV_ARGS);
#undef WKV_ARGS
}
