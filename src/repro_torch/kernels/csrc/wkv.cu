// The chunked RWKV6 / SSD recurrence (WKV):
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
// Bound on the H100: bytes (at Hymba's widths, dk = 16, dv = 64, about
// 2·C + 4·dk operations per element read: 67 MB a launch, 0.020 ms).  Only
// S_c = exp(P_end,c) S_{c−1} + U_c, with U_c = k_endᵀv, links one chunk to
// the next, and it links each element of S to itself alone: everything
// else in a chunk (r̃, k̃, k_end, A, A·v, the bonus, U_c) reads that chunk's
// rows only, and column c of S and of y reads column c of v only.  So, for
// every T (decode's single token is one chunk of 1: 400 blocks of one warp
// at Hymba's widths):
//   * a block per (n, h, slice of VS columns of v, y and S): VS = dv = 64 in
//     the instance for Hymba's widths (chunk 16, dk 16, its loops unrolled;
//     100 blocks at Hymba's prefill), VS = 16 in the general one (any chunk
//     and width);
//   * a block of G warps takes G chunks (a super-chunk) at a time, warp g
//     owning chunk g: its r̃, k̃ᵀ, k_end (a decay per head: each row's three
//     exponentials once; per channel: a lane a channel with its own
//     cumulative sum of log w), A, Y = A·v + (r·u·k)·v and U_g, v read
//     straight from the raw rows;
//   * then the sequential part alone, one thread an element of S: for g in
//     order, U_g ← S (the state chunk g starts from), S ← exp(P_end,g)·S + U_g;
//     then each warp adds r̃_g·S_{g−1} to its Y and writes y;
//   * the products are bound by shared memory's 128 bytes a cycle, so each
//     lane holds a tile of 32/(VS/8)-apart rows × 8 columns (at VS = 64, 4
//     rows: 12 wavefronts a step for 32 FMAs, against 9 for 8 with one row),
//     its columns two runs of 4 that the lanes of a quarter-warp read
//     without conflict;
//   * the raw rows of the next super-chunk are copied into shared memory by
//     cp.async (16-byte pieces where rows allow, else 8 or 4, else loads)
//     while the sequential part and y of the current one run; three
//     barriers a super-chunk; G is as many chunks as fit in shared memory,
//     12 at most (11 at Hymba's prefill);
//   * every sum runs in the order of the chunk-by-chunk kernel it replaced
//     (no atomics), so two calls give the same bits, and that kernel's bits
//     (tools/wkv_against.py holds the two to it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int G_MAX = 12;   // chunks (warps) a super-chunk
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16(x);
}

__host__ __device__ inline int up4(int f) { return (f + 3) / 4 * 4; }  // floats: 16 bytes
__host__ __device__ inline int round_up(int b, int p) { return (b + p - 1) / p * p; }

// Shared memory: G chunk slots of floats, the state, then the raw rows of
// a super-chunk (r, k, the v slice, log w), each array on 16 bytes.
struct Layout {
  int dkp, cp, kts;                                        // row widths (floats)
  int rt, ktt, ke, yl, a, diag, dend, fac, u, slot;        // offsets in a slot (floats)
  int s;                                                   // S [dk][VS] (floats)
  int sr, sv, sw;                                          // raw row strides (bytes)
  int raw_r, raw_k, raw_v, raw_w, bytes;                   // raw offsets (bytes), total
};

// sr, sv, sw: the raw rows' strides, each a multiple of its copy's piece.
__host__ __device__ inline Layout layout(int C, int dk, int vs, int G, int sr, int sv, int sw) {
  Layout L;
  L.dkp = dk + 1;  // odd: a column read by the lanes of a warp is conflict-free
  L.cp = C + 1;
  L.kts = up4((C + 7) / 8 * 8 + 4);  // k̃ᵀ rows: 8 keys a float4 pair, padded
  L.rt = 0;
  L.ktt = up4(L.rt + C * L.dkp);
  L.ke = up4(L.ktt + dk * L.kts);
  L.yl = up4(L.ke + C * L.dkp);
  L.a = L.yl + C * vs;
  L.diag = up4(L.a + C * L.cp);
  L.dend = up4(L.diag + C);
  L.fac = up4(L.dend + dk);
  L.u = up4(L.fac + 3 * C);
  L.slot = L.u + dk * vs;
  L.s = G * L.slot;
  L.sr = sr;
  L.sv = sv;
  L.sw = sw;
  const int rows = G * C;
  L.raw_r = 4 * (L.s + dk * vs);
  L.raw_k = L.raw_r + round_up(rows * sr, 16);
  L.raw_v = L.raw_k + round_up(rows * sr, 16);
  L.raw_w = L.raw_v + round_up(rows * sv, 16);
  L.bytes = L.raw_w + round_up(rows * sw, 16);
  return L;
}

// The widest piece (16, 8 or 4 bytes) that every row of a copy can be cut
// into, with its source addresses aligned to it; 2: none, copied by plain
// 2-byte loads.
inline int piece(const void* base, long long offset_bytes, long long stride, int bytes) {
  const long long a = (long long)(uintptr_t)base + offset_bytes;
  for (int p = 16; p >= 4; p /= 2)
    if (bytes % p == 0 && stride % p == 0 && a % p == 0) return p;
  return 2;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int p) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (p == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else if (p == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// rows × bytes from src (rows stride bytes apart) to dst (dstride apart).
__device__ __forceinline__ void copy_rows(char* dst, int dstride, const char* src,
                                          long long stride, int rows, int bytes, int p) {
  const int per = bytes / p;
  for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
    const int r = e / per, j = e % per;
    if (p == 2)
      *reinterpret_cast<uint16_t*>(dst + r * dstride + 2 * j) =
          *reinterpret_cast<const uint16_t*>(src + r * stride + 2 * j);
    else
      cp_async(dst + r * dstride + j * p, src + r * stride + j * p, p);
  }
}

// The pieces of the four copies (see piece()), one launch's worth, and
// whether y's runs of 4 columns take one store each.
struct Pieces {
  int r, k, v, w, y4;
};

// A lane's 8 columns: two runs of 4, at c and c + half.
__device__ __forceinline__ void ld8(float* x, const float* p, int half) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + half);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void ld8(float* x, const __nv_bfloat16* p, int half) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const uint2 b = *reinterpret_cast<const uint2*>(p + half);
  const unsigned w[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void st8(float* p, const float* x, int half) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + half) = make_float4(x[4], x[5], x[6], x[7]);
}
// 4 floats to p, aligned to their width: as they are or rounded to bf16.
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  __align__(8) __nv_bfloat162 b[2] = {__floats2bfloat162_rn(x[0], x[1]),
                                      __floats2bfloat162_rn(x[2], x[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(b);
}
__device__ __forceinline__ void fma8(float* a, float w, const float* x) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = fmaf(w, x[j], a[j]);
}

// CT, DKT: the chunk and dk fixed at compile time (their loops unrolled, a
// lane's tile CT/TS rows), or 0 to take C_ and dk_ (one row a pass).
template <typename TI, typename TW, int CT, int DKT, int VS>
__global__ void __launch_bounds__(32 * G_MAX)
wkv_kernel(const TI* __restrict__ r, const TI* __restrict__ k, const TI* __restrict__ v,
           const TW* __restrict__ lw, const float* __restrict__ u,
           const float* __restrict__ state0, TI* __restrict__ y, float* __restrict__ state,
           int T, int H, int dk_, int dv, int dw, int C_, int G, Pieces pc) {
  constexpr int NCG = VS / 8, TS = 32 / NCG, HALF = VS / 2;  // column groups; tile rows apart
  constexpr int R = CT ? (CT + TS - 1) / TS : 1;              // a lane's tile rows
  constexpr int es = sizeof(TI), esw = sizeof(TW);
  extern __shared__ __align__(16) float sm[];
  char* smb = reinterpret_cast<char*>(sm);
  const int C = CT ? CT : C_, dk = DKT ? DKT : dk_;
  const Layout L = layout(C, dk, VS, G, round_up(dk * es, pc.r), round_up(VS * es, pc.v),
                          round_up(dw * esw, pc.w));
  const int slices = (dv + VS - 1) / VS;
  const int nh = blockIdx.x / slices, sl = blockIdx.x % slices;
  const int n = nh / H, h = nh % H;
  const int c0 = sl * VS, cols = min(VS, dv - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = lane % NCG * 4, t0 = lane / NCG;  // the lane's columns cg.., HALF + cg..
  const int nchunks = T / C;
  float* S = sm + L.s;

  const long long sbase = (long long)nh * dk * dv;
  for (int e = threadIdx.x; e < dk * VS; e += blockDim.x) {
    const int d = e / VS, c = e % VS;
    S[e] = (state0 && c < cols) ? state0[sbase + (long long)d * dv + c0 + c] : 0.f;
  }

  // The raw rows of chunks [c_lo, c_lo + g_n) into shared memory, async.
  auto prefetch = [&](int c_lo, int g_n) {
    const long long row0 = ((long long)n * T + (long long)c_lo * C) * H + h;
    const int rows = g_n * C;
    copy_rows(smb + L.raw_r, L.sr, reinterpret_cast<const char*>(r + row0 * dk),
              (long long)H * dk * es, rows, dk * es, pc.r);
    copy_rows(smb + L.raw_k, L.sr, reinterpret_cast<const char*>(k + row0 * dk),
              (long long)H * dk * es, rows, dk * es, pc.k);
    copy_rows(smb + L.raw_v, L.sv, reinterpret_cast<const char*>(v + row0 * dv + c0),
              (long long)H * dv * es, rows, cols * es, pc.v);
    copy_rows(smb + L.raw_w, L.sw, reinterpret_cast<const char*>(lw + row0 * dw),
              (long long)H * dw * esw, rows, dw * esw, pc.w);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  prefetch(0, min(G, nchunks));
  for (int c_lo = 0; c_lo < nchunks; c_lo += G) {
    const int g_n = min(G, nchunks - c_lo);
    const bool mine = warp < g_n;  // this warp owns chunk c_lo + warp
    float* own = sm + warp * L.slot;
    float* rt = own + L.rt;
    float* ktt = own + L.ktt;  // k̃ᵀ [dk][kts]
    float* ke = own + L.ke;
    float* yl = own + L.yl;
    float* A = own + L.a;
    float* diag = own + L.diag;
    float* dend = own + L.dend;
    float* fac = own + L.fac;  // a decay per head: exp(P − log w), exp(−P), exp(P_end − P)
    float* U = own + L.u;
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // raw rows in; the previous super-chunk's readers done

    // 1. Each warp its chunk: r̃, k̃ᵀ, k_end and exp(P_end), the bonus, then
    //    A = r̃k̃ᵀ (strict lower), Y = A·v + (r·u·k)·v and U = k_endᵀv, v read
    //    from the raw rows.  A decay per channel: a lane a channel, with its
    //    own cumulative sum of log w.  A decay per head: the three factors
    //    of a row once (a lane a row, its sums in the same order), then each
    //    (row, channel) one product each, over all lanes.
    if (mine) {
      const int base = warp * C;
      auto raw = [&](int off, int stride, int t, int d) {
        return ld(reinterpret_cast<const TI*>(smb + off + (base + t) * stride), d);
      };
      auto raw_w = [&](int t, int d) {
        return fminf(fmaxf(ld(reinterpret_cast<const TW*>(smb + L.raw_w + (base + t) * L.sw), d),
                           -60.f), -1e-6f);
      };
      // A lane's 8 columns of row t of v (past cols: whatever the rows hold;
      // those columns are never written out).
      auto v8 = [&](float* x, int t) {
        ld8(x, reinterpret_cast<const TI*>(smb + L.raw_v + (base + t) * L.sv) + cg, HALF);
      };
      if (dw == 1) {
        float pend = 0.f;
        for (int t = lane; t < C; t += 32) {
          float pt = 0.f, lwt = 0.f;
          pend = 0.f;
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const float x = raw_w(j, 0);
            pend += x;
            if (j <= t) pt += x;
            if (j == t) lwt = x;
          }
          fac[t] = expf(pt - lwt);
          fac[C + t] = expf(-pt);
          fac[2 * C + t] = expf(pend - pt);
        }
        pend = __shfl_sync(0xffffffffu, pend, 0);
        for (int d = lane; d < dk; d += 32) dend[d] = expf(pend);
        __syncwarp();
        for (int e = lane; e < C * dk; e += 32) {
          const int t = e / dk, d = e % dk;
          const float kk = raw(L.raw_k, L.sr, t, d);
          rt[t * L.dkp + d] = raw(L.raw_r, L.sr, t, d) * fac[t];
          ktt[d * L.kts + t] = kk * fac[C + t];
          ke[t * L.dkp + d] = kk * fac[2 * C + t];
        }
      }
      for (int d = lane; d < dk && dw != 1; d += 32) {
        float run = 0.f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const float lwv = raw_w(t, d);
          run += lwv;
          const float kk = raw(L.raw_k, L.sr, t, d);
          rt[t * L.dkp + d] = raw(L.raw_r, L.sr, t, d) * expf(run - lwv);
          ktt[d * L.kts + t] = kk * expf(-run);
          ke[t * L.dkp + d] = run;  // P, until the end is known
        }
        dend[d] = expf(run);
#pragma unroll
        for (int t = 0; t < C; ++t)
          ke[t * L.dkp + d] = raw(L.raw_k, L.sr, t, d) * expf(run - ke[t * L.dkp + d]);
      }
      if (u) {
        for (int t = lane; t < C; t += 32) {
          float a = 0.f;
#pragma unroll
          for (int d = 0; d < dk; ++d)
            a = fmaf(raw(L.raw_r, L.sr, t, d) * u[(long long)h * dk + d],
                     raw(L.raw_k, L.sr, t, d), a);
          diag[t] = a;
        }
      }
      __syncwarp();
      // A: a lane 8 keys of a row.
      const int c8 = (C + 7) / 8;
      for (int o = lane; o < C * c8; o += 32) {
        const int t = o / c8, s0 = o % c8 * 8;
        float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (s0 < t) {
#pragma unroll
          for (int d = 0; d < dk; ++d) {
            float x[8];
            ld8(x, ktt + d * L.kts + s0, 4);
            fma8(a, rt[t * L.dkp + d], x);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (s0 + j < C) A[t * L.cp + s0 + j] = s0 + j < t ? a[j] : 0.f;
      }
      __syncwarp();
      // Y and U: a lane its tile.
      for (int tb = t0; tb < C; tb += TS * R) {
        float a[R][8] = {};
#pragma unroll
        for (int s = 0; s < C; ++s) {
          float x[8];
          v8(x, s);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int t = tb + TS * i;
            if (t < C && s < t) fma8(a[i], A[t * L.cp + s], x);
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int t = tb + TS * i;
          if (t >= C) continue;
          if (u) {
            float x[8];
            v8(x, t);
            fma8(a[i], diag[t], x);
          }
          st8(yl + t * VS + cg, a[i], HALF);
        }
      }
      for (int db = t0; db < dk; db += TS * R) {
        float a[R][8] = {};
#pragma unroll
        for (int s = 0; s < C; ++s) {
          float x[8];
          v8(x, s);
#pragma unroll
          for (int i = 0; i < R; ++i)
            if (db + TS * i < dk) fma8(a[i], ke[s * L.dkp + db + TS * i], x);
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (db + TS * i < dk) st8(U + (db + TS * i) * VS + cg, a[i], HALF);
      }
    }
    __syncthreads();  // every warp is done with the raw rows and has its U
    if (c_lo + G < nchunks) prefetch(c_lo + G, min(G, nchunks - c_lo - G));

    // 2. The sequential part, one thread an element of S: chunk g starts
    //    from S (kept in U_g's place), then S ← exp(P_end,g)·S + U_g.
    for (int e = threadIdx.x; e < dk * VS; e += blockDim.x) {
      const int d = e / VS;
      float s = S[e];
      for (int g = 0; g < g_n; ++g) {
        float* slot = sm + g * L.slot;
        const float ug = slot[L.u + e];
        slot[L.u + e] = s;
        s = fmaf(slot[L.dend + d], s, ug);
      }
      S[e] = s;
    }
    __syncthreads();

    // 3. Each warp: y = Y + r̃·S_{g−1}, written out.
    if (mine) {
      const long long row0 = ((long long)n * T + (long long)(c_lo + warp) * C) * H + h;
      for (int tb = t0; tb < C; tb += TS * R) {
        float b[R][8] = {};
#pragma unroll
        for (int d = 0; d < dk; ++d) {
          float x[8];
          ld8(x, U + d * VS + cg, HALF);
#pragma unroll
          for (int i = 0; i < R; ++i)
            if (tb + TS * i < C) fma8(b[i], rt[(tb + TS * i) * L.dkp + d], x);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int t = tb + TS * i;
          if (t >= C) continue;
          float yo[8];
          ld8(yo, yl + t * VS + cg, HALF);
#pragma unroll
          for (int j = 0; j < 8; ++j) yo[j] += b[i][j];
          TI* out = y + (row0 + (long long)t * H) * dv + c0;
#pragma unroll
          for (int run = 0; run < 2; ++run) {
            const int c = cg + run * HALF;
            if (pc.y4 && c + 4 <= cols) {
              store4(out + c, yo + 4 * run);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (c + j < cols) st(out, c + j, yo[4 * run + j]);
            }
          }
        }
      }
    }
  }
  for (int e = threadIdx.x; e < dk * VS; e += blockDim.x) {
    const int d = e / VS, c = e % VS;
    if (c < cols) state[sbase + (long long)d * dv + c0 + c] = S[e];
  }
}

// The chunks a super-chunk: as many as fit in shared memory, at most G_MAX.
template <int VS>
int chunks_a_block(int C, int dk, int nchunks, int sr, int sv, int sw) {
  int G = nchunks < G_MAX ? nchunks : G_MAX;
  while (G > 1 && layout(C, dk, VS, G, sr, sv, sw).bytes > MAX_SMEM) --G;
  return G;
}

template <typename TI, typename TW, int CT, int DKT, int VS>
int launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
           const float* state0, void* y, float* state, int N, int T, int H, int dk, int dv,
           int dw, int C, cudaStream_t stream) {
  constexpr int es = sizeof(TI), esw = sizeof(TW);
  auto kern = wkv_kernel<TI, TW, CT, DKT, VS>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // Every slice starts at a multiple of VS columns; the last may be narrower.
  const int last = dv - (dv - 1) / VS * VS;
  const int pv = piece(v, 0, (long long)dv * es, VS * es);
  const int pv_last = piece(v, (long long)(dv - last) * es, (long long)dv * es, last * es);
  const Pieces pc{piece(r, 0, (long long)dk * es, dk * es),
                  piece(k, 0, (long long)dk * es, dk * es), pv < pv_last ? pv : pv_last,
                  piece(lw, 0, (long long)dw * esw, dw * esw),
                  (uintptr_t)y % (4 * es) == 0 && dv % 4 == 0};
  const int slices = (dv + VS - 1) / VS, blocks = N * H * slices;
  const int sr = round_up(dk * es, pc.r), sv = round_up(VS * es, pc.v),
            sw = round_up(dw * esw, pc.w);
  const int G = chunks_a_block<VS>(C, dk, T / C, sr, sv, sw);
  const int bytes = layout(C, dk, VS, G, sr, sv, sw).bytes;
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  kern<<<blocks, 32 * G, bytes, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k), static_cast<const TI*>(v),
      static_cast<const TW*>(lw), u, state0, static_cast<TI*>(y), state, T, H, dk, dv, dw, C, G,
      pc);
  return (int)cudaGetLastError();
}

// Hymba's SSD (chunk 16, dk 16, dv 64) unrolled, a block all 64 columns;
// any other chunk and width through the general instance, 16 columns a
// block.
template <typename TI, typename TW>
int dispatch(const void* r, const void* k, const void* v, const void* lw, const float* u,
             const float* state0, void* y, float* state, int N, int T, int H, int dk, int dv,
             int dw, int C, cudaStream_t stream) {
#define WKV_ARGS r, k, v, lw, u, state0, y, state, N, T, H, dk, dv, dw, C, stream
  if (C == 16 && dk == 16 && dv == 64) return launch<TI, TW, 16, 16, 64>(WKV_ARGS);
  return launch<TI, TW, 0, 0, 16>(WKV_ARGS);
#undef WKV_ARGS
}

}  // namespace

// Shared memory the smallest launch of the general instance needs (one
// chunk a block, float32 inputs), in bytes: the wrapper refuses a chunk that
// needs more than the card's 227 KB.
extern "C" long long wkv_smem_bytes(int C, int dk, int dv, int dw) {
  (void)dv;
  return layout(C, dk, 16, 1, up4(dk) * 4, 16 * 4, up4(dw) * 4).bytes;
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
  if (in_bf16 && lw_bf16) return dispatch<BF, BF>(WKV_ARGS);
  if (in_bf16) return dispatch<BF, float>(WKV_ARGS);
  if (lw_bf16) return dispatch<float, BF>(WKV_ARGS);
  return dispatch<float, float>(WKV_ARGS);
#undef WKV_ARGS
}
