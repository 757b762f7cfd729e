// Per-sample products on the tensor cores in 3xTF32: t[c, n] = A_nᵀ S_cn
// over the R rows of sample n, for the C classes of S [C, N, R, b] against
// one A_n [R, a] each, A_n staged and split once for every class.
// fused_second_order and ggn_diag square t into the GGN diagonal (and the
// former into the per-sample trace), both through sq_launch below;
// cross_dot's form stage stores it as the per-sample gradients G of the
// NTK's classes and GGNGram's class-major rows; predictive_var sums each
// class's squares [· Σ] into the GLM predictive variance.  The design is in
// fused_second_order.cu's source note.
#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace rowprod {

constexpr int RS = 32;        // rows a stage: one 128-byte K-major row of A_nᵀ
constexpr int STAGES = 2;     // the ring of stages
constexpr int THREADS = 256;  // two warpgroups
constexpr int BS = 64;        // b columns a block: wgmma's M
constexpr int HALF = 4096;    // one class's 32 r x 32 b, 128-byte swizzled
constexpr int WN = 48;        // a-columns a warpgroup: wgmma's N

// A block's work: CW classes a warpgroup.  Ten classes: the two warpgroups
// take classes 0–4 and 5–9 of the same 48 a-columns.  One class (the MC
// sweep): they take a-columns 0–47 and 48–95 of it.
struct Shape {
  int cw;
  bool split_a;
  __host__ __device__ constexpr int na() const { return split_a ? 2 * WN : WN; }  // a-columns
  __host__ __device__ constexpr int classes() const { return split_a ? cw : 2 * cw; }
  __host__ __device__ constexpr int pa() const { return na() + 1; }  // raw A row stride
  // A stage: each class's S rows (two swizzled halves of 32 b-columns), then
  // A_n's raw rows, rounded up to the swizzle's 1024-byte repeat.
  __host__ __device__ constexpr int stage_bytes() const {
    return (classes() * 2 * HALF + RS * pa() * 4 + 1023) / 1024 * 1024;
  }
  // A_nᵀ hi and lo (na rows of 128 bytes), the ring, two mbarriers, and 1024
  // bytes to align the swizzled tiles by hand.
  constexpr int smem_bytes() const {
    return 2 * na() * 128 + STAGES * stage_bytes() + 8 * STAGES + 1024;
  }
};

// d (+)= A·B for 64 rows x 48 columns and 8 of K in TF32: A in registers, in
// mma.m16n8k8's A layout for each warp's 16 rows; B (48 x 8) K-major in
// 128-byte-swizzled shared memory.  acc = 0 overwrites d.  d[4j + 2i + c] is
// row 16·warp + lane/4 + 8i, column 8j + 2·(lane%4) + c.
__device__ __forceinline__ void wgmma_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// Byte offset of (row r, column c < 32) in a 128-byte-swizzled tile of
// 32-float rows: 16-byte chunk c/4 of row r sits at position (c/4) ^ (r%8).
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7))) << 4) + ((c & 3) << 2);
}

// What a launch computes: A [N, R, a] and S [C, N, R, b] float32.  DIAG:
// diag_part [groups · (split_a ? 1 : 2), a, b] (the diag output itself when
// that is 1: a warpgroup of ten classes writes its own partial).  TRACE:
// trace_part [tiles, N].  STORE: t[c, n] itself at out + (c·N + n)·out_ld,
// as [a, b].  VAR: var_part [tiles, var_warps, C, N], each warp's share of
// Σ_ab t[c, n]² [· sigma[a, b]] (sigma [a, b], or nullptr: unweighted).
struct Args {
  const float* A;
  const float* S;
  int C, N, R, a, b, group_size;
  bool tma;  // S through smap (b a multiple of 4); else the threads copy it
  float* diag_part;
  float* trace_part;
  float* out;
  long long out_ld;
  const float* sigma;
  float* var_part;
};

enum { DIAG = 1, TRACE = 2, STORE = 4, VAR = 8 };

// The warps that hold a class's share of a tile: one warpgroup's four with
// ten classes, both warpgroups' eight with one (their a-columns differ).
__host__ __device__ constexpr int var_warps(bool split_a) { return split_a ? 8 : 4; }

using Fn = void (*)(const CUtensorMap, const Args);

// Grid (tiles, groups); block (x, g) takes tile x (64 b-columns fastest, then
// na a-columns) and the samples [g·group_size, (g+1)·group_size).  smap is S
// as [C·N, R, b] in boxes of {32 b, 32 r, 1}.
template <int CW, bool SPLIT_A, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap smap, const Args p) {
  constexpr bool DIAG_ = MODE & DIAG, TRACE_ = MODE & TRACE, STORE_ = MODE & STORE;
  constexpr bool VAR_ = MODE & VAR;
  const float* __restrict__ A = p.A;
  const float* __restrict__ S = p.S;
  const int C = p.C, N = p.N, R = p.R, a = p.a, b = p.b, group_size = p.group_size;
  const bool tma = p.tma;
  constexpr Shape sh{CW, SPLIT_A};
  constexpr int NA = sh.na(), PA = sh.pa(), CLS = sh.classes(), STAGE = sh.stage_bytes();
  extern __shared__ uint8_t smem_raw[];
  __shared__ float red[32];
  const uint32_t raw_addr = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw_addr);
  const uint32_t ring = base + 2 * NA * 128, full_bar = ring + STAGES * STAGE;
  uint8_t* sring = sbase + 2 * NA * 128;
  const int tiles_b = (b + BS - 1) / BS;
  const int b0 = blockIdx.x % tiles_b * BS, a0 = blockIdx.x / tiles_b * NA;
  const int n_lo = blockIdx.y * group_size, n_hi = min(N, n_lo + group_size);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int cls0 = SPLIT_A ? 0 : CW * wg;     // the warpgroup's first class of a block
  const int aoff = SPLIT_A ? WN * wg : 0;     // and its a-columns in the tile
  const int ncb = (C + CLS - 1) / CLS;        // class blocks a sample
  const int spz = (R + RS - 1) / RS;          // stages a (sample, class block)
  const int steps = (n_hi - n_lo) * ncb * spz;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(full_bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage `step`: every class's S rows [k0, k0 + 32) x the tile's 64
  // b-columns (TMA from thread 0, or the threads' own copies), zeros past
  // the edges and for classes past C; and A_n's rows x the tile's
  // a-columns (4-byte copies into rows of na + 1 floats).
  auto copy = [&](int step) {
    const int u = step / spz, n = n_lo + u / ncb, c0 = u % ncb * CLS;
    const int k0 = step % spz * RS, stage = step % STAGES;
    uint8_t* st = sring + stage * STAGE;
    if (tma) {
      if (tid == 0) {
        const uint32_t fb = full_bar + 8 * stage, dst = ring + stage * STAGE;
        hopper::mbar_expect_tx(fb, CLS * 2 * HALF);
#pragma unroll
        for (int c = 0; c < CLS; ++c)  // a row past C·N is out of bounds: zeros
          for (int h = 0; h < 2; ++h)
            hopper::tma_load_3d(dst + (2 * c + h) * HALF, &smap, fb, b0 + 32 * h, k0,
                                (c0 + c) * N + n);
      }
    } else {
      for (int e = tid; e < CLS * RS * BS; e += THREADS) {
        const int c = e / (RS * BS), r = e / BS % RS, j = e % BS;
        const bool in = c0 + c < C && k0 + r < R && b0 + j < b;
        tf32x3::cp_async4(
            reinterpret_cast<float*>(st + (2 * c + j / 32) * HALF + sw128(r, j % 32)),
            in ? S + (((long long)(c0 + c) * N + n) * R + k0 + r) * b + b0 + j : S, in);
      }
    }
    float* ar = reinterpret_cast<float*>(st + CLS * 2 * HALF);
    const float* An = A + (long long)n * R * a;
    for (int e = tid; e < RS * NA; e += THREADS) {
      const int r = e / NA, c = e % NA;
      const bool in = k0 + r < R && a0 + c < a;
      tf32x3::cp_async4(ar + r * PA + c, in ? An + (long long)(k0 + r) * a + a0 + c : A, in);
    }
  };

  float acc[CW][WN / 2], tc[WN / 2], dg[WN / 2];
#pragma unroll
  for (int x = 0; x < WN / 2; ++x) {
    tc[x] = dg[x] = 0.f;
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[i][x] = 0.f;
  }
  float tr = 0.f;
  float sg[WN / 2];  // VAR: the thread's weights, 0 past the edges (t is 0 there too)
  if (VAR_) {
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int bb = b0 + 16 * warp + g + 8 * i, aa = a0 + aoff + 8 * j + 2 * t + c;
          sg[4 * j + 2 * i + c] =
              bb < b && aa < a ? (p.sigma ? p.sigma[(long long)aa * b + bb] : 1.f) : 0.f;
        }
  }
  if (steps > 0) copy(0);
  tf32x3::cp_commit();
  for (int step = 0; step < steps; ++step) {
    const int stage = step % STAGES;
    tf32x3::cp_wait<0>();
    if (tma) hopper::mbar_wait(full_bar + 8 * stage, (step / STAGES) & 1);
    __syncthreads();  // stage `step` is in; step − 1's buffers and wgmma are done
    if (step + 1 < steps) copy(step + 1);
    tf32x3::cp_commit();
    const uint8_t* st = sring + stage * STAGE;
    const float* ar = reinterpret_cast<const float*>(st + CLS * 2 * HALF);

    // A_nᵀ split once for every class: hi and lo, row = a-column, 32 r of
    // 128-byte-swizzled K-major (lanes run along r: conflict-free).
    for (int e = tid; e < NA * RS; e += THREADS) {
      const int r = e % RS, c = e / RS;
      uint32_t h, l;
      tf32x3::split_tf32(ar[r * PA + c], h, l);
      *reinterpret_cast<uint32_t*>(sbase + sw128(c, r)) = h;
      *reinterpret_cast<uint32_t*>(sbase + NA * 128 + sw128(c, r)) = l;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // Each of the warpgroup's classes: S_cnᵀ's 64 b-rows as register A
    // fragments (rows 16·warp + g (+8), r = 8kq + t (+4)), split; three
    // products a k-step into tc (the first overwrites it); then acc += tc
    // on the CUDA cores (tf32x3::promote's reason).  The other warpgroup's
    // classes keep the tensor cores busy while one loads its fragments.
    const uint32_t bhi = base + aoff * 128, blo = bhi + NA * 128;
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      const uint8_t* ss = st + 2 * (cls0 + i) * HALF + (warp / 2) * HALF;
      const int j0 = 16 * (warp % 2) + g;
      uint32_t ah[RS / 8][4], al[RS / 8][4];
#pragma unroll
      for (int kq = 0; kq < RS / 8; ++kq)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 8 * kq + t + 4 * (q / 2), j = j0 + 8 * (q % 2);
          tf32x3::split_tf32(*reinterpret_cast<const float*>(ss + sw128(r, j)), ah[kq][q],
                             al[kq][q]);
        }
      hopper::wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < RS / 8; ++kq) {
        wgmma_n48(tc, al[kq], hopper::sw128_desc(bhi + 32 * kq), kq > 0);
        wgmma_n48(tc, ah[kq], hopper::sw128_desc(blo + 32 * kq), 1);
        wgmma_n48(tc, ah[kq], hopper::sw128_desc(bhi + 32 * kq), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
#pragma unroll
      for (int x = 0; x < WN / 2; ++x) {
        asm volatile("" : "+f"(tc[x])::"memory");  // no read of tc before the wait
        acc[i][x] += tc[x];
      }
    }
    if (step % spz == spz - 1) {  // the class block's last stage for this sample
      const int n = n_lo + step / spz / ncb;
      if (STORE_) {  // each class's t to its row of out: rows a, columns b
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          const int c = step / spz % ncb * CLS + cls0 + i;
          if (c >= C) continue;
          float* o = p.out + ((long long)c * N + n) * p.out_ld;
#pragma unroll
          for (int j = 0; j < WN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int bb = b0 + 16 * warp + g + 8 * h, aa = a0 + aoff + 8 * j + 2 * t + q;
                if (bb < b && aa < a) o[(long long)aa * b + bb] = acc[i][4 * j + 2 * h + q];
              }
        }
      }
      float vs[CW];  // VAR: each class's weighted squares
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        vs[i] = 0.f;
#pragma unroll
        for (int x = 0; x < WN / 2; ++x) {
          const float v = acc[i][x] * acc[i][x];
          if (DIAG_) dg[x] += v;  // classes past C give zeros
          if (TRACE_) tr += v;
          if (VAR_) vs[i] = fmaf(v, sg[x], vs[i]);
          acc[i][x] = 0.f;
        }
      }
      if (VAR_) {  // each warp's share a class, summed in a fixed order: no block barrier
        const int c0 = step / spz % ncb * CLS + cls0;
        const int w = SPLIT_A ? 4 * wg + warp : warp;
        float* o = p.var_part + ((long long)blockIdx.x * var_warps(SPLIT_A) + w) * C * N + n;
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          const float s = bp::warp_sum(vs[i]);
          if (lane == 0 && c0 + i < C) o[(long long)(c0 + i) * N] = s;
        }
      }
      if (TRACE_ && step / spz % ncb == ncb - 1) {  // the sample's last class block
        const float s = bp::block_sum(tr, red);
        if (tid == 0) p.trace_part[(long long)blockIdx.x * N + n] = s;
        tr = 0.f;
      }
    }
  }
  tf32x3::cp_wait<0>();
  if (DIAG_) {
    float* o = p.diag_part + ((long long)blockIdx.y * (SPLIT_A ? 1 : 2) + (SPLIT_A ? 0 : wg)) * a * b;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int bb = b0 + 16 * warp + g + 8 * i, aa = a0 + aoff + 8 * j + 2 * t + c;
          if (bb < b && aa < a) o[(long long)aa * b + bb] = dg[4 * j + 2 * i + c];
        }
  }
}

// S [C·N, R, b] in boxes of {32, 32, 1}, 128-byte swizzle, zeros past the
// edges; false where TMA cannot read it (b not a multiple of 4, S not
// 16-byte aligned).
inline bool s_map(CUtensorMap* map, const float* S, int C, int N, int R, int b) {
  hopper::EncodeTiled enc = hopper::encode_tiled();
  if (!enc || b % 4 || (uintptr_t)S % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)b, (cuuint64_t)R, (cuuint64_t)C * N};
  const cuuint64_t strides[2] = {(cuuint64_t)b * 4, (cuuint64_t)R * b * 4};
  const cuuint32_t box[3] = {32, RS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(S), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}



// The kernel's grid for `tiles` tiles: samples a block (whole waves,
// bp::wave_chunk, a sample `per_sample` stages), its shared memory set.
inline int group_size(Fn fn, const Shape& sh, long long tiles, long long samples,
                      long long per_sample) {
  int per_sm = 1;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, sh.smem_bytes());
  return bp::wave_chunk(samples, tiles, (per_sm > 0 ? per_sm : 1) * bp::num_sms(),
                        per_sample + 1, STAGES + 2);
}

// One class (the MC sweep) or ten (fewer or more classes take blocks of
// ten, zeros past C).
inline Shape shape_for(int C) { return C == 1 ? Shape{1, true} : Shape{5, false}; }

// ---------------------------------------------------------------------------
// The squared sums of t, diag [a, b] = Σ_cn t∘t and trace [N] = Σ_cab t∘t:
// fused_second_order's diag and trace, and ggn_diag (diag alone).  One t
// kernel launch over (tiles, sample groups), each warpgroup of ten classes
// (each block of one) writing its own diag partial and each tile its trace
// partial, then the partials added in a fixed order: deterministic, no
// atomics.
// ---------------------------------------------------------------------------

template <int CW, bool SPLIT_A>
Fn sq_masked(bool diag, bool trace) {
  return diag && trace ? kernel<CW, SPLIT_A, DIAG | TRACE>
         : diag        ? kernel<CW, SPLIT_A, DIAG>
                       : kernel<CW, SPLIT_A, TRACE>;
}

inline Fn sq_instance(const Shape& sh, bool diag, bool trace) {
  return sh.split_a ? sq_masked<1, true>(diag, trace) : sq_masked<5, false>(diag, trace);
}

struct SqPlan {
  Shape shape;
  bool diag, trace;
  int tiles, groups, group_size, diag_parts;
  // Scratch floats: the diag partials (none where there is one), then the
  // trace partials.
  long long diag_scratch(int a, int b) const {
    return diag && diag_parts > 1 ? (long long)diag_parts * a * b : 0;
  }
  long long scratch(int N, int a, int b) const {
    return diag_scratch(a, b) + (trace ? (long long)tiles * N : 0);
  }
};

inline SqPlan sq_plan(int C, int N, int R, int a, int b, bool diag, bool trace) {
  SqPlan p{};
  p.diag = diag;
  p.trace = trace;
  p.shape = shape_for(C);
  p.tiles = (int)(bp::cdiv(b, BS) * bp::cdiv(a, p.shape.na()));
  p.group_size = group_size(sq_instance(p.shape, diag, trace), p.shape, p.tiles, N,
                            bp::cdiv(C, p.shape.classes()) * bp::cdiv(R, RS));
  p.groups = (int)bp::cdiv(N, p.group_size);
  p.diag_parts = p.groups * (p.shape.split_a ? 1 : 2);
  return p;
}

// A [N, R, a], S [C, N, R, b] float32 → the plan's diag [a, b] and trace
// [N]; scratch holds p.scratch(N, a, b) floats.
inline void sq_launch(const SqPlan& p, const float* A, const float* S, int C, int N, int R, int a,
                      int b, float* diag, float* trace, float* scratch, cudaStream_t stream) {
  float* diag_part = p.diag_parts > 1 ? scratch : diag;
  float* trace_part = scratch + p.diag_scratch(a, b);
  Args args{};
  args.A = A;
  args.S = S;
  args.C = C;
  args.N = N;
  args.R = R;
  args.a = a;
  args.b = b;
  args.group_size = p.group_size;
  args.diag_part = diag_part;
  args.trace_part = trace_part;
  CUtensorMap smap{};
  args.tma = s_map(&smap, S, C, N, R, b);
  const dim3 grid((unsigned)p.tiles, (unsigned)p.groups);
  sq_instance(p.shape, p.diag, p.trace)<<<grid, THREADS, p.shape.smem_bytes(), stream>>>(smap,
                                                                                        args);
  if (p.diag && p.diag_parts > 1)
    bp::launch_sum_partials(diag_part, diag, 1, p.diag_parts, (long long)a * b, stream);
  if (p.trace) bp::launch_sum_partials(trace_part, trace, 1, p.tiles, N, stream);
}

}  // namespace rowprod
