// xty: the batched 3xTF32 product out_z = X_zᵀ·Y_z (tf32x3.cuh's helpers),
// which serves cross_dot's form stage (G = AᵀB per row), fused_second_order's
// kron factor (SᵀS, its rows cut into pieces), and the one-class per-sample
// products of fused_first_order and per_sample_moment (G_z = A_zᵀB_z reduced
// in the epilogue: Σ_z G_z∘G_z, Σ G_z∘G_z a sample, G_z itself).
#pragma once

#include "common.cuh"  // bp::cdiv, bp::num_sms, bp::block_sum, bp::launch_sum_partials
#include "tf32x3.cuh"

namespace tf32x3 {

// ---------------------------------------------------------------------------
// xty: out_z[n·M + m] = Σ_k X_z[k, m] · Y_z[k, n] for z < Z, in 3xTF32.
// X_z = X + z·xs is [K_z, M] and Y_z is [K_z, N], both row-major; Y_z is row
// (yg ? z / yd : 0)·yr + (z mod yd) mod yr of Y in units of ys floats, so one
// Y row can serve many z without a copy (cross_dot's shared layer input);
// K_z = min(K, k_total − z·K) (a long row axis cut into Z pieces: kron).
// The z fall into Z / zn groups of zn (zn = 0: one group); a block's z lie
// in one group.  The epilogues, chosen by template so an unrequested one
// costs nothing:
//   STORE:  out_z, stored transposed, [N, M] a z, at out + z·os;
//   SQUARE: moment[q] = Σ out_z∘out_z over the z of block row q (a partial
//           [groups · z_blocks, N, M], the sum itself when z_blocks = 1),
//           squared from the promoted tile into float32 registers;
//   ROWSUM: rowsum[t·Z + z] = Σ out_z∘out_z over output tile t (a partial
//           [tiles, Z], the sum itself when there is one tile).
// ---------------------------------------------------------------------------

enum : int { XTY_STORE = 1, XTY_SQUARE = 2, XTY_ROWSUM = 4 };

struct XtyArgs {
  const float* X;
  const float* Y;
  float* out;
  float* moment;
  float* rowsum;
  int M, N, Z, zn;
  long long K, k_total, xs, ys, os;
  int yd, yr, yg;
  int z_per_block, z_blocks;  // set by the launch
  bool vx, vy;  // 16-byte copies of X / Y
};

constexpr int XTY_RS = 32;  // rows a stage: four k-steps of 8
constexpr int XTY_STAGES = 3;
constexpr int XTY_THREADS = 128;  // warps 2 (m) x 2 (n), each 16·MI x 8·NI

template <int MI, int NI>
constexpr int xty_smem_bytes() {
  return XTY_STAGES * XTY_RS * (32 * MI + 8 + 16 * NI + 8) * 4;
}

// Grid (N tiles · M tiles, groups · z blocks).  A block walks its z in
// order, the rows of one z after another through one cp.async ring, so a
// short K (64 rows at 3C3D's conv3) costs no ring fill a z; the epilogues
// run when a z's last stage has been added.  The tiles of one z block are
// issued together (blockIdx.x fastest), so each z's rows come from device
// memory once and from L2 for the other tiles.
template <int MI, int NI, int EPI = XTY_STORE>
__global__ void __launch_bounds__(XTY_THREADS) xty_kernel(const XtyArgs p) {
  constexpr int TM = 32 * MI, TN = 16 * NI, RS = XTY_RS, S = XTY_STAGES;
  constexpr int PM = TM + 8, PN = TN + 8, STAGE = RS * (PM + PN);
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[32];  // ROWSUM's block sums
  const int tiles_m = (p.M + TM - 1) / TM;
  const int m0 = blockIdx.x % tiles_m * TM, n0 = blockIdx.x / tiles_m * TN;
  const int zn = p.zn > 0 ? p.zn : p.Z;
  const int z0 = blockIdx.y / p.z_blocks * zn + blockIdx.y % p.z_blocks * p.z_per_block;
  const int z1 = min(z0 - z0 % zn + zn, z0 + p.z_per_block);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = 16 * MI * (warp / 2), wn = 8 * NI * (warp % 2);
  const int g = lane / 4, t = lane % 4;
  const int spz = (int)((p.K + RS - 1) / RS);  // stages a z
  const int steps = (z1 - z0) * spz;

  auto copy = [&](int step) {
    const int z = z0 + step / spz;
    const long long k0 = (long long)(step % spz) * RS;
    const long long kz = min(p.K, p.k_total - (long long)z * p.K);
    const long long yrow = (long long)(p.yg ? z / p.yd : 0) * p.yr + z % p.yd % p.yr;
    float* st = smem + (step % S) * STAGE;
    stage_rows(st, p.X + z * p.xs, p.M, p.M, m0, TM, RS, k0, kz, p.vx, XTY_THREADS);
    stage_rows(st + RS * PM, p.Y + yrow * p.ys, p.N, p.N, n0, TN, RS, k0, kz, p.vy, XTY_THREADS);
  };

  // acc[mi][ni][c]: m = wm + 16mi + g + 8(c/2), n = wn + 8ni + 2t + c%2.
  float acc[MI][NI][4], mom[MI][NI][4];
  zero(acc);
  zero(mom);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) copy(s);
    cp_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_wait<S - 2>();
    __syncthreads();  // the stage of `step` is in; the one of step − 1 is free
    if (step + S - 1 < steps) copy(step + S - 1);
    cp_commit();
    const float* xs = smem + (step % S) * STAGE;
    const float* ys = xs + RS * PM;
#pragma unroll
    for (int k0 = 0; k0 < RS; k0 += 16) {  // 16 rows at a time, promoted
      uint32_t bh[2][NI][2], bl[2][NI][2];
#pragma unroll
      for (int kq = 0; kq < 2; ++kq)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          frag_b_kn(ys, PN, k0 + 8 * kq, wn + 8 * ni, bh[kq][ni], bl[kq][ni]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {  // a row of tiles at a time
        float tc[1][NI][4];
        zero(tc);
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          uint32_t ah[1][4], al[1][4];
          frag_a_mk(xs, PM, k0 + 8 * kq, wm + 16 * mi, ah[0], al[0]);
          mma3(tc, ah, al, bh[kq], bl[kq]);
        }
        promote(acc[mi], tc[0]);
      }
    }
    if (step % spz == spz - 1) {  // z's last stage: the epilogues, the next z from 0
      const int z = z0 + step / spz;
      float* o = p.out + (long long)z * p.os;
      float sq = 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = m0 + wm + 16 * mi + g + 8 * (c / 2);
            const int n = n0 + wn + 8 * ni + 2 * t + c % 2;
            const float v = acc[mi][ni][c];  // 0 past the edges: the stages are zero-filled
            if (EPI & XTY_STORE)
              if (m < p.M && n < p.N) o[(long long)n * p.M + m] = v;
            if (EPI & XTY_SQUARE) mom[mi][ni][c] = fmaf(v, v, mom[mi][ni][c]);
            if (EPI & XTY_ROWSUM) sq = fmaf(v, v, sq);
            acc[mi][ni][c] = 0.f;
          }
      if (EPI & XTY_ROWSUM) {
        const float s = bp::block_sum(sq, red);
        if (threadIdx.x == 0) p.rowsum[(long long)blockIdx.x * p.Z + z] = s;
      }
    }
  }
  cp_wait<0>();
  if (EPI & XTY_SQUARE) {
    float* o = p.moment + (long long)blockIdx.y * p.M * p.N;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + wm + 16 * mi + g + 8 * (c / 2);
          const int n = n0 + wn + 8 * ni + 2 * t + c % 2;
          if (m < p.M && n < p.N) o[(long long)n * p.M + m] = mom[mi][ni][c];
        }
  }
}

struct XtyTile {
  int mi, ni;  // TM = 32·mi, TN = 16·ni
};

// Of the warp tiles 16·MI x 8·NI with MI ∈ {2, 3, 4}, NI ∈ {4, 5, 6} and
// MI·NI ≤ most (18: the larger ones spill at 255 registers; 12 with SQUARE's
// moment registers), the one whose block tiles pad M x N least (the larger
// tile on a tie): a = 75 columns take 80, 576 and 864 take 96, b = 128 takes
// 128 for kron and 2 x 64 against a = 864.
inline XtyTile xty_tile(int M, int N, int most = 18) {
  XtyTile best{2, 4};
  long long best_area = -1;
  for (int mi = 2; mi <= 4; ++mi)
    for (int ni = 4; ni <= 6; ++ni) {
      if (mi * ni > most) continue;
      const long long area = bp::cdiv(M, 32 * mi) * 32 * mi * bp::cdiv(N, 16 * ni) * 16 * ni;
      if (best_area < 0 || area < best_area ||
          (area == best_area && mi * ni > best.mi * best.ni))
        best = {mi, ni}, best_area = area;
    }
  return best;
}

struct XtyFn {
  void (*fn)(XtyArgs);
  int smem;
};

template <int MI, int NI, int EPI>
XtyFn xty_fn() {
  return {xty_kernel<MI, NI, EPI>, xty_smem_bytes<MI, NI>()};
}

// The instance of xty_kernel for xty_tile's tile (MI·NI ≤ 12 with SQUARE).
template <int EPI>
XtyFn xty_instance(XtyTile t) {
  switch (10 * t.mi + t.ni) {
    case 24: return xty_fn<2, 4, EPI>();
    case 25: return xty_fn<2, 5, EPI>();
    case 26: return xty_fn<2, 6, EPI>();
    case 34: return xty_fn<3, 4, EPI>();
  }
  if constexpr (EPI & XTY_SQUARE) {
    return xty_fn<3, 4, EPI>();
  } else {
    switch (10 * t.mi + t.ni) {
      case 35: return xty_fn<3, 5, EPI>();
      case 36: return xty_fn<3, 6, EPI>();
    }
    return xty_fn<4, 4, EPI>();
  }
}

struct XtyPlan {
  XtyFn fn;
  long long tiles;         // output tiles (grid x)
  int z_per_block, z_blocks;
  cudaError_t err;
};

// The instance, its output tiles and the z a block: the count whose blocks
// fill whole waves soonest (bp::wave_chunk) within each group.
template <int EPI>
XtyPlan xty_plan(const XtyArgs& p) {
  XtyPlan q{};
  const XtyTile t = xty_tile(p.M, p.N, EPI & XTY_SQUARE ? 12 : 18);
  q.fn = xty_instance<EPI>(t);
  q.err = cudaFuncSetAttribute(q.fn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, q.fn.smem);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, q.fn.fn, XTY_THREADS, q.fn.smem);
  q.tiles = bp::cdiv(p.M, 32 * t.mi) * bp::cdiv(p.N, 16 * t.ni);
  const int zn = p.zn > 0 ? p.zn : p.Z;
  q.z_per_block = bp::wave_chunk(zn, q.tiles * (p.Z / zn), (per_sm > 0 ? per_sm : 1) * bp::num_sms(),
                                 bp::cdiv(p.K, XTY_RS) + 1, XTY_STAGES + 2);
  q.z_blocks = (int)bp::cdiv(zn, q.z_per_block);
  return q;
}

// Launches xty_kernel with xty_plan's instance.  The caller sets every field
// but z_per_block and z_blocks (and the pointers of the epilogues it asks
// for).
template <int EPI = XTY_STORE>
cudaError_t xty_launch(XtyArgs p, cudaStream_t stream) {
  const XtyPlan q = xty_plan<EPI>(p);
  if (q.err != cudaSuccess) return q.err;
  p.z_per_block = q.z_per_block;
  p.z_blocks = q.z_blocks;
  const int groups = p.Z / (p.zn > 0 ? p.zn : p.Z);
  const dim3 grid((unsigned)q.tiles, (unsigned)(groups * q.z_blocks));
  q.fn.fn<<<grid, XTY_THREADS, q.fn.smem, stream>>>(p);
  return cudaGetLastError();
}

// Whether a row-major [*, cols] matrix at ptr (rows `stride` floats apart
// between pieces) can take 16-byte copies.
inline bool vec_ok(const void* ptr, long long cols, long long stride) {
  return cols % 4 == 0 && stride % 4 == 0 && (uintptr_t)ptr % 16 == 0;
}

// ---------------------------------------------------------------------------
// per_sample: the one-class per-sample product of fused_first_order and
// per_sample_moment, G[e,n] = A[e,n]ᵀB[e,n] for A [E, N, R, a] and B [E, N,
// R, b], through xty_kernel with X = B and Y = A (so out_z is G in [a, b]
// order), z = e·N + n in E groups of N.  Its outputs, as EPI asks:
//   G      [E, N, ld]  STORE: rows of ld ≥ a·b floats (cross_dot's layout);
//   moment [E, a, b]   SQUARE: Σ_n G∘G;
//   l2     [E, N]      ROWSUM: Σ_ab G∘G.
// The partials (moment's z blocks, l2's tiles) go to scratch, and a second
// pass adds them in a fixed order: deterministic, no atomics.
// ---------------------------------------------------------------------------

inline XtyArgs per_sample_args(const float* A, const float* B, int E, int N, int R, int a,
                               int b) {
  XtyArgs p{};
  p.X = B;
  p.Y = A;
  p.M = b;
  p.N = a;
  p.Z = E * N;
  p.zn = N;
  p.K = R;
  p.k_total = (long long)p.Z * R;
  p.xs = (long long)R * b;
  p.ys = (long long)R * a;
  p.yd = p.yr = p.Z;
  p.yg = 0;
  p.vx = vec_ok(B, b, p.xs);
  p.vy = vec_ok(A, a, p.ys);
  return p;
}

struct PerSampleParts {
  XtyPlan plan;
  long long moment, l2;  // scratch floats of each partial (0: written in place)
};

template <int EPI>
PerSampleParts per_sample_parts(const XtyArgs& p) {
  PerSampleParts s{xty_plan<EPI>(p), 0, 0};
  if ((EPI & XTY_SQUARE) && s.plan.z_blocks > 1)
    s.moment = (long long)(p.Z / p.zn) * s.plan.z_blocks * p.M * p.N;
  if ((EPI & XTY_ROWSUM) && s.plan.tiles > 1) s.l2 = s.plan.tiles * p.Z;
  return s;
}

template <int EPI>
long long per_sample_scratch_floats(const XtyArgs& p) {
  const PerSampleParts s = per_sample_parts<EPI>(p);
  return s.moment + s.l2;
}

// p from per_sample_args; G (with its row stride ld), moment and l2 as EPI
// asks; scratch holds per_sample_scratch_floats.
template <int EPI>
cudaError_t per_sample_launch(XtyArgs p, float* G, long long ld, float* moment, float* l2,
                              float* scratch, cudaStream_t stream) {
  const PerSampleParts s = per_sample_parts<EPI>(p);
  p.out = G;
  p.os = ld;
  p.moment = s.moment ? scratch : moment;
  p.rowsum = s.l2 ? scratch + s.moment : l2;
  const cudaError_t err = xty_launch<EPI>(p, stream);
  if (err != cudaSuccess) return err;
  if (s.moment)
    bp::launch_sum_partials(p.moment, moment, p.Z / p.zn, s.plan.z_blocks,
                            (long long)p.M * p.N, stream);
  if (s.l2) bp::launch_sum_partials(p.rowsum, l2, 1, (int)s.plan.tiles, p.Z, stream);
  return cudaGetLastError();
}

}  // namespace tf32x3
