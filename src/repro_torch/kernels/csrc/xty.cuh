// xty: the batched 3xTF32 product out_z = X_zᵀ·Y_z (tf32x3.cuh's helpers),
// which serves cross_dot's form stage (G = AᵀB per row) and
// fused_second_order's kron factor (SᵀS, its rows cut into pieces).
#pragma once

#include "common.cuh"  // bp::cdiv, bp::num_sms
#include "tf32x3.cuh"

namespace tf32x3 {

// ---------------------------------------------------------------------------
// xty: out_z[n·M + m] = Σ_k X_z[k, m] · Y_z[k, n] for z < Z, in 3xTF32.
// X_z = X + z·xs is [K_z, M] and Y_z is [K_z, N], both row-major; Y_z is row
// (yg ? z / yd : 0)·yr + (z mod yd) mod yr of Y in units of ys floats, so one
// Y row can serve many z without a copy (cross_dot's shared layer input);
// K_z = min(K, k_total − z·K) (a long row axis cut into Z pieces: kron).
// The result is stored transposed, [N, M] a z, at out + z·os.
// ---------------------------------------------------------------------------

struct XtyArgs {
  const float* X;
  const float* Y;
  float* out;
  int M, N, Z;
  long long K, k_total, xs, ys, os;
  int yd, yr, yg;
  int z_per_block;
  bool vx, vy;  // 16-byte copies of X / Y
};

constexpr int XTY_RS = 32;  // rows a stage: four k-steps of 8
constexpr int XTY_STAGES = 3;
constexpr int XTY_THREADS = 128;  // warps 2 (m) x 2 (n), each 16·MI x 8·NI

template <int MI, int NI>
constexpr int xty_smem_bytes() {
  return XTY_STAGES * XTY_RS * (32 * MI + 8 + 16 * NI + 8) * 4;
}

// Grid (N tiles · M tiles, z blocks).  A block walks its z in order, the
// rows of one z after another through one cp.async ring, so a short K (64
// rows at 3C3D's conv3) costs no ring fill a z; the tile is stored when a
// z's last stage has been added.
template <int MI, int NI>
__global__ void __launch_bounds__(XTY_THREADS) xty_kernel(const XtyArgs p) {
  constexpr int TM = 32 * MI, TN = 16 * NI, RS = XTY_RS, S = XTY_STAGES;
  constexpr int PM = TM + 8, PN = TN + 8, STAGE = RS * (PM + PN);
  extern __shared__ __align__(16) float smem[];
  const int tiles_m = (p.M + TM - 1) / TM;
  const int m0 = blockIdx.x % tiles_m * TM, n0 = blockIdx.x / tiles_m * TN;
  const int z0 = blockIdx.y * p.z_per_block;
  const int z1 = min(p.Z, z0 + p.z_per_block);
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
  float acc[MI][NI][4];
  zero(acc);
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
    if (step % spz == spz - 1) {  // z's last stage: store, start the next z at 0
      float* o = p.out + (long long)(z0 + step / spz) * p.os;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = m0 + wm + 16 * mi + g + 8 * (c / 2);
            const int n = n0 + wn + 8 * ni + 2 * t + c % 2;
            if (m < p.M && n < p.N) o[(long long)n * p.M + m] = acc[mi][ni][c];
            acc[mi][ni][c] = 0.f;
          }
    }
  }
  cp_wait<0>();
}

struct XtyTile {
  int mi, ni;  // TM = 32·mi, TN = 16·ni
};

// Of the warp tiles 16·MI x 8·NI with MI ∈ {2, 3, 4}, NI ∈ {4, 5, 6} and
// MI·NI ≤ 18 (the larger ones spill at 255 registers), the one whose block
// tiles pad M x N least (the larger tile on a tie): a = 75 columns take 80,
// 576 and 864 take 96, b = 128 takes 128 for kron and 2 x 64 against a = 864.
inline XtyTile xty_tile(int M, int N) {
  XtyTile best{2, 4};
  long long best_area = -1;
  for (int mi = 2; mi <= 4; ++mi)
    for (int ni = 4; ni <= 6; ++ni) {
      if (mi * ni > 18) continue;
      const long long area = bp::cdiv(M, 32 * mi) * 32 * mi * bp::cdiv(N, 16 * ni) * 16 * ni;
      if (best_area < 0 || area < best_area ||
          (area == best_area && mi * ni > best.mi * best.ni))
        best = {mi, ni}, best_area = area;
    }
  return best;
}

template <int MI, int NI>
cudaError_t xty_launch_mn(XtyArgs p, cudaStream_t stream) {
  constexpr int TM = 32 * MI, TN = 16 * NI, SMEM = xty_smem_bytes<MI, NI>();
  const cudaError_t err =
      cudaFuncSetAttribute(xty_kernel<MI, NI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xty_kernel<MI, NI>, XTY_THREADS, SMEM);
  const long long tiles = bp::cdiv(p.M, TM) * bp::cdiv(p.N, TN);
  p.z_per_block = bp::wave_chunk(p.Z, tiles, (per_sm > 0 ? per_sm : 1) * bp::num_sms(),
                             bp::cdiv(p.K, XTY_RS) + 1, XTY_STAGES + 2);
  const dim3 grid((unsigned)tiles, (unsigned)bp::cdiv(p.Z, p.z_per_block));
  xty_kernel<MI, NI><<<grid, XTY_THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

// Launches xty_kernel with xty_tile's tile.  The caller sets every field
// but z_per_block.
inline cudaError_t xty_launch(const XtyArgs& p, cudaStream_t stream) {
  const XtyTile t = xty_tile(p.M, p.N);
  switch (10 * t.mi + t.ni) {
    case 24: return xty_launch_mn<2, 4>(p, stream);
    case 25: return xty_launch_mn<2, 5>(p, stream);
    case 26: return xty_launch_mn<2, 6>(p, stream);
    case 34: return xty_launch_mn<3, 4>(p, stream);
    case 35: return xty_launch_mn<3, 5>(p, stream);
    case 36: return xty_launch_mn<3, 6>(p, stream);
    default: return xty_launch_mn<4, 4>(p, stream);
  }
}

// Whether a row-major [*, cols] matrix at ptr (rows `stride` floats apart
// between pieces) can take 16-byte copies.
inline bool vec_ok(const void* ptr, long long cols, long long stride) {
  return cols % 4 == 0 && stride % 4 == 0 && (uintptr_t)ptr % 16 == 0;
}

}  // namespace tf32x3
