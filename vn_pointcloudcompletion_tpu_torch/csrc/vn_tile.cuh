// The channel-map products of one tile of a VN layer, shared by the layer
// kernels (vn_layer_fused.cu, vn_layer_bwd.cu).
//
// For one sample, a tile of kCh output channels x kPts points:
//   p[j][c][n] = sum_k W[c][k] x[j][k][n],  d likewise with Wd (kWithD),
// for the three coordinate planes j.  The K loop stages kK input channels of
// W, Wd and x (all three planes) in shared memory.  Each of the kThreads
// threads holds a 4-channel x 4-point micro-tile of the accumulators (p and
// d, three planes each): channels c0 + ty*4 + i, points n0 + tx*4 + q.  The
// inner products call fmaf() explicitly, in input-channel order.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCh = 64;   // output channels per tile (16 groups x 4)
constexpr int kPts = 64;  // points per tile (16 groups x 4)
constexpr int kK = 8;     // input channels per shared-memory stage

struct VnkTileSmem {
  __align__(16) float ws[kK][kCh];
  __align__(16) float wds[kK][kCh];
  __align__(16) float xs[3][kK][kPts];
};

template <bool kWithD>
__device__ __forceinline__ void vnk_tile_products(
    const float* __restrict__ xb, const float* __restrict__ w,
    const float* __restrict__ wd, int Cin, int Cout, int N, int c0, int n0,
    VnkTileSmem& sm, float (&accp)[3][4][4], float (&accd)[3][4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) accp[j][i][q] = accd[j][i][q] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += kK) {
    for (int e = threadIdx.x; e < kCh * kK; e += kThreads) {
      const int c = e / kK, k = e % kK;
      const int gc = c0 + c, gk = k0 + k;
      const bool ok = gc < Cout && gk < Cin;
      sm.ws[k][c] = ok ? w[static_cast<size_t>(gc) * Cin + gk] : 0.f;
      if (kWithD) sm.wds[k][c] = ok ? wd[static_cast<size_t>(gc) * Cin + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < 3 * kK * kPts; e += kThreads) {
      const int j = e / (kK * kPts);
      const int r = e % (kK * kPts);
      const int k = r / kPts, nn = r % kPts;
      const int gk = k0 + k, gn = n0 + nn;
      sm.xs[j][k][nn] = (gk < Cin && gn < N)
                            ? xb[(static_cast<size_t>(j) * Cin + gk) * N + gn]
                            : 0.f;
    }
    __syncthreads();
    const int kmax = min(kK, Cin - k0);
    for (int k = 0; k < kmax; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&sm.ws[k][ty * 4]);
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
      float dr[4] = {0.f, 0.f, 0.f, 0.f};
      if (kWithD) {
        const float4 dv = *reinterpret_cast<const float4*>(&sm.wds[k][ty * 4]);
        dr[0] = dv.x; dr[1] = dv.y; dr[2] = dv.z; dr[3] = dv.w;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(&sm.xs[j][k][tx * 4]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            accp[j][i][q] = fmaf(wr[i], xr[q], accp[j][i][q]);
            if (kWithD) accd[j][i][q] = fmaf(dr[i], xr[q], accd[j][i][q]);
          }
      }
    }
    __syncthreads();
  }
}

// Sum v over the 16 threads of a point group row (same ty, tx = 0..15: 16
// neighbouring lanes of one warp), in a fixed butterfly order.  Every lane
// of the warp must call it.
__device__ __forceinline__ float vnk_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

}  // namespace
