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
//
// x is float32 or, in the bf16 mode (T = vnk_bf16), bfloat16; W and Wd are
// float32 parameters and are then rounded to bf16 as they are staged (JAX
// vn_layer_fused.py::_dot casts both operands to bf16).  The stages hold
// float32 either way: a product of two bf16 values is exact in float32, so
// the sums are float32 sums of exact products, as the TPU's bf16 matrix
// unit with float32 accumulation gives them.
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

template <bool kWithD, typename T>
__device__ __forceinline__ void vnk_tile_products(
    const T* __restrict__ xb, const float* __restrict__ w,
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
      float wv = ok ? w[static_cast<size_t>(gc) * Cin + gk] : 0.f;
      if (vnk_is_bf16<T>()) wv = vnk_round_bf16(wv);
      sm.ws[k][c] = wv;
      if (kWithD) {
        float dv = ok ? wd[static_cast<size_t>(gc) * Cin + gk] : 0.f;
        if (vnk_is_bf16<T>()) dv = vnk_round_bf16(dv);
        sm.wds[k][c] = dv;
      }
    }
    for (int e = threadIdx.x; e < 3 * kK * kPts; e += kThreads) {
      const int j = e / (kK * kPts);
      const int r = e % (kK * kPts);
      const int k = r / kPts, nn = r % kPts;
      const int gk = k0 + k, gn = n0 + nn;
      sm.xs[j][k][nn] = (gk < Cin && gn < N)
                            ? vnk_load(xb[(static_cast<size_t>(j) * Cin + gk) * N + gn])
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

// v rounded through the activation type T: unchanged for float32, through
// bf16 and back in the bf16 mode (the products' operands W, Wd, and the
// planes p, d once their float32 sum is complete).
template <typename T>
__device__ __forceinline__ float vnk_round_as(float v) {
  return vnk_is_bf16<T>() ? vnk_round_bf16(v) : v;
}

// Sum v over aligned runs of `lanes` (1, 2, 4, 8 or 16) threads of a point
// group row (same ty, tx = 0..15: 16 neighbouring lanes of one warp), in a
// fixed butterfly order; every lane of a run ends with the run's sum.
// `lanes` must be the same in the whole warp, and every lane must call it.
__device__ __forceinline__ float vnk_sum_lanes(float v, int lanes) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    if (off < lanes) v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

__device__ __forceinline__ float vnk_sum16(float v) { return vnk_sum_lanes(v, 16); }

// The bias of output channel c, plane j, at point n of sample bi:
//   group == 0: one column per sample, bias (B, 3, Cout);
//   group  > 0: one column per `group` consecutive points, bias
//               (B, 3, Cout, N / group), column n / group (the JAX kernels'
//               in-register expansion, vn_layer_fused.py:74-84).
// n past the end reads the last column (its point is masked by the caller).
// The bias is stored in the activations' type and read as float32.
template <typename T>
__device__ __forceinline__ float vnk_bias(const T* __restrict__ bias, int bi,
                                          int j, int c, int Cout, int n, int N,
                                          int group) {
  const size_t row = (static_cast<size_t>(bi) * 3 + j) * Cout + c;
  if (group == 0) return vnk_load(bias[row]);
  return vnk_load(bias[row * (N / group) + min(n, N - 1) / group]);
}

// p and d of output channel c at point n < N of sample bi (three planes
// each) into pd_out (2, B, 3, Cout, N) of the activations' type, p then d:
// the planes a layer kernel's epilogue (or its backward) reads, handed to
// tests (kernels C and C' write them where their pd_out is not null).
template <typename T>
__device__ __forceinline__ void vnk_put_pd(T* __restrict__ pd_out, int B, int bi, int c,
                                           int Cout, int n, int N, const float (&p)[3],
                                           const float (&d)[3]) {
  const size_t plane = static_cast<size_t>(B) * 3 * Cout * N;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const size_t at = ((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N + n;
    pd_out[at] = vnk_cast<T>(p[j]);
    pd_out[plane + at] = vnk_cast<T>(d[j]);
  }
}

}  // namespace
