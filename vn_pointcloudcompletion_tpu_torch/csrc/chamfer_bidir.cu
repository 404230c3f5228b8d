// Kernel D: exact nearest neighbour (squared distance and index) from every
// point of one cloud to another, launched once for each chamfer direction.
//
// Replaces vn_pointcloudcompletion_tpu/ops/chamfer_pallas_bidir.py
// ::nn_bidirectional_pallas (the pallas_call at :159, kernel body
// _bidir_kernel at :54).  The TPU kernel sweeps each distance tile once and
// carries the column minima across a sequential x-tile grid axis; Hopper runs
// blocks in no order, so this port takes the other exact design: a one-sided
// kernel launched for x -> y and again for y -> x.  It computes every
// distance twice and needs no combine across blocks.
//
// Semantics kept from the TPU kernel: the diff form (x - y)^2 summed over the
// coordinates in order, in float32 rounded after every operation (the file
// is built with --fmad=false), and ties go to the lowest index (the strict <
// below, scanning the targets in ascending order).
//
// Design.  A block owns kRows query points (kRowsPerThread per thread, in
// registers); the target cloud streams through shared memory in tiles of
// kTile points, one 16-byte load per target point that every thread of the
// warp reads at once.  Bound on the H100: operations, about 11 FP32/ALU
// instructions per (query, target) pair on the CUDA cores; the inputs are a
// few megabytes and stay in L2.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 2;
constexpr int kRows = kThreads * kRowsPerThread;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn_one_sided(const float* __restrict__ x, const float* __restrict__ y,
             float* __restrict__ dist, int* __restrict__ idx, int N, int M) {
  __shared__ float4 ys[kTile];
  const int bi = blockIdx.y;
  const float* xb = x + static_cast<size_t>(bi) * N * 3;
  const float* yb = y + static_cast<size_t>(bi) * M * 3;

  float xr[kRowsPerThread][3];
  float best[kRowsPerThread];
  int best_i[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int n = blockIdx.x * kRows + r * kThreads + threadIdx.x;
    const bool ok = n < N;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      xr[r][k] = ok ? xb[static_cast<size_t>(n) * 3 + k] : 0.f;
    best[r] = INFINITY;
    best_i[r] = 0;
  }

  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int cnt = min(kTile, M - m0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const float* t = yb + static_cast<size_t>(m0 + e) * 3;
      ys[e] = make_float4(t[0], t[1], t[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int e = 0; e < cnt; ++e) {
      const float4 v = ys[e];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float d0 = xr[r][0] - v.x;
        const float d1 = xr[r][1] - v.y;
        const float d2 = xr[r][2] - v.z;
        const float dd = d0 * d0 + d1 * d1 + d2 * d2;
        if (dd < best[r]) {
          best[r] = dd;
          best_i[r] = m0 + e;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int n = blockIdx.x * kRows + r * kThreads + threadIdx.x;
    if (n < N) {
      dist[static_cast<size_t>(bi) * N + n] = best[r];
      idx[static_cast<size_t>(bi) * N + n] = best_i[r];
    }
  }
}

}  // namespace

// x: (B, N, 3), y: (B, M, 3) float32 -> dist (B, N) float32, idx (B, N) int32.
VNK_EXPORT int chamfer_nn_one_sided(const void* x, const void* y, void* dist,
                                    void* idx, int B, int N, int M,
                                    void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + kRows - 1) / kRows, B);
  nn_one_sided<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(dist), static_cast<int*>(idx), N, M);
  return static_cast<int>(cudaGetLastError());
}
