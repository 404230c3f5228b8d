// Kernel F: greedy furthest-point sampling.
//
// Replaces vn_pointcloudcompletion_tpu/ops/fps_pallas.py
// ::furthest_point_sample_pallas (the pallas_call at :85, body _kernel :38).
//
// Semantics kept from the TPU kernel: the first sample is index 0; every
// step updates each point's running minimum of the squared distance to the
// samples so far, in the difference form d0*d0 + d1*d1 + d2*d2 with each
// operation rounded (the file is built with --fmad=false), and takes the
// first point of largest minimum (lowest index on ties).  Exact duplicate
// points (resample padding makes them) then behave as in the JAX package:
// once every minimum is 0 the argmax returns index 0 again.  The plain
// version in ops/fps_pallas.py does the same operations in the same order.
//
// Design.  The TPU kernel advances all samples of the batch together, one
// sample per sublane.  Here one 1024-thread block owns one sample: each
// thread keeps the running minima of up to 16 points in registers (N <=
// 16384, the gate of fps_pallas.eligible), reads its points' coordinates from
// the (B, 3, N) planes (L1-resident at N = 2048), and each of the S - 1 steps
// ends in a block-wide argmax (warp shuffles, then one warp over the 32
// partials).  Bound on the H100: operations, about 10 per point per step;
// the design is far from it, because each step is a chain of two block
// barriers and only B of the 132 SMs hold a block (8 at batch 8).
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 16;

// (value, index) of the larger value, the lower index on ties.
__device__ __forceinline__ void argmax_pair(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    argmax_pair(bv, bi, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ planes, int* __restrict__ idx, int N, int S) {
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int sel;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* x0 = planes + static_cast<int64_t>(blockIdx.x) * 3 * N;
  const float* x1 = x0 + N;
  const float* x2 = x1 + N;
  int* out = idx + static_cast<int64_t>(blockIdx.x) * S;

  float md[kPerThread];
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) md[t] = INFINITY;
  if (tid == 0) out[0] = 0;
  int cur = 0;
  for (int s = 1; s < S; ++s) {
    const float l0 = x0[cur], l1 = x1[cur], l2 = x2[cur];
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int p = tid + t * kThreads;
      if (p < N) {
        const float d0 = x0[p] - l0;
        const float d1 = x1[p] - l1;
        const float d2 = x2[p] - l2;
        const float dd = d0 * d0 + d1 * d1 + d2 * d2;
        md[t] = fminf(md[t], dd);
        if (md[t] > bv) {  // p rises with t: the strict > keeps the first
          bv = md[t];
          bi = p;
        }
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        sel = bi;
        out[s] = bi;
      }
    }
    __syncthreads();
    cur = sel;
  }
}

}  // namespace

// planes: (B, 3, N) float32 coordinate planes -> idx (B, S) int32; N <= 16384.
VNK_EXPORT int furthest_point_sample(const void* planes, void* idx, int B, int N,
                                     int S, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (N > kThreads * kPerThread || N == 0) return static_cast<int>(cudaErrorInvalidValue);
  fps_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<int*>(idx), N, S);
  return static_cast<int>(cudaGetLastError());
}
