// Shared pieces of the hand-written Hopper kernels (sm_90a).
//
// Every source in this directory is compiled on its own by nvcc into a shared
// library with a plain C interface and loaded with ctypes
// (ops/cuda_lib.py).  Each entry point launches on the caller's stream and
// returns cudaGetLastError() so that a refused launch is reported.
//
// The sources are compiled with --fmad=false: a * b + c is then rounded twice,
// exactly as PyTorch's elementwise kernels round it, so the epilogue below
// gives the same bits as the plain PyTorch versions on the same inputs.
// Inner products of the matrix kernels call fmaf() explicitly, which is
// always fused.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define VNK_EXPORT extern "C" __attribute__((visibility("default")))

VNK_EXPORT const char* vnk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

constexpr float VNK_EPS = 1e-6f;  // models/vn_layers.py:10 of the reference

// Folded norm-BatchNorm followed by the VN leaky reflection, for one vector
// (p, d) of one channel (vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py
// ::_epilogue, the same arithmetic as ops/vn_fused.py::_fwd_kernel):
//   norm_e = |p| + EPS;  s = A + B / norm_e;  q = p * s
//   dot = <q, d>;  z = <d, d> + EPS
//   out = q - [dot < 0] * (1 - ns) * dot / z * d
// The operation order matches the plain version in ops/vn_fused.py.
__device__ __forceinline__ void vnk_bn_leaky(float p0, float p1, float p2,
                                             float d0, float d1, float d2,
                                             float a, float b,
                                             float one_minus_ns, float* o) {
  const float norm_e = sqrtf(p0 * p0 + p1 * p1 + p2 * p2) + VNK_EPS;
  const float s = a + b / norm_e;
  const float q0 = p0 * s, q1 = p1 * s, q2 = p2 * s;
  const float dot = q0 * d0 + q1 * d1 + q2 * d2;
  const float z = d0 * d0 + d1 * d1 + d2 * d2 + VNK_EPS;
  const float coef = dot >= 0.f ? 0.f : one_minus_ns * dot / z;
  o[0] = q0 - coef * d0;
  o[1] = q1 - coef * d1;
  o[2] = q2 - coef * d2;
}

// Backward of vnk_bn_leaky for one vector, given the cotangent g of its
// output (vn_pointcloudcompletion_tpu/ops/vn_fused.py::_bwd_kernel, the same
// arithmetic in the same order as ops/vn_fused.py::reference_bn_leaky_bwd):
//   c1 = (1-ns) [dot < 0];  k1 = c1 <d, g> / z;  dq = g - k1 d
//   dd = -(c1 r g + k1 q - 2 k1 r d)
//   dp = s dq - (B <dq, p> / |p| / norm_e^2) p      (0 where |p| = 0)
// Writes dp and dd, and returns <dq, p> and norm_e, the per-channel sums of
// dA (sum <dq, p>) and dB (sum <dq, p> / norm_e).  With o != nullptr it also
// writes the forward output q - c1 r d, which the projected layer's w_out
// gradient needs.
__device__ __forceinline__ void vnk_bn_leaky_bwd(
    const float p[3], const float d[3], const float g[3], float a, float b,
    float one_minus_ns, float dp[3], float dd[3], float* dqp_out,
    float* norm_e_out, float* o) {
  const float pnorm = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
  const float norm_e = pnorm + VNK_EPS;
  const float s = a + b / norm_e;
  const float q[3] = {p[0] * s, p[1] * s, p[2] * s};
  const float dot = q[0] * d[0] + q[1] * d[1] + q[2] * d[2];
  const float z = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + VNK_EPS;
  const float r = dot / z;
  const float c1 = dot >= 0.f ? 0.f : one_minus_ns;
  const float dg = d[0] * g[0] + d[1] * g[1] + d[2] * g[2];
  const float k1 = c1 * dg / z;
  const float dq[3] = {g[0] - k1 * d[0], g[1] - k1 * d[1], g[2] - k1 * d[2]};
  const float k2 = c1 * r;
  const float k3 = 2.f * k1 * r;
#pragma unroll
  for (int j = 0; j < 3; ++j) dd[j] = -(k2 * g[j] + k1 * q[j] - k3 * d[j]);
  const float dqp = dq[0] * p[0] + dq[1] * p[1] + dq[2] * p[2];
  const float inv_pnorm = pnorm > 0.f ? 1.f / fmaxf(pnorm, 1e-30f) : 0.f;
  const float coef_p = b * dqp * inv_pnorm / (norm_e * norm_e);
#pragma unroll
  for (int j = 0; j < 3; ++j) dp[j] = s * dq[j] - coef_p * p[j];
  if (o != nullptr) {
#pragma unroll
    for (int j = 0; j < 3; ++j) o[j] = q[j] - k2 * d[j];
  }
  *dqp_out = dqp;
  *norm_e_out = norm_e;
}

// Sums across blocks without atomics.  A kernel that reduces over points
// writes one partial per block; vnk_reduce_rows then sums in[g, :, c] over
// its rows into out[g, c] in a fixed order (each thread a strided run of
// rows, then a tree in shared memory), so every run gives the same bits.
namespace {

constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
vnk_reduce_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int rows, int64_t cols) {
  __shared__ float red[kReduceThreads];
  const int64_t g = blockIdx.y;
  const int64_t c = blockIdx.x;
  const float* base = in + g * rows * cols + c;
  float s = 0.f;
  for (int r = threadIdx.x; r < rows; r += kReduceThreads)
    s += base[static_cast<int64_t>(r) * cols];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[g * cols + c] = red[0];
}

// Few rows and many columns (the split-K partials of a weight gradient): one
// thread per column sums its rows in order.
__global__ void __launch_bounds__(kReduceThreads)
vnk_reduce_few_rows_kernel(const float* __restrict__ in,
                           float* __restrict__ out, int rows, int64_t cols) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (c >= cols) return;
  const int64_t g = blockIdx.y;
  const float* base = in + g * rows * cols + c;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += base[static_cast<int64_t>(r) * cols];
  out[g * cols + c] = s;
}

// in: (groups, rows, cols) -> out: (groups, cols); cols < 2^31.
inline void vnk_reduce_rows(const float* in, float* out, int groups, int rows,
                            int64_t cols, cudaStream_t stream) {
  if (groups == 0 || cols == 0) return;
  if (rows <= 64 && cols >= 4096) {
    const unsigned blocks = static_cast<unsigned>((cols + kReduceThreads - 1) / kReduceThreads);
    vnk_reduce_few_rows_kernel<<<dim3(blocks, groups), kReduceThreads, 0,
                                 stream>>>(in, out, rows, cols);
    return;
  }
  vnk_reduce_rows_kernel<<<dim3(static_cast<unsigned>(cols), groups),
                           kReduceThreads, 0, stream>>>(in, out, rows, cols);
}

}  // namespace
