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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VNK_EXPORT extern "C" __attribute__((visibility("default")))

VNK_EXPORT const char* vnk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

constexpr float VNK_EPS = 1e-6f;  // models/vn_layers.py:10 of the reference

// The element types of the activations: float32, or bfloat16 under the
// bfloat16 compute policy (nn/precision.py).  A bfloat16 kernel reads its
// activations as bf16, computes in float32 and stores bf16 rounded to
// nearest even (the TPU kernels' `.astype(jnp.float32)` ... `.astype(
// out_ref.dtype)`); the conversions are the cuda_bf16.h intrinsics.
typedef __nv_bfloat16 vnk_bf16;

__device__ __forceinline__ float vnk_load(float v) { return v; }
__device__ __forceinline__ float vnk_load(vnk_bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T vnk_cast(float v);
template <>
__device__ __forceinline__ float vnk_cast<float>(float v) { return v; }
template <>
__device__ __forceinline__ vnk_bf16 vnk_cast<vnk_bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded through bf16 and back (exact in float32).
__device__ __forceinline__ float vnk_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__host__ __device__ constexpr bool vnk_is_bf16() { return sizeof(T) == 2; }

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

// The blocks of `kernel` (a __global__ function) that the card holds at
// once, at `threads` threads and `smem` bytes of dynamic shared memory (the
// kernel is allowed that much above 48 KB first): its occupancy times the
// SMs, or 0 if the runtime refuses.  The runtime's queries cost host time
// that a launch of a short kernel would wait for, so the answer is kept per
// kernel, device and size; the first launch asks.  The kernel's limit only
// rises, to the largest size asked for so far: a lower one would refuse a
// larger size answered from the cache.
inline int vnk_resident_blocks(const void* kernel, int threads, int smem) {
  struct Entry {
    const void* kernel;
    int dev, threads, smem, slots;
  };
  static Entry cache[32];
  static int used = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev && cache[i].threads == threads &&
        cache[i].smem == smem)
      return cache[i].slots;
  int sms = 0, per_sm = 0, limit = smem;
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev && cache[i].smem > limit)
      limit = cache[i].smem;
  if ((smem > 48 * 1024 &&
       cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit) !=
           cudaSuccess) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  if (used < 32) cache[used++] = {kernel, dev, threads, smem, sms * per_sm};
  return sms * per_sm;
}

// Sums across blocks without atomics.  A kernel that reduces over points
// writes one partial per block; vnk_reduce_rows then sums in[g, :, c] over
// its rows into out[g, c] in a fixed order (each thread a strided run of
// rows, then a tree in shared memory), so every run gives the same bits.
namespace {

constexpr int kReduceThreads = 256;
// vnk_reduce_rows sums a column one thread in order where it has at most
// kReduceFewRows rows and the rows at least kReduceFewCols columns (or 8
// rows or fewer), else over a tree of kReduceThreads.  ops/vn_layer_fused.py
// ::wide_split caps the wgmma design's split-K partials at kReduceFewRows
// (REDUCE_FEW_ROWS there; its Cin, Cout multiples of 64 give >= 4096
// columns), so its reduction takes the one-thread sum.
constexpr int kReduceFewRows = 64;
constexpr int64_t kReduceFewCols = 4096;

// Both kernels walk the groups in strides of gridDim.y (at most 65535).
__global__ void __launch_bounds__(kReduceThreads)
vnk_reduce_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int groups, int rows, int64_t cols) {
  __shared__ float red[kReduceThreads];
  const int64_t c = blockIdx.x;
  for (int64_t g = blockIdx.y; g < groups; g += gridDim.y) {
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
    __syncthreads();
  }
}

// Few rows (the split-K partials of a weight gradient; the bias partials of
// a group=S layer, one to a column at S = 64): one thread per column sums
// its rows in order.
__global__ void __launch_bounds__(kReduceThreads)
vnk_reduce_few_rows_kernel(const float* __restrict__ in,
                           float* __restrict__ out, int groups, int rows,
                           int64_t cols) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (c >= cols) return;
  for (int64_t g = blockIdx.y; g < groups; g += gridDim.y) {
    const float* base = in + g * rows * cols + c;
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += base[static_cast<int64_t>(r) * cols];
    out[g * cols + c] = s;
  }
}

// in: (groups, rows, cols) -> out: (groups, cols); cols < 2^31.
inline void vnk_reduce_rows(const float* in, float* out, int groups, int rows,
                            int64_t cols, cudaStream_t stream) {
  if (groups == 0 || cols == 0) return;
  const unsigned gy = static_cast<unsigned>(groups < 65535 ? groups : 65535);
  if (rows <= 8 || (rows <= kReduceFewRows && cols >= kReduceFewCols)) {
    const unsigned blocks = static_cast<unsigned>((cols + kReduceThreads - 1) / kReduceThreads);
    vnk_reduce_few_rows_kernel<<<dim3(blocks, gy), kReduceThreads, 0,
                                 stream>>>(in, out, groups, rows, cols);
    return;
  }
  vnk_reduce_rows_kernel<<<dim3(static_cast<unsigned>(cols), gy),
                           kReduceThreads, 0, stream>>>(in, out, groups, rows, cols);
}

}  // namespace
