// Kernel A: folded norm-BatchNorm + VN leaky reflection on plane-layout
// features, one pass; kernel A' (vn_bn_leaky_bwd, below): its backward.
//
// A replaces vn_pointcloudcompletion_tpu/ops/vn_fused.py::fused_bn_leaky
// (the pallas_call at :189, kernel body _fwd_kernel at :76).
//
// p, d, out: (B, 3, C, N), contiguous, float32 or (the bf16 mode, the
// bfloat16 compute policy) bfloat16; a, b: (C,) float32, the folded BN
// affine.  One thread per (b, c, n) vector: it reads the three planes of p
// and d and writes the three planes of out.  Neighbouring threads take
// neighbouring n, so every plane is read and written in full coalesced
// lines.  The bf16 mode is the TPU kernel's on bf16 planes (vn_fused.py
// :76-95): it reads p and d as bf16, computes in float32 in the float32
// mode's order and stores bf16 rounded to nearest even.
//
// Bound on the H100: bytes.  The pass moves 3 * B*3*C*N*s bytes (p and d
// read once, out written once; s = 4, or 2 in the bf16 mode) and does some
// 40 operations per vector, far below the FP32 rate for that traffic, so
// the design only has to keep every access coalesced and touch each byte
// once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_leaky_fwd(const T* __restrict__ p, const T* __restrict__ d,
             const float* __restrict__ a, const float* __restrict__ b,
             T* __restrict__ out, int C, int64_t N, int64_t total,
             float one_minus_ns) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t cn = static_cast<int64_t>(C) * N;
  const int64_t bi = i / cn;
  const int64_t r = i - bi * cn;
  const int c = static_cast<int>(r / N);
  const int64_t base = bi * 3 * cn + r;
  float o[3];
  vnk_bn_leaky(vnk_load(p[base]), vnk_load(p[base + cn]), vnk_load(p[base + 2 * cn]),
               vnk_load(d[base]), vnk_load(d[base + cn]), vnk_load(d[base + 2 * cn]),
               a[c], b[c], one_minus_ns, o);
  out[base] = vnk_cast<T>(o[0]);
  out[base + cn] = vnk_cast<T>(o[1]);
  out[base + 2 * cn] = vnk_cast<T>(o[2]);
}

// Kernel A': the backward of A.  Replaces vn_fused.py::_fused_bwd (the
// pallas_call at :214, kernel body _bwd_kernel at :98).
//
// Reads p, d and the cotangent g, writes dp and dd (all (B, 3, C, N)) and
// the per-channel sums dA = sum <dq, p>, dB = sum <dq, p> / norm_e over
// batch and points.  A block owns kBwdPts points of one (sample, channel)
// row; each thread takes kBwdPts / kThreads points, kThreads apart, so every
// plane is read and written in full coalesced lines.  The sums cross
// blocks: each block reduces its points in a fixed tree and writes one
// partial per (sample, point tile, channel) to a scratch buffer that the
// wrapper allocates, and vnk_reduce_rows sums those in a fixed order.  No
// float atomics, so the result is the same on every run.
//
// The bf16 mode (vn_bn_leaky_bwd_bf16: p, d, g, dp and dd bfloat16; a, b
// and the partials float32) is the TPU kernel's on bf16 planes (:98-146,
// out_shape p.dtype at :223-224): bf16 loads, the float32 arithmetic of the
// float32 mode, dp and dd rounded to nearest even as they are stored, and
// the dA, dB partials summed from the float32 values.
//
// Bound on the H100: bytes, 5 * B*3*C*N*s (p, d, g read, dp, dd written;
// s = 4, or 2 in the bf16 mode); some 70 operations per vector are far
// below the FP32 rate for that.
constexpr int kBwdPts = 1024;

template <typename E>
__global__ void __launch_bounds__(kThreads)
bn_leaky_bwd(const E* __restrict__ p, const E* __restrict__ d,
             const float* __restrict__ a, const float* __restrict__ b,
             const E* __restrict__ g, E* __restrict__ dp,
             E* __restrict__ dd, float* __restrict__ partial, int B,
             int C, int N, float one_minus_ns) {
  __shared__ float red[2][kThreads];
  const int t = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int T = gridDim.x;
  const int64_t cn = static_cast<int64_t>(C) * N;
  const int64_t row = static_cast<int64_t>(bi) * 3 * cn + static_cast<int64_t>(c) * N;
  const float av = a[c], bv = b[c];
  float sa = 0.f, sb = 0.f;
  for (int k = 0; k < kBwdPts / kThreads; ++k) {
    const int n = t * kBwdPts + k * kThreads + threadIdx.x;
    if (n >= N) break;
    const int64_t i = row + n;
    const float pv[3] = {vnk_load(p[i]), vnk_load(p[i + cn]), vnk_load(p[i + 2 * cn])};
    const float dv[3] = {vnk_load(d[i]), vnk_load(d[i + cn]), vnk_load(d[i + 2 * cn])};
    const float gv[3] = {vnk_load(g[i]), vnk_load(g[i + cn]), vnk_load(g[i + 2 * cn])};
    float dpv[3], ddv[3], dqp, norm_e;
    vnk_bn_leaky_bwd(pv, dv, gv, av, bv, one_minus_ns, dpv, ddv, &dqp,
                     &norm_e, nullptr);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dp[i + j * cn] = vnk_cast<E>(dpv[j]);
      dd[i + j * cn] = vnk_cast<E>(ddv[j]);
    }
    sa += dqp;
    sb += dqp / norm_e;
  }
  red[0][threadIdx.x] = sa;
  red[1][threadIdx.x] = sb;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      red[0][threadIdx.x] += red[0][threadIdx.x + h];
      red[1][threadIdx.x] += red[1][threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    // partial: (2, B, T, C)
    const int64_t rows = static_cast<int64_t>(B) * T;
    const int64_t o = (static_cast<int64_t>(bi) * T + t) * C + c;
    partial[o] = red[0][0];
    partial[rows * C + o] = red[1][0];
  }
}

template <typename E>
int launch_bwd(const void* p, const void* d, const void* a, const void* b,
               const void* g, void* dp, void* dd, void* dadb, void* partial,
               int B, int C, int N, float one_minus_ns, void* stream) {
  if (static_cast<int64_t>(B) * C * N == 0) return 0;
  const int T = (N + kBwdPts - 1) / kBwdPts;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_leaky_bwd<E><<<dim3(T, C, B), kThreads, 0, st>>>(
      static_cast<const E*>(p), static_cast<const E*>(d),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const E*>(g), static_cast<E*>(dp), static_cast<E*>(dd),
      static_cast<float*>(partial), B, C, N, one_minus_ns);
  vnk_reduce_rows(static_cast<const float*>(partial), static_cast<float*>(dadb),
                  2, B * T, C, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dadb: (2, C) -> dA, dB; partial: scratch of 2 * B * ceil(N / 1024) * C
// floats.  p, d, g, dp and dd float32 here, bfloat16 in the _bf16 entry.
VNK_EXPORT int vn_bn_leaky_bwd(const void* p, const void* d, const void* a,
                               const void* b, const void* g, void* dp,
                               void* dd, void* dadb, void* partial, int B,
                               int C, int N, float one_minus_ns,
                               void* stream) {
  return launch_bwd<float>(p, d, a, b, g, dp, dd, dadb, partial, B, C, N,
                           one_minus_ns, stream);
}

VNK_EXPORT int vn_bn_leaky_bwd_bf16(const void* p, const void* d,
                                    const void* a, const void* b,
                                    const void* g, void* dp, void* dd,
                                    void* dadb, void* partial, int B, int C,
                                    int N, float one_minus_ns, void* stream) {
  return launch_bwd<vnk_bf16>(p, d, a, b, g, dp, dd, dadb, partial, B, C, N,
                              one_minus_ns, stream);
}

namespace {

template <typename T>
int launch_fwd(const void* p, const void* d, const void* a, const void* b,
               void* out, int B, int C, int N, float one_minus_ns,
               void* stream) {
  const int64_t total = static_cast<int64_t>(B) * C * N;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  bn_leaky_fwd<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(d),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(out), C, N, total, one_minus_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VNK_EXPORT int vn_bn_leaky_fwd(const void* p, const void* d, const void* a,
                               const void* b, void* out, int B, int C, int N,
                               float one_minus_ns, void* stream) {
  return launch_fwd<float>(p, d, a, b, out, B, C, N, one_minus_ns, stream);
}

// The bf16 mode: p, d, out bfloat16; a, b float32.
VNK_EXPORT int vn_bn_leaky_fwd_bf16(const void* p, const void* d, const void* a,
                                    const void* b, void* out, int B, int C,
                                    int N, float one_minus_ns, void* stream) {
  return launch_fwd<vnk_bf16>(p, d, a, b, out, B, C, N, one_minus_ns, stream);
}
