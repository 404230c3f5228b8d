// Kernel A: folded norm-BatchNorm + VN leaky reflection on plane-layout
// features, one pass; kernel A' (vn_bn_leaky_bwd, below): its backward.
//
// A replaces vn_pointcloudcompletion_tpu/ops/vn_fused.py::fused_bn_leaky
// (the pallas_call at :189, kernel body _fwd_kernel at :76).
//
// p, d, out: (B, 3, C, N) float32, contiguous; a, b: (C,) folded BN affine.
// One thread per (b, c, n) vector: it reads the three planes of p and d and
// writes the three planes of out.  Neighbouring threads take neighbouring n,
// so every plane is read and written in full coalesced lines.
//
// Bound on the H100: bytes.  The pass moves 3 * B*3*C*N*4 bytes (p and d
// read once, out written once) and does some 40 operations per vector, far
// below the FP32 rate for that traffic, so the design only has to keep
// every access coalesced and touch each byte once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bn_leaky_fwd(const float* __restrict__ p, const float* __restrict__ d,
             const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ out, int C, int64_t N, int64_t total,
             float one_minus_ns) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t cn = static_cast<int64_t>(C) * N;
  const int64_t bi = i / cn;
  const int64_t r = i - bi * cn;
  const int c = static_cast<int>(r / N);
  const int64_t base = bi * 3 * cn + r;
  float o[3];
  vnk_bn_leaky(p[base], p[base + cn], p[base + 2 * cn],
               d[base], d[base + cn], d[base + 2 * cn],
               a[c], b[c], one_minus_ns, o);
  out[base] = o[0];
  out[base + cn] = o[1];
  out[base + 2 * cn] = o[2];
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
// Bound on the H100: bytes, 5 * B*3*C*N*4 (p, d, g read, dp, dd written);
// some 70 operations per vector are far below the FP32 rate for that.
constexpr int kBwdPts = 1024;

__global__ void __launch_bounds__(kThreads)
bn_leaky_bwd(const float* __restrict__ p, const float* __restrict__ d,
             const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ g, float* __restrict__ dp,
             float* __restrict__ dd, float* __restrict__ partial, int B,
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
    const float pv[3] = {p[i], p[i + cn], p[i + 2 * cn]};
    const float dv[3] = {d[i], d[i + cn], d[i + 2 * cn]};
    const float gv[3] = {g[i], g[i + cn], g[i + 2 * cn]};
    float dpv[3], ddv[3], dqp, norm_e;
    vnk_bn_leaky_bwd(pv, dv, gv, av, bv, one_minus_ns, dpv, ddv, &dqp,
                     &norm_e, nullptr);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dp[i + j * cn] = dpv[j];
      dd[i + j * cn] = ddv[j];
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

}  // namespace

// dadb: (2, C) -> dA, dB; partial: scratch of 2 * B * ceil(N / 1024) * C floats.
VNK_EXPORT int vn_bn_leaky_bwd(const void* p, const void* d, const void* a,
                               const void* b, const void* g, void* dp,
                               void* dd, void* dadb, void* partial, int B,
                               int C, int N, float one_minus_ns,
                               void* stream) {
  if (static_cast<int64_t>(B) * C * N == 0) return 0;
  const int T = (N + kBwdPts - 1) / kBwdPts;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_leaky_bwd<<<dim3(T, C, B), kThreads, 0, st>>>(
      static_cast<const float*>(p), static_cast<const float*>(d),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(g), static_cast<float*>(dp),
      static_cast<float*>(dd), static_cast<float*>(partial), B, C, N,
      one_minus_ns);
  vnk_reduce_rows(static_cast<const float*>(partial), static_cast<float*>(dadb),
                  2, B * T, C, st);
  return static_cast<int>(cudaGetLastError());
}

VNK_EXPORT int vn_bn_leaky_fwd(const void* p, const void* d, const void* a,
                               const void* b, void* out, int B, int C, int N,
                               float one_minus_ns, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * C * N;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  bn_leaky_fwd<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(d),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), C, N, total, one_minus_ns);
  return static_cast<int>(cudaGetLastError());
}
