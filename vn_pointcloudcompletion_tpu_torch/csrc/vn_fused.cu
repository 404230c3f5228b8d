// Kernel A: folded norm-BatchNorm + VN leaky reflection on plane-layout
// features, one pass (forward only).
//
// Replaces vn_pointcloudcompletion_tpu/ops/vn_fused.py::fused_bn_leaky
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

}  // namespace

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
