// Kernel A: folded norm-BatchNorm + VN leaky reflection on plane-layout
// features, one pass; kernel A' (vn_bn_leaky_bwd, below): its backward.
//
// A replaces vn_pointcloudcompletion_tpu/ops/vn_fused.py::fused_bn_leaky
// (the pallas_call at :189, kernel body _fwd_kernel at :76).
//
// p, d, out: (B, 3, C, N), contiguous, float32 or (the bf16 mode, the
// bfloat16 compute policy) bfloat16; a, b: (C,) float32, the folded BN
// affine.  The "vector" design: one thread per (b, c, n) vector; it reads
// the three planes of p and d and writes the three planes of out.
// Neighbouring threads take neighbouring n, so every plane is read and
// written in full coalesced lines.  The bf16 mode is the TPU kernel's on
// bf16 planes (vn_fused.py :76-95): it reads p and d as bf16, computes in
// float32 in the float32 mode's order and stores bf16 rounded to nearest
// even.
//
// Bound on the H100: bytes.  The pass moves 3 * B*3*C*N*s bytes (p and d
// read once, out written once; s = 4, or 2 in the bf16 mode) and does some
// 40 operations per vector, far below the FP32 rate for that traffic.  In
// bf16 the vector design still issued as many instructions a vector as in
// float32 (two 64-bit divisions for its row and channel, six 2-byte loads,
// three 2-byte stores, a[c] and b[c] again), for half the bytes, and so
// took nearly the float32 time.  The bf16 "run8" design (ops/vn_fused.py
// ::fwd_design: N a multiple of 8 and 16-byte aligned planes) gives a
// thread 8 consecutive points of one (sample, channel) row: one 16-byte
// load from each of the six input planes, one 16-byte store to each of the
// three output planes, a[c] and b[c] read once, the grid over (runs of the
// row, channels, samples) so that no division is left; each vector's
// arithmetic is vnk_bn_leaky's, in the same order, so the bits are the
// vector design's.
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

constexpr int kRun = 8;  // points a thread of the run8 design (16 bytes of bf16)

__device__ __forceinline__ void unpack_bf16x8(uint4 w, float (&f)[kRun]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    f[2 * m] = __uint_as_float(u[m] << 16);
    f[2 * m + 1] = __uint_as_float(u[m] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// The bf16 run8 design: thread (x, y) of block (bx, by, b) owns points
// 8 (bx * blockDim.x + x) ... + 7 of row (b, c = by * blockDim.y + y);
// N % 8 == 0 and 16-byte aligned planes (checked by the launch).
__global__ void __launch_bounds__(kThreads)
bn_leaky_fwd_run8(const vnk_bf16* __restrict__ p, const vnk_bf16* __restrict__ d,
                  const float* __restrict__ a, const float* __restrict__ b,
                  vnk_bf16* __restrict__ out, int C, int N, float one_minus_ns) {
  const int n0 = (blockIdx.x * blockDim.x + threadIdx.x) * kRun;
  const int c = blockIdx.y * blockDim.y + threadIdx.y;
  if (n0 >= N || c >= C) return;
  const int64_t cn = static_cast<int64_t>(C) * N;
  const int64_t base = blockIdx.z * 3 * cn + static_cast<int64_t>(c) * N + n0;
  const float av = a[c], bv = b[c];
  float pv[3][kRun], dv[3][kRun];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(p + base + j * cn), pv[j]);
    unpack_bf16x8(*reinterpret_cast<const uint4*>(d + base + j * cn), dv[j]);
  }
  unsigned ow[3][kRun / 2];
#pragma unroll
  for (int e = 0; e < kRun; e += 2) {
    float o0[3], o1[3];
    vnk_bn_leaky(pv[0][e], pv[1][e], pv[2][e], dv[0][e], dv[1][e], dv[2][e], av, bv,
                 one_minus_ns, o0);
    vnk_bn_leaky(pv[0][e + 1], pv[1][e + 1], pv[2][e + 1], dv[0][e + 1], dv[1][e + 1],
                 dv[2][e + 1], av, bv, one_minus_ns, o1);
#pragma unroll
    for (int j = 0; j < 3; ++j) ow[j][e / 2] = pack_bf16x2(o0[j], o1[j]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    *reinterpret_cast<uint4*>(out + base + j * cn) = make_uint4(ow[j][0], ow[j][1], ow[j][2], ow[j][3]);
  }
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

// The bf16 designs (ops/vn_fused.py::fwd_design)
enum FwdDesign { kFwdVector = 0, kFwdRun8 = 1 };

int launch_fwd_run8(const void* p, const void* d, const void* a, const void* b, void* out,
                    int B, int C, int N, float one_minus_ns, cudaStream_t st) {
  if (N % kRun != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(B) * C * N == 0) return 0;
  // x over the row's runs (a power of two up to the block), y over channels
  const int runs = N / kRun;
  int bx = 32;
  while (bx < runs && bx < kThreads) bx *= 2;
  const dim3 block(bx, kThreads / bx);
  const dim3 grid((runs + bx - 1) / bx, (C + block.y - 1) / block.y, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  bn_leaky_fwd_run8<<<grid, block, 0, st>>>(
      static_cast<const vnk_bf16*>(p), static_cast<const vnk_bf16*>(d),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<vnk_bf16*>(out), C,
      N, one_minus_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VNK_EXPORT int vn_bn_leaky_fwd(const void* p, const void* d, const void* a,
                               const void* b, void* out, int B, int C, int N,
                               float one_minus_ns, void* stream) {
  return launch_fwd<float>(p, d, a, b, out, B, C, N, one_minus_ns, stream);
}

// The bf16 mode: p, d, out bfloat16; a, b float32; design: 0 vector, 1
// run8 (N % 8 == 0 and 16-byte aligned p, d and out, else
// cudaErrorInvalidValue).
VNK_EXPORT int vn_bn_leaky_fwd_bf16(const void* p, const void* d, const void* a,
                                    const void* b, void* out, int B, int C,
                                    int N, float one_minus_ns, int design, void* stream) {
  if (design == kFwdRun8) {
    return launch_fwd_run8(p, d, a, b, out, B, C, N, one_minus_ns,
                           static_cast<cudaStream_t>(stream));
  }
  if (design != kFwdVector) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd<vnk_bf16>(p, d, a, b, out, B, C, N, one_minus_ns, stream);
}
