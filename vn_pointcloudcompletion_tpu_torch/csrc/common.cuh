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
