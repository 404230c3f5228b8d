// Kernels B and C: a whole VNLinearLeakyReLU layer in one pass (forward),
// optionally followed by a 1-channel output contraction.
//
// B replaces vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py::vn_layer_fused
//   (the pallas_call at :541, kernel body _layer_fwd_kernel at :359).
// C replaces vn_layer_fused.py::vn_layer_fused_project
//   (the pallas_call at :821, kernel body _proj_fwd_kernel at :640).
//
//   p = W x (+ pbias),  d = Wd x (+ dbias)      per plane j of x (B, 3, Cin, N)
//   the biases per sample (group = 0) or per run of `group` points
//   (group = S: one column per fold centre, vnk_bias in vn_tile.cuh)
//   o = bn_leaky(p, d; A, B)                    (common.cuh)
//   B: out = o                                  (B, 3, Cout, N)
//   C: out = sum_c w_out[c] o[c]                (B, 3, 1, N)
//
// Design.  A block owns kPts points of one sample and walks the output
// channels in tiles of kCh; the products of a tile (vn_tile.cuh) leave each
// of the 256 threads a 4-channel x 4-point micro-tile of all six
// accumulators (p and d, three planes each), which is what the epilogue
// needs: the folded BN and the reflection read all three planes of p and d
// of one vector.  p and d never leave registers.
//   B: the grid spreads the channel tiles over blockIdx.y; each block
//      writes its (3, kCh, kPts) output tile with 16-byte stores.
//   C: one block walks all Cout channels (gridDim.y == 1) and keeps the
//      w_out contraction in registers, so the per-point sum needs one
//      shared-memory reduction over the 16 channel groups at the end and no
//      atomics across blocks.
//
// The bf16 mode (T = vnk_bf16: x, the biases and out bfloat16; W, Wd, A, B
// and w_out float32) is the TPU kernels' bf16=True (vn_layer_fused.py:61-65
// _dot, :86-126 _compute_pd): products of bf16-rounded W and x summed in
// float32, the bias added in float32, then p and d rounded through bf16
// once (never Wx alone: that would round twice) before the float32
// epilogue; B stores the epilogue in bf16, C sums the UNROUNDED float32
// epilogue times w_out (as JAX's fused C does, :650-656) and stores the
// sum in bf16.  The loops are the float32 mode's over bf16 loads, FMAs on
// the CUDA cores: the bf16 bound below is the tensor cores', which only a
// redesign with mma/wgmma could approach.
//
// Bound on the H100.  B (Cin = 2 on the main path): bytes, the
// B*3*Cout*N*4-byte output write; the two-term products cost two FMAs per
// accumulator.  C (Cin = Cout = 256): operations, 2 * 2*Cin*Cout*3*B*N FLOP
// of FP32 FMAs on the CUDA cores (the float32 policy keeps them off the
// tensor cores).  The register micro-tile gives 96 FMAs per 20 shared-memory
// loads; the stages are not double-buffered yet, so loads and FMAs of one
// block do not overlap.
#include "vn_tile.cuh"

namespace {

// Four point values of one output row, from n (a multiple of 4, 8-byte
// aligned in the bf16 mode, 16-byte in the float32 one).
__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(vnk_bf16* dst, const float (&v)[4]) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(v[0], v[1]);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(v[2], v[3]);
}

template <bool kProject, typename T>
__global__ void __launch_bounds__(kThreads, 1)
layer_fwd(const T* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ wd, const T* __restrict__ pbias,
          const T* __restrict__ dbias, const float* __restrict__ a,
          const float* __restrict__ b, const float* __restrict__ w_out,
          T* __restrict__ out, int Cin, int Cout, int N, int group,
          float one_minus_ns) {
  __shared__ VnkTileSmem sm;
  __shared__ float red[kProject ? 16 : 1][3][kPts];

  const int tx = threadIdx.x % 16;  // point group: points tx*4 .. tx*4+3
  const int ty = threadIdx.x / 16;  // channel group: channels ty*4 .. ty*4+3
  const int bi = blockIdx.z;
  const int n0 = blockIdx.x * kPts;
  const T* xb = x + static_cast<size_t>(bi) * 3 * Cin * N;
  const bool vec_store = (N % 4 == 0) && (n0 + tx * 4 + 3 < N);

  float proj[3][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) proj[j][q] = 0.f;

  for (int c0 = blockIdx.y * kCh; c0 < Cout; c0 += gridDim.y * kCh) {
    float accp[3][4][4], accd[3][4][4];
    vnk_tile_products<true>(xb, w, wd, Cin, Cout, N, c0, n0, sm, accp, accd);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty * 4 + i;
      if (c >= Cout) continue;
      const float av = a[c], bv = b[c];
      float o[3][4];
      float pb[3] = {0.f, 0.f, 0.f}, db[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // a thread's 4 points share one bias column unless group is 1 or 2
        if (pbias != nullptr && (q == 0 || group == 1 || group == 2)) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            pb[j] = vnk_bias(pbias, bi, j, c, Cout, n0 + tx * 4 + q, N, group);
            db[j] = vnk_bias(dbias, bi, j, c, Cout, n0 + tx * 4 + q, N, group);
          }
        }
        float pv[3], dv[3], v[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          pv[j] = accp[j][i][q] + pb[j];
          dv[j] = accd[j][i][q] + db[j];
          if (vnk_is_bf16<T>()) {
            pv[j] = vnk_round_bf16(pv[j]);
            dv[j] = vnk_round_bf16(dv[j]);
          }
        }
        vnk_bn_leaky(pv[0], pv[1], pv[2], dv[0], dv[1], dv[2], av, bv,
                     one_minus_ns, v);
        o[0][q] = v[0];
        o[1][q] = v[1];
        o[2][q] = v[2];
      }
      if (kProject) {
        const float wo = w_out[c];
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) proj[j][q] += wo * o[j][q];
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          T* row = out + ((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N;
          const int n = n0 + tx * 4;
          if (vec_store) {
            store4(row + n, o[j]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n + q < N) row[n + q] = vnk_cast<T>(o[j][q]);
          }
        }
      }
    }
  }

  if (kProject) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[ty][j][tx * 4 + q] = proj[j][q];
    __syncthreads();
    if (threadIdx.x < 3 * kPts) {
      const int j = threadIdx.x / kPts, nn = threadIdx.x % kPts;
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < 16; ++g) s += red[g][j][nn];
      const int n = n0 + nn;
      if (n < N) out[(static_cast<size_t>(bi) * 3 + j) * N + n] = vnk_cast<T>(s);
    }
  }
}

template <bool kProject, typename T>
int launch(const void* x, const void* w, const void* wd, const void* pbias,
           const void* dbias, const void* a, const void* b, const void* w_out,
           void* out, int B, int Cin, int Cout, int N, int group,
           float one_minus_ns, void* stream) {
  if (B == 0 || N == 0) return 0;
  const int ch_tiles = kProject ? 1 : (Cout + kCh - 1) / kCh;
  const dim3 grid((N + kPts - 1) / kPts, ch_tiles, B);
  layer_fwd<kProject, T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(wd), static_cast<const T*>(pbias),
      static_cast<const T*>(dbias), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(w_out),
      static_cast<T*>(out), Cin, Cout, N, group, one_minus_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pbias and dbias are (B, 3, Cout) per-sample biases (group = 0) or
// (B, 3, Cout, N / group) per-group ones (N % group == 0), or both null.
// x, the biases and out are float32 here and bfloat16 in the _bf16 entry
// points; W, Wd, A, B and w_out are float32 in both.
VNK_EXPORT int vn_layer_fused_fwd(const void* x, const void* w, const void* wd,
                                  const void* pbias, const void* dbias,
                                  const void* a, const void* b, void* out,
                                  int B, int Cin, int Cout, int N, int group,
                                  float one_minus_ns, void* stream) {
  return launch<false, float>(x, w, wd, pbias, dbias, a, b, nullptr, out, B,
                              Cin, Cout, N, group, one_minus_ns, stream);
}

VNK_EXPORT int vn_layer_fused_project_fwd(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    void* out, int B, int Cin, int Cout, int N, int group, float one_minus_ns,
    void* stream) {
  return launch<true, float>(x, w, wd, pbias, dbias, a, b, w_out, out, B, Cin,
                             Cout, N, group, one_minus_ns, stream);
}

VNK_EXPORT int vn_layer_fused_fwd_bf16(const void* x, const void* w,
                                       const void* wd, const void* pbias,
                                       const void* dbias, const void* a,
                                       const void* b, void* out, int B,
                                       int Cin, int Cout, int N, int group,
                                       float one_minus_ns, void* stream) {
  return launch<false, vnk_bf16>(x, w, wd, pbias, dbias, a, b, nullptr, out, B,
                                 Cin, Cout, N, group, one_minus_ns, stream);
}

VNK_EXPORT int vn_layer_fused_project_fwd_bf16(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    void* out, int B, int Cin, int Cout, int N, int group, float one_minus_ns,
    void* stream) {
  return launch<true, vnk_bf16>(x, w, wd, pbias, dbias, a, b, w_out, out, B,
                                Cin, Cout, N, group, one_minus_ns, stream);
}
