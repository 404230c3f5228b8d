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
// Bound on the H100.  B (Cin = 2 on the main path): bytes, the
// B*3*Cout*N*4-byte output write; the two-term products cost two FMAs per
// accumulator.  C (Cin = Cout = 256): operations, 2 * 2*Cin*Cout*3*B*N FLOP
// of FP32 FMAs on the CUDA cores (the float32 policy keeps them off the
// tensor cores).  The register micro-tile gives 96 FMAs per 20 shared-memory
// loads; the stages are not double-buffered yet, so loads and FMAs of one
// block do not overlap.
#include "vn_tile.cuh"

namespace {

template <bool kProject>
__global__ void __launch_bounds__(kThreads, 1)
layer_fwd(const float* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ wd, const float* __restrict__ pbias,
          const float* __restrict__ dbias, const float* __restrict__ a,
          const float* __restrict__ b, const float* __restrict__ w_out,
          float* __restrict__ out, int Cin, int Cout, int N, int group,
          float one_minus_ns) {
  __shared__ VnkTileSmem sm;
  __shared__ float red[kProject ? 16 : 1][3][kPts];

  const int tx = threadIdx.x % 16;  // point group: points tx*4 .. tx*4+3
  const int ty = threadIdx.x / 16;  // channel group: channels ty*4 .. ty*4+3
  const int bi = blockIdx.z;
  const int n0 = blockIdx.x * kPts;
  const float* xb = x + static_cast<size_t>(bi) * 3 * Cin * N;
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
        float v[3];
        vnk_bn_leaky(accp[0][i][q] + pb[0], accp[1][i][q] + pb[1],
                     accp[2][i][q] + pb[2], accd[0][i][q] + db[0],
                     accd[1][i][q] + db[1], accd[2][i][q] + db[2], av, bv,
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
          float* row = out + ((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N;
          const int n = n0 + tx * 4;
          if (vec_store) {
            *reinterpret_cast<float4*>(row + n) =
                make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n + q < N) row[n + q] = o[j][q];
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
      if (n < N) out[(static_cast<size_t>(bi) * 3 + j) * N + n] = s;
    }
  }
}

template <bool kProject>
int launch(const void* x, const void* w, const void* wd, const void* pbias,
           const void* dbias, const void* a, const void* b, const void* w_out,
           void* out, int B, int Cin, int Cout, int N, int group,
           float one_minus_ns, void* stream) {
  if (B == 0 || N == 0) return 0;
  const int ch_tiles = kProject ? 1 : (Cout + kCh - 1) / kCh;
  const dim3 grid((N + kPts - 1) / kPts, ch_tiles, B);
  layer_fwd<kProject><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(wd), static_cast<const float*>(pbias),
      static_cast<const float*>(dbias), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(w_out),
      static_cast<float*>(out), Cin, Cout, N, group, one_minus_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pbias and dbias are (B, 3, Cout) per-sample biases (group = 0) or
// (B, 3, Cout, N / group) per-group ones (N % group == 0), or both null.
VNK_EXPORT int vn_layer_fused_fwd(const void* x, const void* w, const void* wd,
                                  const void* pbias, const void* dbias,
                                  const void* a, const void* b, void* out,
                                  int B, int Cin, int Cout, int N, int group,
                                  float one_minus_ns, void* stream) {
  return launch<false>(x, w, wd, pbias, dbias, a, b, nullptr, out, B, Cin,
                       Cout, N, group, one_minus_ns, stream);
}

VNK_EXPORT int vn_layer_fused_project_fwd(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    void* out, int B, int Cin, int Cout, int N, int group, float one_minus_ns,
    void* stream) {
  return launch<true>(x, w, wd, pbias, dbias, a, b, w_out, out, B, Cin, Cout,
                      N, group, one_minus_ns, stream);
}
