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
// Two designs of B and three of C; the wrapper picks one, B's from Cin
// (ops/vn_layer_fused.py::layer_fwd_design), C's from (Cin, Cout)
// (forward_design; in bf16 then fwd_bf16_design), and none stands in for
// another:
//   stream (B at Cin <= 2: final_conv.0's 2 -> 256, conv1's 2 -> 32, the
//      pair folds' 1 -> 256 at group 64): layer_fwd_stream below.  The layer
//      writes (B, 3, Cout, N) and reads almost nothing, so the output write
//      bounds it; there is no product tile and no barrier.  A grid of
//      resident blocks walks work items (sample, 16-channel tile, 1024-point
//      tile); a thread holds the Cin x-values of its 4 points (three
//      planes) in registers, reads each channel's W, Wd, A, B and bias
//      (vnk_bias's column, worked out once an item) through L1 (one
//      address a warp), forms p and d with the narrow
//      design's fmaf chain, the bias after it and (bf16) the rounding of p
//      and d, runs the same epilogue and writes each plane's 4 points with
//      one streaming store (__stcs: 16 bytes float32, 8 bytes bf16; a warp
//      writes 512 or 256 contiguous bytes).  The same operations in the same
//      order as the narrow design: its bits, in both modes and bias layouts.
//   narrow (Cin or Cout < 16 for C; B at Cin > 2): layer_fwd below.  A block owns
//      kPts points of one sample and walks the output channels in tiles of
//      kCh; the products of a tile (vn_tile.cuh) leave each of the 256
//      threads a 4-channel x 4-point micro-tile of all six accumulators (p
//      and d, three planes each), which is what the epilogue needs: the
//      folded BN and the reflection read all three planes of p and d of one
//      vector.  p and d never leave registers.
//      B: the grid spreads the channel tiles over blockIdx.y; each block
//         writes its (3, kCh, kPts) output tile with 16-byte stores.
//      C: one block walks all Cout channels (gridDim.y == 1) and keeps the
//         w_out contraction in registers, so the per-point sum needs one
//         shared-memory reduction over the 16 channel groups at the end and
//         no atomics across blocks.  Its loop has 8-channel stages, not
//         double-buffered, one block an SM (13-22% of the FP32 peak).
//   wide (Cin >= 16 and Cout >= 16: final_conv.1 + .2's 256 -> 256 -> 1,
//      vn_folding{1,2}.1 + .2's 256 -> 128 -> 1): W and Wd first transposed
//      into a (2, Cin, Cout) scratch in the activations' type (vn_mma.cuh,
//      bf16-rounded in the bf16 mode), then a ring of shared-memory stages
//      filled by cp.async, the next input-channel slice loading while the
//      current one multiplies.  The grid runs the channel blocks of one
//      64-point tile together (blockIdx.x), so x comes from DRAM once; each
//      block contracts its channels with w_out in a fixed order and writes
//      one projection partial per (channel block, sample, plane, point);
//      proj_sum adds the partials in channel-block order and rounds once to
//      the output's type.  No float atomics.
//      float32 (proj_wide_fma): FP32 FMAs on the CUDA cores, the layout of
//         the wide C' pass 1 (vn_layer_bwd.cu pd_wide_fma): 2 channels x 4
//         points x 3 planes of p and d a thread, 32 channels a block, 256
//         threads, two blocks an SM, 16-channel stages three deep; p and d
//         summed with fmaf in input-channel order (the narrow kernel's bits
//         and the plain version's order).
//      bf16 (proj_wide_mma): the tensor cores, mma.sync.m16n8k16 bf16 ->
//         float32 (exact products, float32 sums), W^T, Wd^T and x read by
//         ldmatrix.trans; 64 channels x 64 points a block in 8 warps (32
//         channels x 16 points each, p and d, three planes), three 32-channel
//         stages, two blocks an SM.  The sums run in the tensor cores' order,
//         not input-channel order, so a p or d that lies at a bf16 rounding
//         boundary rounds one ulp away from the in-order sum's at rare
//         points; C''s pass 1 takes the same k16 steps (vn_layer_bwd.cu
//         pd_wide_mma, pd_wgmma), so its backward sees these bits, and the
//         plain version summing in k16 order (ops/vn_layer_fused.py
//         k16_sum) gives them too; against the in-order plain version the
//         check is a stated bound (chip_smoke.py, BF16_C_RMS).  The epilogue reads the
//         accumulators in their fragment layout: a thread's four channels in
//         order, a fixed shuffle tree over the warp's eight channel rows, the
//         two channel warps in order; the plain version sums in that order.
//         It runs where the wgmma design's tiles do not fit.
//      bf16 (proj_wgmma, the wgmma design): below, with proj_wide_mma's bits.
//
// The bf16 mode (T = vnk_bf16: x, the biases and out bfloat16; W, Wd, A, B
// and w_out float32) is the TPU kernels' bf16=True (vn_layer_fused.py:61-65
// _dot, :86-126 _compute_pd): products of bf16-rounded W and x summed in
// float32, the bias added in float32, then p and d rounded through bf16
// once (never Wx alone: that would round twice) before the float32
// epilogue; B stores the epilogue in bf16, C sums the UNROUNDED float32
// epilogue times w_out (as JAX's fused C does, :650-656) and stores the
// sum in bf16.  The narrow loops are the float32 mode's over bf16 loads.
//
// Bound on the H100.  B (Cin <= 2 on the main paths): bytes, the
// B*3*Cout*N*4-byte output write (2 bytes an element in bf16); its ~75 FP32
// instructions a vector (two FMAs a plane of p and of d, the epilogue's
// square root and two divisions) come close behind in bf16.  C (Cin = Cout = 256): operations, 2 * 2*Cin*Cout*3*B*N FLOP,
// of FP32 FMAs on the CUDA cores in float32 (the float32 policy keeps them
// off the tensor cores; 1.56 ms at batch 8, N 16384) and of the bf16 tensor
// cores in the bf16 mode (0.104 ms at 989 TFLOP/s); the epilogue's ~40
// FP32 operations a vector and the bf16 x read (0.06 ms) come next.
#include <algorithm>

#include "vn_mma.cuh"
#include "vn_tile.cuh"
#include "vn_wgmma.cuh"

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
          T* __restrict__ out, T* __restrict__ pd_out, int Cin, int Cout, int N, int group,
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
        if (kProject && pd_out != nullptr && n0 + tx * 4 + q < N)
          vnk_put_pd(pd_out, gridDim.z, bi, c, Cout, n0 + tx * 4 + q, N, pv, dv);
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
           void* out, void* pd_out, int B, int Cin, int Cout, int N, int group,
           float one_minus_ns, void* stream) {
  if (B == 0 || N == 0) return 0;
  const int ch_tiles = kProject ? 1 : (Cout + kCh - 1) / kCh;
  const dim3 grid((N + kPts - 1) / kPts, ch_tiles, B);
  layer_fwd<kProject, T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(wd), static_cast<const T*>(pbias),
      static_cast<const T*>(dbias), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(w_out),
      static_cast<T*>(out), static_cast<T*>(pd_out), Cin, Cout, N, group, one_minus_ns);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- the stream B

constexpr int kStreamThreads = 256;
constexpr int kStreamCh = 16;                        // channels a work item
constexpr int kStreamPts = kStreamThreads * 4;       // points a work item

// Four values of an x row from `src`, of which the first `len` exist
// (zeros past them); `vec`: one aligned vector load.
__device__ __forceinline__ void load4(const float* src, int len, bool vec, float (&v)[4]) {
  if (vec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < len ? src[q] : 0.f;
  }
}

__device__ __forceinline__ void load4(const vnk_bf16* src, int len, bool vec, float (&v)[4]) {
  if (vec) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < len ? vnk_load(src[q]) : 0.f;
  }
}

// store4 with the streaming hint (evict first: the output is read by the
// next layer, not by this kernel).
__device__ __forceinline__ void store4_cs(float* dst, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store4_cs(vnk_bf16* dst, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  __stcs(reinterpret_cast<uint2*>(dst), make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                   *reinterpret_cast<const unsigned*>(&hi)));
}

// ax: x's rows take aligned vector loads (N % 4 == 0, x aligned).  The
// bias columns of a thread's points (vnk_bias's n / group) and its row
// pointers are worked out once a work item, not once a channel.  Blocks an
// SM: 4 at Cin 1 (64 registers, no spill), 3 at Cin 2 (the second channel's
// x spills at 64; measured faster at 3 on the H100).
template <int kCin, typename T>
__global__ void __launch_bounds__(kStreamThreads, kCin == 1 ? 4 : 3)
layer_fwd_stream(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ wd, const T* __restrict__ pbias,
                 const T* __restrict__ dbias, const float* __restrict__ a,
                 const float* __restrict__ b, T* __restrict__ out, int B, int Cout, int N,
                 int group, float one_minus_ns, bool ax) {
  const int pt_tiles = (N + kStreamPts - 1) / kStreamPts;
  const int ch_tiles = (Cout + kStreamCh - 1) / kStreamCh;
  const int items = B * ch_tiles * pt_tiles;
  const bool vec_out = N % 4 == 0;
  const int cols = group ? N / group : 1;  // bias columns a channel
  const size_t out_plane = static_cast<size_t>(Cout) * N;
  const size_t bias_plane = static_cast<size_t>(Cout) * cols;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int pt = item % pt_tiles, rest = item / pt_tiles;
    const int ct = rest % ch_tiles, bi = rest / ch_tiles;
    const int n = (pt * kStreamThreads + threadIdx.x) * 4;
    if (n >= N) continue;
    const int len = N - n;  // points from n that exist
    const bool full = len >= 4;
    float xv[3][kCin][4];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < kCin; ++k)
        load4(x + ((static_cast<size_t>(bi) * 3 + j) * kCin + k) * N + n, len, ax && full,
              xv[j][k]);
    int bcol[4];  // one column for all 4 points unless group is 1 or 2
#pragma unroll
    for (int q = 0; q < 4; ++q) bcol[q] = group ? min(n + q, N - 1) / group : 0;
    const int c0 = ct * kStreamCh, c1 = min(Cout, c0 + kStreamCh);
    T* orow = out + (static_cast<size_t>(bi) * 3 * Cout + c0) * N + n;  // plane 0, channel c
    size_t brow = (static_cast<size_t>(bi) * 3 * Cout + c0) * cols;  // channel c's bias columns
    for (int c = c0; c < c1; ++c, orow += N, brow += cols) {
      float wr[kCin], dr[kCin];
#pragma unroll
      for (int k = 0; k < kCin; ++k) {
        wr[k] = vnk_round_as<T>(__ldg(w + c * kCin + k));
        dr[k] = vnk_round_as<T>(__ldg(wd + c * kCin + k));
      }
      const float av = __ldg(a + c), bv = __ldg(b + c);
      float pb[3] = {0.f, 0.f, 0.f}, db[3] = {0.f, 0.f, 0.f};
      float o[3][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (pbias != nullptr && (q == 0 || bcol[q] != bcol[q - 1])) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            pb[j] = vnk_load(pbias[brow + j * bias_plane + bcol[q]]);
            db[j] = vnk_load(dbias[brow + j * bias_plane + bcol[q]]);
          }
        }
        float pv[3], dv[3], v[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {  // the narrow design's products, in its order
          float ap = 0.f, ad = 0.f;
#pragma unroll
          for (int k = 0; k < kCin; ++k) {
            ap = fmaf(wr[k], xv[j][k][q], ap);
            ad = fmaf(dr[k], xv[j][k][q], ad);
          }
          pv[j] = vnk_round_as<T>(ap + pb[j]);
          dv[j] = vnk_round_as<T>(ad + db[j]);
        }
        vnk_bn_leaky(pv[0], pv[1], pv[2], dv[0], dv[1], dv[2], av, bv, one_minus_ns, v);
#pragma unroll
        for (int j = 0; j < 3; ++j) o[j][q] = v[j];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T* row = orow + j * out_plane;
        if (vec_out && full) {
          store4_cs(row, o[j]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q < len) row[q] = vnk_cast<T>(o[j][q]);
        }
      }
    }
  }
}

// Kernel B in the stream design (Cin 1 or 2): as many blocks as the card
// holds at once, at most one a work item.
template <typename T>
int launch_stream(const void* x, const void* w, const void* wd, const void* pbias,
                  const void* dbias, const void* a, const void* b, void* out, int B, int Cin,
                  int Cout, int N, int group, float one_minus_ns, void* stream) {
  if (Cin < 1 || Cin > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || Cout == 0) return 0;
  auto kernel = Cin == 1 ? layer_fwd_stream<1, T> : layer_fwd_stream<2, T>;
  const int slots = vnk_resident_blocks(reinterpret_cast<const void*>(kernel), kStreamThreads, 0);
  if (slots == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = static_cast<int64_t>(B) * ((Cout + kStreamCh - 1) / kStreamCh) *
                        ((N + kStreamPts - 1) / kStreamPts);
  const int64_t grid = std::min<int64_t>(items, slots);
  const bool ax = reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 && N % 4 == 0;
  kernel<<<static_cast<unsigned>(grid), kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(wd),
      static_cast<const T*>(pbias), static_cast<const T*>(dbias), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(out), B, Cout, N, group, one_minus_ns, ax);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ the wide C

// float32: thread (ty, tx) of the 16 x 16 grid holds p and d of channels
// c0 + 2 ty + i (i < 2) at points n0 + 4 tx + q (q < 4), three planes.
struct ProjFma {
  static constexpr int kMC = 2, kBC = 32, kKs = 16, kStages = 3;
  static constexpr int kW = kKs * kBC;            // floats of one W stage
  static constexpr int kX = kKs * kPts;           // floats of one x plane stage
  static constexpr int kStage = 2 * kW + 3 * kX;  // floats
  static constexpr int kRed = 16 * 3 * kPts;      // the 16 channel groups' projections
  static constexpr int kBytes = (kStages * kStage + kRed) * 4;
};

__global__ void __launch_bounds__(kWideThreads, 2)
proj_wide_fma(const float* __restrict__ x, const float* __restrict__ wt,
              const float* __restrict__ pbias, const float* __restrict__ dbias,
              const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ w_out, float* __restrict__ part,
              float* __restrict__ pd_out, int B, int Cin, int Cout, int N, int group,
              float one_minus_ns, bool aw, bool ax) {
  using P = ProjFma;
  constexpr int kMC = P::kMC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  float* const red = sm + P::kStages * P::kStage;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int cb = blockIdx.x, t = blockIdx.y, bi = blockIdx.z;  // channel blocks of a tile together
  const int n0 = t * kPts, c0 = cb * P::kBC;
  const float* xb = x + static_cast<size_t>(bi) * 3 * Cin * N;
  const float* wdt = wt + static_cast<size_t>(Cin) * Cout;

  float accp[3][kMC][4], accd[3][kMC][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < kMC; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) accp[j][i][q] = accd[j][i][q] = 0.f;

  auto load = [&](int s, int kt) {
    float* st = sm + s * P::kStage;
    const int k0 = kt * P::kKs;
    const size_t wrow = static_cast<size_t>(k0) * Cout + c0;
    stage_tile<float, P::kKs, P::kBC>(st, P::kBC, wt + wrow, Cout, Cin - k0, Cout - c0, aw);
    stage_tile<float, P::kKs, P::kBC>(st + P::kW, P::kBC, wdt + wrow, Cout, Cin - k0,
                                      Cout - c0, aw);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      stage_tile<float, P::kKs, kPts>(st + 2 * P::kW + j * P::kX, kPts,
                                      xb + (static_cast<size_t>(j) * Cin + k0) * N + n0, N,
                                      Cin - k0, N - n0, ax);
  };
  auto compute = [&](int s) {
    const float* ws = sm + s * P::kStage;
    const float* wds = ws + P::kW;
    const float* xs = ws + 2 * P::kW;
#pragma unroll
    for (int k = 0; k < P::kKs; ++k) {
      const float2 wv = *reinterpret_cast<const float2*>(ws + k * P::kBC + ty * kMC);
      const float2 dv = *reinterpret_cast<const float2*>(wds + k * P::kBC + ty * kMC);
      const float wr[kMC] = {wv.x, wv.y}, dr[kMC] = {dv.x, dv.y};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + (j * P::kKs + k) * kPts + tx * 4);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < kMC; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            accp[j][i][q] = fmaf(wr[i], xr[q], accp[j][i][q]);
            accd[j][i][q] = fmaf(dr[i], xr[q], accd[j][i][q]);
          }
      }
    }
  };
  pipeline<P::kStages>((Cin + P::kKs - 1) / P::kKs, load, compute);

  // the epilogue, then w_out: a thread's two channels in order
  float proj[3][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) proj[j][q] = 0.f;
#pragma unroll
  for (int i = 0; i < kMC; ++i) {
    const int c = c0 + ty * kMC + i;
    if (c >= Cout) continue;
    const float av = a[c], bv = b[c], wo = w_out[c];
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
      const float pv[3] = {accp[0][i][q] + pb[0], accp[1][i][q] + pb[1], accp[2][i][q] + pb[2]};
      const float dv[3] = {accd[0][i][q] + db[0], accd[1][i][q] + db[1], accd[2][i][q] + db[2]};
      if (pd_out != nullptr && n0 + tx * 4 + q < N)
        vnk_put_pd(pd_out, B, bi, c, Cout, n0 + tx * 4 + q, N, pv, dv);
      float o[3];
      vnk_bn_leaky(pv[0], pv[1], pv[2], dv[0], dv[1], dv[2], av, bv, one_minus_ns, o);
#pragma unroll
      for (int j = 0; j < 3; ++j) proj[j][q] += wo * o[j];
    }
  }
  // the 16 channel groups in order
#pragma unroll
  for (int j = 0; j < 3; ++j)
    *reinterpret_cast<float4*>(red + (ty * 3 + j) * kPts + tx * 4) =
        make_float4(proj[j][0], proj[j][1], proj[j][2], proj[j][3]);
  __syncthreads();
  if (threadIdx.x < 3 * kPts) {
    const int j = threadIdx.x / kPts, nn = threadIdx.x % kPts, n = n0 + nn;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) s += red[(g * 3 + j) * kPts + nn];
    if (n < N) part[((static_cast<size_t>(cb) * B + bi) * 3 + j) * N + n] = s;
  }
}

// bf16: warp (wm, wn) of the 2 x 4 grid owns channels wm * 32 .. + 31 of the
// block's 64 and points wn * 16 .. + 15 of its 64: two m16 tiles x two n8
// tiles of p and of d, three planes.
struct ProjMma {
  static constexpr int kThreads = 256;  // 8 warps
  static constexpr int kBC = 64, kKs = 32, kStages = 3;
  static constexpr int kWld = kBC + 8, kXld = kPts + 8;  // padded rows: no bank conflicts
  static constexpr int kW = kKs * kWld, kX = kKs * kXld;
  static constexpr int kStage = 2 * kW + 3 * kX;  // bf16 elements
  static constexpr int kBytes = kStages * kStage * 2 + 2 * 3 * kPts * 4;  // + two warps' sums
};

__global__ void __launch_bounds__(ProjMma::kThreads, 2)
proj_wide_mma(const vnk_bf16* __restrict__ x, const vnk_bf16* __restrict__ wt,
              const vnk_bf16* __restrict__ pbias, const vnk_bf16* __restrict__ dbias,
              const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ w_out, float* __restrict__ part,
              vnk_bf16* __restrict__ pd_out, int B, int Cin, int Cout, int N, int group,
              float one_minus_ns, bool aw, bool ax) {
  using T = vnk_bf16;
  using P = ProjMma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  float* const red = reinterpret_cast<float*>(smem_raw + P::kStages * P::kStage * 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2, grp = lane / 4, tig = lane % 4;
  const int cb = blockIdx.x, t = blockIdx.y, bi = blockIdx.z;  // channel blocks of a tile together
  const int n0 = t * kPts, c0 = cb * P::kBC;
  const T* xb = x + static_cast<size_t>(bi) * 3 * Cin * N;
  const T* wdt = wt + static_cast<size_t>(Cin) * Cout;

  float accp[3][2][2][4], accd[3][2][2][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) accp[j][mt][nt][e] = accd[j][mt][nt][e] = 0.f;

  auto load = [&](int s, int kt) {
    T* st = sm + s * P::kStage;
    const int k0 = kt * P::kKs;
    const size_t wrow = static_cast<size_t>(k0) * Cout + c0;
    stage_tile<T, P::kKs, P::kBC, P::kThreads>(st, P::kWld, wt + wrow, Cout, Cin - k0,
                                               Cout - c0, aw);
    stage_tile<T, P::kKs, P::kBC, P::kThreads>(st + P::kW, P::kWld, wdt + wrow, Cout, Cin - k0,
                                               Cout - c0, aw);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      stage_tile<T, P::kKs, kPts, P::kThreads>(
          st + 2 * P::kW + j * P::kX, P::kXld, xb + (static_cast<size_t>(j) * Cin + k0) * N + n0,
          N, Cin - k0, N - n0, ax);
  };
  auto compute = [&](int s) {
    const T* ws = sm + s * P::kStage;
    const T* wds = ws + P::kW;
    const T* xs = ws + 2 * P::kW;
#pragma unroll
    for (int ks = 0; ks < P::kKs; ks += 16) {
      unsigned fw[2][4], fd[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        frag_a_t(fw[mt], ws, P::kWld, wm * 32 + mt * 16, ks);
        frag_a_t(fd[mt], wds, P::kWld, wm * 32 + mt * 16, ks);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        unsigned fx[4];
        frag_b2_t(fx, xs + j * P::kX, P::kXld, wn * 16, ks);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(accp[j][mt][0], fw[mt], fx[0], fx[1]);
          mma_bf16(accp[j][mt][1], fw[mt], fx[2], fx[3]);
          mma_bf16(accd[j][mt][0], fd[mt], fx[0], fx[1]);
          mma_bf16(accd[j][mt][1], fd[mt], fx[2], fx[3]);
        }
      }
    }
  };
  pipeline<P::kStages>((Cin + P::kKs - 1) / P::kKs, load, compute);

  // The epilogue on the fragments: element 2 r + e of acc[j][mt][nt] is
  // channel c0 + wm 32 + mt 16 + grp + 8 r at point n0 + wn 16 + nt 8 +
  // 2 tig + e.  A thread contracts its four channels with w_out in order
  // (mt, then r).
  const bool has_bias = pbias != nullptr;
  float proj[3][2][2];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) proj[j][nt][0] = proj[j][nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = c0 + wm * 32 + mt * 16 + grp + 8 * r;
      if (c >= Cout) continue;
      const float av = a[c], bv = b[c], wo = w_out[c];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 16 + nt * 8 + 2 * tig + e;
          float pv[3], dv[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float pb = has_bias ? vnk_bias(pbias, bi, j, c, Cout, n, N, group) : 0.f;
            const float db = has_bias ? vnk_bias(dbias, bi, j, c, Cout, n, N, group) : 0.f;
            pv[j] = vnk_round_bf16(accp[j][mt][nt][2 * r + e] + pb);
            dv[j] = vnk_round_bf16(accd[j][mt][nt][2 * r + e] + db);
          }
          if (pd_out != nullptr && n < N) vnk_put_pd(pd_out, B, bi, c, Cout, n, N, pv, dv);
          float o[3];
          vnk_bn_leaky(pv[0], pv[1], pv[2], dv[0], dv[1], dv[2], av, bv, one_minus_ns, o);
#pragma unroll
          for (int j = 0; j < 3; ++j) proj[j][nt][e] += wo * o[j];
        }
      }
    }
  }
  // the warp's eight channel rows (lanes 4 grp + tig): a fixed tree, pairs
  // of neighbouring rows first; then the two channel warps in order
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = proj[j][nt][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (grp == 0) red[(wm * 3 + j) * kPts + wn * 16 + nt * 8 + 2 * tig + e] = v;
      }
  __syncthreads();
  if (threadIdx.x < 3 * kPts) {
    const int j = threadIdx.x / kPts, nn = threadIdx.x % kPts, n = n0 + nn;
    const float s = red[j * kPts + nn] + red[(3 + j) * kPts + nn];
    if (n < N) part[((static_cast<size_t>(cb) * B + bi) * 3 + j) * N + n] = s;
  }
}

// bf16 on Hopper's warpgroup products fed by TMA (proj_wgmma, the "wgmma"
// design; ops/vn_layer_fused.py::fwd_bf16_design): C_in and C_out
// multiples of 64, C_in <= 256, N % 8 == 0 and 16-byte aligned x, as the
// tensor maps and the resident x tile need; group 0 or a multiple of 64.
//   Persistent blocks, one an SM (`ctas` of them), each walking 64-point
//   tiles (sample, point tile) t = blockIdx.x + k gridDim.x, every channel
//   block of a tile in turn: the tile's x (three planes, C_in deep) stays
//   resident in shared memory, loaded once as 64-deep chunks, so x is read
//   once from device memory and once from L2 (the parent read it once per
//   channel block: 805 MB of L2 at 256 -> 256); W^T and Wd^T go through a
//   four-stage ring.  The channel blocks' projections sum in a register
//   per (plane, point), in channel-block order from 0 (proj_sum's order):
//   no partials and no second pass.  In the last channel block each x chunk
//   is released once its products are done, so the next tile's chunk loads
//   under the rest of this one.
//   Registers: 64 channels x 64 points of p and of d, three planes, would
//   be 192 float32 accumulators a thread.  Here product warpgroup 0 forms p
//   and product warpgroup 1 forms d (m64n64k16, 96 accumulators each), both
//   over the same x boxes (two warpgroups of m64n64 read 24 KB of shared
//   memory a k16 step, four of m64n32 with p and d each would read 36 KB),
//   two stages in flight (wait_group 1).  Each then writes its matrix, the
//   bias added and rounded to bf16 (pv of proj_wide_mma), into a staged
//   (2, 3, 64, 72) tile and goes on to the next channel block's products,
//   while four epilogue warpgroups run the BN-leaky epilogue and the w_out
//   contraction on the staged tile (proj_wg_round) and keep the running
//   projections; named barriers hand the tile over (kPdFull, kPdEmpty).
//   Bits: the k16 steps in proj_wide_mma's order (input channels ascending,
//   one float32 accumulator chained through them; wgmma rounds the k16
//   steps as mma.sync does, as pd_wgmma found), and the w_out contraction
//   in its order (_project_wide_order): proj_wide_mma's lane sums channels
//   wm 32 + grp + 8 m (m = 2 mt + r) in order from zero, which wgmma's
//   fragment puts in two warps.  So the epilogue deals lanes afresh from the
//   staged tile: lane 4 grp + q one such chain, then the shuffle tree over
//   grp, the two halves in order, the blocks in order.  The output is
//   proj_wide_mma's to the bit, ragged N included.
//   Measured by phase (tools/probe_proj.py, PERF.md): the epilogue on the
//   product warpgroups' own fragments, each chain carried from one warp to
//   the next through shared memory, took 0.60 ms alone at 256 -> 256; on
//   two warps a scheduler it ran at under half the issue rate; on sixteen
//   warps beside the products the call takes 0.29 ms.
//   Bound at 256 -> 256 -> 1, batch 8, N 16384: the products' 103 GFLOP at
//   the bf16 rate (0.104 ms) and the epilogue's ~38 FP32 operations a
//   vector (0.019 ms); x is 0.2 GB (0.06 ms).
struct ProjWg {
  static constexpr int kBox = kWgDepth * kPts * 2;  // one 64 x 64 bf16 box, 8 KB
  static constexpr int kMaxChunks = 4;              // x chunks of a resident tile: C_in <= 256
  static constexpr int kStages = 4;                 // W^T and Wd^T of one 64-deep step a stage
  static constexpr int kStage = 2 * kBox;
  static constexpr int kPdLd = kPts + 8;            // bf16 a row of the staged p, d
  static constexpr int kPd = 2 * 3 * kWgDepth * kPdLd * 2;  // bytes of the staged p, d
  static constexpr int kRed = 2 * 3 * kPts;         // floats: the halves' projections [wm][j][n]
                                                    // (two: blocks in turn)
  static constexpr int kAbw = 3 * kWgDepth;         // floats: A, B, w_out of the staged block
  static constexpr int bytes(int chunks) {
    return 1024 + chunks * 3 * kBox + kStages * kStage + kPd + (2 * kRed + kAbw) * 4 +
           (2 * chunks + 2 * kStages) * 8;
  }
};
static_assert(ProjWg::bytes(ProjWg::kMaxChunks) <= 232448, "one block an SM");

// One round of proj_wgmma's epilogue on the staged p, d of a channel block
// (pd: (2, 3, 64, kPdLd) bf16): lane 4 grp + q of warp v of the sixteen
// epilogue warps takes the channel half wm = v % 2 and, in round rd, point
// 16 rd + 4 ((v / 2) % 4) + q; it runs proj_wide_mma's chain over its four
// channels wm 32 + grp + 8 m (m = 2 mt + r) from zero, then the warp's
// shuffle tree over grp, and the lanes of row grp 0 leave the half's
// projection in red (2, 3, 64).  abw: A, B and w_out of the block's 64
// channels, (3, 64).
__device__ __forceinline__ void proj_wg_round(const vnk_bf16* __restrict__ pd,
                                              const float* __restrict__ abw,
                                              float* __restrict__ red, int rd, int v, int lane,
                                              float one_minus_ns) {
  const int wm = v % 2, grp = lane / 4, pt = 16 * rd + 4 * ((v / 2) % 4) + lane % 4;
  float s[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = wm * 32 + grp + 8 * m;
    float p[3], d[3], o[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p[j] = __bfloat162float(pd[(j * kWgDepth + row) * ProjWg::kPdLd + pt]);
      d[j] = __bfloat162float(pd[((3 + j) * kWgDepth + row) * ProjWg::kPdLd + pt]);
    }
    vnk_bn_leaky(p[0], p[1], p[2], d[0], d[1], d[2], abw[row], abw[kWgDepth + row],
                 one_minus_ns, o);
    const float wo = abw[2 * kWgDepth + row];
#pragma unroll
    for (int j = 0; j < 3; ++j) s[j] += wo * o[j];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float t = s[j];
    t += __shfl_xor_sync(0xffffffffu, t, 4);
    t += __shfl_xor_sync(0xffffffffu, t, 8);
    t += __shfl_xor_sync(0xffffffffu, t, 16);
    if (grp == 0) red[(wm * 3 + j) * kPts + pt] = t;
  }
}

// Named barriers of proj_wgmma: the two product warpgroups arrive on
// kPdFull once a block's p, d are staged (the epilogue warpgroups wait
// there), the epilogue warpgroups on kPdEmpty once they have read them (the
// product warpgroups wait there before staging the next block); kEpiSync
// joins the four epilogue warpgroups.
constexpr int kPdFull = 2, kPdEmpty = 3, kEpiSync = 4;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Stage kc's products of one warpgroup: 64 channels of W^T (p) or Wd^T
// (d) times the x chunk's three planes, four k16 steps in order, one
// commit group.
__device__ __forceinline__ void proj_wg_issue(float (&acc)[3][32], const unsigned char* wst,
                                              const unsigned char* xc) {
#pragma unroll
  for (int j = 0; j < 3; ++j) fence_acc(acc[j]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgDepth / 16; ++kk) {
    const uint64_t da = gmma_desc(wst + kk * 16 * 128, ProjWg::kBox, 1024);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      wgmma_m64n64k16_tt(acc[j], da, gmma_desc(xc + j * ProjWg::kBox + kk * 2048, ProjWg::kBox,
                                               1024));
  }
  wgmma_commit();
}

// Threads of proj_wgmma: two product warpgroups, four epilogue warpgroups
// (the epilogue's square root and two divisions a vector run one vector
// after another behind their slow-path branches, so it takes four warps a
// scheduler to keep it issuing), one producer warpgroup.  At launch each
// thread holds 65536 / 896 rounded down to 8: 72 registers.  setmaxnreg
// then moves them where they are needed, within the same 7 x 72 a
// thread-slot (a larger total would block the product warpgroups' increase
// forever): the producer 24, the epilogue 48, the products 144 (96
// accumulators).
constexpr int kProjThreads = 896;
constexpr int kProjEpi = 512;     // the epilogue warpgroups' threads, from 256
constexpr int kProjPd = 256 + kProjEpi;  // the threads of kPdFull and kPdEmpty
constexpr int kProjRegs[3] = {24, 48, 144};  // producer, epilogue, products
static_assert(kProjRegs[0] + 4 * kProjRegs[1] + 2 * kProjRegs[2] <=
                  7 * (65536 / kProjThreads / 8 * 8),
              "setmaxnreg's moves fit the launch's registers");

// kNk: C_in / 64, the x chunks of a tile.
template <int kNk>
__global__ void __launch_bounds__(kProjThreads, 1)
proj_wgmma(const __grid_constant__ CUtensorMap tm_wt, const __grid_constant__ CUtensorMap tm_x,
           const vnk_bf16* __restrict__ pbias, const vnk_bf16* __restrict__ dbias,
           const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ w_out, vnk_bf16* __restrict__ out,
           vnk_bf16* __restrict__ pd_out, int B, int Cin, int Cout, int N, int group,
           float one_minus_ns) {
  using P = ProjWg;
  extern __shared__ unsigned char smem_raw[];
  constexpr int nk = kNk;
  const int nb = Cout / kWgDepth;
  unsigned char* const xs = align1024(smem_raw);  // (nk, 3) boxes: chunk kc, plane j
  unsigned char* const ws = xs + nk * 3 * P::kBox;
  vnk_bf16* const pd = reinterpret_cast<vnk_bf16*>(ws + P::kStages * P::kStage);
  float* const red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(pd) + P::kPd);
  float* const abw = red + 2 * P::kRed;
  uint64_t* const x_full = reinterpret_cast<uint64_t*>(abw + P::kAbw);
  uint64_t* const x_empty = x_full + nk;
  uint64_t* const w_full = x_empty + nk;
  uint64_t* const w_empty = w_full + P::kStages;
  const int tiles_n = (N + kPts - 1) / kPts, tiles = B * tiles_n;
  if (threadIdx.x == 0) {
    for (int i = 0; i < nk; ++i) {
      mbar_init(&x_full[i], 1);
      mbar_init(&x_empty[i], 256);
    }
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int tiles_mine = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  if (threadIdx.x >= kProjPd) {  // the producer warpgroup: its first thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProjRegs[0]) : "memory");
    if (threadIdx.x == kProjPd) {
      int it = 0;
      for (int t = blockIdx.x, ti = 0; t < tiles; t += gridDim.x, ++ti) {
        const int bi = t / tiles_n, n0 = (t % tiles_n) * kPts;
        for (int cb = 0; cb < nb; ++cb)
          for (int kc = 0; kc < nk; ++kc, ++it) {
            if (cb == 0) {  // chunk kc of the tile, once its slot is free
              mbar_wait(&x_empty[kc], (ti & 1) ^ 1);
              mbar_expect_tx(&x_full[kc], 3 * P::kBox);
              for (int j = 0; j < 3; ++j)
                tma_load(xs + (kc * 3 + j) * P::kBox, &tm_x, &x_full[kc], n0, kc * kWgDepth,
                         bi * 3 + j);
            }
            const int s = it % P::kStages;
            mbar_wait(&w_empty[s], ((it / P::kStages) & 1) ^ 1);
            mbar_expect_tx(&w_full[s], P::kStage);
            unsigned char* st = ws + s * P::kStage;
            tma_load(st, &tm_wt, &w_full[s], cb * kWgDepth, kc * kWgDepth, 0);
            tma_load(st + P::kBox, &tm_wt, &w_full[s], cb * kWgDepth, kc * kWgDepth, 1);
          }
      }
    }
    return;
  }

  if (threadIdx.x >= 256) {  // the epilogue warpgroups: the staged blocks in turn
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProjRegs[1]) : "memory");
    const int et = threadIdx.x - 256, v = et / 32, lane = et % 32;
    const int blocks = tiles_mine * nb;
    float tot = 0.f;  // et < 192: the projection of plane et / 64 at point et % 64
    named_arrive(kPdEmpty, kProjPd);  // pd is free for the first block
    int blk = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int bi = t / tiles_n, n0 = (t % tiles_n) * kPts;
      for (int cb = 0; cb < nb; ++cb, ++blk) {
        float* const rb = red + (blk & 1) * P::kRed;
        named_sync(kPdFull, kProjPd);
        proj_wg_round(pd, abw, rb, 2 * (v / 8), v, lane, one_minus_ns);
        proj_wg_round(pd, abw, rb, 2 * (v / 8) + 1, v, lane, one_minus_ns);
        if (blk + 1 < blocks) named_arrive(kPdEmpty, kProjPd);
        named_sync(kEpiSync, kProjEpi);  // rb holds both halves of every point
        if (et < 3 * kPts) {  // the halves in order, then the blocks in order
          const int j = et / kPts, pt = et % kPts, n = n0 + pt;
          tot += rb[j * kPts + pt] + rb[(3 + j) * kPts + pt];
          if (cb == nb - 1) {
            if (n < N) out[(static_cast<size_t>(bi) * 3 + j) * N + n] = __float2bfloat16_rn(tot);
            tot = 0.f;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kProjRegs[2]) : "memory");

  // the product warpgroups: thread (w, grp, tig) of warpgroup wg holds p
  // (wg 0) or d (wg 1) of channel 16 w + grp + 8 r of the block at points
  // 8 i + 2 tig + e of the tile (i < 8; e, r < 2): acc[j][4 i + 2 r + e].
  const int wg = threadIdx.x / 128, ct = threadIdx.x;
  const int w = (ct % 128) / 32, lane = ct % 32, grp = lane / 4, tig = lane % 4;
  const vnk_bf16* const bias = wg == 0 ? pbias : dbias;
  const float* const param = ct < kWgDepth ? a : ct < 2 * kWgDepth ? b : w_out;  // ct < 192
  float acc[3][32];
  int it = 0;
  for (int t = blockIdx.x, ti = 0; t < tiles; t += gridDim.x, ++ti) {
    const int bi = t / tiles_n, n0 = (t % tiles_n) * kPts;
    for (int cb = 0; cb < nb; ++cb) {
      // this block's A, B or w_out at channel ct % 64, staged with p and d
      const float abw_next = ct < 3 * kWgDepth ? param[cb * kWgDepth + ct % kWgDepth] : 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
      // Stage kc's products go in flight behind stage kc - 1's, which then
      // completes (wait_group 1) and frees its stage and, in a tile's last
      // block, its x chunk.
#pragma unroll
      for (int kc = 0; kc <= nk; ++kc) {
        if (kc < nk) {
          const int q = it + kc, s = q % P::kStages;
          if (cb == 0) mbar_wait(&x_full[kc], ti & 1);
          mbar_wait(&w_full[s], (q / P::kStages) & 1);
          proj_wg_issue(acc, ws + s * P::kStage + wg * P::kBox, xs + kc * 3 * P::kBox);
        }
        if (kc == 0) continue;
        if (kc < nk)
          wgmma_wait<1>();
        else
          wgmma_wait_all();
        mbar_arrive(&w_empty[(it + kc - 1) % P::kStages]);
        if (cb == nb - 1) mbar_arrive(&x_empty[kc - 1]);
      }
      it += nk;
#pragma unroll
      for (int j = 0; j < 3; ++j) fence_acc(acc[j]);
      named_sync(kPdEmpty, kProjPd);  // the epilogue has read the last block
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * w + grp + 8 * r;
        // a bias column covers the tile (group 0 or a multiple of 64)
        float bc[3] = {0.f, 0.f, 0.f};
        if (bias != nullptr) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            bc[j] = vnk_bias(bias, bi, j, cb * kWgDepth + row, Cout, n0, N, group);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(acc[j][4 * i + 2 * r] + bc[j],
                                                           acc[j][4 * i + 2 * r + 1] + bc[j]);
            *reinterpret_cast<__nv_bfloat162*>(pd + ((wg * 3 + j) * kWgDepth + row) * P::kPdLd +
                                               8 * i + 2 * tig) = v;
            // the test hook: p (wg 0) or d (wg 1) as staged, (2, B, 3, Cout, N);
            // N % 8 == 0, so a pair is in or out
            const int n = n0 + 8 * i + 2 * tig;
            if (pd_out != nullptr && n < N)
              *reinterpret_cast<__nv_bfloat162*>(
                  pd_out + (((static_cast<size_t>(wg) * B + bi) * 3 + j) * Cout +
                            cb * kWgDepth + row) * N + n) = v;
          }
      }
      if (ct < 3 * kWgDepth) abw[ct] = abw_next;
      named_arrive(kPdFull, kProjPd);
    }
  }
}

// out[e] = the sum of the `blocks` projection partials of element e, in
// channel-block order, rounded once to T.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
proj_sum(const float* __restrict__ part, T* __restrict__ out, int blocks, int64_t cols) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kWideThreads + threadIdx.x; e < cols;
       e += static_cast<int64_t>(gridDim.x) * kWideThreads) {
    float s = 0.f;
    for (int k = 0; k < blocks; ++k) s += part[k * cols + e];
    out[e] = vnk_cast<T>(s);
  }
}

// The designs of kernel C (ops/vn_layer_fused.py DESIGN_CODES).
enum ProjDesign { kProjNarrow = 0, kProjWide = 1, kProjWgmma = 3 };

// Where proj_wgmma's tiles fit (fwd_bf16_design): whole 64-channel boxes,
// x resident (C_in <= 256), point rows of whole 16-byte vectors from a
// 16-byte aligned base (the tensor maps), a bias column per whole tile
// (group 0 or a multiple of 64).
inline bool proj_wgmma_fits(int Cin, int Cout, int N, int group, const void* x) {
  return Cin % kWgDepth == 0 && Cin <= ProjWg::kMaxChunks * kWgDepth && Cout % kWgDepth == 0 &&
         Cin > 0 && Cout > 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         group % kPts == 0;
}

// W^T and Wd^T into wt, then proj_wgmma on `ctas` persistent blocks.
cudaError_t launch_proj_wgmma(const vnk_bf16* x, const float* w, const float* wd,
                              const vnk_bf16* pbias, const vnk_bf16* dbias, const float* a,
                              const float* b, const float* w_out, vnk_bf16* out, vnk_bf16* wt,
                              vnk_bf16* pd_out, int B, int Cin, int Cout, int N, int group, int ctas,
                              float one_minus_ns, cudaStream_t st) {
  if (!proj_wgmma_fits(Cin, Cout, N, group, x) || ctas < 1) return cudaErrorInvalidValue;
  launch_transpose(w, wd, wt, Cin, Cout, st);
  CUtensorMap wt_map, x_map;
  cudaError_t err = tensor_map(&wt_map, wt, Cout, Cin, 2, kWgDepth, kWgDepth);
  if (err == cudaSuccess) err = tensor_map(&x_map, x, N, Cin, B * 3, kPts, kWgDepth);
  if (err != cudaSuccess) return err;
  auto kernel = Cin == 64    ? proj_wgmma<1>
                : Cin == 128 ? proj_wgmma<2>
                : Cin == 192 ? proj_wgmma<3>
                             : proj_wgmma<4>;
  return launch_wide<kProjThreads>(kernel, dim3(ctas), ProjWg::bytes(Cin / kWgDepth), st, wt_map,
                                   x_map, pbias, dbias, a, b, w_out, out, pd_out, B, Cin, Cout, N,
                                   group, one_minus_ns);
}

// Kernel C in the design the wrapper chose: wide, wgmma (bf16 only; `ctas`
// its blocks), or layer_fwd<true, T>.
template <typename T>
int project_fwd(const void* x, const void* w, const void* wd, const void* pbias,
                const void* dbias, const void* a, const void* b, const void* w_out, void* out,
                void* wt, void* part, void* pd_out, int B, int Cin, int Cout, int N, int group,
                int design, int ctas, float one_minus_ns, void* stream) {
  if (design == kProjNarrow)
    return launch<true, T>(x, w, wd, pbias, dbias, a, b, w_out, out, pd_out, B, Cin, Cout, N,
                           group, one_minus_ns, stream);
  if (design != kProjWide && (design != kProjWgmma || !vnk_is_bf16<T>()))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (vnk_is_bf16<T>()) {
    if (design == kProjWgmma)
      return static_cast<int>(launch_proj_wgmma(
          static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(wd),
          static_cast<const T*>(pbias), static_cast<const T*>(dbias),
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<const float*>(w_out), static_cast<T*>(out), static_cast<T*>(wt),
          static_cast<T*>(pd_out), B, Cin, Cout, N, group, ctas, one_minus_ns, st));
  }
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  launch_transpose(static_cast<const float*>(w), static_cast<const float*>(wd),
                   static_cast<T*>(wt), Cin, Cout, st);
  const bool aw = aligned16(wt, Cout, kV), ax = aligned16(x, N, kV);
  const int tiles = (N + kPts - 1) / kPts;
  int blocks;
  cudaError_t err;
  if constexpr (vnk_is_bf16<T>()) {
    using P = ProjMma;
    blocks = (Cout + P::kBC - 1) / P::kBC;
    err = launch_wide<P::kThreads>(
        proj_wide_mma, dim3(blocks, tiles, B), P::kBytes, st, static_cast<const T*>(x),
        static_cast<const T*>(wt), static_cast<const T*>(pbias), static_cast<const T*>(dbias),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(w_out), static_cast<float*>(part), static_cast<T*>(pd_out), B,
        Cin, Cout, N, group, one_minus_ns, aw, ax);
  } else {
    using P = ProjFma;
    blocks = (Cout + P::kBC - 1) / P::kBC;
    err = launch_wide(
        proj_wide_fma, dim3(blocks, tiles, B), P::kBytes, st, static_cast<const T*>(x),
        static_cast<const T*>(wt), static_cast<const T*>(pbias), static_cast<const T*>(dbias),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(w_out), static_cast<float*>(part), static_cast<T*>(pd_out), B,
        Cin, Cout, N, group, one_minus_ns, aw, ax);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cols = static_cast<int64_t>(B) * 3 * N;
  const int64_t need = (cols + kWideThreads - 1) / kWideThreads;
  proj_sum<T><<<static_cast<unsigned>(need < 65535 ? need : 65535), kWideThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<T*>(out), blocks, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel B in the design the wrapper chose: the stream (Cin <= 2) or
// layer_fwd<false, T>.
template <typename T>
int layer_fwd_design(const void* x, const void* w, const void* wd, const void* pbias,
                     const void* dbias, const void* a, const void* b, void* out, int B, int Cin,
                     int Cout, int N, int group, int streamed, float one_minus_ns, void* stream) {
  if (streamed)
    return launch_stream<T>(x, w, wd, pbias, dbias, a, b, out, B, Cin, Cout, N, group,
                            one_minus_ns, stream);
  return launch<false, T>(x, w, wd, pbias, dbias, a, b, nullptr, out, nullptr, B, Cin, Cout, N,
                          group, one_minus_ns, stream);
}

// pbias and dbias are (B, 3, Cout) per-sample biases (group = 0) or
// (B, 3, Cout, N / group) per-group ones (N % group == 0), or both null.
// x, the biases and out are float32 here and bfloat16 in the _bf16 entry
// points; W, Wd, A, B and w_out are float32 in both.  B takes `streamed`
// (1: the stream design, Cin 1 or 2; 0: the narrow one; the wrapper's
// layer_fwd_design).
VNK_EXPORT int vn_layer_fused_fwd(const void* x, const void* w, const void* wd,
                                  const void* pbias, const void* dbias,
                                  const void* a, const void* b, void* out,
                                  int B, int Cin, int Cout, int N, int group, int streamed,
                                  float one_minus_ns, void* stream) {
  return layer_fwd_design<float>(x, w, wd, pbias, dbias, a, b, out, B, Cin, Cout, N, group,
                                 streamed, one_minus_ns, stream);
}

// C takes `design` (ProjDesign: 1 the wide design, 0 the narrow one, 3 the
// wgmma one, bf16 only; the wrapper's forward_design and fwd_bf16_design;
// another, or wgmma where its tiles do not fit, returns
// cudaErrorInvalidValue) and, for the wide and wgmma designs, wt, a (2,
// Cin, Cout) scratch in the activations' type; for the wide design part,
// (ceil(Cout / kBC), B, 3, N) floats (kBC 32 in float32, ProjFma, and 64 in
// bf16, ProjMma); for the wgmma design `ctas`, its persistent blocks
// (the wrapper's proj_wgmma_grid).  pd_out: null, or (2, B, 3, Cout, N) in
// the activations' type, which every design fills with the p and d its
// epilogue reads (the bias added, rounded through bf16 in the bf16 mode),
// so that a test can hold C''s recomputed planes to them; no path passes it.
VNK_EXPORT int vn_layer_fused_project_fwd(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    void* out, void* wt, void* part, void* pd_out, int B, int Cin, int Cout, int N, int group,
    int design, int ctas, float one_minus_ns, void* stream) {
  return project_fwd<float>(x, w, wd, pbias, dbias, a, b, w_out, out, wt, part, pd_out, B, Cin,
                            Cout, N, group, design, ctas, one_minus_ns, stream);
}

VNK_EXPORT int vn_layer_fused_fwd_bf16(const void* x, const void* w,
                                       const void* wd, const void* pbias,
                                       const void* dbias, const void* a,
                                       const void* b, void* out, int B,
                                       int Cin, int Cout, int N, int group, int streamed,
                                       float one_minus_ns, void* stream) {
  return layer_fwd_design<vnk_bf16>(x, w, wd, pbias, dbias, a, b, out, B, Cin, Cout, N, group,
                                    streamed, one_minus_ns, stream);
}

VNK_EXPORT int vn_layer_fused_project_fwd_bf16(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    void* out, void* wt, void* part, void* pd_out, int B, int Cin, int Cout, int N, int group,
    int design, int ctas, float one_minus_ns, void* stream) {
  return project_fwd<vnk_bf16>(x, w, wd, pbias, dbias, a, b, w_out, out, wt, part, pd_out, B, Cin,
                               Cout, N, group, design, ctas, one_minus_ns, stream);
}
