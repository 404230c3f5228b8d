// Kernels S, S', B' and C': the training half of the whole-layer VN kernels.
// x is (B, 3, Cin, N) planes, W and Wd (Cout, Cin), the optional biases per
// sample (group = 0: (B, 3, Cout)) or per run of `group` points (group = S:
// (B, 3, Cout, N / S), the attention decoder's per-centre feature, column
// n / S at point n); p = W x (+ pbias), d = Wd x (+ dbias) are recomputed
// from x in every kernel and never saved.
//
// S  replaces vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py
//    ::vn_layer_stats (the pallas_call at :278, body _stats_fwd_kernel :147):
//    s1 = sum (|p| + EPS), s2 = sum (|p| + EPS)^2 per channel.
// S' replaces vn_layer_fused.py::_stats_bwd (pallas_call :325, body :172):
//    dp = (c1 + 2 c2 (|p| + EPS)) p / |p| from the cotangents (c1, c2) of
//    (s1, s2), then dx = W^T dp, dW = sum dp x^T, dpbias = sum_n dp (over
//    each bias column's points: all N, or the S points of its group).
// B' replaces vn_layer_fused.py::_layer_bwd (pallas_call :594, body :377):
//    the epilogue backward (common.cuh) gives dp, dd, dA, dB from g, then
//    dx = W^T dp + Wd^T dd, dW = sum dp x^T, dWd = sum dd x^T, and the bias
//    gradients sum_n dp, sum_n dd.
// C' replaces vn_layer_fused.py::_proj_bwd (pallas_call :878, body :659):
//    as B', with the (B, 3, Cout, N) cotangent formed in registers as
//    w_out[c] * g[n] from g (B, 3, 1, N), and dw_out = sum <o, g>.
//
// Design.  The TPU kernels run their grid in order and add each point
// tile's dW into one output; Hopper blocks run in no order, and a register
// tile that holds dx for all input channels does not fit.  So each backward
// is three passes, all hand-written here, with no float atomics:
//   1. pd_pass: the tile products of vn_tile.cuh recompute p (and d); the
//      epilogue backward runs in registers; dp (and dd) go to a scratch
//      buffer of B*3*Cout*N floats each, and the per-channel sums go out as
//      one partial per (sample, 64-point tile), summed over the 16 point
//      groups of a tile with a fixed butterfly.  The bias sums go out as one
//      partial per (sample, tile) too where a bias column covers whole tiles
//      (group 0 or group >= 64), else (pd_pass<kSplit>) as 64 / group
//      sub-partials per tile, each the sum over one group's points (a
//      butterfly over group / 4 lanes, or a thread's own points for
//      group < 4).
//   2. dx_gemm: dx = W^T dp (+ Wd^T dd), a 64 x 64 output tile per block,
//      the same 4 x 4 register micro-tile and fmaf loop over Cout.
//   3. dw_gemm: each block owns a 64 x 64 tile of dW (and dWd, which share
//      the x loads) and one of S contiguous chunks of the B*3*N points
//      (split K), writing a partial tile.
// vnk_reduce_rows then sums every partial in a fixed order (the bias
// partials over the tiles of each column), so each run of a kernel gives the
// same bits.  S is pass 1 alone, with the norm sums.
//
// Bound on the H100 at the main path's shapes (batch 8, N = 16384):
//   S at 256 -> 256: operations, the 2*Cin*Cout*3*B*N FLOP of p = W x.
//   S' at 256 -> 256: operations, three such products (p, dx, dW).
//   B' at 2 -> 256: bytes, reading g (B*3*Cout*N floats).
//   C' at 256 -> 256: operations, six products (p, d, dx from dp and dd,
//      dW, dWd).
// The attention decoder's pair fold (1 -> 256, N = 14336, group 64) is
// bound by bytes like B': S and S' read x (one channel) and write dx, B'
// reads g; the bias columns are 1/64 of a plane.
// All products run as FP32 FMAs on the CUDA cores (the float32 policy keeps
// them off the tensor cores).  Passes 2 and 3 read the dp/dd scratch back
// once each; the scratch round trip is what a fused later version removes.
//
// The bf16 mode (entry points <name>_bf16; T = vnk_bf16: x, the biases, g,
// dx and the dp/dd scratch bfloat16; W, Wd, A, B, w_out, c1, c2, dW, the
// per-channel and the bias sums float32) is the TPU kernels' bf16=True
// (vn_layer_fused.py:61-65, :86-123, :204-209, :440-457, :733-750):
//   pass 1 recomputes p and d as the forward's bf16 mode does (vn_tile.cuh:
//      products of bf16-rounded W and x summed in float32, the bias added,
//      one rounding through bf16), runs the float32 epilogue backward on
//      them and on the bf16 cotangent (C': w_out * g formed in float32),
//      writes the per-channel and the bias partials from the float32 dp
//      and dd, and only then rounds dp and dd to bf16 as it stores them:
//      the scratch holds JAX's dp16 and dd16 (half the float32 mode's);
//   pass 2 takes dx = W16^T dp16 (+ Wd16^T dd16), exact products summed in
//      float32, stored bf16;
//   pass 3 takes dW = dp16 x16^T (dWd = dd16 x16^T) in float32.
// The loops are the float32 mode's over bf16 loads: the bf16 bounds (the
// tensor cores' rate, half the bytes) are for a redesign with mma/wgmma.
#include "vn_tile.cuh"

namespace {

enum Mode { kStatsFwd = 0, kStatsBwd = 1, kLayerBwd = 2, kProjBwd = 3 };

constexpr int kP = 16;  // points per shared-memory stage of dw_gemm

template <typename E>  // the activations' type (T below is a tile count)
struct PdArgs {
  const E* x;
  const float* w;
  const float* wd;
  const E* pbias;
  const E* dbias;
  const float* a;
  const float* b;
  const float* w_out;
  const E* g;
  const float* c1;
  const float* c2;
  E* dp;  // the dp, dd scratch: float32, or bf16 in the bf16 mode
  E* dd;
  float* partial;  // (nqc, B, T, Cout) per-channel sums, then the bias
                   // sums (nqb, B, R, Cout) with R = T * spt
  int B, Cin, Cout, N, T;
  int group;  // 0: one bias column per sample; S: one per S points
  int sub;    // points per bias partial: min(group, kPts), kPts for group 0
  int spt;    // bias partials per tile: kPts / sub
  float one_minus_ns;
};

// Per-channel sums written by each mode: S (s1, s2), B' (dA, dB),
// C' (dA, dB, dw_out); the bias sums (dpbias[3], ddbias[3]) follow.
template <int kMode>
__host__ __device__ constexpr int channel_sums() {
  return kMode == kStatsFwd ? 2 : kMode == kStatsBwd ? 0 : kMode == kLayerBwd ? 2 : 3;
}

// Four consecutive points n .. n+3 of one row (n a multiple of 4), at once
// where they are all inside a row of N % 4 == 0 points (16 bytes of float32,
// 8 of bf16, rounded to nearest even).
__device__ __forceinline__ void store4(float* row, int n, int N, bool vec,
                                       const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n + q < N) row[n + q] = v[q];
  }
}

__device__ __forceinline__ void store4(vnk_bf16* row, int n, int N, bool vec,
                                       const float (&v)[4]) {
  if (vec) {
    reinterpret_cast<__nv_bfloat162*>(row + n)[0] = __floats2bfloat162_rn(v[0], v[1]);
    reinterpret_cast<__nv_bfloat162*>(row + n)[1] = __floats2bfloat162_rn(v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n + q < N) row[n + q] = __float2bfloat16_rn(v[q]);
  }
}

// kSplit: bias columns narrower than a tile (0 < group < 64), a tile's
// bias partials split per group; otherwise one running sum a thread.
template <int kMode, bool kSplit, typename T>
__global__ void __launch_bounds__(kThreads, 1) pd_pass(PdArgs<T> args) {
  constexpr bool kWithD = kMode == kLayerBwd || kMode == kProjBwd;
  constexpr int kNqc = channel_sums<kMode>();
  constexpr bool kWrites = kMode != kStatsFwd;
  __shared__ VnkTileSmem sm;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int t = blockIdx.x;
  const int bi = blockIdx.z;
  const int n0 = t * kPts;
  const int c0 = blockIdx.y * kCh;
  const int Cout = args.Cout, N = args.N;
  const T* xb = args.x + static_cast<size_t>(bi) * 3 * args.Cin * N;
  const bool has_bias = args.pbias != nullptr;
  const bool vec_store = (N % 4 == 0) && (n0 + tx * 4 + 3 < N);

  float accp[3][4][4], accd[3][4][4];
  vnk_tile_products<kWithD>(xb, args.w, args.wd, args.Cin, Cout, N, c0, n0,
                            sm, accp, accd);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    const bool cok = c < Cout;
    float av = 0.f, bv = 0.f, wo = 0.f, c1v = 0.f, c2v = 0.f;
    if (cok) {
      if (kWithD) {
        av = args.a[c];
        bv = args.b[c];
      }
      if (kMode == kProjBwd) wo = args.w_out[c];
      if (kMode == kStatsBwd) {
        c1v = args.c1[c];
        c2v = args.c2[c];
      }
    }
    float sc[3] = {0.f, 0.f, 0.f}, sp[3] = {0.f, 0.f, 0.f}, sd[3] = {0.f, 0.f, 0.f};
    float outp[3][4], outd[3][4];
    float pb[3] = {0.f, 0.f, 0.f}, db[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      const bool ok = cok && n < N;
      // a thread's 4 points share one bias column unless group is 1 or 2
      if (has_bias && cok && (q == 0 || (kSplit && args.group < 4))) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          pb[j] = vnk_bias(args.pbias, bi, j, c, Cout, n, N, args.group);
          if (kWithD) db[j] = vnk_bias(args.dbias, bi, j, c, Cout, n, N, args.group);
        }
      }
      // the bf16 mode rounds p and d through bf16 once
      const float p[3] = {vnk_round_as<T>(accp[0][i][q] + pb[0]),
                          vnk_round_as<T>(accp[1][i][q] + pb[1]),
                          vnk_round_as<T>(accp[2][i][q] + pb[2])};
      if (kMode == kStatsFwd) {
        const float norm_e = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) + VNK_EPS;
        if (ok) {
          sc[0] += norm_e;
          sc[1] += norm_e * norm_e;
        }
      } else if (kMode == kStatsBwd) {
        const float pnorm = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
        const float norm_e = pnorm + VNK_EPS;
        float scale = (c1v + 2.f * c2v * norm_e) *
                      (pnorm > 0.f ? 1.f / fmaxf(pnorm, 1e-30f) : 0.f);
        if (!ok) scale = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          outp[j][q] = scale * p[j];
          sp[j] += outp[j][q];
        }
      } else {
        const float d[3] = {vnk_round_as<T>(accd[0][i][q] + db[0]),
                            vnk_round_as<T>(accd[1][i][q] + db[1]),
                            vnk_round_as<T>(accd[2][i][q] + db[2])};
        float gp[3] = {0.f, 0.f, 0.f}, gv[3] = {0.f, 0.f, 0.f};
        if (ok) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            if (kMode == kProjBwd) {
              gp[j] = vnk_load(args.g[(static_cast<size_t>(bi) * 3 + j) * N + n]);
              gv[j] = wo * gp[j];
            } else {
              gv[j] = vnk_load(args.g[((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N + n]);
            }
          }
        }
        float dpv[3], ddv[3], o[3], dqp, norm_e;
        vnk_bn_leaky_bwd(p, d, gv, av, bv, args.one_minus_ns, dpv, ddv, &dqp,
                         &norm_e, kMode == kProjBwd ? o : nullptr);
        if (ok) {
          sc[0] += dqp;
          sc[1] += dqp / norm_e;
          if (kMode == kProjBwd) sc[2] += o[0] * gp[0] + o[1] * gp[1] + o[2] * gp[2];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          outp[j][q] = ok ? dpv[j] : 0.f;
          outd[j][q] = ok ? ddv[j] : 0.f;
          sp[j] += outp[j][q];
          sd[j] += outd[j][q];
        }
      }
    }

    // the partials below sum the float32 outp/outd; the stores round them
    if (kWrites && cok) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const size_t row = ((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N;
        const int n = n0 + tx * 4;
        store4(args.dp + row, n, N, vec_store, outp[j]);
        if (kWithD) store4(args.dd + row, n, N, vec_store, outd[j]);
      }
    }

    // one partial per (quantity, sample, tile, channel)
    const size_t stride = static_cast<size_t>(args.B) * args.T * Cout;
    const size_t at = (static_cast<size_t>(bi) * args.T + t) * Cout + c;
#pragma unroll
    for (int k = 0; k < kNqc; ++k) {
      const float v = vnk_sum16(sc[k]);
      if (tx == 0 && cok) args.partial[k * stride + at] = v;
    }
    if (kMode != kStatsFwd && has_bias) {
      float* bias_part = args.partial + kNqc * stride;
      const size_t bstride = stride * args.spt;
      const size_t row0 = (static_cast<size_t>(bi) * args.T + t) * args.spt;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int h = 0; h < (kWithD ? 2 : 1); ++h) {
          const float o0 = h == 0 ? outp[j][0] : outd[j][0];
          const float o1 = h == 0 ? outp[j][1] : outd[j][1];
          const float o2 = h == 0 ? outp[j][2] : outd[j][2];
          const float o3 = h == 0 ? outp[j][3] : outd[j][3];
          float* dst = bias_part + (h * 3 + j) * bstride;
          if (!kSplit) {  // group 0 or >= 64: one partial a tile
            const float v = vnk_sum16(h == 0 ? sp[j] : sd[j]);
            if (tx == 0 && cok) dst[row0 * Cout + c] = v;
          } else if (args.sub >= 4) {  // a thread's 4 points, then its run of lanes
            const int lanes = args.sub / 4;
            const float v = vnk_sum_lanes(((o0 + o1) + o2) + o3, lanes);
            if (tx % lanes == 0 && cok) dst[(row0 + tx / lanes) * Cout + c] = v;
          } else if (args.sub == 2) {  // two groups in a thread's points
            if (cok) {
              dst[(row0 + tx * 2) * Cout + c] = o0 + o1;
              dst[(row0 + tx * 2 + 1) * Cout + c] = o2 + o3;
            }
          } else if (cok) {  // group 1: every point its own column
            dst[(row0 + tx * 4) * Cout + c] = o0;
            dst[(row0 + tx * 4 + 1) * Cout + c] = o1;
            dst[(row0 + tx * 4 + 2) * Cout + c] = o2;
            dst[(row0 + tx * 4 + 3) * Cout + c] = o3;
          }
        }
      }
    }
  }
}

// dx[bj, k, n] = sum_c W[c, k] g1[bj, c, n] (+ Wd[c, k] g2[bj, c, n]) for
// every (sample, plane) bj: a 64-row x 64-point tile per block.  The bf16
// mode rounds W and Wd to bf16 as they are staged and reads bf16 g1, g2:
// each product is exact in float32.
template <bool kTwo, typename T>
__global__ void __launch_bounds__(kThreads)
dx_gemm(const float* __restrict__ w, const float* __restrict__ wd,
        const T* __restrict__ g1, const T* __restrict__ g2,
        T* __restrict__ dx, int Cin, int Cout, int N) {
  __shared__ __align__(16) float ws[kK][kCh];
  __shared__ __align__(16) float wds[kK][kCh];
  __shared__ __align__(16) float gs[kK][kPts];
  __shared__ __align__(16) float g2s[kK][kPts];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kPts;
  const int k0 = blockIdx.y * kCh;
  const size_t bj = blockIdx.z;
  const T* g1b = g1 + bj * Cout * N;
  const T* g2b = kTwo ? g2 + bj * Cout * N : nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  for (int c0 = 0; c0 < Cout; c0 += kK) {
    for (int e = threadIdx.x; e < kK * kCh; e += kThreads) {
      const int cc = e / kCh, r = e % kCh;
      const int gc = c0 + cc, gk = k0 + r;
      const bool ok = gc < Cout && gk < Cin;
      ws[cc][r] = ok ? vnk_round_as<T>(w[static_cast<size_t>(gc) * Cin + gk]) : 0.f;
      if (kTwo) wds[cc][r] = ok ? vnk_round_as<T>(wd[static_cast<size_t>(gc) * Cin + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < kK * kPts; e += kThreads) {
      const int cc = e / kPts, nn = e % kPts;
      const int gc = c0 + cc, gn = n0 + nn;
      const bool ok = gc < Cout && gn < N;
      gs[cc][nn] = ok ? vnk_load(g1b[static_cast<size_t>(gc) * N + gn]) : 0.f;
      if (kTwo) g2s[cc][nn] = ok ? vnk_load(g2b[static_cast<size_t>(gc) * N + gn]) : 0.f;
    }
    __syncthreads();
    const int cmax = min(kK, Cout - c0);
    for (int cc = 0; cc < cmax; ++cc) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[cc][ty * 4]);
      const float4 gv = *reinterpret_cast<const float4*>(&gs[cc][tx * 4]);
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(wr[i], gr[q], acc[i][q]);
      if (kTwo) {
        const float4 dv = *reinterpret_cast<const float4*>(&wds[cc][ty * 4]);
        const float4 hv = *reinterpret_cast<const float4*>(&g2s[cc][tx * 4]);
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(dr[i], hr[q], acc[i][q]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx * 4;
  const bool vec_store = (N % 4 == 0) && (n + 3 < N);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k < Cin) store4(dx + (bj * Cin + k) * N, n, N, vec_store, acc[i]);
  }
}

// Split-K weight gradient: part[s, c, k] = sum over points p in chunk s of
// g1[p, c] x[p, k] (and part2 with g2), where p runs over (sample, plane,
// point) of the (B*3, C, N) tensors.  One 64 x 64 (c, k) tile per block.
template <bool kTwo, typename T>
__global__ void __launch_bounds__(kThreads)
dw_gemm(const T* __restrict__ g1, const T* __restrict__ g2,
        const T* __restrict__ x, float* __restrict__ part,
        float* __restrict__ part2, int Cin, int Cout, int N, int P,
        int chunk) {
  __shared__ __align__(16) float gs[kP][kCh];
  __shared__ __align__(16) float g2s[kP][kCh];
  __shared__ __align__(16) float xs[kP][kCh];
  const int tx = threadIdx.x % 16;  // k group
  const int ty = threadIdx.x / 16;  // c group
  const int k0 = blockIdx.x * kCh;
  const int c0 = blockIdx.y * kCh;
  const int s = blockIdx.z;
  const int p_begin = s * chunk;
  const int p_end = min(P, p_begin + chunk);

  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = acc2[i][q] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += kP) {
    for (int e = threadIdx.x; e < kP * kCh; e += kThreads) {
      const int r = e / kP, pp = e % kP;
      const int p = p0 + pp;
      float gv = 0.f, hv = 0.f, xv = 0.f;
      if (p < p_end) {
        const int bj = p / N;
        const int n = p - bj * N;
        if (c0 + r < Cout) {
          const size_t at = (static_cast<size_t>(bj) * Cout + c0 + r) * N + n;
          gv = vnk_load(g1[at]);
          if (kTwo) hv = vnk_load(g2[at]);
        }
        if (k0 + r < Cin) xv = vnk_load(x[(static_cast<size_t>(bj) * Cin + k0 + r) * N + n]);
      }
      gs[pp][r] = gv;
      if (kTwo) g2s[pp][r] = hv;
      xs[pp][r] = xv;
    }
    __syncthreads();
#pragma unroll 4
    for (int pp = 0; pp < kP; ++pp) {
      const float4 gv = *reinterpret_cast<const float4*>(&gs[pp][ty * 4]);
      const float4 xv = *reinterpret_cast<const float4*>(&xs[pp][tx * 4]);
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(gr[i], xr[q], acc[i][q]);
      if (kTwo) {
        const float4 hv = *reinterpret_cast<const float4*>(&g2s[pp][ty * 4]);
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc2[i][q] = fmaf(hr[i], xr[q], acc2[i][q]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= Cout) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + tx * 4 + q;
      if (k >= Cin) continue;
      const size_t at = (static_cast<size_t>(s) * Cout + c) * Cin + k;
      part[at] = acc[i][q];
      if (kTwo) part2[at] = acc2[i][q];
    }
  }
}

int tiles(int N) { return (N + kPts - 1) / kPts; }

template <int kMode, typename T>
void launch_pd(const PdArgs<T>& args, cudaStream_t st) {
  const dim3 grid(args.T, (args.Cout + kCh - 1) / kCh, args.B);
  if (kMode != kStatsFwd && args.sub < kPts) {
    pd_pass<kMode, true, T><<<grid, kThreads, 0, st>>>(args);
  } else {
    pd_pass<kMode, false, T><<<grid, kThreads, 0, st>>>(args);
  }
}

// Passes 2 and 3 and the reductions shared by S', B' and C'.  dw2 receives
// (kTwo ? 2 : 1) gradients of (Cout, Cin); dw_part holds as many split-K
// partials of (S, Cout, Cin).
template <bool kTwo, typename T>
void products_bwd(const T* x, const float* w, const float* wd, const T* dp,
                  const T* dd, T* dx, float* dw2, float* dw_part, int B,
                  int Cin, int Cout, int N, int S, cudaStream_t st) {
  dx_gemm<kTwo, T><<<dim3(tiles(N), (Cin + kCh - 1) / kCh, B * 3), kThreads, 0,
                  st>>>(w, wd, dp, dd, dx, Cin, Cout, N);
  const int P = B * 3 * N;
  const int chunk = ((P + S - 1) / S + kP - 1) / kP * kP;
  const size_t part_size = static_cast<size_t>(S) * Cout * Cin;
  dw_gemm<kTwo, T><<<dim3((Cin + kCh - 1) / kCh, (Cout + kCh - 1) / kCh, S),
                  kThreads, 0, st>>>(dp, dd, x, dw_part,
                                     kTwo ? dw_part + part_size : nullptr, Cin,
                                     Cout, N, P, chunk);
  vnk_reduce_rows(dw_part, dw2, kTwo ? 2 : 1, S,
                  static_cast<int64_t>(Cout) * Cin, st);
}

template <typename T>
PdArgs<T> make_args(const void* x, const void* w, const void* wd,
                    const void* pbias, const void* dbias, const void* a,
                    const void* b, const void* w_out, const void* g,
                    const void* c1, const void* c2, void* dp, void* dd,
                    void* partial, int B, int Cin, int Cout, int N, int group,
                    float one_minus_ns) {
  PdArgs<T> r;
  r.x = static_cast<const T*>(x);
  r.w = static_cast<const float*>(w);
  r.wd = static_cast<const float*>(wd);
  r.pbias = static_cast<const T*>(pbias);
  r.dbias = static_cast<const T*>(dbias);
  r.a = static_cast<const float*>(a);
  r.b = static_cast<const float*>(b);
  r.w_out = static_cast<const float*>(w_out);
  r.g = static_cast<const T*>(g);
  r.c1 = static_cast<const float*>(c1);
  r.c2 = static_cast<const float*>(c2);
  r.dp = static_cast<T*>(dp);
  r.dd = static_cast<T*>(dd);
  r.partial = static_cast<float*>(partial);
  r.B = B;
  r.Cin = Cin;
  r.Cout = Cout;
  r.N = N;
  r.T = tiles(N);
  r.group = group;
  r.sub = group == 0 || group > kPts ? kPts : group;
  r.spt = kPts / r.sub;
  r.one_minus_ns = one_minus_ns;
  return r;
}

// The bias sums (3 or 6 quantities of (B, R, Cout), R = T * spt partials a
// sample) after nqc per-channel ones -> dbias_out (nq, B, R / rpg, Cout),
// each the sum of the rpg consecutive partials of one bias column: all T
// tiles for group 0, group / 64 tiles for group >= 64, else 1 (the wrapper
// keeps the first N / group columns).
template <typename T>
void reduce_bias(const PdArgs<T>& args, int nqc, int nq, float* dbias_out,
                 cudaStream_t st) {
  const size_t stride = static_cast<size_t>(args.B) * args.T * args.Cout;
  const int rows = args.T * args.spt;
  const int rpg = args.group == 0 ? args.T : args.group >= kPts ? args.group / kPts : 1;
  vnk_reduce_rows(args.partial + nqc * stride, dbias_out, nq * args.B * (rows / rpg),
                  rpg, args.Cout, st);
}

template <typename T>
int stats_fwd(const void* x, const void* w, const void* pbias, void* s12,
              void* partial, int B, int Cin, int Cout, int N, int group,
              void* stream) {
  if (B == 0 || N == 0 || Cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PdArgs<T> args = make_args<T>(x, w, nullptr, pbias, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, partial, B, Cin, Cout, N, group, 0.f);
  launch_pd<kStatsFwd>(args, st);
  vnk_reduce_rows(args.partial, static_cast<float*>(s12), 2, B * args.T, Cout, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stats_bwd(const void* x, const void* w, const void* pbias, const void* c1,
              const void* c2, void* dx, void* dw, void* dpb, void* dp,
              void* partial, void* dw_part, int B, int Cin, int Cout, int N,
              int S, int group, void* stream) {
  if (B == 0 || N == 0 || Cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PdArgs<T> args = make_args<T>(x, w, nullptr, pbias, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, c1, c2, dp, nullptr, partial,
                                      B, Cin, Cout, N, group, 0.f);
  launch_pd<kStatsBwd>(args, st);
  if (pbias != nullptr) reduce_bias(args, 0, 3, static_cast<float*>(dpb), st);
  products_bwd<false>(args.x, args.w, nullptr, args.dp, static_cast<const T*>(nullptr),
                      static_cast<T*>(dx), static_cast<float*>(dw),
                      static_cast<float*>(dw_part), B, Cin, Cout, N, S, st);
  return static_cast<int>(cudaGetLastError());
}

// B' (w_out null, kLayerBwd) and C' (kProjBwd): nqc per-channel sums.
template <int kMode, typename T>
int layer_bwd(const void* x, const void* w, const void* wd, const void* pbias,
              const void* dbias, const void* a, const void* b,
              const void* w_out, const void* g, void* dx, void* dw2,
              void* sums, void* dpdb, void* dp, void* dd, void* partial,
              void* dw_part, int B, int Cin, int Cout, int N, int S,
              int group, float one_minus_ns, void* stream) {
  if (B == 0 || N == 0 || Cout == 0) return 0;
  constexpr int nqc = channel_sums<kMode>();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PdArgs<T> args = make_args<T>(x, w, wd, pbias, dbias, a, b, w_out, g,
                                      nullptr, nullptr, dp, dd, partial, B, Cin,
                                      Cout, N, group, one_minus_ns);
  launch_pd<kMode>(args, st);
  vnk_reduce_rows(args.partial, static_cast<float*>(sums), nqc, B * args.T, Cout, st);
  if (pbias != nullptr) reduce_bias(args, nqc, 6, static_cast<float*>(dpdb), st);
  products_bwd<true>(args.x, args.w, args.wd, args.dp, args.dd,
                     static_cast<T*>(dx), static_cast<float*>(dw2),
                     static_cast<float*>(dw_part), B, Cin, Cout, N, S, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch the wrapper allocates: partial (floats), the per-channel sums
// (nqc, B, T, Cout) then the bias sums (nqb, B, T * spt, Cout), T =
// ceil(N / 64), spt = 64 / group for 0 < group < 64 and 1 otherwise; dp, dd
// (B, 3, Cout, N) in the activations' type; dw_part (1 or 2, S, Cout, Cin)
// floats.  The bias gradients (nq, B, G, Cout), float32, have G = 1 for
// group 0, N / group for group >= 64 and T * 64 / group otherwise.  `group`
// is 0 or a power of two dividing 512.  x, the biases, g, dx, dp and dd are
// float32 in these entry points and bfloat16 in the _bf16 ones.

// S: s12 (2, Cout) = (s1, s2); partial with nq = 2.
VNK_EXPORT int vn_layer_stats_fwd(const void* x, const void* w,
                                  const void* pbias, void* s12, void* partial,
                                  int B, int Cin, int Cout, int N, int group,
                                  void* stream) {
  return stats_fwd<float>(x, w, pbias, s12, partial, B, Cin, Cout, N, group, stream);
}

VNK_EXPORT int vn_layer_stats_fwd_bf16(const void* x, const void* w,
                                       const void* pbias, void* s12,
                                       void* partial, int B, int Cin, int Cout,
                                       int N, int group, void* stream) {
  return stats_fwd<vnk_bf16>(x, w, pbias, s12, partial, B, Cin, Cout, N, group, stream);
}

// S': dx (B, 3, Cin, N), dw (Cout, Cin), dpb (3, B, G, Cout) or null
// without bias; partial with nqc = 0, nqb = 3.
VNK_EXPORT int vn_layer_stats_bwd(const void* x, const void* w,
                                  const void* pbias, const void* c1,
                                  const void* c2, void* dx, void* dw,
                                  void* dpb, void* dp, void* partial,
                                  void* dw_part, int B, int Cin, int Cout,
                                  int N, int S, int group, void* stream) {
  return stats_bwd<float>(x, w, pbias, c1, c2, dx, dw, dpb, dp, partial, dw_part,
                          B, Cin, Cout, N, S, group, stream);
}

VNK_EXPORT int vn_layer_stats_bwd_bf16(const void* x, const void* w,
                                       const void* pbias, const void* c1,
                                       const void* c2, void* dx, void* dw,
                                       void* dpb, void* dp, void* partial,
                                       void* dw_part, int B, int Cin, int Cout,
                                       int N, int S, int group, void* stream) {
  return stats_bwd<vnk_bf16>(x, w, pbias, c1, c2, dx, dw, dpb, dp, partial,
                             dw_part, B, Cin, Cout, N, S, group, stream);
}

// B': dx, dw2 (2, Cout, Cin) = (dW, dWd), dab (2, Cout) = (dA, dB),
// dpdb (6, B, G, Cout) = (dpbias planes, ddbias planes) or null; partial
// with nqc = 2, nqb = 6.
VNK_EXPORT int vn_layer_fused_bwd(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* g, void* dx,
    void* dw2, void* dab, void* dpdb, void* dp, void* dd, void* partial,
    void* dw_part, int B, int Cin, int Cout, int N, int S, int group,
    float one_minus_ns, void* stream) {
  return layer_bwd<kLayerBwd, float>(x, w, wd, pbias, dbias, a, b, nullptr, g, dx,
                                     dw2, dab, dpdb, dp, dd, partial, dw_part, B,
                                     Cin, Cout, N, S, group, one_minus_ns, stream);
}

VNK_EXPORT int vn_layer_fused_bwd_bf16(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* g, void* dx,
    void* dw2, void* dab, void* dpdb, void* dp, void* dd, void* partial,
    void* dw_part, int B, int Cin, int Cout, int N, int S, int group,
    float one_minus_ns, void* stream) {
  return layer_bwd<kLayerBwd, vnk_bf16>(x, w, wd, pbias, dbias, a, b, nullptr, g,
                                        dx, dw2, dab, dpdb, dp, dd, partial,
                                        dw_part, B, Cin, Cout, N, S, group,
                                        one_minus_ns, stream);
}

// C': as B' with w_out (Cout,) and g (B, 3, 1, N); dabo (3, Cout) =
// (dA, dB, dw_out); partial with nqc = 3, nqb = 6.
VNK_EXPORT int vn_layer_fused_project_bwd(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    const void* g, void* dx, void* dw2, void* dabo, void* dpdb, void* dp,
    void* dd, void* partial, void* dw_part, int B, int Cin, int Cout, int N,
    int S, int group, float one_minus_ns, void* stream) {
  return layer_bwd<kProjBwd, float>(x, w, wd, pbias, dbias, a, b, w_out, g, dx,
                                    dw2, dabo, dpdb, dp, dd, partial, dw_part, B,
                                    Cin, Cout, N, S, group, one_minus_ns, stream);
}

VNK_EXPORT int vn_layer_fused_project_bwd_bf16(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    const void* g, void* dx, void* dw2, void* dabo, void* dpdb, void* dp,
    void* dd, void* partial, void* dw_part, int B, int Cin, int Cout, int N,
    int S, int group, float one_minus_ns, void* stream) {
  return layer_bwd<kProjBwd, vnk_bf16>(x, w, wd, pbias, dbias, a, b, w_out, g,
                                       dx, dw2, dabo, dpdb, dp, dd, partial,
                                       dw_part, B, Cin, Cout, N, S, group,
                                       one_minus_ns, stream);
}
