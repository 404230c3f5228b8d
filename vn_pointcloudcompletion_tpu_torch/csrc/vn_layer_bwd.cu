// Kernels S, S', B' and C': the training half of the whole-layer VN kernels
// (group = 0).  x is (B, 3, Cin, N) planes, W and Wd (Cout, Cin), the
// optional per-sample biases (B, 3, Cout, 1); p = W x (+ pbias), d = Wd x
// (+ dbias) are recomputed from x in every kernel and never saved.
//
// S  replaces vn_pointcloudcompletion_tpu/ops/vn_layer_fused.py
//    ::vn_layer_stats (the pallas_call at :278, body _stats_fwd_kernel :147):
//    s1 = sum (|p| + EPS), s2 = sum (|p| + EPS)^2 per channel.
// S' replaces vn_layer_fused.py::_stats_bwd (pallas_call :325, body :172):
//    dp = (c1 + 2 c2 (|p| + EPS)) p / |p| from the cotangents (c1, c2) of
//    (s1, s2), then dx = W^T dp, dW = sum dp x^T, dpbias = sum_n dp.
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
//      buffer of B*3*Cout*N floats each, and the per-channel and per-sample
//      sums go out as one partial per (sample, 64-point tile), summed over
//      the 16 point groups of a tile with a fixed butterfly.
//   2. dx_gemm: dx = W^T dp (+ Wd^T dd), a 64 x 64 output tile per block,
//      the same 4 x 4 register micro-tile and fmaf loop over Cout.
//   3. dw_gemm: each block owns a 64 x 64 tile of dW (and dWd, which share
//      the x loads) and one of S contiguous chunks of the B*3*N points
//      (split K), writing a partial tile.
// vnk_reduce_rows then sums every partial in a fixed order, so each run of
// a kernel gives the same bits.  S is pass 1 alone, with the norm sums.
//
// Bound on the H100 at the main path's shapes (batch 8, N = 16384):
//   S at 256 -> 256: operations, the 2*Cin*Cout*3*B*N FLOP of p = W x.
//   S' at 256 -> 256: operations, three such products (p, dx, dW).
//   B' at 2 -> 256: bytes, reading g (B*3*Cout*N floats).
//   C' at 256 -> 256: operations, six products (p, d, dx from dp and dd,
//      dW, dWd).
// All products run as FP32 FMAs on the CUDA cores (the float32 policy keeps
// them off the tensor cores).  Passes 2 and 3 read the dp/dd scratch back
// once each; the scratch round trip is what a fused later version removes.
#include "vn_tile.cuh"

namespace {

enum Mode { kStatsFwd = 0, kStatsBwd = 1, kLayerBwd = 2, kProjBwd = 3 };

constexpr int kP = 16;  // points per shared-memory stage of dw_gemm

struct PdArgs {
  const float* x;
  const float* w;
  const float* wd;
  const float* pbias;
  const float* dbias;
  const float* a;
  const float* b;
  const float* w_out;
  const float* g;
  const float* c1;
  const float* c2;
  float* dp;
  float* dd;
  float* partial;  // (nq, B, T, Cout): per-channel sums, then per-sample ones
  int B, Cin, Cout, N, T;
  float one_minus_ns;
};

// Per-channel sums written by each mode: S (s1, s2), B' (dA, dB),
// C' (dA, dB, dw_out); the per-sample bias sums (dpbias[3], ddbias[3]) follow.
template <int kMode>
__host__ __device__ constexpr int channel_sums() {
  return kMode == kStatsFwd ? 2 : kMode == kStatsBwd ? 0 : kMode == kLayerBwd ? 2 : 3;
}

// Four consecutive points n .. n+3 of one row, 16 bytes at once where they
// are aligned and all inside the row.
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

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1) pd_pass(PdArgs args) {
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
  const float* xb = args.x + static_cast<size_t>(bi) * 3 * args.Cin * N;
  const bool has_bias = args.pbias != nullptr;
  const bool vec_store = (N % 4 == 0) && (n0 + tx * 4 + 3 < N);

  float accp[3][4][4], accd[3][4][4];
  vnk_tile_products<kWithD>(xb, args.w, args.wd, args.Cin, Cout, N, c0, n0,
                            sm, accp, accd);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    const bool cok = c < Cout;
    float pb[3] = {0.f, 0.f, 0.f}, db[3] = {0.f, 0.f, 0.f};
    if (has_bias && cok) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        pb[j] = args.pbias[(static_cast<size_t>(bi) * 3 + j) * Cout + c];
        if (kWithD) db[j] = args.dbias[(static_cast<size_t>(bi) * 3 + j) * Cout + c];
      }
    }
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
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      const bool ok = cok && n < N;
      const float p[3] = {accp[0][i][q] + pb[0], accp[1][i][q] + pb[1],
                          accp[2][i][q] + pb[2]};
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
        const float d[3] = {accd[0][i][q] + db[0], accd[1][i][q] + db[1],
                            accd[2][i][q] + db[2]};
        float gp[3] = {0.f, 0.f, 0.f}, gv[3] = {0.f, 0.f, 0.f};
        if (ok) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            if (kMode == kProjBwd) {
              gp[j] = args.g[(static_cast<size_t>(bi) * 3 + j) * N + n];
              gv[j] = wo * gp[j];
            } else {
              gv[j] = args.g[((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N + n];
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
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            sp[j] += dpv[j];
            sd[j] += ddv[j];
          }
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          outp[j][q] = ok ? dpv[j] : 0.f;
          outd[j][q] = ok ? ddv[j] : 0.f;
        }
      }
    }

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
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float v = vnk_sum16(sp[j]);
        if (tx == 0 && cok) args.partial[(kNqc + j) * stride + at] = v;
        if (kWithD) {
          const float u = vnk_sum16(sd[j]);
          if (tx == 0 && cok) args.partial[(kNqc + 3 + j) * stride + at] = u;
        }
      }
    }
  }
}

// dx[bj, k, n] = sum_c W[c, k] g1[bj, c, n] (+ Wd[c, k] g2[bj, c, n]) for
// every (sample, plane) bj: a 64-row x 64-point tile per block.
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
dx_gemm(const float* __restrict__ w, const float* __restrict__ wd,
        const float* __restrict__ g1, const float* __restrict__ g2,
        float* __restrict__ dx, int Cin, int Cout, int N) {
  __shared__ __align__(16) float ws[kK][kCh];
  __shared__ __align__(16) float wds[kK][kCh];
  __shared__ __align__(16) float gs[kK][kPts];
  __shared__ __align__(16) float g2s[kK][kPts];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kPts;
  const int k0 = blockIdx.y * kCh;
  const size_t bj = blockIdx.z;
  const float* g1b = g1 + bj * Cout * N;
  const float* g2b = kTwo ? g2 + bj * Cout * N : nullptr;

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
      ws[cc][r] = ok ? w[static_cast<size_t>(gc) * Cin + gk] : 0.f;
      if (kTwo) wds[cc][r] = ok ? wd[static_cast<size_t>(gc) * Cin + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < kK * kPts; e += kThreads) {
      const int cc = e / kPts, nn = e % kPts;
      const int gc = c0 + cc, gn = n0 + nn;
      const bool ok = gc < Cout && gn < N;
      gs[cc][nn] = ok ? g1b[static_cast<size_t>(gc) * N + gn] : 0.f;
      if (kTwo) g2s[cc][nn] = ok ? g2b[static_cast<size_t>(gc) * N + gn] : 0.f;
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
    if (k >= Cin) continue;
    float* row = dx + (bj * Cin + k) * N;
    if (vec_store) {
      *reinterpret_cast<float4*>(row + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n + q < N) row[n + q] = acc[i][q];
    }
  }
}

// Split-K weight gradient: part[s, c, k] = sum over points p in chunk s of
// g1[p, c] x[p, k] (and part2 with g2), where p runs over (sample, plane,
// point) of the (B*3, C, N) tensors.  One 64 x 64 (c, k) tile per block.
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
dw_gemm(const float* __restrict__ g1, const float* __restrict__ g2,
        const float* __restrict__ x, float* __restrict__ part,
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
          gv = g1[at];
          if (kTwo) hv = g2[at];
        }
        if (k0 + r < Cin) xv = x[(static_cast<size_t>(bj) * Cin + k0 + r) * N + n];
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

template <int kMode>
void launch_pd(const PdArgs& args, cudaStream_t st) {
  const dim3 grid(args.T, (args.Cout + kCh - 1) / kCh, args.B);
  pd_pass<kMode><<<grid, kThreads, 0, st>>>(args);
}

// Passes 2 and 3 and the reductions shared by S', B' and C'.  dw2 receives
// (kTwo ? 2 : 1) gradients of (Cout, Cin); dw_part holds as many split-K
// partials of (S, Cout, Cin).
template <bool kTwo>
void products_bwd(const float* x, const float* w, const float* wd,
                  const float* dp, const float* dd, float* dx, float* dw2,
                  float* dw_part, int B, int Cin, int Cout, int N, int S,
                  cudaStream_t st) {
  dx_gemm<kTwo><<<dim3(tiles(N), (Cin + kCh - 1) / kCh, B * 3), kThreads, 0,
                  st>>>(w, wd, dp, dd, dx, Cin, Cout, N);
  const int P = B * 3 * N;
  const int chunk = ((P + S - 1) / S + kP - 1) / kP * kP;
  const size_t part_size = static_cast<size_t>(S) * Cout * Cin;
  dw_gemm<kTwo><<<dim3((Cin + kCh - 1) / kCh, (Cout + kCh - 1) / kCh, S),
                  kThreads, 0, st>>>(dp, dd, x, dw_part,
                                     kTwo ? dw_part + part_size : nullptr, Cin,
                                     Cout, N, P, chunk);
  vnk_reduce_rows(dw_part, dw2, kTwo ? 2 : 1, S,
                  static_cast<int64_t>(Cout) * Cin, st);
}

PdArgs make_args(const void* x, const void* w, const void* wd,
                 const void* pbias, const void* dbias, const void* a,
                 const void* b, const void* w_out, const void* g,
                 const void* c1, const void* c2, void* dp, void* dd,
                 void* partial, int B, int Cin, int Cout, int N,
                 float one_minus_ns) {
  PdArgs r;
  r.x = static_cast<const float*>(x);
  r.w = static_cast<const float*>(w);
  r.wd = static_cast<const float*>(wd);
  r.pbias = static_cast<const float*>(pbias);
  r.dbias = static_cast<const float*>(dbias);
  r.a = static_cast<const float*>(a);
  r.b = static_cast<const float*>(b);
  r.w_out = static_cast<const float*>(w_out);
  r.g = static_cast<const float*>(g);
  r.c1 = static_cast<const float*>(c1);
  r.c2 = static_cast<const float*>(c2);
  r.dp = static_cast<float*>(dp);
  r.dd = static_cast<float*>(dd);
  r.partial = static_cast<float*>(partial);
  r.B = B;
  r.Cin = Cin;
  r.Cout = Cout;
  r.N = N;
  r.T = tiles(N);
  r.one_minus_ns = one_minus_ns;
  return r;
}

// The per-sample bias sums (3 or 6 quantities of (B, T, Cout)) after nqc
// per-channel ones -> dbias_out (nq, B, Cout).
void reduce_bias(const PdArgs& args, int nqc, int nq, float* dbias_out,
                 cudaStream_t st) {
  const size_t stride = static_cast<size_t>(args.B) * args.T * args.Cout;
  vnk_reduce_rows(args.partial + nqc * stride, dbias_out, nq * args.B, args.T,
                  args.Cout, st);
}

}  // namespace

// Scratch the wrapper allocates (floats): partial (nq, B, ceil(N/64), Cout);
// dp, dd (B, 3, Cout, N); dw_part (1 or 2, S, Cout, Cin).

// S: s12 (2, Cout) = (s1, s2); partial with nq = 2.
VNK_EXPORT int vn_layer_stats_fwd(const void* x, const void* w,
                                  const void* pbias, void* s12, void* partial,
                                  int B, int Cin, int Cout, int N,
                                  void* stream) {
  if (B == 0 || N == 0 || Cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PdArgs args = make_args(x, w, nullptr, pbias, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, partial, B, Cin, Cout, N, 0.f);
  launch_pd<kStatsFwd>(args, st);
  vnk_reduce_rows(args.partial, static_cast<float*>(s12), 2, B * args.T, Cout, st);
  return static_cast<int>(cudaGetLastError());
}

// S': dx (B, 3, Cin, N), dw (Cout, Cin), dpb (3, B, Cout) or null without
// bias; partial with nq = 3 (bias only).
VNK_EXPORT int vn_layer_stats_bwd(const void* x, const void* w,
                                  const void* pbias, const void* c1,
                                  const void* c2, void* dx, void* dw,
                                  void* dpb, void* dp, void* partial,
                                  void* dw_part, int B, int Cin, int Cout,
                                  int N, int S, void* stream) {
  if (B == 0 || N == 0 || Cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PdArgs args = make_args(x, w, nullptr, pbias, nullptr, nullptr, nullptr,
                                nullptr, nullptr, c1, c2, dp, nullptr, partial,
                                B, Cin, Cout, N, 0.f);
  launch_pd<kStatsBwd>(args, st);
  if (pbias != nullptr) reduce_bias(args, 0, 3, static_cast<float*>(dpb), st);
  products_bwd<false>(args.x, args.w, nullptr, args.dp, nullptr,
                      static_cast<float*>(dx), static_cast<float*>(dw),
                      static_cast<float*>(dw_part), B, Cin, Cout, N, S, st);
  return static_cast<int>(cudaGetLastError());
}

// B': dx, dw2 (2, Cout, Cin) = (dW, dWd), dab (2, Cout) = (dA, dB),
// dpdb (6, B, Cout) = (dpbias planes, ddbias planes) or null; partial with
// nq = 2 + 6.
VNK_EXPORT int vn_layer_fused_bwd(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* g, void* dx,
    void* dw2, void* dab, void* dpdb, void* dp, void* dd, void* partial,
    void* dw_part, int B, int Cin, int Cout, int N, int S, float one_minus_ns,
    void* stream) {
  if (B == 0 || N == 0 || Cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PdArgs args = make_args(x, w, wd, pbias, dbias, a, b, nullptr, g,
                                nullptr, nullptr, dp, dd, partial, B, Cin,
                                Cout, N, one_minus_ns);
  launch_pd<kLayerBwd>(args, st);
  vnk_reduce_rows(args.partial, static_cast<float*>(dab), 2, B * args.T, Cout, st);
  if (pbias != nullptr) reduce_bias(args, 2, 6, static_cast<float*>(dpdb), st);
  products_bwd<true>(args.x, args.w, args.wd, args.dp, args.dd,
                     static_cast<float*>(dx), static_cast<float*>(dw2),
                     static_cast<float*>(dw_part), B, Cin, Cout, N, S, st);
  return static_cast<int>(cudaGetLastError());
}

// C': as B' with w_out (Cout,) and g (B, 3, 1, N); dabo (3, Cout) =
// (dA, dB, dw_out); partial with nq = 3 + 6.
VNK_EXPORT int vn_layer_fused_project_bwd(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    const void* g, void* dx, void* dw2, void* dabo, void* dpdb, void* dp,
    void* dd, void* partial, void* dw_part, int B, int Cin, int Cout, int N,
    int S, float one_minus_ns, void* stream) {
  if (B == 0 || N == 0 || Cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PdArgs args = make_args(x, w, wd, pbias, dbias, a, b, w_out, g,
                                nullptr, nullptr, dp, dd, partial, B, Cin,
                                Cout, N, one_minus_ns);
  launch_pd<kProjBwd>(args, st);
  vnk_reduce_rows(args.partial, static_cast<float*>(dabo), 3, B * args.T, Cout, st);
  if (pbias != nullptr) reduce_bias(args, 3, 6, static_cast<float*>(dpdb), st);
  products_bwd<true>(args.x, args.w, args.wd, args.dp, args.dd,
                     static_cast<float*>(dx), static_cast<float*>(dw2),
                     static_cast<float*>(dw_part), B, Cin, Cout, N, S, st);
  return static_cast<int>(cudaGetLastError());
}
