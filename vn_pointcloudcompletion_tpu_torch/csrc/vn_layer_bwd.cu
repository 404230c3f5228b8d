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
// tile that holds dx for all input channels does not fit.  So S', C' and
// B' above Cin = 2 are three passes, all hand-written here, with no float
// atomics (S, S' and B' at Cin <= 2 walk the channels in one pass, below):
//   1. pass 1 recomputes p (and d) for all three planes of a (channel x
//      64-point) tile, runs the epilogue backward in registers, writes dp
//      (and dd) to a scratch of B*3*Cout*N elements each, and the
//      per-channel sums as one partial per (sample, 64-point tile), summed
//      in a fixed order.  The bias sums go out as one partial per (sample,
//      tile) too where a bias column covers whole tiles (group 0 or >= 64),
//      else (kSplit) as 64 / group sub-partials per tile, each the sum over
//      one group's points;
//   2. dx = W^T dp (+ Wd^T dd);
//   3. dW = sum dp x^T (dWd = sum dd x^T, sharing the x loads), each block
//      one output tile and one of S contiguous chunks of the B*3*N points
//      (split K), writing a partial tile.
// vnk_reduce_rows then sums every partial in a fixed order (the bias
// partials over the tiles of each column), so each run of a kernel gives the
// same bits.  S is pass 1 alone, with the norm sums and no dp store.
//
// Five designs; the wrapper picks one from (Cin, Cout) (ops/
// vn_layer_fused.py::stats_design for S, ::stats_bwd_design for S',
// ::backward_design and, for bf16, ::wide_bf16_design for C',
// ::layer_bwd_design for B') and none stands in for another:
//   stream (S) and fused (S', B'), at Cin <= 2 only (final_conv.0's 2 ->
//      256, conv1's 2 -> 32, the pair folds' 1 -> 256 at group 64):
//      channel_walk, one pass.  A block owns a 64-point tile of one sample
//      and walks all Cout channels: it recomputes p (B': and d; Cin FMAs a
//      plane) at its points and sums what the mode needs over them, one
//      partial per sample, tile and channel (or the kSplit sub-partials), as
//      pass 1 writes them.  S: |p| + EPS and its square, in pd_pass's order,
//      so the narrow S's bits, with no product tile, no shared memory and
//      no barrier.  S': dp from (c1, c2) in registers (no g, no d), the bias
//      gradients and dW.  B': reads g once, runs the epilogue backward in
//      registers, sums dA, dB, the bias gradients, dW and dWd.  S' and B'
//      keep dx of their points in registers across the channels, adding the
//      16 channel groups in order at the end: no dp/dd scratch (403 / 805
//      MB in float32 at batch 8, N 16384, 2 -> 256), no dx_gemm or dw_gemm.
//   narrow (C' at Cin or Cout < 16; S and S' there above Cin 2; B' at
//      Cin > 2): pd_pass with the 4 x 4 FMA micro-tile of
//      vn_tile.cuh (for S alone: no scratch, one block an SM), dx_gemm and
//      dw_gemm below.  At Cin <= 2 these shapes are bound by bytes, not
//      operations, and the 64 x 64 tiles of dx_gemm and dw_gemm are 1/32-1/64
//      used: the parent design of the walk, kept as its yardstick.
//   wide (Cin >= 16 and Cout >= 16, S, S' and C': final_conv.1's 256 ->
//      256, vn_folding{1,2}.1's 256 -> 128): W (and Wd) first transposed
//      into a (Cin, Cout) scratch in the activations' type (bf16-rounded in
//      the bf16 mode, the rounding the products' operands get); then in
//      every pass a ring of shared-memory stages filled by cp.async
//      (vn_mma.cuh), loading the next reduction slice while the current one
//      multiplies, one barrier a slice.
//      Pass 1 in float32 (pd_wide_fma): FP32 FMAs on the CUDA cores,
//      pd_pass's layout and epilogue at 2 (C') or 4 (S, S') channels x 4
//      points x 3 planes a thread, 256 threads, two blocks an SM, over a
//      ring of 16-channel stages; p, d summed in input-channel order with
//      fmaf, so they have pd_pass's bits and the plain version's.  float32
//      S takes the same products in the same order as pd_pass and sums its
//      partials in pd_pass's order, so its bits are the narrow S's.
//      Pass 1 in bf16 (pd_wide_mma): the tensor cores, warp-level
//      mma.sync.m16n8k16 bf16 -> float32 (exact products, float32 sums:
//      JAX's preferred_element_type=float32), W^T (and Wd^T) and x read by
//      ldmatrix.trans, a 128-channel (C': 64-channel, p and d) x 64-point
//      tile in 16 warps, three 32-channel stages, the k16 steps in
//      ascending order from 0 as kernel C's forward takes them, so that
//      C''s p, d are the forward's and S's p is S''s, bit for bit (the
//      card rounds a step by its operands alone: ops/vn_layer_fused.py
//      ::k16_step).  S and S' run their epilogue on the accumulators in
//      their fragment layout and sum the bias columns (S': dp; S: |p| + EPS
//      and its square, p rounded through bf16 once as pd_pass rounds it)
//      over a thread's points, its quad by shuffles, then across the point
//      warps in warp order through shared memory; C' stages p and d in
//      bf16 and runs pd_wide_fma's epilogue on them (staged_pd_epilogue).
//      Passes 2 and 3 in float32 (dx_wide_f32, dw_wide_f32): FP32 FMAs (the
//      float32 policy keeps products in full float32; 3xTF32 would round
//      each product), 128 x 128 tiles (pass 3: 64 x 128 for C'), 8 x 8 a
//      thread, three stages 32 (pass 2) or 16 (pass 3) deep.  In bf16
//      (dx_wide_bf16, dw_wide_bf16): mma.sync as pass 1, dp/dd read by
//      ldmatrix.trans in pass 2, dp/dd and x plain in pass 3 (both lie with
//      the points contiguous), three 32-deep stages.  The grids run the row blocks of one point tile
//      together, so x (pass 1) and dp, dd (pass 2) come from DRAM once.
//   Pass 3's chunks are whole stages of one plane (the wrapper's
//   wide_split), so a stage never straddles two planes.
//   wgmma (bf16 S' and C' where Cin and Cout are multiples of 64 and the
//      point rows 16-byte aligned: final_conv.1's 256 -> 256,
//      vn_folding{1,2}.1's 256 -> 128): the wide design's W^T and pass 1,
//      then passes 2 and 3 on Hopper's warpgroup products (vn_wgmma.cuh):
//      TMA loads of 128-byte swizzled tiles into a ring of shared-memory
//      stages, one producer warp and two consumer warpgroups of
//      wgmma.m64n128k16 (bf16 operands, float32 accumulators), 128 x 128
//      output tiles, 64-deep stages.  Pass 2 reads W^T K-major and dp, dd
//      MN-major (points contiguous); pass 3 reads dp, dd and x K-major over
//      the points, split K over whole 64-point stages of one plane, and
//      vnk_reduce_rows sums the splits in order.  Pass 1 stays the wide
//      one (pd_wide_mma): the parent design of the one below.
//   wgmma_p (bf16 S, S' and C' where wgmma fits, bias columns of whole
//      tiles; C' where kernel C takes proj_wgmma): pass 1 on wgmma fed by
//      TMA too (pd_wgmma); S' and C' then the wgmma passes 2 and 3.  Its
//      k16 steps run in pd_wide_mma's order and S's and S''s sums too, so
//      S and S' give the bits of the designs above, S's p stays S''s and
//      C''s p, d stay the forward C's.
//
// Bound on the H100 at the main path's shapes (batch 8, N = 16384):
//   S at 256 -> 256: operations, the 2*Cin*Cout*3*B*N FLOP of p = W x.
//   S' at 256 -> 256: operations, three such products (p, dx, dW).
//   B' at 2 -> 256: bytes, reading g (B*3*Cout*N floats: 403 MB, 0.12 ms);
//      the fused pass issues ~130 instructions a (channel, point) vector
//      (p, d, the epilogue backward, the dx and dW products, the sums).
//   S and S' at 2 -> 256: operations (x and dx are 3 MB; the partials ~10
//      MB): ~24 (S) and ~54 (S') FP32 operations a vector, an FMA counted
//      as two (p, the norm, the sums; S' also dp, dx and dW), besides the
//      square root's and the division's sequences and the lane
//      butterflies, which that count leaves out.
//   C' at 256 -> 256: operations, six products (p, d, dx from dp and dd,
//      dW, dWd).  C''s pass 1 hands out the p, d it formed (pd_out, tests).
// The attention decoder's pair fold (1 -> 256, N = 14336, group 64) is
// bound like final_conv.0: B' by the g read, S and S' by their operations;
// the bias columns are 1/64 of a plane.  Passes 2 and 3 read the dp/dd
// scratch back once each: that round trip (403 / 805 MB for S' / C' in
// float32 at 256 -> 256, half in bf16) remains in the wide S' and C'.
//
// The bf16 mode (entry points <name>_bf16; T = vnk_bf16: x, the biases, g,
// dx and the dp/dd scratch bfloat16; W, Wd, A, B, w_out, c1, c2, dW, the
// per-channel and the bias sums float32) is the TPU kernels' bf16=True
// (vn_layer_fused.py:61-65, :86-123, :204-209, :440-457, :733-750):
//   pass 1 recomputes p and d as the forward's bf16 mode does: products of
//      bf16-rounded W and x summed in float32, the bias added, one rounding
//      through bf16; runs the float32 epilogue backward on them and on the
//      bf16 cotangent (C': w_out * g formed in float32), writes the
//      per-channel and the bias partials from the float32 dp and dd, and
//      only then rounds dp and dd to bf16 as it stores them: the scratch
//      holds JAX's dp16 and dd16;
//   pass 2 takes dx = W16^T dp16 (+ Wd16^T dd16), exact products summed in
//      float32, stored bf16;
//   pass 3 takes dW = dp16 x16^T (dWd = dd16 x16^T) in float32.
// The narrow passes run the float32 mode's loops over bf16 loads.  The
// fused S' and B' form dp (dd) in float32 as pass 1 does, sum dA, dB and
// the bias gradients from them, and round dp, dd (and W, Wd) to bf16 only
// as operands of their dx and dW products; dx is stored bf16.
#include "vn_mma.cuh"
#include "vn_tile.cuh"
#include "vn_wgmma.cuh"

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
  E* pd_out;       // C': null, or (2, B, 3, Cout, N) that pass 1 fills with the
                   // p and d its epilogue backward reads (tests)
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

// The epilogue of the wide FMA pass 1 (pd_wide_fma): pd_pass's below for
// kMC channels a thread (thread (ty, tx) holds channels c0 + ty * kMC + i,
// points n0 + tx * 4 + q).  The sums over a channel's 64 points run over a
// thread's 4, then a fixed butterfly over its 16 lanes.  (pd_pass keeps its
// own copy: moved into a function, it compiled to other code, and kernel S
// ran slower.)  kBiasIn: accp, accd already hold p and d with their biases
// added (bf16 C''s staged p, d), so only the bias gradients read the bias.
template <int kMode, bool kSplit, int kMC, typename T, bool kBiasIn = false>
__device__ __forceinline__ void pd_epilogue(const PdArgs<T>& args,
                                            const float (&accp)[3][kMC][4],
                                            const float (&accd)[3][kMC][4], int t, int bi,
                                            int c0, int n0) {
  constexpr bool kWithD = kMode == kLayerBwd || kMode == kProjBwd;
  constexpr int kNqc = channel_sums<kMode>();
  constexpr bool kWrites = kMode != kStatsFwd;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int Cout = args.Cout, N = args.N;
  const bool has_bias = args.pbias != nullptr;
  const bool vec_store = (N % 4 == 0) && (n0 + tx * 4 + 3 < N);

#pragma unroll
  for (int i = 0; i < kMC; ++i) {
    const int c = c0 + ty * kMC + i;
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
      if (!kBiasIn && has_bias && cok && (q == 0 || (kSplit && args.group < 4))) {
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
        if (kMode == kProjBwd && args.pd_out != nullptr && ok)
          vnk_put_pd(args.pd_out, args.B, bi, c, Cout, n, N, p, d);
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
        if (kMode == kProjBwd && args.pd_out != nullptr && ok)
          vnk_put_pd(args.pd_out, args.B, bi, c, Cout, n, N, p, d);
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

// ------------------------------------------------------------ wide passes

// Wide pass 1 on the CUDA cores (float32 S, S' and C'): pd_pass's layout,
// order and epilogue (thread (ty, tx) of the 16 x 16 grid: kMC channels x
// 4 points x 3 planes, of p and d for C'; two blocks an SM, so one's
// epilogue overlaps the other's products) over a ring of 16 input channels
// a stage: W^T rows and the three x planes by cp.async.  p and d are summed
// with fmaf in input-channel order, so they have pd_pass's bits and the
// plain version's.
template <int kMode>
struct PdFma {
  static constexpr bool kWithD = kMode == kProjBwd;
  static constexpr int kMC = kWithD ? 2 : 4;  // channels a thread
  static constexpr int kBC = 16 * kMC;        // channels a block
  static constexpr int kKs = 16, kStages = 3;  // input channels a stage, stages
  static constexpr int kW = kKs * kBC;        // floats of one W stage
  static constexpr int kX = kKs * kPts;       // floats of one x plane stage
  static constexpr int kStage = (kWithD ? 2 : 1) * kW + 3 * kX;  // floats
  static constexpr int kBytes = kStages * kStage * 4;
};

// kN (2 or 4) consecutive elements of shared memory, widened to float.
template <int kN>
__device__ __forceinline__ void load_n(const float* p, float (&v)[kN]) {
  static_assert(kN == 2 || kN == 4, "two or four elements");
  if constexpr (kN == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  }
}

template <int kN>
__device__ __forceinline__ void load_n(const vnk_bf16* p, float (&v)[kN]) {
#pragma unroll
  for (int h = 0; h < kN / 2; ++h) {
    const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(p)[h];
    v[2 * h] = __low2float(a);
    v[2 * h + 1] = __high2float(a);
  }
}

template <int kMode, bool kSplit>
__global__ void __launch_bounds__(kWideThreads, 2)
pd_wide_fma(PdArgs<float> args, const float* __restrict__ wt, bool aw, bool ax) {
  using P = PdFma<kMode>;
  constexpr int kMC = P::kMC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t = blockIdx.y, bi = blockIdx.z;  // channel blocks of a tile run together
  const int n0 = t * kPts, c0 = blockIdx.x * P::kBC;
  const int Cin = args.Cin, Cout = args.Cout, N = args.N;
  const float* xb = args.x + static_cast<size_t>(bi) * 3 * Cin * N;
  const float* wdt = wt + static_cast<size_t>(Cin) * Cout;

  float accp[3][kMC][4], accd[3][kMC][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < kMC; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) accp[j][i][q] = accd[j][i][q] = 0.f;

  auto load = [&](int s, int kt) {
    float* ws = sm + s * P::kStage;
    const int k0 = kt * P::kKs;
    const size_t wrow = static_cast<size_t>(k0) * Cout + c0;
    stage_tile<float, P::kKs, P::kBC>(ws, P::kBC, wt + wrow, Cout, Cin - k0, Cout - c0, aw);
    if (P::kWithD)
      stage_tile<float, P::kKs, P::kBC>(ws + P::kW, P::kBC, wdt + wrow, Cout, Cin - k0,
                                        Cout - c0, aw);
    float* xs = ws + (P::kWithD ? 2 : 1) * P::kW;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      stage_tile<float, P::kKs, kPts>(xs + j * P::kX, kPts,
                                      xb + (static_cast<size_t>(j) * Cin + k0) * N + n0, N,
                                      Cin - k0, N - n0, ax);
  };
  auto compute = [&](int s) {
    const float* ws = sm + s * P::kStage;
    const float* wds = ws + P::kW;
    const float* xs = ws + (P::kWithD ? 2 : 1) * P::kW;
#pragma unroll
    for (int k = 0; k < P::kKs; ++k) {
      float wr[kMC], dr[kMC];
      load_n<kMC>(ws + k * P::kBC + ty * kMC, wr);
      if (P::kWithD) load_n<kMC>(wds + k * P::kBC + ty * kMC, dr);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float xr[4];
        load_n<4>(xs + (j * P::kKs + k) * kPts + tx * 4, xr);
#pragma unroll
        for (int i = 0; i < kMC; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            accp[j][i][q] = fmaf(wr[i], xr[q], accp[j][i][q]);
            if (P::kWithD) accd[j][i][q] = fmaf(dr[i], xr[q], accd[j][i][q]);
          }
      }
    }
  };
  pipeline<P::kStages>((Cin + P::kKs - 1) / P::kKs, load, compute);
  pd_epilogue<kMode, kSplit, kMC>(args, accp, accd, t, bi, c0, n0);
}

// ----------------------------------------- pass 1 of bf16 C' from staged p, d
//
// Both tensor-core designs of C''s pass 1 (pd_wide_mma and pd_wgmma in
// kProjBwd mode) round p and d through bf16 after the bias, as kernel C's
// forward does (proj_wide_mma, proj_wgmma), stage them in shared memory as
// bf16 (2, 3 planes, 64 channels, kPdLd: p then d) and run pd_epilogue on
// them with pd_wide_fma's thread layout at 512 threads: thread (ty, tx)
// holds channels ty 2 + i (i < 2), points tx 4 + q.
constexpr int kPdLd = kPts + 8;                  // bf16 a row of the staged p, d
constexpr int kPdStaged = 2 * 3 * 64 * kPdLd;    // bf16 elements of the staged p, d

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// p or d (h 0 or 1) of plane j, channel cl of the block (c0 + cl), point nl
// of the tile: the accumulator plus the bias, rounded through bf16, staged.
__device__ __forceinline__ void stage_pd(const PdArgs<vnk_bf16>& args, unsigned short* pd, int h,
                                         int j, int cl, int nl, float acc, int bi, int c0,
                                         int n0) {
  const int c = c0 + cl;
  const float bias = args.pbias != nullptr && c < args.Cout
                         ? vnk_bias(h ? args.dbias : args.pbias, bi, j, c, args.Cout, n0 + nl,
                                    args.N, args.group)
                         : 0.f;
  pd[((h * 3 + j) * 64 + cl) * kPdLd + nl] = bf16_bits(acc + bias);
}

template <bool kSplit>
__device__ __forceinline__ void staged_pd_epilogue(const PdArgs<vnk_bf16>& args,
                                                   const unsigned short* pd, int t, int bi,
                                                   int c0, int n0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float accp[3][2][4], accd[3][2][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cl = ty * 2 + i;
      const uint2 vp = *reinterpret_cast<const uint2*>(pd + (j * 64 + cl) * kPdLd + tx * 4);
      const uint2 vd = *reinterpret_cast<const uint2*>(pd + ((3 + j) * 64 + cl) * kPdLd + tx * 4);
      accp[j][i][0] = __uint_as_float(vp.x << 16);
      accp[j][i][1] = __uint_as_float(vp.x & 0xffff0000u);
      accp[j][i][2] = __uint_as_float(vp.y << 16);
      accp[j][i][3] = __uint_as_float(vp.y & 0xffff0000u);
      accd[j][i][0] = __uint_as_float(vd.x << 16);
      accd[j][i][1] = __uint_as_float(vd.x & 0xffff0000u);
      accd[j][i][2] = __uint_as_float(vd.y << 16);
      accd[j][i][3] = __uint_as_float(vd.y & 0xffff0000u);
    }
  pd_epilogue<kProjBwd, kSplit, 2, vnk_bf16, true>(args, accp, accd, t, bi, c0, n0);
}

// Wide pass 1 in bf16 (S, S' and C') on the tensor cores: warp-level
// mma.sync.m16n8k16 bf16 -> float32 (exact products, float32 sums: JAX's
// preferred_element_type=float32), W^T (and Wd^T) and x read by
// ldmatrix.trans from a ring of three 32-channel stages, 16 warps; warp
// (wm, wn) of the 4 x 4 grid owns channels wm 16 kMT .. + 16 kMT of the
// block's 64 kMT and points wn 16 .. + 16 of its 64: kMT m16 tiles x two n8
// tiles a plane.  S and S' (kMT 2, 128 channels a block) run their
// epilogue on the accumulators in their fragment layout; C' (kMT 1, 64
// channels, p and d) stages p and d (staged_pd_epilogue).  The k16 steps
// run in ascending order from a zero accumulator, as in kernel C's
// proj_wide_mma, so C''s p, d are the forward's.
template <int kMode>
struct PdBf16 {
  static constexpr bool kTwo = kMode == kProjBwd;  // p and d
  static constexpr int kThreads = 512;             // 16 warps
  static constexpr int kMT = kTwo ? 1 : 2, kBC = 64 * kMT;
  static constexpr int kKs = 32, kStages = 3;
  static constexpr int kWld = kBC + 8, kXld = kPts + 8;  // padded rows: no bank conflicts
  static constexpr int kW = kKs * kWld, kX = kKs * kXld;
  static constexpr int kStage = (kTwo ? 2 : 1) * kW + 3 * kX;  // bf16 elements
  static constexpr int kRing = kStages * kStage * 2;             // bytes
  // + the bias sums of S' (4 point warps x kBC channels x 3 planes), or C''s
  // staged p, d in the freed ring
  static constexpr int kBytes = kTwo ? (kRing > kPdStaged * 2 ? kRing : kPdStaged * 2)
                                     : kRing + 4 * kBC * 3 * 4;
};

// dp at points n, n + 1 of a row, rounded to bf16.
__device__ __forceinline__ void store2(vnk_bf16* row, int n, int N, float v0, float v1) {
  if (n + 1 < N && N % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (n < N) row[n] = __float2bfloat16_rn(v0);
    if (n + 1 < N) row[n + 1] = __float2bfloat16_rn(v1);
  }
}

template <int kMode, bool kSplit>
__global__ void __launch_bounds__(512, 1)
pd_wide_mma(PdArgs<vnk_bf16> args, const vnk_bf16* __restrict__ wt, bool aw, bool ax) {
  using T = vnk_bf16;
  using P = PdBf16<kMode>;
  constexpr int kMT = P::kMT, kBC = P::kBC, kNh = P::kTwo ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  float* const red = reinterpret_cast<float*>(smem_raw + P::kRing);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4, grp = lane / 4, tig = lane % 4;
  const int t = blockIdx.y, bi = blockIdx.z;  // channel blocks of a tile run together
  const int n0 = t * kPts, c0 = blockIdx.x * kBC;
  const int Cin = args.Cin, Cout = args.Cout, N = args.N;
  const T* xb = args.x + static_cast<size_t>(bi) * 3 * Cin * N;

  float acc[kNh][3][kMT][2][4];  // [p or d][plane][m16 tile][n8 tile][fragment]
#pragma unroll
  for (int h = 0; h < kNh; ++h)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][j][mt][nt][e] = 0.f;

  auto load = [&](int s, int kt) {
    T* st = sm + s * P::kStage;
    const int k0 = kt * P::kKs;
#pragma unroll
    for (int h = 0; h < kNh; ++h)  // W^T, then Wd^T (wt's second matrix)
      stage_tile<T, P::kKs, kBC, P::kThreads>(
          st + h * P::kW, P::kWld,
          wt + (static_cast<size_t>(h) * Cin + k0) * Cout + c0, Cout, Cin - k0, Cout - c0, aw);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      stage_tile<T, P::kKs, kPts, P::kThreads>(
          st + kNh * P::kW + j * P::kX, P::kXld,
          xb + (static_cast<size_t>(j) * Cin + k0) * N + n0, N, Cin - k0, N - n0, ax);
  };
  auto compute = [&](int s) {
    const T* ws = sm + s * P::kStage;
    const T* xs = ws + kNh * P::kW;
#pragma unroll
    for (int ks = 0; ks < P::kKs; ks += 16) {
      unsigned a[kNh][kMT][4];
#pragma unroll
      for (int h = 0; h < kNh; ++h)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          frag_a_t(a[h][mt], ws + h * P::kW, P::kWld, wm * 16 * kMT + mt * 16, ks);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        unsigned b[4];
        frag_b2_t(b, xs + j * P::kX, P::kXld, wn * 16, ks);
#pragma unroll
        for (int h = 0; h < kNh; ++h)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[h][j][mt][0], a[h][mt], b[0], b[1]);
            mma_bf16(acc[h][j][mt][1], a[h][mt], b[2], b[3]);
          }
      }
    }
  };
  pipeline<P::kStages>((Cin + P::kKs - 1) / P::kKs, load, compute);
  const bool has_bias = args.pbias != nullptr;

  if constexpr (kMode == kProjBwd) {
    // C': p and d through bf16 into the freed ring, then the epilogue
    // backward on all 16 warps
    unsigned short* const pd = reinterpret_cast<unsigned short*>(smem_raw);
    __syncthreads();  // every warp is past the ring
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            stage_pd(args, pd, h, j, wm * 16 + grp + 8 * (f / 2), wn * 16 + nt * 8 + 2 * tig + f % 2,
                     acc[h][j][0][nt][f], bi, c0, n0);
    __syncthreads();
    staged_pd_epilogue<kSplit>(args, pd, t, bi, c0, n0);
    return;
  } else if constexpr (kMode == kStatsFwd) {
    // S: p rounded through bf16 once (the bias added first), then |p| + EPS
    // and its square summed over a thread's four points (nt, then e), its
    // quad (quad_sum) and the four point warps in order (shared memory):
    // one (s1, s2) partial per (sample, tile, channel), pd_pass's layout.
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int cl = wm * 16 * kMT + mt * 16 + grp + 8 * r;
        const int c = c0 + cl;
        const bool cok = c < Cout;
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * 16 + nt * 8 + 2 * tig + e;
            float p[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const float pb = has_bias && cok ? vnk_bias(args.pbias, bi, j, c, Cout, n, N,
                                                          args.group) : 0.f;
              p[j] = vnk_round_bf16(acc[0][j][mt][nt][2 * r + e] + pb);
            }
            const float norm_e = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) + VNK_EPS;
            if (cok && n < N) {
              s1 += norm_e;
              s2 += norm_e * norm_e;
            }
          }
        }
        s1 = quad_sum(s1);
        s2 = quad_sum(s2);
        if (tig == 0) {
          red[(wn * kBC + cl) * 2] = s1;
          red[(wn * kBC + cl) * 2 + 1] = s2;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kBC) {
      const int cl = threadIdx.x % kBC, k = threadIdx.x / kBC, c = c0 + cl;
      if (c < Cout) {
        float v = red[cl * 2 + k];
#pragma unroll
        for (int w = 1; w < 4; ++w) v += red[(w * kBC + cl) * 2 + k];
        const size_t stride = static_cast<size_t>(args.B) * args.T * Cout;
        args.partial[k * stride + (static_cast<size_t>(bi) * args.T + t) * Cout + c] = v;
      }
    }
    return;
  } else {
    // S': the epilogue on the fragments.  A thread holds, per (mt, row half
    // r), channel c0 + wm 32 + mt 16 + grp + 8 r at points n0 + wn 16 + nt 8
    // + 2 tig + e (nt, e < 2), all three planes of p.  A bias sum runs over
    // a thread's points, its quad (shuffles), then, for columns of 16
    // points or more, the point warps in order (shared memory).
    const int sub = args.sub;
    const bool warp_sums = has_bias && (!kSplit || sub >= 16);
    const size_t bstride = static_cast<size_t>(args.B) * args.T * Cout * args.spt;
    const size_t row0 = (static_cast<size_t>(bi) * args.T + t) * args.spt;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int cl = wm * 16 * kMT + mt * 16 + grp + 8 * r;
        const int c = c0 + cl;
        const bool cok = c < Cout;
        const float c1v = cok ? args.c1[c] : 0.f, c2v = cok ? args.c2[c] : 0.f;
        float sb[3] = {0.f, 0.f, 0.f};  // the warp's bias sums
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int lp = wn * 16 + nt * 8 + 2 * tig;  // the pair's first point in the tile
          float o[2][3];
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // dp = (c1 + 2 c2 (|p| + EPS)) p / |p|, as pd_pass
            const int n = n0 + lp + e;
            float p[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const float pb = has_bias && cok ? vnk_bias(args.pbias, bi, j, c, Cout, n, N,
                                                          args.group) : 0.f;
              p[j] = vnk_round_bf16(acc[0][j][mt][nt][2 * r + e] + pb);
            }
            const float pnorm = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
            const float norm_e = pnorm + VNK_EPS;
            float scale = (c1v + 2.f * c2v * norm_e) *
                          (pnorm > 0.f ? 1.f / fmaxf(pnorm, 1e-30f) : 0.f);
            if (!(cok && n < N)) scale = 0.f;
#pragma unroll
            for (int j = 0; j < 3; ++j) o[e][j] = scale * p[j];
          }
          if (cok) {  // the stores round dp; the bias sums read the float32 values
#pragma unroll
            for (int j = 0; j < 3; ++j)
              store2(args.dp + ((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N, n0 + lp, N,
                     o[0][j], o[1][j]);
          }
          if (!has_bias) continue;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float pair = o[0][j] + o[1][j];
            float* dst = args.partial + j * bstride;
            if (warp_sums) {
              sb[j] += pair;
            } else if (sub == 8) {  // one n8 tile a column
              const float v = quad_sum(pair);
              if (tig == 0 && cok) dst[(row0 + lp / 8) * Cout + c] = v;
            } else if (sub == 4) {  // two lanes' pairs
              const float v = pair + __shfl_xor_sync(0xffffffffu, pair, 1);
              if (tig % 2 == 0 && cok) dst[(row0 + lp / 4) * Cout + c] = v;
            } else if (sub == 2) {
              if (cok) dst[(row0 + lp / 2) * Cout + c] = pair;
            } else if (cok) {  // group 1: every point its own column
              dst[(row0 + lp) * Cout + c] = o[0][j];
              dst[(row0 + lp + 1) * Cout + c] = o[1][j];
            }
          }
        }
        if (warp_sums) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float v = quad_sum(sb[j]);
            if (tig == 0) red[((wn * kBC + cl) * 3) + j] = v;
          }
        }
      }
    }
    if (!warp_sums) return;
    __syncthreads();
    // a bias column of w = sub / 16 point warps (4 for group 0 or >= 64)
    // sums its w in order
    if (threadIdx.x < kBC && c0 + static_cast<int>(threadIdx.x) < Cout) {
      const int cl = threadIdx.x, c = c0 + cl;
      const int per = kSplit ? sub / 16 : 4;
      for (int j = 0; j < 3; ++j)
        for (int col = 0; col < 4 / per; ++col) {
          float v = red[(col * per * kBC + cl) * 3 + j];
          for (int w = col * per + 1; w < (col + 1) * per; ++w) v += red[(w * kBC + cl) * 3 + j];
          args.partial[j * bstride + (row0 + col) * Cout + c] = v;
        }
    }
  }
}

// Pass 1 of bf16 S, S' and C' on Hopper's warpgroup products (the "wgmma_p"
// design; ops/vn_layer_fused.py::pass1_bf16_design): the reduction over
// Cin in 64-deep stages that TMA loads into a ring (vn_wgmma.cuh), all
// operands MN-major (the channels of W^T, the points of x contiguous),
// 128-byte swizzled: two 64-channel boxes of W^T (S, S': channels c0 ..
// c0 + 127; C': W^T's and Wd^T's channels c0 .. c0 + 63) and x's three
// 64-point boxes of the stage's 64 input channels.  The k16 steps run in
// ascending order from a zero accumulator, as in pd_wide_mma and in kernel
// C (proj_wide_mma, proj_wgmma): the card gives them the same bits, so S's
// p is S''s and C''s p, d are the forward's.
// S and S' (288 threads: two warpgroups and a producer warp): warpgroup wg
// owns channels wg 64 .. + 64 and keeps the three planes' m64n64
// accumulators (96 float32 a thread); the epilogue runs on them in their
// fragment layout: S sums |p| + EPS and its square, S' its dp for the bias
// gradients, in pd_wide_mma's order (a thread's points of each of that
// design's 16-point warps, its quad, then those warps in turn): one partial
// per (sample, 64-point tile, channel); S' writes dp through shared memory
// in 16-byte pieces of a row.  p is rounded through bf16 once after the
// bias, as in pd_pass.  p_out, where not null, receives p itself (bf16), so
// that a test can hold S's p to S''s.
// C' (512 threads): warpgroup j < 3 forms p and d of plane j (64 float32
// accumulators a thread), thread 384 issues the loads, and all four
// warpgroups then run the epilogue backward on p and d staged through bf16
// in the freed ring (staged_pd_epilogue).
// Bias columns cover whole tiles here (group 0 or >= 64; the wrapper keeps
// narrower groups on pd_wide_mma).  One block an SM (the ring's four
// stages, 160 KB).  Bound at 256 -> 256: S, S' bytes (x read; S' also dp
// written), the products at the bf16 rate below them; C' the six products.
template <int kMode>
struct PdWg {
  static constexpr bool kTwo = kMode == kProjBwd;     // p and d
  static constexpr int kThreads = kTwo ? 512 : kWgThreads;
  static constexpr int kConsumers = kTwo ? 384 : 256;  // the threads of the products
  static constexpr int kBC = kTwo ? 64 : 2 * 64;     // channels a block
  static constexpr int kA = kWgDepth * 2 * 64 * 2;   // two boxes of 64 channels x 64 rows
  static constexpr int kB = kWgDepth * kPts * 2;     // x, one plane: 64 rows of 64 points
  static constexpr int kStage = kA + 3 * kB, kStages = 4;
  static constexpr int kBytes = wg_smem(kStage, kStages);
  static constexpr int kOutLd = kPts + 8;            // bf16 a row of S''s staged dp
};

template <int kMode>
__global__ void __launch_bounds__(PdWg<kMode>::kThreads, 1)
pd_wgmma(PdArgs<vnk_bf16> args, const __grid_constant__ CUtensorMap tm_wt,
         const __grid_constant__ CUtensorMap tm_x, vnk_bf16* __restrict__ p_out) {
  using P = PdWg<kMode>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const tiles = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(tiles + P::kStages * P::kStage);
  uint64_t* const empty = full + P::kStages;
  const int t = blockIdx.y, bi = blockIdx.z;
  const int c0 = blockIdx.x * P::kBC, n0 = t * kPts;
  const int Cout = args.Cout, N = args.N;
  const int steps = (args.Cin + kWgDepth - 1) / kWgDepth;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  if (threadIdx.x == P::kConsumers) {  // the producer issues the loads
    for (int it = 0; it < steps; ++it) {
      const int s = it % P::kStages, k0 = it * kWgDepth;
      mbar_wait(&empty[s], ((it / P::kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], P::kStage);
      unsigned char* st = tiles + s * P::kStage;
      tma_load(st, &tm_wt, &full[s], c0, k0, 0);
      if (P::kTwo)  // Wd^T's box of the same channels
        tma_load(st + P::kA / 2, &tm_wt, &full[s], c0, k0, 1);
      else
        tma_load(st + P::kA / 2, &tm_wt, &full[s], c0 + 64, k0, 0);
      for (int j = 0; j < 3; ++j)
        tma_load(st + P::kA + j * P::kB, &tm_x, &full[s], n0, k0, bi * 3 + j);
    }
  }

  if constexpr (P::kTwo) {
    // warpgroup j: p (acc[0]) and d (acc[1]) of plane j; thread (w, grp,
    // tig) holds channel w 16 + grp + 8 r at points 8 i + 2 tig + e of the
    // tile (i < 8; e, r < 2): acc[h][4 i + 2 r + e]
    float acc[2][32];
    if (threadIdx.x < P::kConsumers) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
      for (int it = 0; it < steps; ++it) {
        const int s = it % P::kStages;
        mbar_wait(&full[s], (it / P::kStages) & 1);
        const unsigned char* st = tiles + s * P::kStage;
#pragma unroll
        for (int h = 0; h < 2; ++h) fence_acc(acc[h]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgDepth / 16; ++kk) {
          const uint64_t b = gmma_desc(st + P::kA + wg * P::kB + kk * 16 * 128, P::kB, 1024);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_m64n64k16_tt(acc[h], gmma_desc(st + h * (P::kA / 2) + kk * 16 * 128,
                                                 P::kA / 2, 1024), b);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int h = 0; h < 2; ++h) fence_acc(acc[h]);
        mbar_arrive(&empty[s]);
      }
    }
    __syncthreads();  // every warpgroup is past the ring
    unsigned short* const pd = reinterpret_cast<unsigned short*>(tiles);
    if (threadIdx.x < P::kConsumers) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            stage_pd(args, pd, h, wg, w * 16 + grp + 8 * (f / 2), 8 * i + 2 * tig + f % 2,
                     acc[h][4 * i + f], bi, c0, n0);
    }
    __syncthreads();
    staged_pd_epilogue<false>(args, pd, t, bi, c0, n0);
    return;
  } else {
    if (threadIdx.x >= P::kConsumers) return;
    float d[3][32];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) d[j][i] = 0.f;
    for (int it = 0; it < steps; ++it) {
      const int s = it % P::kStages;
      mbar_wait(&full[s], (it / P::kStages) & 1);
      const unsigned char* st = tiles + s * P::kStage;
#pragma unroll
      for (int j = 0; j < 3; ++j) fence_acc(d[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgDepth / 16; ++kk) {
        const uint64_t a = gmma_desc(st + wg * (P::kA / 2) + kk * 16 * 128, P::kA / 2, 1024);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          wgmma_m64n64k16_tt(d[j], a,
                             gmma_desc(st + P::kA + j * P::kB + kk * 16 * 128, P::kB, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < 3; ++j) fence_acc(d[j]);
      mbar_arrive(&empty[s]);
    }

    // thread (w, grp, tig) of warpgroup wg holds channel c0 + wg 64 + w 16 +
    // grp + 8 r at points n0 + 8 i + 2 tig + e (i < 8; e, r < 2): d[j][4 i + 2 r + e]
    const bool has_bias = args.pbias != nullptr;
    const size_t stride = static_cast<size_t>(args.B) * args.T * Cout;
    const size_t at = static_cast<size_t>(bi) * args.T + t;
    vnk_bf16* const out = reinterpret_cast<vnk_bf16*>(tiles);  // (3, 128, kOutLd): S''s dp
    if (kMode == kStatsBwd) consumers_sync();  // the stages are free: both warpgroups are past them
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int cl = wg * 64 + w * 16 + grp + 8 * r, c = c0 + cl;
      const bool cok = c < Cout;
      float pb[3] = {0.f, 0.f, 0.f};
      if (has_bias && cok) {  // a bias column covers the tile
#pragma unroll
        for (int j = 0; j < 3; ++j)
          pb[j] = vnk_bias(args.pbias, bi, j, c, Cout, n0, N, args.group);
      }
      float c1v = 0.f, c2v = 0.f;
      if (kMode == kStatsBwd && cok) {
        c1v = args.c1[c];
        c2v = args.c2[c];
      }
      // the sums in pd_wide_mma's order, so its bits: a thread's points of
      // one of that design's point warps (i / 2: its 16 points) over its two
      // n8 tiles (i % 2) and their pairs, its quad, then those warps in turn
      float s1w[4], s2w[4], sbw[4][3];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float o[2][3];
        if (i % 2 == 0) {
          s1w[i / 2] = s2w[i / 2] = 0.f;
#pragma unroll
          for (int j = 0; j < 3; ++j) sbw[i / 2][j] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * i + 2 * tig + e;
          const bool ok = cok && n < N;
          float p[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) p[j] = vnk_round_bf16(d[j][4 * i + 2 * r + e] + pb[j]);
          if (p_out != nullptr && ok) {
#pragma unroll
            for (int j = 0; j < 3; ++j)
              p_out[((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N + n] =
                  __float2bfloat16_rn(p[j]);
          }
          if (kMode == kStatsFwd) {
            const float norm_e = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) + VNK_EPS;
            if (ok) {
              s1w[i / 2] += norm_e;
              s2w[i / 2] += norm_e * norm_e;
            }
          } else {  // dp = (c1 + 2 c2 (|p| + EPS)) p / |p|, as pd_pass
            const float pnorm = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
            const float norm_e = pnorm + VNK_EPS;
            float scale = (c1v + 2.f * c2v * norm_e) *
                          (pnorm > 0.f ? 1.f / fmaxf(pnorm, 1e-30f) : 0.f);
            if (!ok) scale = 0.f;
#pragma unroll
            for (int j = 0; j < 3; ++j) o[e][j] = scale * p[j];
          }
        }
        if (kMode == kStatsBwd) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            sbw[i / 2][j] += o[0][j] + o[1][j];
            *reinterpret_cast<__nv_bfloat162*>(out + (j * P::kBC + cl) * P::kOutLd + 8 * i +
                                               2 * tig) = __floats2bfloat162_rn(o[0][j], o[1][j]);
          }
        }
      }
      if (kMode == kStatsFwd) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          const float a1 = quad_sum(s1w[w4]), a2 = quad_sum(s2w[w4]);
          s1 = w4 == 0 ? a1 : s1 + a1;
          s2 = w4 == 0 ? a2 : s2 + a2;
        }
        if (tig == 0 && cok) {
          args.partial[at * Cout + c] = s1;
          args.partial[stride + at * Cout + c] = s2;
        }
      } else if (has_bias) {  // one bias partial per (plane, sample, tile, channel)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float v = 0.f;
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) {
            const float a1 = quad_sum(sbw[w4][j]);
            v = w4 == 0 ? a1 : v + a1;
          }
          if (tig == 0 && cok) args.partial[j * stride + at * Cout + c] = v;
        }
      }
    }
    if (kMode == kStatsBwd) {  // dp in 16-byte pieces of a row (N % 8 == 0: a piece is in or out)
      consumers_sync();
      for (int e = threadIdx.x; e < 3 * P::kBC * 8; e += 256) {
        const int row = e / 8, j = row / P::kBC, cl = row % P::kBC, col = (e % 8) * 8;
        const int c = c0 + cl, n = n0 + col;
        if (c < Cout && n < N)
          *reinterpret_cast<uint4*>(args.dp + ((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N +
                                    n) = *reinterpret_cast<const uint4*>(out + row * P::kOutLd + col);
      }
    }
  }
}

// Wide pass 2: dx[bj, k, n] = sum_c W[c, k] g1[bj, c, n] (+ Wd g2), a
// kBM x kBN (input channel x point) tile per block; the reduction runs over
// the Cout channels of (W, g1), then of (Wd, g2).
struct DxF32 {
  static constexpr int kBM = 128, kBN = 128, kKs = 32, kStages = 3;
  static constexpr int kStage = kKs * kBM + kKs * kBN;
  static constexpr int kBytes = kStages * kStage * 4;
};

// float32: A = W as stored ([c][k], k contiguous), B = g ([c][n]); thread
// (ty, tx) holds rows {ty * 4 + i, 64 + ty * 4 + i} x points {tx * 4 + q,
// 64 + tx * 4 + q}, read as float4 (a half warp shares its A rows).
template <bool kTwo>
__global__ void __launch_bounds__(kWideThreads, 2)
dx_wide_f32(const float* __restrict__ w, const float* __restrict__ wd,
            const float* __restrict__ g1, const float* __restrict__ g2,
            float* __restrict__ dx, int Cin, int Cout, int N, bool aw, bool ag) {
  using P = DxF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * P::kBM, n0 = blockIdx.y * P::kBN;  // row blocks together
  const size_t bj = blockIdx.z;
  const int nk = (Cout + P::kKs - 1) / P::kKs;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;

  auto load = [&](int s, int kt) {
    float* st = sm + s * P::kStage;
    const bool second = kTwo && kt >= nk;
    const int c0 = (second ? kt - nk : kt) * P::kKs;
    const float* a = second ? wd : w;
    const float* g = (second ? g2 : g1) + bj * Cout * N;
    stage_tile<float, P::kKs, P::kBM>(st, P::kBM, a + static_cast<size_t>(c0) * Cin + m0, Cin,
                                      Cout - c0, Cin - m0, aw);
    stage_tile<float, P::kKs, P::kBN>(st + P::kKs * P::kBM, P::kBN,
                                      g + static_cast<size_t>(c0) * N + n0, N, Cout - c0,
                                      N - n0, ag);
  };
  auto compute = [&](int s) {
    const float* as = sm + s * P::kStage;
    const float* bs = as + P::kKs * P::kBM;
#pragma unroll 4
    for (int k = 0; k < P::kKs; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * P::kBM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * P::kBM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * P::kBN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * P::kBN + 64 + tx * 4);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(ar[i], br[q], acc[i][q]);
    }
  };
  pipeline<P::kStages>(kTwo ? 2 * nk : nk, load, compute);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 0 : 64) + ty * 4 + i % 4;
    if (m >= Cin) continue;
    float* row = dx + (bj * Cin + m) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + tx * 4;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      store4(row, n, N, N % 4 == 0 && n + 3 < N, v);
    }
  }
}

// bf16: A = W^T16 ([k][c], the reduction contiguous), B = g16 ([c][n], read
// with .trans); warp (wm, wn) of the 2 x 4 grid owns 64 rows x 32 points.
struct DxBf16 {
  static constexpr int kBM = 128, kBN = 128, kKs = 32, kStages = 3;
  static constexpr int kAld = kKs + 8, kBld = kBN + 8;
  static constexpr int kA = kBM * kAld, kB = kKs * kBld;
  static constexpr int kStage = kA + kB;
  static constexpr int kBytes = kStages * kStage * 2;
};

template <bool kTwo>
__global__ void __launch_bounds__(kWideThreads, 2)
dx_wide_bf16(const vnk_bf16* __restrict__ wt, const vnk_bf16* __restrict__ g1,
             const vnk_bf16* __restrict__ g2, vnk_bf16* __restrict__ dx, int Cin, int Cout,
             int N, bool aw, bool ag) {
  using T = vnk_bf16;
  using P = DxBf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2, grp = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.x * P::kBM, n0 = blockIdx.y * P::kBN;  // row blocks together
  const size_t bj = blockIdx.z;
  const int nk = (Cout + P::kKs - 1) / P::kKs;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto load = [&](int s, int kt) {
    T* st = sm + s * P::kStage;
    const bool second = kTwo && kt >= nk;
    const int c0 = (second ? kt - nk : kt) * P::kKs;
    const T* a = wt + (second ? static_cast<size_t>(Cin) * Cout : 0);
    const T* g = (second ? g2 : g1) + bj * Cout * N;
    stage_tile<T, P::kBM, P::kKs>(st, P::kAld, a + static_cast<size_t>(m0) * Cout + c0, Cout,
                                  Cin - m0, Cout - c0, aw);
    stage_tile<T, P::kKs, P::kBN>(st + P::kA, P::kBld, g + static_cast<size_t>(c0) * N + n0,
                                  N, Cout - c0, N - n0, ag);
  };
  auto compute = [&](int s) {
    const T* as = sm + s * P::kStage;
    const T* bs = as + P::kA;
#pragma unroll
    for (int ks = 0; ks < P::kKs; ks += 16) {
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) frag_a(a[mt], as, P::kAld, wm * 64 + mt * 16, ks);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned b[4];
        frag_b2_t(b, bs, P::kBld, wn * 32 + np * 16, ks);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  };
  pipeline<P::kStages>(kTwo ? 2 * nk : nk, load, compute);

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm * 64 + mt * 16 + grp + 8 * r;
      if (m >= Cin) continue;
      T* row = dx + (bj * Cin + m) * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store2(row, n0 + wn * 32 + nt * 8 + 2 * tig, N, acc[mt][nt][2 * r],
               acc[mt][nt][2 * r + 1]);
    }
}

// Wide pass 3, split K: part[s, c, k] = sum over the stages of chunk s of
// g1[bj, c, n] x[bj, k, n] (part2 with g2).  Stage t of the B*3 planes'
// ceil(N / kKs) each is plane t / tiles_n, points (t % tiles_n) kKs ..;
// chunk s is stages s * chunk .. (s + 1) * chunk - 1.
template <bool kTwo>
struct DwF32 {
  static constexpr int kMI = kTwo ? 4 : 8;  // rows a thread
  static constexpr int kBM = 16 * kMI, kBN = 128, kKs = 16, kStages = 3, kLd = kKs + 4;
  static constexpr int kStage = ((kTwo ? 2 : 1) * kBM + kBN) * kLd;
  static constexpr int kBytes = kStages * kStage * 4;
};

// float32: A = g ([c][n]) and B = x ([k][n]) both with the points
// contiguous, rows padded to kKs + 4 (float4 reads of 8 neighbouring rows
// hit distinct banks); thread (ty, tx) holds rows ty + 16 i x columns tx +
// 16 q.
template <bool kTwo>
__global__ void __launch_bounds__(kWideThreads, 2)
dw_wide_f32(const float* __restrict__ g1, const float* __restrict__ g2,
            const float* __restrict__ x, float* __restrict__ part, float* __restrict__ part2,
            int Cin, int Cout, int N, int planes, int chunk, bool ax) {
  using P = DwF32<kTwo>;
  constexpr int kMI = P::kMI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * P::kBN, c0 = blockIdx.y * P::kBM, s = blockIdx.z;
  const int tiles_n = (N + P::kKs - 1) / P::kKs;
  const int t0 = s * chunk;
  const int tiles = min(chunk, planes * tiles_n - t0);

  float acc[kTwo ? 2 : 1][kMI][8];
#pragma unroll
  for (int h = 0; h < (kTwo ? 2 : 1); ++h)
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[h][i][q] = 0.f;

  auto load = [&](int st_i, int it) {
    float* st = sm + st_i * P::kStage;
    const int t = t0 + it;
    const size_t bj = t / tiles_n;
    const int n0 = (t % tiles_n) * P::kKs;
    const size_t ga = (bj * Cout + c0) * N + n0;
    stage_tile<float, P::kBM, P::kKs>(st, P::kLd, g1 + ga, N, Cout - c0, N - n0, ax);
    if (kTwo)
      stage_tile<float, P::kBM, P::kKs>(st + P::kBM * P::kLd, P::kLd, g2 + ga, N, Cout - c0,
                                        N - n0, ax);
    stage_tile<float, P::kBN, P::kKs>(st + (kTwo ? 2 : 1) * P::kBM * P::kLd, P::kLd,
                                      x + (bj * Cin + k0) * N + n0, N, Cin - k0, N - n0, ax);
  };
  auto compute = [&](int st_i) {
    const float* as = sm + st_i * P::kStage;
    const float* bs = as + (kTwo ? 2 : 1) * P::kBM * P::kLd;
#pragma unroll
    for (int kk = 0; kk < P::kKs; kk += 4) {
#pragma unroll
      for (int qh = 0; qh < 8; qh += 4) {  // half the columns at a time: no spills
        float4 b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          b[q] = *reinterpret_cast<const float4*>(bs + (tx + 16 * (qh + q)) * P::kLd + kk);
#pragma unroll
        for (int h = 0; h < (kTwo ? 2 : 1); ++h)
#pragma unroll
          for (int i = 0; i < kMI; ++i) {
            const float4 a =
                *reinterpret_cast<const float4*>(as + (h * P::kBM + ty + 16 * i) * P::kLd + kk);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float& c = acc[h][i][qh + q];
              c = fmaf(a.x, b[q].x, c);
              c = fmaf(a.y, b[q].y, c);
              c = fmaf(a.z, b[q].z, c);
              c = fmaf(a.w, b[q].w, c);
            }
          }
      }
    }
  };
  pipeline<P::kStages>(tiles, load, compute);

#pragma unroll
  for (int h = 0; h < (kTwo ? 2 : 1); ++h)
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int c = c0 + ty + 16 * i;
      if (c >= Cout) continue;
      float* row = (h == 0 ? part : part2) + (static_cast<size_t>(s) * Cout + c) * Cin;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int k = k0 + tx + 16 * q;
        if (k < Cin) row[k] = acc[h][i][q];
      }
    }
}

template <bool kTwo>
struct DwBf16 {
  static constexpr int kMT = kTwo ? 2 : 4;  // m16 tiles a warp
  static constexpr int kBM = 32 * kMT, kBN = 128, kKs = 32, kStages = 3, kLd = kKs + 8;
  static constexpr int kStage = ((kTwo ? 2 : 1) * kBM + kBN) * kLd;
  static constexpr int kBytes = kStages * kStage * 2;
};

// bf16: A = g16 ([c][n]) and B = x16 ([k][n]), both with the reduction
// (points) contiguous, read plain; warp (wm, wn) of the 2 x 4 grid owns
// 16 kMT rows x 32 columns.
template <bool kTwo>
__global__ void __launch_bounds__(kWideThreads, 2)
dw_wide_bf16(const vnk_bf16* __restrict__ g1, const vnk_bf16* __restrict__ g2,
             const vnk_bf16* __restrict__ x, float* __restrict__ part,
             float* __restrict__ part2, int Cin, int Cout, int N, int planes, int chunk,
             bool ax) {
  using T = vnk_bf16;
  using P = DwBf16<kTwo>;
  constexpr int kMT = P::kMT, kNh = kTwo ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2, grp = lane / 4, tig = lane % 4;
  const int k0 = blockIdx.x * P::kBN, c0 = blockIdx.y * P::kBM, s = blockIdx.z;
  const int tiles_n = (N + P::kKs - 1) / P::kKs;
  const int t0 = s * chunk;
  const int tiles = min(chunk, planes * tiles_n - t0);

  float acc[kNh][kMT][4][4];
#pragma unroll
  for (int h = 0; h < kNh; ++h)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][mt][nt][e] = 0.f;

  auto load = [&](int st_i, int it) {
    T* st = sm + st_i * P::kStage;
    const int t = t0 + it;
    const size_t bj = t / tiles_n;
    const int n0 = (t % tiles_n) * P::kKs;
    const size_t ga = (bj * Cout + c0) * N + n0;
    stage_tile<T, P::kBM, P::kKs>(st, P::kLd, g1 + ga, N, Cout - c0, N - n0, ax);
    if (kTwo)
      stage_tile<T, P::kBM, P::kKs>(st + P::kBM * P::kLd, P::kLd, g2 + ga, N, Cout - c0,
                                    N - n0, ax);
    stage_tile<T, P::kBN, P::kKs>(st + kNh * P::kBM * P::kLd, P::kLd,
                                  x + (bj * Cin + k0) * N + n0, N, Cin - k0, N - n0, ax);
  };
  auto compute = [&](int st_i) {
    const T* as = sm + st_i * P::kStage;
    const T* bs = as + kNh * P::kBM * P::kLd;
#pragma unroll
    for (int ks = 0; ks < P::kKs; ks += 16) {
      unsigned a[kNh][kMT][4];
#pragma unroll
      for (int h = 0; h < kNh; ++h)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          frag_a(a[h][mt], as + h * P::kBM * P::kLd, P::kLd, wm * 16 * kMT + mt * 16, ks);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned b[4];
        frag_b2(b, bs, P::kLd, wn * 32 + np * 16, ks);
#pragma unroll
        for (int h = 0; h < kNh; ++h)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[h][mt][2 * np], a[h][mt], b[0], b[1]);
            mma_bf16(acc[h][mt][2 * np + 1], a[h][mt], b[2], b[3]);
          }
      }
    }
  };
  pipeline<P::kStages>(tiles, load, compute);

#pragma unroll
  for (int h = 0; h < kNh; ++h)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = c0 + wm * 16 * kMT + mt * 16 + grp + 8 * r;
        if (c >= Cout) continue;
        float* row = (h == 0 ? part : part2) + (static_cast<size_t>(s) * Cout + c) * Cin;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int k = k0 + wn * 32 + nt * 8 + 2 * tig;
          if (k + 1 < Cin && Cin % 2 == 0) {
            *reinterpret_cast<float2*>(row + k) =
                make_float2(acc[h][mt][nt][2 * r], acc[h][mt][nt][2 * r + 1]);
          } else {
            if (k < Cin) row[k] = acc[h][mt][nt][2 * r];
            if (k + 1 < Cin) row[k + 1] = acc[h][mt][nt][2 * r + 1];
          }
        }
      }
}

// ------------------------------------------------------------ the channel walk
//
// S (the stream design), S' and B' (the fused designs) at Cin <= 2 (kCin:
// the decoder's first fold layer, conv1, the pair folds): a block owns one
// 64-point tile of one sample and walks all Cout channels, thread (ty, tx)
// of the 16 x 16 grid channels c0 + 4 ty + i (i < 4, c0 in steps of 64) at
// points n0 + 4 tx + q.  It holds x at its four points (three planes) in
// registers and, for each channel, recomputes p (and B''s d) as pd_pass
// does: kCin FMAs a plane in input-channel order, the bias after them, (bf16)
// one rounding.  Then
//   S  sums |p| + EPS and its square over its four points and a fixed
//      butterfly over its 16 lanes: one partial per (sample, tile,
//      channel), pd_pass's operations in pd_pass's order, so the narrow
//      S's bits.  No product tile, no shared memory, no barrier.
//   S' forms dp = (c1 + 2 c2 (|p| + EPS)) p / |p| (0 where |p| = 0) in
//      registers; it reads no g and carries no d.
//   B' reads g once (a thread's four points of the three planes, copied by
//      cp.async into its own shared-memory slots one channel ahead) and
//      runs the epilogue backward in registers.
// S' and B' then
//   - sum the bias gradients (and B''s dA, dB) as pd_pass does (one
//     partial per sample, tile and channel, or the kSplit sub-partials) and
//     dW[c, k] (dWd) over the four points and a fixed butterfly over the 16
//     lanes: one partial per (sample, tile, channel, k), summed by
//     vnk_reduce_rows;
//   - add W[c, k] dp (+ Wd[c, k] dd) to the running dx of the four points,
//     kept in registers across the channels; the 16 channel groups are
//     added in order through shared memory at the end.
// No dp/dd scratch, no further pass over the points.  The bf16 mode forms
// dp and dd in float32, sums dA, dB and the bias gradients from those, and
// rounds dp, dd (and W, Wd) to bf16 only as operands of the dx and dW
// products (JAX vn_layer_fused.py:204-209, :440-457); dx is stored bf16.
// cp.async of a thread's g slice: 16 bytes (four float32 points, through
// L2 only) or 8 (four bf16 points).
template <int kBytes>
__device__ __forceinline__ void cp_async_g(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    cp_async16(dst, src);
  } else {
    static_assert(kBytes == 8, "8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  }
}

// Channels of g in flight ahead of the one in use (on the card one was
// faster than none and than two).
constexpr int kGAhead = 1;

// Blocks an SM of the walk: B' three at Cin 1 (its x and dx take half the
// registers), two at Cin 2; S' four and three; S four.  Each was the
// fastest of its neighbours (one block more or fewer; S also six and eight,
// where eight spills) when timed on an H100.
constexpr int kStatsBwdBlocks1 = 4;
constexpr int kStatsBwdBlocks2 = 3;
constexpr int kStatsBlocks = 4;
// Channels of the walk unrolled for S (two was faster than one at 2 ->
// 256); S' walks one at a time (two and four were slower, four spills), and
// so does B' (its g ring runs one channel ahead).
constexpr int kStatsUnroll = 2;

template <int kMode, int kCin>
constexpr int walk_blocks() {
  return kMode == kLayerBwd   ? (kCin == 1 ? 3 : 2)
         : kMode == kStatsBwd ? (kCin == 1 ? kStatsBwdBlocks1 : kStatsBwdBlocks2)
                              : kStatsBlocks;
}

template <int kMode>
__host__ __device__ constexpr int walk_unroll() {
  return kMode == kStatsFwd ? kStatsUnroll : 1;
}

template <int kMode, int kCin, bool kSplit, typename T>
__global__ void __launch_bounds__(kThreads, walk_blocks<kMode, kCin>())
channel_walk(PdArgs<T> args, T* __restrict__ dx, float* __restrict__ dw_part, bool ag) {
  constexpr bool kWithD = kMode == kLayerBwd;  // d and g: B' only
  constexpr bool kGrads = kMode != kStatsFwd;  // dx, dW and the bias sums
  constexpr int kNqc = channel_sums<kMode>();
  // B': a thread's g slices (three planes x its four points) kGAhead
  // channels ahead, each thread filling and reading only its own slots;
  // then, after the walk (S', B'), the 16 channel groups' dx
  constexpr int kGV = 4 * static_cast<int>(sizeof(T));  // bytes of four points
  constexpr int kGBytes = kWithD ? (kGAhead + 1) * 3 * kThreads * kGV : 16;
  constexpr int kRedBytes = kGrads ? 16 * 3 * kCin * kPts * 4 : 16;
  __shared__ __align__(16) unsigned char smem[kGBytes > kRedBytes ? kGBytes : kRedBytes];
  auto red = reinterpret_cast<float (*)[3][kCin][kPts]>(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t = blockIdx.x, bi = blockIdx.y;
  const int n0 = t * kPts, nt0 = n0 + tx * 4;
  const int Cout = args.Cout, N = args.N;
  const bool has_bias = args.pbias != nullptr;
  const bool vec = ag && (N % 4 == 0) && (nt0 + 3 < N);  // g rows 16 (8)-byte aligned

  // x at this thread's four points (zero past N), and its running dx
  float xv[3][kCin][4], dxa[3][kCin][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < kCin; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = nt0 + q;
        xv[j][k][q] = n < N ? vnk_load(args.x[((static_cast<size_t>(bi) * 3 + j) * kCin + k) * N + n])
                            : 0.f;
        dxa[j][k][q] = 0.f;
      }

  const size_t stride = static_cast<size_t>(args.B) * args.T * Cout;
  const size_t bstride = stride * args.spt;
  const size_t row0 = (static_cast<size_t>(bi) * args.T + t) * args.spt;
  float* const bias_part = args.partial + kNqc * stride;
  // the bias columns of the thread's points (vnk_bias's n / group, the last
  // column past N), worked out once, not once a channel
  const int cols = args.group ? N / args.group : 1;
  int bcol[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bcol[q] = args.group ? min(nt0 + q, N - 1) / args.group : 0;
  const auto bias_at = [&](const T* bias, int j, int c, int q) {
    return vnk_load(bias[((static_cast<size_t>(bi) * 3 + j) * Cout + c) * cols + bcol[q]]);
  };
  // the thread's channels in turn: m -> c0 + 4 ty + i, c0 = 64 (m / 4), i = m % 4
  const int walk = (Cout + kCh - 1) / kCh * 4;
  const auto channel = [&](int m) { return m / 4 * kCh + ty * 4 + m % 4; };
  const auto slot = [&](int m, int j) {
    return smem + ((m % (kGAhead + 1) * 3 + j) * kThreads + threadIdx.x) * kGV;
  };
  const auto fetch = [&](int m) {  // one commit group a channel, empty past the walk
    const int c = channel(m);
    if (vec && m < walk && c < Cout) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        cp_async_g<kGV>(slot(m, j), args.g + ((static_cast<size_t>(bi) * 3 + j) * Cout + c) * N + nt0);
    }
    cp_async_commit();
  };
  if constexpr (kWithD) {
#pragma unroll
    for (int m = 0; m < kGAhead; ++m) fetch(m);
  }
  constexpr int kUnroll = walk_unroll<kMode>();
#pragma unroll(kUnroll)
  for (int m = 0; m < walk; ++m) {
    if constexpr (kWithD) {
      fetch(m + kGAhead);
      cp_async_wait<kGAhead>();  // this thread's copies of channel m have landed
    }
    {
      const int c = channel(m);
      const bool cok = c < Cout;
      // the products' operands: W and Wd rounded to bf16 in the bf16 mode
      float wr[kCin], dr[kCin];
#pragma unroll
      for (int k = 0; k < kCin; ++k) {
        wr[k] = cok ? vnk_round_as<T>(args.w[c * kCin + k]) : 0.f;
        dr[k] = kWithD && cok ? vnk_round_as<T>(args.wd[c * kCin + k]) : 0.f;
      }
      float av = 0.f, bv = 0.f, c1v = 0.f, c2v = 0.f;
      if (cok && kWithD) {
        av = args.a[c];
        bv = args.b[c];
      }
      if (cok && kMode == kStatsBwd) {
        c1v = args.c1[c];
        c2v = args.c2[c];
      }

      // B': g of the four points, three planes
      float gq[3][4];
      if constexpr (kWithD) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T* row = args.g + ((static_cast<size_t>(bi) * 3 + j) * Cout + (cok ? c : 0)) * N;
          if (cok && vec) {
            load_n<4>(reinterpret_cast<const T*>(slot(m, j)), gq[j]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) gq[j][q] = cok && nt0 + q < N ? vnk_load(row[nt0 + q]) : 0.f;
          }
        }
      }

      float sc[2] = {0.f, 0.f}, sp[3] = {0.f, 0.f, 0.f}, sd[3] = {0.f, 0.f, 0.f};
      float sw[kCin], swd[kCin];
#pragma unroll
      for (int k = 0; k < kCin; ++k) sw[k] = swd[k] = 0.f;
      float outp[3][4], outd[3][4];
      float pb[3] = {0.f, 0.f, 0.f}, db[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = nt0 + q;
        const bool ok = cok && n < N;
        // a thread's 4 points share one bias column unless group is 1 or 2
        if (has_bias && cok && (q == 0 || (kSplit && args.group < 4))) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            pb[j] = bias_at(args.pbias, j, c, q);
            if (kWithD) db[j] = bias_at(args.dbias, j, c, q);
          }
        }
        // p and d as the forward's: input-channel order, the bias, one rounding
        float p[3], d[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float ap = 0.f, ad = 0.f;
#pragma unroll
          for (int k = 0; k < kCin; ++k) {
            ap = fmaf(wr[k], xv[j][k][q], ap);
            if (kWithD) ad = fmaf(dr[k], xv[j][k][q], ad);
          }
          p[j] = vnk_round_as<T>(ap + pb[j]);
          d[j] = vnk_round_as<T>(ad + db[j]);
        }
        if constexpr (kMode == kStatsFwd) {
          const float norm_e = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) + VNK_EPS;
          if (ok) {
            sc[0] += norm_e;
            sc[1] += norm_e * norm_e;
          }
        } else {
          float dpv[3], ddv[3] = {0.f, 0.f, 0.f};
          if constexpr (kMode == kStatsBwd) {
            const float pnorm = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
            const float norm_e = pnorm + VNK_EPS;
            const float scale = (c1v + 2.f * c2v * norm_e) *
                                (pnorm > 0.f ? 1.f / fmaxf(pnorm, 1e-30f) : 0.f);
#pragma unroll
            for (int j = 0; j < 3; ++j) dpv[j] = scale * p[j];
          } else {
            const float gv[3] = {gq[0][q], gq[1][q], gq[2][q]};
            float dqp, norm_e;
            vnk_bn_leaky_bwd(p, d, gv, av, bv, args.one_minus_ns, dpv, ddv, &dqp, &norm_e,
                             nullptr);
            if (ok) {
              sc[0] += dqp;
              sc[1] += dqp / norm_e;
            }
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            outp[j][q] = ok ? dpv[j] : 0.f;
            outd[j][q] = ok ? ddv[j] : 0.f;
            sp[j] += outp[j][q];
            sd[j] += outd[j][q];
            const float p16 = vnk_round_as<T>(outp[j][q]), d16 = vnk_round_as<T>(outd[j][q]);
#pragma unroll
            for (int k = 0; k < kCin; ++k) {
              sw[k] = fmaf(p16, xv[j][k][q], sw[k]);
              if constexpr (kWithD) {
                swd[k] = fmaf(d16, xv[j][k][q], swd[k]);
                dxa[j][k][q] = fmaf(dr[k], d16, fmaf(wr[k], p16, dxa[j][k][q]));
              } else {
                dxa[j][k][q] = fmaf(wr[k], p16, dxa[j][k][q]);
              }
            }
          }
        }
      }

      // one partial per (quantity, sample, tile, channel): S's s1, s2, B''s
      // dA, dB; dW (dWd) at (sample, tile, channel, k); the bias sums as
      // pd_pass writes them
      const size_t at = (static_cast<size_t>(bi) * args.T + t) * Cout + c;
#pragma unroll
      for (int k = 0; k < kNqc; ++k) {
        const float v = vnk_sum16(sc[k]);
        if (tx == 0 && cok) args.partial[k * stride + at] = v;
      }
      if constexpr (kGrads) {
#pragma unroll
        for (int k = 0; k < kCin; ++k) {
          const float v = vnk_sum16(sw[k]);
          if (tx == 0 && cok) dw_part[at * kCin + k] = v;
          if constexpr (kWithD) {
            const float vd = vnk_sum16(swd[k]);
            if (tx == 0 && cok) dw_part[(stride + at) * kCin + k] = vd;
          }
        }
        if (has_bias) {
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
  }

  if constexpr (kGrads) {
    // dx: the 16 channel groups' sums in order (red overlays the g slots)
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < kCin; ++k)
        *reinterpret_cast<float4*>(&red[ty][j][k][tx * 4]) =
            make_float4(dxa[j][k][0], dxa[j][k][1], dxa[j][k][2], dxa[j][k][3]);
    __syncthreads();
    for (int e = threadIdx.x; e < 3 * kCin * kPts; e += kThreads) {
      const int j = e / (kCin * kPts), k = e / kPts % kCin, nn = e % kPts, n = n0 + nn;
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < 16; ++g) s += red[g][j][k][nn];
      if (n < N) dx[((static_cast<size_t>(bi) * 3 + j) * kCin + k) * N + n] = vnk_cast<T>(s);
    }
  }
}

int tiles(int N) { return (N + kPts - 1) / kPts; }

// kSplit also makes S read the bias at every point of a thread's four where
// groups 1 and 2 give them two or four columns.
template <int kMode, typename T>
void launch_pd(const PdArgs<T>& args, cudaStream_t st) {
  const dim3 grid(args.T, (args.Cout + kCh - 1) / kCh, args.B);
  if (args.sub < kPts) {
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

// W^T (and Wd^T) into wt, then the wide pass 1: the FMAs in float32, the
// tensor cores in bf16.
template <int kMode, typename T>
cudaError_t launch_pd_wide(const PdArgs<T>& args, T* wt, cudaStream_t st) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  launch_transpose(args.w, kMode == kProjBwd ? args.wd : nullptr, wt, args.Cin, args.Cout, st);
  const bool aw = aligned16(wt, args.Cout, kV), ax = aligned16(args.x, args.N, kV);
  const bool split = args.sub < kPts;
  if constexpr (vnk_is_bf16<T>()) {
    using P = PdBf16<kMode>;
    const dim3 grid((args.Cout + P::kBC - 1) / P::kBC, args.T, args.B);
    // S reads its bias at every point and writes no bias partials: kSplit
    // plays no part there
    return split && kMode != kStatsFwd ? launch_wide<P::kThreads>(pd_wide_mma<kMode, true>, grid, P::kBytes, st, args,
                                            wt, aw, ax)
                 : launch_wide<P::kThreads>(pd_wide_mma<kMode, false>, grid, P::kBytes, st, args,
                                            wt, aw, ax);
  } else {
    using P = PdFma<kMode>;
    const dim3 grid((args.Cout + P::kBC - 1) / P::kBC, args.T, args.B);
    return split ? launch_wide(pd_wide_fma<kMode, true>, grid, P::kBytes, st, args, wt, aw, ax)
                 : launch_wide(pd_wide_fma<kMode, false>, grid, P::kBytes, st, args, wt, aw, ax);
  }
}

// W^T (and C''s Wd^T) into wt, then pass 1 on wgmma (pd_wgmma; p_out null
// or S's and S''s p).
template <int kMode>
cudaError_t launch_pd_wgmma(const PdArgs<vnk_bf16>& args, vnk_bf16* wt, vnk_bf16* p_out,
                            cudaStream_t st) {
  using P = PdWg<kMode>;
  launch_transpose(args.w, P::kTwo ? args.wd : nullptr, wt, args.Cin, args.Cout, st);
  CUtensorMap wt_map, x_map;
  cudaError_t err =
      tensor_map(&wt_map, wt, args.Cout, args.Cin, P::kTwo ? 2 : 1, kWgDepth, kWgDepth);
  if (err == cudaSuccess)
    err = tensor_map(&x_map, args.x, args.N, args.Cin, args.B * 3, kWgDepth, kWgDepth);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.Cout + P::kBC - 1) / P::kBC, args.T, args.B);
  return launch_wide<P::kThreads>(pd_wgmma<kMode>, grid, P::kBytes, st, args, wt_map, x_map,
                                  p_out);
}

// Wide passes 2 and 3 and the split-K reduction: as products_bwd, with
// `chunk` stages of pass 3 to a split.
template <bool kTwo, typename T>
cudaError_t products_wide(const T* x, const float* w, const float* wd, const T* wt, const T* dp,
                          const T* dd, T* dx, float* dw2, float* dw_part, int B, int Cin,
                          int Cout, int N, int S, int chunk, cudaStream_t st) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const bool ag = aligned16(dp, N, kV) && (!kTwo || aligned16(dd, N, kV));
  const bool ax = ag && aligned16(x, N, kV);
  float* part2 = kTwo ? dw_part + static_cast<size_t>(S) * Cout * Cin : nullptr;
  cudaError_t err;
  if constexpr (vnk_is_bf16<T>()) {
    using P = DxBf16;
    using Q = DwBf16<kTwo>;
    err = launch_wide(dx_wide_bf16<kTwo>,
                      dim3((Cin + P::kBM - 1) / P::kBM, (N + P::kBN - 1) / P::kBN, B * 3),
                      P::kBytes, st, wt, dp, dd, dx, Cin, Cout, N, aligned16(wt, Cout, kV), ag);
    if (err != cudaSuccess) return err;
    err = launch_wide(dw_wide_bf16<kTwo>,
                      dim3((Cin + Q::kBN - 1) / Q::kBN, (Cout + Q::kBM - 1) / Q::kBM, S),
                      Q::kBytes, st, dp, dd, x, dw_part, part2, Cin, Cout, N, B * 3, chunk, ax);
  } else {
    using P = DxF32;
    using Q = DwF32<kTwo>;
    const bool aw = aligned16(w, Cin, kV) && (!kTwo || aligned16(wd, Cin, kV));
    err = launch_wide(dx_wide_f32<kTwo>,
                      dim3((Cin + P::kBM - 1) / P::kBM, (N + P::kBN - 1) / P::kBN, B * 3),
                      P::kBytes, st, w, wd, dp, dd, dx, Cin, Cout, N, aw, ag);
    if (err != cudaSuccess) return err;
    err = launch_wide(dw_wide_f32<kTwo>,
                      dim3((Cin + Q::kBN - 1) / Q::kBN, (Cout + Q::kBM - 1) / Q::kBM, S),
                      Q::kBytes, st, dp, dd, x, dw_part, part2, Cin, Cout, N, B * 3, chunk, ax);
  }
  if (err != cudaSuccess) return err;
  vnk_reduce_rows(dw_part, dw2, kTwo ? 2 : 1, S, static_cast<int64_t>(Cout) * Cin, st);
  return cudaGetLastError();
}

// Whether the wgmma passes take these operands: whole 64-channel tiles of
// both widths, and every row of x, dp and dd 16-byte aligned (N % 8 == 0,
// aligned bases), as the tensor maps need.
inline bool wgmma_fits(int Cin, int Cout, int N, const void* x, const void* dp, const void* dd) {
  auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return Cin % kWgDepth == 0 && Cout % kWgDepth == 0 && N % 8 == 0 && aligned(x) &&
         aligned(dp) && aligned(dd);
}

// Passes 2 and 3 of the wgmma design (vn_wgmma.cuh) and the split-K
// reduction: as products_wide's bf16 passes, pass 3's `chunk` stages of
// kWgDepth points each.
template <bool kTwo>
cudaError_t products_wgmma(const vnk_bf16* x, const vnk_bf16* wt, const vnk_bf16* dp,
                           const vnk_bf16* dd, vnk_bf16* dx, float* dw2, float* dw_part, int B,
                           int Cin, int Cout, int N, int S, int chunk, cudaStream_t st) {
  const int planes = B * 3;
  float* part2 = kTwo ? dw_part + static_cast<size_t>(S) * Cout * Cin : nullptr;
  CUtensorMap wt_map, g1, g2;
  cudaError_t err = tensor_map(&wt_map, wt, Cout, Cin, kTwo ? 2 : 1, kWgDepth, kWgTile);
  if (err == cudaSuccess) err = tensor_map(&g1, dp, N, Cout, planes, kWgDepth, kWgDepth);
  if (err == cudaSuccess)
    err = tensor_map(&g2, kTwo ? dd : dp, N, Cout, planes, kWgDepth, kWgDepth);
  if (err == cudaSuccess)
    err = launch_wide<kWgThreads>(dx_wgmma<kTwo>,
                                  dim3((Cin + kWgTile - 1) / kWgTile,
                                       (N + kWgTile - 1) / kWgTile, planes),
                                  DxWg::kBytes, st, wt_map, g1, g2, dx, Cin, Cout, N);
  if (err != cudaSuccess) return err;
  CUtensorMap h1, h2, xm;
  err = tensor_map(&h1, dp, N, Cout, planes, kWgDepth, kWgTile);
  if (err == cudaSuccess)
    err = tensor_map(&h2, kTwo ? dd : dp, N, Cout, planes, kWgDepth, kWgTile);
  if (err == cudaSuccess) err = tensor_map(&xm, x, N, Cin, planes, kWgDepth, kWgTile);
  if (err == cudaSuccess)
    err = launch_wide<kWgThreads>(dw_wgmma<kTwo>,
                                  dim3((Cin + kWgTile - 1) / kWgTile,
                                       (Cout + kWgTile - 1) / kWgTile, S),
                                  DwWg<kTwo>::kBytes, st, h1, h2, xm, dw_part, part2, Cin, Cout,
                                  N, planes, chunk);
  if (err != cudaSuccess) return err;
  vnk_reduce_rows(dw_part, dw2, kTwo ? 2 : 1, S, static_cast<int64_t>(Cout) * Cin, st);
  return cudaGetLastError();
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
  r.pd_out = nullptr;
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

// The channel walk (S, S', B' at Cin 1 or 2) into its partials, and dx for
// S' and B'; cudaErrorInvalidValue at any other Cin.
template <int kMode, int kCin, typename T>
cudaError_t launch_walk_at(const PdArgs<T>& args, T* dx, float* dw_part, cudaStream_t st) {
  const bool ag =
      kMode == kLayerBwd && aligned16(args.g, args.N, 16 / static_cast<int>(sizeof(T)));
  const dim3 grid(args.T, args.B);
  if (args.sub < kPts) {
    channel_walk<kMode, kCin, true, T><<<grid, kThreads, 0, st>>>(args, dx, dw_part, ag);
  } else {
    channel_walk<kMode, kCin, false, T><<<grid, kThreads, 0, st>>>(args, dx, dw_part, ag);
  }
  return cudaGetLastError();
}

template <int kMode, typename T>
cudaError_t launch_walk(const PdArgs<T>& args, T* dx, float* dw_part, cudaStream_t st) {
  if (args.Cin == 1) return launch_walk_at<kMode, 1>(args, dx, dw_part, st);
  if (args.Cin == 2) return launch_walk_at<kMode, 2>(args, dx, dw_part, st);
  return cudaErrorInvalidValue;
}

// The design code every entry point here takes (the wrapper's DESIGN_CODES:
// stats_design, stats_bwd_design, backward_design, layer_bwd_design): the
// narrow passes, the wide ones (S, S', C'), or the channel walk (S's
// "stream", S''s and B''s "fused"; Cin 1 or 2 only).
// kWgmmaDesign: the wide passes with passes 2 and 3 on wgmma + TMA (the
// bf16 S' and C' only, where wgmma_fits).  kWgmmaPDesign: pass 1 on wgmma
// too (pd_wgmma), S''s and C''s passes 2 and 3 as kWgmmaDesign's (bf16 S,
// S' and C' where wgmma_fits and a bias column covers whole tiles: group 0
// or >= 64).
enum Design {
  kNarrowDesign = 0,
  kWideDesign = 1,
  kWalkDesign = 2,
  kWgmmaDesign = 3,
  kWgmmaPDesign = 4
};

// cudaErrorInvalidValue for a design code that is none of these, a design
// the kernel does not have (`wide`, `walk`: whether it has the wide passes,
// the walk; `wgmma`, `wgmma_p`: whether the wgmma passes, the wgmma pass 1
// take this launch), or the walk at a Cin it does not take; else
// cudaSuccess.
inline cudaError_t check_design(int design, int Cin, bool wide, bool walk, bool wgmma = false,
                                bool wgmma_p = false) {
  if (design == kNarrowDesign || (design == kWideDesign && wide)) return cudaSuccess;
  if (design == kWgmmaDesign) return wide && wgmma ? cudaSuccess : cudaErrorInvalidValue;
  if (design == kWgmmaPDesign) return wgmma_p ? cudaSuccess : cudaErrorInvalidValue;
  return design == kWalkDesign && walk && (Cin == 1 || Cin == 2) ? cudaSuccess
                                                                  : cudaErrorInvalidValue;
}

template <typename T>
int stats_fwd(const void* x, const void* w, const void* pbias, void* s12,
              void* partial, void* wt, void* p_out, int B, int Cin, int Cout, int N, int group,
              int design, void* stream) {
  const bool wgmma_p = vnk_is_bf16<T>() && wgmma_fits(Cin, Cout, N, x, nullptr, nullptr) &&
                       (group == 0 || group >= kPts);
  if (check_design(design, Cin, true, true, false, wgmma_p) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || Cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PdArgs<T> args = make_args<T>(x, w, nullptr, pbias, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, partial, B, Cin, Cout, N, group, 0.f);
  cudaError_t err = cudaSuccess;
  if (design == kWgmmaPDesign) {
    if constexpr (vnk_is_bf16<T>())
      err = launch_pd_wgmma<kStatsFwd>(args, static_cast<T*>(wt), static_cast<T*>(p_out), st);
  } else if (design == kWideDesign) {
    err = launch_pd_wide<kStatsFwd>(args, static_cast<T*>(wt), st);
  } else if (design == kWalkDesign) {
    err = launch_walk<kStatsFwd>(args, static_cast<T*>(nullptr), nullptr, st);
  } else {
    launch_pd<kStatsFwd>(args, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  vnk_reduce_rows(args.partial, static_cast<float*>(s12), 2, B * args.T, Cout, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stats_bwd(const void* x, const void* w, const void* pbias, const void* c1,
              const void* c2, void* dx, void* dw, void* dpb, void* dp,
              void* partial, void* dw_part, void* wt, void* p_out, int B, int Cin, int Cout,
              int N, int S, int chunk, int group, int design, void* stream) {
  const bool wgmma = vnk_is_bf16<T>() && wgmma_fits(Cin, Cout, N, x, dp, nullptr);
  const bool wgmma_p = wgmma && (group == 0 || group >= kPts);
  if (check_design(design, Cin, true, true, wgmma, wgmma_p) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || Cout == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PdArgs<T> args = make_args<T>(x, w, nullptr, pbias, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, c1, c2, dp, nullptr, partial,
                                      B, Cin, Cout, N, group, 0.f);
  if (design == kWalkDesign) {  // dw_part: the weight partials (B, T, Cout, Cin)
    float* part = static_cast<float*>(dw_part);
    const cudaError_t err = launch_walk<kStatsBwd>(args, static_cast<T*>(dx), part, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (pbias != nullptr) reduce_bias(args, 0, 3, static_cast<float*>(dpb), st);
    vnk_reduce_rows(part, static_cast<float*>(dw), 1, B * args.T,
                    static_cast<int64_t>(Cout) * Cin, st);
  } else if (design == kWideDesign || design == kWgmmaDesign || design == kWgmmaPDesign) {
    cudaError_t err = cudaSuccess;
    if constexpr (vnk_is_bf16<T>()) {
      if (design == kWgmmaPDesign)
        err = launch_pd_wgmma<kStatsBwd>(args, static_cast<T*>(wt), static_cast<T*>(p_out), st);
      else
        err = launch_pd_wide<kStatsBwd>(args, static_cast<T*>(wt), st);
    } else {
      err = launch_pd_wide<kStatsBwd>(args, static_cast<T*>(wt), st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (pbias != nullptr) reduce_bias(args, 0, 3, static_cast<float*>(dpb), st);
    if constexpr (vnk_is_bf16<T>()) {
      if (design == kWgmmaDesign || design == kWgmmaPDesign)
        return static_cast<int>(products_wgmma<false>(
            args.x, static_cast<const T*>(wt), args.dp, nullptr, static_cast<T*>(dx),
            static_cast<float*>(dw), static_cast<float*>(dw_part), B, Cin, Cout, N, S, chunk, st));
    }
    err = products_wide<false>(args.x, args.w, nullptr, static_cast<const T*>(wt), args.dp,
                               static_cast<const T*>(nullptr), static_cast<T*>(dx),
                               static_cast<float*>(dw), static_cast<float*>(dw_part), B, Cin,
                               Cout, N, S, chunk, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    launch_pd<kStatsBwd>(args, st);
    if (pbias != nullptr) reduce_bias(args, 0, 3, static_cast<float*>(dpb), st);
    products_bwd<false>(args.x, args.w, nullptr, args.dp, static_cast<const T*>(nullptr),
                        static_cast<T*>(dx), static_cast<float*>(dw),
                        static_cast<float*>(dw_part), B, Cin, Cout, N, S, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// B' (w_out null, kLayerBwd) and C' (kProjBwd): nqc per-channel sums.
// `design` kWalkDesign takes B''s fused pass (Cin <= 2), kWideDesign C''s
// wide passes, kNarrowDesign the narrow ones.
template <int kMode, typename T>
int layer_bwd(const void* x, const void* w, const void* wd, const void* pbias,
              const void* dbias, const void* a, const void* b,
              const void* w_out, const void* g, void* dx, void* dw2,
              void* sums, void* dpdb, void* dp, void* dd, void* partial,
              void* dw_part, void* wt, void* pd_out, int B, int Cin, int Cout, int N, int S,
              int chunk, int group, int design, float one_minus_ns, void* stream) {
  const bool wgmma = vnk_is_bf16<T>() && wgmma_fits(Cin, Cout, N, x, dp, dd);
  const bool wgmma_p = kMode == kProjBwd && wgmma && (group == 0 || group >= kPts);
  if (check_design(design, Cin, kMode == kProjBwd, kMode == kLayerBwd, wgmma, wgmma_p) !=
      cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || Cout == 0) return 0;
  constexpr int nqc = channel_sums<kMode>();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PdArgs<T> args = make_args<T>(x, w, wd, pbias, dbias, a, b, w_out, g,
                                nullptr, nullptr, dp, dd, partial, B, Cin,
                                Cout, N, group, one_minus_ns);
  args.pd_out = static_cast<T*>(pd_out);
  if constexpr (kMode == kLayerBwd) {
    if (design == kWalkDesign) {
      float* part = static_cast<float*>(dw_part);
      const cudaError_t err = launch_walk<kMode>(args, static_cast<T*>(dx), part, st);
      if (err != cudaSuccess) return static_cast<int>(err);
      vnk_reduce_rows(args.partial, static_cast<float*>(sums), nqc, B * args.T, Cout, st);
      if (pbias != nullptr) reduce_bias(args, nqc, 6, static_cast<float*>(dpdb), st);
      vnk_reduce_rows(part, static_cast<float*>(dw2), 2, B * args.T,
                      static_cast<int64_t>(Cout) * Cin, st);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if constexpr (kMode == kProjBwd) {
    if (design == kWideDesign || design == kWgmmaDesign || design == kWgmmaPDesign) {
      cudaError_t err = cudaSuccess;
      if constexpr (vnk_is_bf16<T>()) {
        if (design == kWgmmaPDesign)
          err = launch_pd_wgmma<kMode>(args, static_cast<T*>(wt), nullptr, st);
        else
          err = launch_pd_wide<kMode>(args, static_cast<T*>(wt), st);
      } else {
        err = launch_pd_wide<kMode>(args, static_cast<T*>(wt), st);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      vnk_reduce_rows(args.partial, static_cast<float*>(sums), nqc, B * args.T, Cout, st);
      if (pbias != nullptr) reduce_bias(args, nqc, 6, static_cast<float*>(dpdb), st);
      if constexpr (vnk_is_bf16<T>()) {
        if (design == kWgmmaDesign || design == kWgmmaPDesign)
          return static_cast<int>(products_wgmma<true>(
              args.x, static_cast<const T*>(wt), args.dp, args.dd, static_cast<T*>(dx),
              static_cast<float*>(dw2), static_cast<float*>(dw_part), B, Cin, Cout, N, S, chunk,
              st));
      }
      err = products_wide<true>(args.x, args.w, args.wd, static_cast<const T*>(wt), args.dp,
                                args.dd, static_cast<T*>(dx), static_cast<float*>(dw2),
                                static_cast<float*>(dw_part), B, Cin, Cout, N, S, chunk, st);
      return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
    }
  }
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
// Each takes `design` (Design: 0 the narrow passes; 1 the wide ones, S, S'
// and C'; 2 the channel walk, S, S' and B' at Cin 1 or 2 only; 3 the wide
// passes with passes 2 and 3 on wgmma, bf16 S' and C' at Cin, Cout
// multiples of 64, N % 8 == 0 and 16-byte aligned x, dp, dd; 4 pass 1 on
// wgmma (and S''s and C''s passes 2 and 3 too), bf16 S, S' and C' there
// with bias columns of whole tiles; any other code, or a design the kernel
// lacks, returns cudaErrorInvalidValue); the wide passes take wt, a (1 or
// 2, Cin, Cout) scratch in the activations' type, and S' and C' `chunk`,
// the pass-3 stages (16 points float32, 32 bf16, 64 for the wgmma passes)
// of each of the S splits.

// S: s12 (2, Cout) = (s1, s2); partial with nq = 2; wt unused unless wide
// (a (Cin, Cout) scratch).  p_out (S and S'): null, or (B, 3, Cout, N)
// bf16 that the wgmma pass 1 (design 4) fills with p; the others leave it.
VNK_EXPORT int vn_layer_stats_fwd(const void* x, const void* w,
                                  const void* pbias, void* s12, void* partial,
                                  void* wt, void* p_out, int B, int Cin, int Cout, int N,
                                  int group, int design, void* stream) {
  return stats_fwd<float>(x, w, pbias, s12, partial, wt, p_out, B, Cin, Cout, N, group, design,
                          stream);
}

VNK_EXPORT int vn_layer_stats_fwd_bf16(const void* x, const void* w,
                                       const void* pbias, void* s12,
                                       void* partial, void* wt, void* p_out, int B, int Cin,
                                       int Cout, int N, int group, int design, void* stream) {
  return stats_fwd<vnk_bf16>(x, w, pbias, s12, partial, wt, p_out, B, Cin, Cout, N, group,
                             design, stream);
}

// S': dx (B, 3, Cin, N), dw (Cout, Cin), dpb (3, B, G, Cout) or null
// without bias; partial with nqc = 0, nqb = 3.  The walk takes no dp (null)
// and dw_part holds its weight partials (B, T, Cout, Cin).
VNK_EXPORT int vn_layer_stats_bwd(const void* x, const void* w,
                                  const void* pbias, const void* c1,
                                  const void* c2, void* dx, void* dw,
                                  void* dpb, void* dp, void* partial,
                                  void* dw_part, void* wt, void* p_out, int B, int Cin,
                                  int Cout, int N, int S, int chunk, int group, int design,
                                  void* stream) {
  return stats_bwd<float>(x, w, pbias, c1, c2, dx, dw, dpb, dp, partial, dw_part, wt, p_out,
                          B, Cin, Cout, N, S, chunk, group, design, stream);
}

VNK_EXPORT int vn_layer_stats_bwd_bf16(const void* x, const void* w,
                                       const void* pbias, const void* c1,
                                       const void* c2, void* dx, void* dw,
                                       void* dpb, void* dp, void* partial,
                                       void* dw_part, void* wt, void* p_out, int B,
                                       int Cin, int Cout, int N, int S, int chunk, int group,
                                       int design, void* stream) {
  return stats_bwd<vnk_bf16>(x, w, pbias, c1, c2, dx, dw, dpb, dp, partial, dw_part, wt,
                             p_out, B, Cin, Cout, N, S, chunk, group, design, stream);
}

// B': dx, dw2 (2, Cout, Cin) = (dW, dWd), dab (2, Cout) = (dA, dB),
// dpdb (6, B, G, Cout) = (dpbias planes, ddbias planes) or null; partial
// with nqc = 2, nqb = 6.  The walk (the wrapper's layer_bwd_design
// "fused"; Cin <= 2 only) takes no dp, dd (null), and dw_part holds the
// weight partials (2, B, T, Cout, Cin); the narrow passes dw_part (2, S,
// Cout, Cin).
VNK_EXPORT int vn_layer_fused_bwd(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* g, void* dx,
    void* dw2, void* dab, void* dpdb, void* dp, void* dd, void* partial,
    void* dw_part, int B, int Cin, int Cout, int N, int S, int group, int design,
    float one_minus_ns, void* stream) {
  return layer_bwd<kLayerBwd, float>(x, w, wd, pbias, dbias, a, b, nullptr, g, dx,
                                     dw2, dab, dpdb, dp, dd, partial, dw_part, nullptr,
                                     nullptr, B, Cin, Cout, N, S, 0, group, design, one_minus_ns,
                                     stream);
}

VNK_EXPORT int vn_layer_fused_bwd_bf16(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* g, void* dx,
    void* dw2, void* dab, void* dpdb, void* dp, void* dd, void* partial,
    void* dw_part, int B, int Cin, int Cout, int N, int S, int group, int design,
    float one_minus_ns, void* stream) {
  return layer_bwd<kLayerBwd, vnk_bf16>(x, w, wd, pbias, dbias, a, b, nullptr, g,
                                        dx, dw2, dab, dpdb, dp, dd, partial,
                                        dw_part, nullptr, nullptr, B, Cin, Cout, N, S, 0, group,
                                        design, one_minus_ns, stream);
}

// C': as B' with w_out (Cout,) and g (B, 3, 1, N); dabo (3, Cout) =
// (dA, dB, dw_out); partial with nqc = 3, nqb = 6.  pd_out: null, or
// (2, B, 3, Cout, N) in the activations' type that every design's pass 1
// fills with the p and d its epilogue backward reads (tests hold them to
// kernel C's pd_out).
VNK_EXPORT int vn_layer_fused_project_bwd(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    const void* g, void* dx, void* dw2, void* dabo, void* dpdb, void* dp,
    void* dd, void* partial, void* dw_part, void* wt, void* pd_out, int B, int Cin, int Cout,
    int N, int S, int chunk, int group, int design, float one_minus_ns, void* stream) {
  return layer_bwd<kProjBwd, float>(x, w, wd, pbias, dbias, a, b, w_out, g, dx,
                                    dw2, dabo, dpdb, dp, dd, partial, dw_part, wt, pd_out, B, Cin,
                                    Cout, N, S, chunk, group, design, one_minus_ns, stream);
}

VNK_EXPORT int vn_layer_fused_project_bwd_bf16(
    const void* x, const void* w, const void* wd, const void* pbias,
    const void* dbias, const void* a, const void* b, const void* w_out,
    const void* g, void* dx, void* dw2, void* dabo, void* dpdb, void* dp,
    void* dd, void* partial, void* dw_part, void* wt, void* pd_out, int B, int Cin, int Cout,
    int N, int S, int chunk, int group, int design, float one_minus_ns, void* stream) {
  return layer_bwd<kProjBwd, vnk_bf16>(x, w, wd, pbias, dbias, a, b, w_out, g,
                                       dx, dw2, dabo, dpdb, dp, dd, partial,
                                       dw_part, wt, pd_out, B, Cin, Cout, N, S, chunk,
                                       group, design, one_minus_ns, stream);
}
