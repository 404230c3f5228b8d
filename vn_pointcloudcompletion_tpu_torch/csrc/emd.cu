// Kernel E: the ten annealing rounds of the approximate Earth Mover's
// Distance (Fan's soft matching) without ever holding the (N, M) match:
// the cost per sample and the match moments s_n, t_n, s_m, t_m that its
// gradient needs.
//
// Replaces vn_pointcloudcompletion_tpu/ops/emd_pallas.py::emd_rounds_pallas
// (the pallas_call at :304, kernel body _kernel at :151), itself the fused
// form of ops/emd.py::_emd_blocked_impl.  Per round, with
// w_ij = exp(level * d_ij) and d_ij the squared distance of x1_i and x2_j:
//   supply   ratio_l_i = remain_l_i / (sum_j w_ij remain_r_j + 1e-9)
//   columns  z_j = sum_i w_ij [ratio_l_i, ratio_l_i x1_i]
//            sumr = z_j0 remain_r_j
//            ratio_r_j = min(remain_r_j / (sumr + 1e-9), 1) remain_r_j
//            remain_r_j = max(0, remain_r_j - sumr); s_m, t_m += ratio_r_j z_j
//   rows     y_i = sum_j w_ij [ratio_r_j, ratio_r_j x2_j]
//            cost_i += ratio_l_i sum_j w_ij d_ij ratio_r_j
//            s_n, t_n += ratio_l_i y_i; remain_l_i = max(0, remain_l_i - ratio_l_i y_i0)
// at levels -4^7, -4^6, ..., -4^-1, 0, capacities by integer ratio
// (n // m).  Only the n and m real points are visited: the JAX kernel's
// padding only gives zero supply to points that do not exist.
//
// Design.  One thread per row (row passes) or per column (column pass), the
// other cloud streamed through shared memory in tiles of kTile points, one
// launch per pass over the whole batch (blockIdx.y is the sample).  The row
// pass of round r also sums round r+1's supply from the same distances (the
// TPU kernel's "C+A merge"), so a round is two passes and the call 21, plus
// one launch that sets the state and one that sums the cost rows.  Bound on
// the H100: operations, about 438 FP32 operations and 30 exps per pair over
// the ten rounds (chip_smoke.py counts them).
//
// Exactness.  The level -4^7 = -16384 amplifies any error in d, so the row
// and column passes must see the same bits for d_ij: both compute it in the
// difference form (x1 - x2)^2 summed over the coordinates in order, rounded
// after every operation (the file is built with --fmad=false), from the same
// float32 coordinates.  exp is expf (no fast-math, subnormals kept).  Every
// sum over points is a per-thread sum in a fixed order, in chunks of kChunk
// terms summed apart and then joined (one running sum over 16384 terms
// would carry ~16384 roundings, the plain version's tree reductions a few
// dozen), or, for the cost over rows, a block sum: no atomics, and a second
// call gives the same bits.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;   // points of the other cloud per shared-memory tile
constexpr int kChunk = 64;    // terms summed apart before joining a running sum
constexpr int kRounds = 10;

// d(x1_i, x2_j) in the difference form; a is the x1 point, b the x2 point.
__device__ __forceinline__ float pair_d(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = ax - bx;
  const float dy = ay - by;
  const float dz = az - bz;
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(kThreads)
emd_init(float* __restrict__ remain_l, float* __restrict__ remain_r,
         float* __restrict__ costrow, float* __restrict__ s_n,
         float* __restrict__ t_n, float* __restrict__ s_m,
         float* __restrict__ t_m, int64_t rows, int64_t cols, float multi_l,
         float multi_r) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = blockIdx.x * kThreads + threadIdx.x; e < rows; e += stride) {
    remain_l[e] = multi_l;
    costrow[e] = 0.f;
    s_n[e] = 0.f;
    t_n[3 * e] = t_n[3 * e + 1] = t_n[3 * e + 2] = 0.f;
  }
  for (int64_t e = blockIdx.x * kThreads + threadIdx.x; e < cols; e += stride) {
    remain_r[e] = multi_r;
    s_m[e] = 0.f;
    t_m[3 * e] = t_m[3 * e + 1] = t_m[3 * e + 2] = 0.f;
  }
}

// A row pass, one thread per row i of x1.  kMode 0: round 0's supply only;
// 1: this round's row moments and cost, and the next round's supply; 2: the
// last round's row moments and cost.  remain_r holds the value after this
// round's column pass (the next round's capacities), u4 this round's
// [ratio_r, ratio_r x2]; v4 holds this round's [ratio_l, ratio_l x1] and
// receives the next round's.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
emd_rows(const float* __restrict__ x1, const float* __restrict__ x2,
         const float* __restrict__ remain_r, const float4* __restrict__ u4,
         float* __restrict__ remain_l, float4* __restrict__ v4,
         float* __restrict__ costrow, float* __restrict__ s_n,
         float* __restrict__ t_n, int N, int M, float level, float level_next) {
  __shared__ float4 xs[kTile];  // x2 and remain_r
  __shared__ float4 us[kTile];  // u4
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool ok = i < N;
  const int64_t row = static_cast<int64_t>(b) * N + i;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (ok) {
    ax = x1[3 * row];
    ay = x1[3 * row + 1];
    az = x1[3 * row + 2];
  }
  const float* x2b = x2 + static_cast<int64_t>(b) * M * 3;
  const float* rrb = remain_r + static_cast<int64_t>(b) * M;
  const float4* u4b = u4 + static_cast<int64_t>(b) * M;

  float sup = 0.f, y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f, c = 0.f;
  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int cnt = min(kTile, M - m0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const float* p = x2b + static_cast<int64_t>(m0 + e) * 3;
      xs[e] = make_float4(p[0], p[1], p[2], rrb[m0 + e]);
      if (kMode > 0) us[e] = u4b[m0 + e];
    }
    __syncthreads();
    for (int c0 = 0; c0 < cnt; c0 += kChunk) {
      const int c1 = min(cnt, c0 + kChunk);
      float lsup = 0.f, l0 = 0.f, l1 = 0.f, l2 = 0.f, l3 = 0.f, lc = 0.f;
#pragma unroll 4
      for (int e = c0; e < c1; ++e) {
        const float4 v = xs[e];
        const float d = pair_d(ax, ay, az, v.x, v.y, v.z);
        const float w = expf(level * d);
        if (kMode == 0) {
          lsup = fmaf(w, v.w, lsup);
        } else {
          const float4 u = us[e];
          l0 = fmaf(w, u.x, l0);
          l1 = fmaf(w, u.y, l1);
          l2 = fmaf(w, u.z, l2);
          l3 = fmaf(w, u.w, l3);
          lc = fmaf(w * d, u.x, lc);
          if (kMode == 1) lsup = fmaf(expf(level_next * d), v.w, lsup);
        }
      }
      sup += lsup;
      y0 += l0;
      y1 += l1;
      y2 += l2;
      y3 += l3;
      c += lc;
    }
  }
  if (!ok) return;

  float rem = remain_l[row];
  if (kMode > 0) {
    const float rl = v4[row].x;
    costrow[row] = costrow[row] + rl * c;
    s_n[row] = s_n[row] + rl * y0;
    t_n[3 * row] = t_n[3 * row] + rl * y1;
    t_n[3 * row + 1] = t_n[3 * row + 1] + rl * y2;
    t_n[3 * row + 2] = t_n[3 * row + 2] + rl * y3;
    rem = fmaxf(0.f, rem - rl * y0);
    remain_l[row] = rem;
  }
  if (kMode < 2) {
    const float rl = rem / (sup + 1e-9f);
    v4[row] = make_float4(rl, rl * ax, rl * ay, rl * az);
  }
}

// The column pass, one thread per column j of x2: z_j from this round's v4,
// then the column's capacity update, its moments and its u4.
__global__ void __launch_bounds__(kThreads)
emd_cols(const float* __restrict__ x1, const float4* __restrict__ v4,
         const float* __restrict__ x2, float* __restrict__ remain_r,
         float4* __restrict__ u4, float* __restrict__ s_m,
         float* __restrict__ t_m, int N, int M, float level) {
  __shared__ float4 xs[kTile];  // x1
  __shared__ float4 vs[kTile];  // v4
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool ok = j < M;
  const int64_t col = static_cast<int64_t>(b) * M + j;
  float bx = 0.f, by = 0.f, bz = 0.f;
  if (ok) {
    bx = x2[3 * col];
    by = x2[3 * col + 1];
    bz = x2[3 * col + 2];
  }
  const float* x1b = x1 + static_cast<int64_t>(b) * N * 3;
  const float4* v4b = v4 + static_cast<int64_t>(b) * N;

  float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int cnt = min(kTile, N - n0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const float* p = x1b + static_cast<int64_t>(n0 + e) * 3;
      xs[e] = make_float4(p[0], p[1], p[2], 0.f);
      vs[e] = v4b[n0 + e];
    }
    __syncthreads();
    for (int c0 = 0; c0 < cnt; c0 += kChunk) {
      const int c1 = min(cnt, c0 + kChunk);
      float l0 = 0.f, l1 = 0.f, l2 = 0.f, l3 = 0.f;
#pragma unroll 4
      for (int e = c0; e < c1; ++e) {
        const float4 a = xs[e];
        const float4 v = vs[e];
        const float w = expf(level * pair_d(a.x, a.y, a.z, bx, by, bz));
        l0 = fmaf(w, v.x, l0);
        l1 = fmaf(w, v.y, l1);
        l2 = fmaf(w, v.z, l2);
        l3 = fmaf(w, v.w, l3);
      }
      z0 += l0;
      z1 += l1;
      z2 += l2;
      z3 += l3;
    }
  }
  if (!ok) return;

  const float rr = remain_r[col];
  const float sumr = z0 * rr;
  const float ratio_r = fminf(rr / (sumr + 1e-9f), 1.f) * rr;
  remain_r[col] = fmaxf(0.f, rr - sumr);
  s_m[col] = s_m[col] + ratio_r * z0;
  t_m[3 * col] = t_m[3 * col] + ratio_r * z1;
  t_m[3 * col + 1] = t_m[3 * col + 1] + ratio_r * z2;
  t_m[3 * col + 2] = t_m[3 * col + 2] + ratio_r * z3;
  u4[col] = make_float4(ratio_r, ratio_r * bx, ratio_r * by, ratio_r * bz);
}

// cost[b] = sum_i costrow[b, i]: per-thread strided sums, then a tree in
// shared memory, one block per sample.
__global__ void __launch_bounds__(kThreads)
emd_cost_sum(const float* __restrict__ costrow, float* __restrict__ cost, int N) {
  __shared__ float red[kThreads];
  const float* base = costrow + static_cast<int64_t>(blockIdx.x) * N;
  float s = 0.f;
  for (int i = threadIdx.x; i < N; i += kThreads) s += base[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) cost[blockIdx.x] = red[0];
}

}  // namespace

// x1: (B, N, 3), x2: (B, M, 3) float32 -> cost (B,), s_n (B, N), t_n
// (B, N, 3), s_m (B, M), t_m (B, M, 3).  scratch: 5 B N + 5 B M floats,
// 16-byte aligned (v4, u4, remain_l, remain_r, costrow).
VNK_EXPORT int emd_rounds(const void* x1v, const void* x2v, void* costv,
                          void* s_nv, void* t_nv, void* s_mv, void* t_mv,
                          void* scratchv, int B, int N, int M, void* streamv) {
  if (B == 0 || N == 0 || M == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(streamv);
  const float* x1 = static_cast<const float*>(x1v);
  const float* x2 = static_cast<const float*>(x2v);
  float* s_n = static_cast<float*>(s_nv);
  float* t_n = static_cast<float*>(t_nv);
  float* s_m = static_cast<float*>(s_mv);
  float* t_m = static_cast<float*>(t_mv);
  const int64_t rows = static_cast<int64_t>(B) * N;
  const int64_t cols = static_cast<int64_t>(B) * M;
  float* scratch = static_cast<float*>(scratchv);
  float4* v4 = reinterpret_cast<float4*>(scratch);
  float4* u4 = reinterpret_cast<float4*>(scratch + 4 * rows);
  float* remain_l = scratch + 4 * rows + 4 * cols;
  float* remain_r = remain_l + rows;
  float* costrow = remain_r + cols;

  // capacities by integer ratio (emd_kernel.cu:29-35 of the reference)
  const float multi_l = N >= M ? 1.f : static_cast<float>(M / N);
  const float multi_r = N >= M ? static_cast<float>(N / M) : 1.f;
  float levels[kRounds];
  for (int r = 0; r < kRounds - 1; ++r) levels[r] = -static_cast<float>(ldexp(1.0, 2 * (7 - r)));
  levels[kRounds - 1] = 0.f;

  cudaError_t err;
  const int64_t most_blocks = ((rows > cols ? rows : cols) + kThreads - 1) / kThreads;
  const unsigned init_blocks = static_cast<unsigned>(most_blocks < 4096 ? most_blocks : 4096);
  emd_init<<<init_blocks, kThreads, 0, stream>>>(remain_l, remain_r, costrow, s_n, t_n,
                                                 s_m, t_m, rows, cols, multi_l, multi_r);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 row_grid((N + kThreads - 1) / kThreads, B);
  const dim3 col_grid((M + kThreads - 1) / kThreads, B);
  emd_rows<0><<<row_grid, kThreads, 0, stream>>>(x1, x2, remain_r, u4, remain_l, v4, costrow,
                                                 s_n, t_n, N, M, levels[0], 0.f);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int r = 0; r < kRounds; ++r) {
    emd_cols<<<col_grid, kThreads, 0, stream>>>(x1, v4, x2, remain_r, u4, s_m, t_m, N, M,
                                                levels[r]);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (r + 1 < kRounds) {
      emd_rows<1><<<row_grid, kThreads, 0, stream>>>(x1, x2, remain_r, u4, remain_l, v4,
                                                     costrow, s_n, t_n, N, M, levels[r],
                                                     levels[r + 1]);
    } else {
      emd_rows<2><<<row_grid, kThreads, 0, stream>>>(x1, x2, remain_r, u4, remain_l, v4,
                                                     costrow, s_n, t_n, N, M, levels[r], 0.f);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  emd_cost_sum<<<B, kThreads, 0, stream>>>(costrow, static_cast<float*>(costv), N);
  return static_cast<int>(cudaGetLastError());
}
