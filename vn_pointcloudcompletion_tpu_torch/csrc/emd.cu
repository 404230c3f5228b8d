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
// Bound on the H100: operations, about 438 FP32 operations a pair over the
// ten rounds as the algorithm counts them (chip_smoke.py EMD_OPS_PER_PAIR).
// The kernel is bound by instruction issue, one warp instruction a clock on
// each of an SM's four schedulers, so its design counts issue slots a pair:
//   - w = 2^(c d), c = level * log2(e) (level is a power of two, so c is
//     log2(e) rounded once and scaled exactly), on the SFU's ex2.approx:
//     a multiply and one MUFU where expf takes about eight instructions;
//   - d = fma(dz, dz, fma(dy, dy, dx * dx)): six instructions, not eight;
//   - kR = 2 points of a pass's own cloud a thread, so one pair of
//     shared-memory float4 reads of the other cloud serves two pairs.
// That is ~14 slots a pair in a column pass and ~18 in a row pass (two
// exponentials: this round's weight and the next round's supply), ~330 a
// pair over the call against the old design's ~580.  kR = 2 halves the
// threads, so each pass also splits the other cloud into S spans (one
// block per (own tile, span, sample)), S chosen on the host so that the
// blocks fill whole waves of the card's resident blocks (at 14336 points
// one block a thread-row of 256 left the last wave 85% full); each block
// writes one partial per point and quantity, and a second launch (the
// "done" kernels) sums the S partials in span order and runs the pass's
// epilogue.
//
// Exactness.  The level -4^7 = -16384 amplifies any error in d, so the row
// and column passes must see the same bits for d_ij and w_ij: both call
// pair_d and weight on the same float32 coordinates and the same c.  Round
// r's row pass sums round r + 1's supply with weight(c_{r+1}, d), which is
// what round r + 1's column pass computes.  Weights below the SFU's normal
// range (2^-126) flush to zero: they vanish under the 1e-9 of every ratio.
// Every sum over points is a per-thread sum in a fixed order, in chunks of
// kChunk terms summed apart and then joined (one running sum over 16384
// terms would carry ~16384 roundings, the plain version's tree reductions a
// few dozen), the S span partials joined in span order, or, for the cost
// over rows, a block sum: no atomics, and a second call on the same card
// gives the same bits (S depends on the card's SM count and the kernels'
// occupancy only).
#include <math.h>

#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kR = 2;         // points of a pass's own cloud a thread
constexpr int kTile = 1024;   // points of the other cloud per shared-memory tile
constexpr int kChunk = 64;    // terms summed apart before joining a running sum
constexpr int kRounds = 10;
constexpr int kMaxSplits = 8;   // spans of the other cloud (the wrapper sizes the partials)
constexpr int kMinSpan = 256;   // the fewest points of the other cloud a span takes
constexpr float kLog2e = 1.4426950408889634f;

// d(x1_i, x2_j) in the difference form; a is the x1 point, b the x2 point.
__device__ __forceinline__ float pair_d(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = ax - bx;
  const float dy = ay - by;
  const float dz = az - bz;
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

// exp(level d) as 2^(c d), c = level log2(e), on the SFU.
__device__ __forceinline__ float weight(float c, float d) {
  float w;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(w) : "f"(c * d));
  return w;
}

// Quantities a pass sums per point: row passes y0..y3, cost (and the next
// supply) or, in kMode 0, the supply alone; column passes z0..z3.
template <int kMode>
__host__ __device__ constexpr int row_sums() {
  return kMode == 0 ? 1 : kMode == 1 ? 6 : 5;
}
constexpr int kColSums = 4;

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

// A row pass over span blockIdx.y of x2 (points lo .. hi - 1), kR rows of
// x1 a thread (rows i0 + k * kThreads).  kMode 0: round 0's supply only;
// 1: this round's row moments and cost, and the next round's supply; 2:
// the last round's row moments and cost.  remain_r holds the value after
// this round's column pass (the next round's capacities), u4 this round's
// [ratio_r, ratio_r x2].  Writes part[q][span][b * N + i].
template <int kMode>
__global__ void __launch_bounds__(kThreads)
emd_rows(const float* __restrict__ x1, const float* __restrict__ x2,
         const float* __restrict__ remain_r, const float4* __restrict__ u4,
         float* __restrict__ part, int N, int M, int span, float c, float c_next) {
  constexpr int kQ = row_sums<kMode>();
  __shared__ float4 xs[kTile];  // x2 and remain_r
  __shared__ float4 us[kTile];  // u4
  const int b = blockIdx.z, s = blockIdx.y;
  const int lo = s * span, hi = min(M, lo + span);
  const int i0 = blockIdx.x * (kThreads * kR) + threadIdx.x;
  float ax[kR], ay[kR], az[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int i = i0 + k * kThreads;
    const int64_t row = static_cast<int64_t>(b) * N + min(i, N - 1);
    ax[k] = x1[3 * row];
    ay[k] = x1[3 * row + 1];
    az[k] = x1[3 * row + 2];
  }
  const float* x2b = x2 + static_cast<int64_t>(b) * M * 3;
  const float* rrb = remain_r + static_cast<int64_t>(b) * M;
  const float4* u4b = u4 + static_cast<int64_t>(b) * M;

  float acc[kR][kQ];
#pragma unroll
  for (int k = 0; k < kR; ++k)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[k][q] = 0.f;
  for (int m0 = lo; m0 < hi; m0 += kTile) {
    const int cnt = min(kTile, hi - m0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const float* p = x2b + static_cast<int64_t>(m0 + e) * 3;
      xs[e] = make_float4(p[0], p[1], p[2], rrb[m0 + e]);
      if (kMode > 0) us[e] = u4b[m0 + e];
    }
    __syncthreads();
    for (int c0 = 0; c0 < cnt; c0 += kChunk) {
      const int c1 = min(cnt, c0 + kChunk);
      float l[kR][kQ];
#pragma unroll
      for (int k = 0; k < kR; ++k)
#pragma unroll
        for (int q = 0; q < kQ; ++q) l[k][q] = 0.f;
#pragma unroll 4
      for (int e = c0; e < c1; ++e) {
        const float4 v = xs[e];
        float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kMode > 0) u = us[e];
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const float d = pair_d(ax[k], ay[k], az[k], v.x, v.y, v.z);
          if (kMode == 0) {
            l[k][0] = fmaf(weight(c, d), v.w, l[k][0]);
          } else {
            const float w = weight(c, d);
            l[k][0] = fmaf(w, u.x, l[k][0]);
            l[k][1] = fmaf(w, u.y, l[k][1]);
            l[k][2] = fmaf(w, u.z, l[k][2]);
            l[k][3] = fmaf(w, u.w, l[k][3]);
            l[k][4] = fmaf(w * d, u.x, l[k][4]);
            if (kMode == 1) l[k][5] = fmaf(weight(c_next, d), v.w, l[k][5]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kR; ++k)
#pragma unroll
        for (int q = 0; q < kQ; ++q) acc[k][q] += l[k][q];
    }
  }
  const int64_t plane = static_cast<int64_t>(gridDim.z) * N;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int i = i0 + k * kThreads;
    if (i >= N) continue;
    float* dst = part + static_cast<int64_t>(s) * plane + static_cast<int64_t>(b) * N + i;
#pragma unroll
    for (int q = 0; q < kQ; ++q) dst[q * gridDim.y * plane] = acc[k][q];
  }
}

// The sum of quantity q of one point over the S span partials, in span order.
__device__ __forceinline__ float span_total(const float* __restrict__ part, int q, int S,
                                            int64_t plane, int64_t at) {
  const float* p = part + static_cast<int64_t>(q) * S * plane + at;
  float v = p[0];
  for (int s = 1; s < S; ++s) v += p[s * plane];
  return v;
}

// The row epilogue, one thread per row of the B * N: the row moments and
// cost of this round (kMode > 0), and the next round's [ratio_l, ratio_l
// x1] into v4 (kMode < 2).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
emd_rows_done(const float* __restrict__ part, int S, const float* __restrict__ x1,
              float* __restrict__ remain_l, float4* __restrict__ v4,
              float* __restrict__ costrow, float* __restrict__ s_n,
              float* __restrict__ t_n, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  float rem = remain_l[row];
  if (kMode > 0) {
    const float y0 = span_total(part, 0, S, rows, row);
    const float rl = v4[row].x;
    costrow[row] = costrow[row] + rl * span_total(part, 4, S, rows, row);
    s_n[row] = s_n[row] + rl * y0;
    t_n[3 * row] = t_n[3 * row] + rl * span_total(part, 1, S, rows, row);
    t_n[3 * row + 1] = t_n[3 * row + 1] + rl * span_total(part, 2, S, rows, row);
    t_n[3 * row + 2] = t_n[3 * row + 2] + rl * span_total(part, 3, S, rows, row);
    rem = fmaxf(0.f, rem - rl * y0);
    remain_l[row] = rem;
  }
  if (kMode < 2) {
    const float sup = span_total(part, kMode == 0 ? 0 : 5, S, rows, row);
    const float rl = rem / (sup + 1e-9f);
    v4[row] = make_float4(rl, rl * x1[3 * row], rl * x1[3 * row + 1], rl * x1[3 * row + 2]);
  }
}

// The column pass over span blockIdx.y of x1, kR columns of x2 a thread:
// z_j from this round's v4.  Writes part[q][span][b * M + j].
__global__ void __launch_bounds__(kThreads)
emd_cols(const float* __restrict__ x1, const float4* __restrict__ v4,
         const float* __restrict__ x2, float* __restrict__ part, int N, int M, int span,
         float c) {
  __shared__ float4 xs[kTile];  // x1
  __shared__ float4 vs[kTile];  // v4
  const int b = blockIdx.z, s = blockIdx.y;
  const int lo = s * span, hi = min(N, lo + span);
  const int j0 = blockIdx.x * (kThreads * kR) + threadIdx.x;
  float bx[kR], by[kR], bz[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int64_t col = static_cast<int64_t>(b) * M + min(j0 + k * kThreads, M - 1);
    bx[k] = x2[3 * col];
    by[k] = x2[3 * col + 1];
    bz[k] = x2[3 * col + 2];
  }
  const float* x1b = x1 + static_cast<int64_t>(b) * N * 3;
  const float4* v4b = v4 + static_cast<int64_t>(b) * N;

  float acc[kR][kColSums];
#pragma unroll
  for (int k = 0; k < kR; ++k)
#pragma unroll
    for (int q = 0; q < kColSums; ++q) acc[k][q] = 0.f;
  for (int n0 = lo; n0 < hi; n0 += kTile) {
    const int cnt = min(kTile, hi - n0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const float* p = x1b + static_cast<int64_t>(n0 + e) * 3;
      xs[e] = make_float4(p[0], p[1], p[2], 0.f);
      vs[e] = v4b[n0 + e];
    }
    __syncthreads();
    for (int c0 = 0; c0 < cnt; c0 += kChunk) {
      const int c1 = min(cnt, c0 + kChunk);
      float l[kR][kColSums];
#pragma unroll
      for (int k = 0; k < kR; ++k)
#pragma unroll
        for (int q = 0; q < kColSums; ++q) l[k][q] = 0.f;
#pragma unroll 4
      for (int e = c0; e < c1; ++e) {
        const float4 a = xs[e];
        const float4 v = vs[e];
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const float w = weight(c, pair_d(a.x, a.y, a.z, bx[k], by[k], bz[k]));
          l[k][0] = fmaf(w, v.x, l[k][0]);
          l[k][1] = fmaf(w, v.y, l[k][1]);
          l[k][2] = fmaf(w, v.z, l[k][2]);
          l[k][3] = fmaf(w, v.w, l[k][3]);
        }
      }
#pragma unroll
      for (int k = 0; k < kR; ++k)
#pragma unroll
        for (int q = 0; q < kColSums; ++q) acc[k][q] += l[k][q];
    }
  }
  const int64_t plane = static_cast<int64_t>(gridDim.z) * M;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int j = j0 + k * kThreads;
    if (j >= M) continue;
    float* dst = part + static_cast<int64_t>(s) * plane + static_cast<int64_t>(b) * M + j;
#pragma unroll
    for (int q = 0; q < kColSums; ++q) dst[q * gridDim.y * plane] = acc[k][q];
  }
}

// The column epilogue, one thread per column of the B * M: the capacity
// update, the column moments and this round's u4.
__global__ void __launch_bounds__(kThreads)
emd_cols_done(const float* __restrict__ part, int S, const float* __restrict__ x2,
              float* __restrict__ remain_r, float4* __restrict__ u4,
              float* __restrict__ s_m, float* __restrict__ t_m, int64_t cols) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= cols) return;
  const float z0 = span_total(part, 0, S, cols, col);
  const float rr = remain_r[col];
  const float sumr = z0 * rr;
  const float ratio_r = fminf(rr / (sumr + 1e-9f), 1.f) * rr;
  remain_r[col] = fmaxf(0.f, rr - sumr);
  s_m[col] = s_m[col] + ratio_r * z0;
  t_m[3 * col] = t_m[3 * col] + ratio_r * span_total(part, 1, S, cols, col);
  t_m[3 * col + 1] = t_m[3 * col + 1] + ratio_r * span_total(part, 2, S, cols, col);
  t_m[3 * col + 2] = t_m[3 * col + 2] + ratio_r * span_total(part, 3, S, cols, col);
  u4[col] = make_float4(ratio_r, ratio_r * x2[3 * col], ratio_r * x2[3 * col + 1],
                        ratio_r * x2[3 * col + 2]);
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

// Spans of a pass's other cloud (len points) for `tiles` blocks a span: the
// fewest that fill the most of their last wave of `slots` resident blocks
// (a larger count must fill 2% more), at most kMaxSplits and no span under
// kMinSpan points.  Returns the span's length in points (a multiple of
// kChunk); the count is ceil(len / span).
int split_span(int64_t tiles, int len, int slots) {
  const int most = std::max(1, std::min(kMaxSplits, len / kMinSpan));
  auto fill = [&](int s) {
    const double waves = static_cast<double>(tiles * s) / std::max(slots, 1);
    return waves / std::ceil(waves);
  };
  int best = 1;
  for (int s = 2; s <= most; ++s)
    if (fill(s) > fill(best) + 0.02) best = s;
  const int span = (len + best - 1) / best;
  return (span + kChunk - 1) / kChunk * kChunk;
}

}  // namespace

// x1: (B, N, 3), x2: (B, M, 3) float32 -> cost (B,), s_n (B, N), t_n
// (B, N, 3), s_m (B, M), t_m (B, M, 3).  scratch: 5 B N + 5 B M floats,
// 16-byte aligned (v4, u4, remain_l, remain_r, costrow), then the span
// partials, 6 * kMaxSplits * B * max(N, M) floats.
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
  float* part = costrow + rows;

  // capacities by integer ratio (emd_kernel.cu:29-35 of the reference)
  const float multi_l = N >= M ? 1.f : static_cast<float>(M / N);
  const float multi_r = N >= M ? static_cast<float>(N / M) : 1.f;
  float c[kRounds];  // level * log2(e), levels -4^7 .. -4^-1, 0
  for (int r = 0; r < kRounds - 1; ++r)
    c[r] = -static_cast<float>(ldexp(1.0, 2 * (7 - r))) * kLog2e;
  c[kRounds - 1] = 0.f;

  // the grids: kR * kThreads points of the pass's own cloud a block, the
  // other cloud in spans
  const int row_tiles = (N + kR * kThreads - 1) / (kR * kThreads);
  const int col_tiles = (M + kR * kThreads - 1) / (kR * kThreads);
  const int row_span = split_span(
      static_cast<int64_t>(row_tiles) * B, M,
      vnk_resident_blocks(reinterpret_cast<const void*>(emd_rows<1>), kThreads, 0));
  const int col_span = split_span(
      static_cast<int64_t>(col_tiles) * B, N,
      vnk_resident_blocks(reinterpret_cast<const void*>(emd_cols), kThreads, 0));
  const int row_splits = (M + row_span - 1) / row_span;
  const int col_splits = (N + col_span - 1) / col_span;
  const dim3 row_grid(row_tiles, row_splits, B), col_grid(col_tiles, col_splits, B);
  const unsigned row_done = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  const unsigned col_done = static_cast<unsigned>((cols + kThreads - 1) / kThreads);

  cudaError_t err;
  const int64_t most_blocks = ((rows > cols ? rows : cols) + kThreads - 1) / kThreads;
  const unsigned init_blocks = static_cast<unsigned>(most_blocks < 4096 ? most_blocks : 4096);
  emd_init<<<init_blocks, kThreads, 0, stream>>>(remain_l, remain_r, costrow, s_n, t_n,
                                                 s_m, t_m, rows, cols, multi_l, multi_r);
  emd_rows<0><<<row_grid, kThreads, 0, stream>>>(x1, x2, remain_r, u4, part, N, M, row_span,
                                                 c[0], 0.f);
  emd_rows_done<0><<<row_done, kThreads, 0, stream>>>(part, row_splits, x1, remain_l, v4,
                                                      costrow, s_n, t_n, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int r = 0; r < kRounds; ++r) {
    emd_cols<<<col_grid, kThreads, 0, stream>>>(x1, v4, x2, part, N, M, col_span, c[r]);
    emd_cols_done<<<col_done, kThreads, 0, stream>>>(part, col_splits, x2, remain_r, u4, s_m,
                                                     t_m, cols);
    if (r + 1 < kRounds) {
      emd_rows<1><<<row_grid, kThreads, 0, stream>>>(x1, x2, remain_r, u4, part, N, M,
                                                     row_span, c[r], c[r + 1]);
      emd_rows_done<1><<<row_done, kThreads, 0, stream>>>(part, row_splits, x1, remain_l, v4,
                                                          costrow, s_n, t_n, rows);
    } else {
      emd_rows<2><<<row_grid, kThreads, 0, stream>>>(x1, x2, remain_r, u4, part, N, M,
                                                     row_span, c[r], 0.f);
      emd_rows_done<2><<<row_done, kThreads, 0, stream>>>(part, row_splits, x1, remain_l, v4,
                                                          costrow, s_n, t_n, rows);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  emd_cost_sum<<<B, kThreads, 0, stream>>>(costrow, static_cast<float*>(costv), N);
  return static_cast<int>(cudaGetLastError());
}
