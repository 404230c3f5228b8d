// Kernel D: exact nearest neighbour (squared distance and index) of every
// point of each cloud in the other, both chamfer directions in one sweep.
//
// Replaces vn_pointcloudcompletion_tpu/ops/chamfer_pallas_bidir.py
// ::nn_bidirectional_pallas (the pallas_call at :159, kernel body
// _bidir_kernel at :54).  Like the TPU kernel it computes each distance
// (x_n, y_m) once and updates both minima from it: the row minimum of x_n and
// the column minimum of y_m.  The TPU carries the column minima across a
// sequential grid axis; Hopper runs blocks in no order, so the blocks here
// combine their minima with a 64-bit integer atomicMin (below).
//
// Semantics kept from the TPU kernel and the plain version
// (ops/chamfer_pallas_bidir.py::nn_bidirectional_reference): the diff form
// (x - y)^2 summed over the coordinates in order, in float32 rounded after
// every operation (the file is built with --fmad=false; no FMA in d), ties
// to the lowest index.  Round-to-nearest subtraction is odd-symmetric,
// fl(a - b) = -fl(b - a), so one d serves both directions to the bit.
//
// Combining across blocks.  Each (distance, index) candidate is one 64-bit
// key, (float bits of d) << 32 | index: d >= +0, and the bits of non-negative
// floats order as unsigned integers (+0, subnormals, normals, +inf), so the
// minimum key is the lexicographic minimum of (d, index): the smallest
// distance, ties to the lowest index.  That minimum is associative and
// commutative, so atomicMin on the keys gives the same bits whatever order
// the blocks run in, on every run and card.  It is an integer min, not a
// float sum.  Chosen over per-block partials summed by a second pass (as
// kernel E's spans are): the partials would be one (d, index) per (row
// block, point) and a launch to fold them, where the atomics are one per
// (warp, column point) and per (row, span), into a key buffer that a last
// short pass splits into distances and indices.  A key that no block
// proposes (an empty cloud) reads as (+inf, 0), as a one-sided scan gives.
//
// Design.  The larger cloud is the row cloud, the other the column cloud.
// The grid is (row tiles of kTileRows, column spans, batch): the span count
// is chosen from the card's resident blocks (choose_span), so the coarse
// pair (1024 x 16384: 8 row tiles a sample) fills the card as the dense one
// does.  A block holds its span of column points in shared memory (float4,
// at most kMaxChunks chunks of 32), copied by cp.async in stages of
// kStageChunks chunks, each stage waited for just before its chunks run.
// Each lane of the 8 warps holds kR rows in registers, rows lane * kR + r of
// its warp's 256 (lane-major, so a lower lane holds lower rows).  For each
// column point of a 32-point chunk (a broadcast shared-memory read) a lane
// forms the kR distances (8 FP32 instructions each), folds each into its
// row's running minimum (fminf, value only) and into the column point's
// minimum over its kR rows (fminf).  Indices come after:
//   rows: at the end of a chunk a row whose minimum fell strictly records
//      the chunk; after the span it rescans that one chunk for the first
//      point at its minimum (every earlier point lay strictly above it),
//      each lane starting at its own point of the chunk so that the lanes'
//      reads of different chunks fall in different banks, and proposes
//      (d, span index) to its row key;
//   columns: at the end of a chunk, for each of its 32 points, one
//      __reduce_min_sync over the lanes' partials (as unsigned bits) gives
//      the warp's minimum and a ballot the lanes that hold it; lane t keeps
//      point t's.  The lowest such lane holds the lowest row at that
//      distance: lane t takes its rows by shuffle, recomputes their kR
//      distances and takes the first equal one: (d, row).  The 8 warps
//      leave these keys in shared memory; every kFlush chunks the block
//      takes the least of the 8 for each point and proposes it to the
//      point's column key (one atomicMin a point and block, not a warp).
// Rows past the row cloud's end are +inf (never a lower distance; a warp of
// them only proposes nothing), column points past a span's end too (skipped).
//
// Bound on the H100: operations, 8 FP32 operations for d and two minima per
// pair: about 10 issue slots a pair plus the column pass's ~1 (shuffle,
// reduce, ballot, the winner's recompute) and the row bookkeeping; the
// clouds are a few megabytes and stay in L2.
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kR = 8;                   // rows a lane holds
constexpr int kWarpRows = 32 * kR;      // 256
constexpr int kTileRows = kWarps * kWarpRows;  // 2048 rows a block
constexpr int kChunk = 32;              // column points a chunk: one per lane
constexpr int kMaxChunks = 128;         // 4096 column points a span: 64 KB
constexpr int kFlush = kThreads / kChunk;  // chunks between column proposals: 8
static_assert(kFlush == kWarps, "the flush gives each warp one chunk of the group");
constexpr int kStageChunks = 32;        // cp.async stages of 1024 points
static_assert(kMaxChunks / kStageChunks <= 4, "cp_async_wait_upto waits for at most 3");
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long Key;

__device__ __forceinline__ float dist3(const float (&a)[3], float4 b) {
  const float d0 = a[0] - b.x;
  const float d1 = a[1] - b.y;
  const float d2 = a[2] - b.z;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

__device__ __forceinline__ Key make_key(float d, int index) {
  return (static_cast<Key>(__float_as_uint(d)) << 32) | static_cast<unsigned>(index);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (an immediate operand, so a switch over the few counts).
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// One chunk of 32 column points for a live warp: folds each distance into
// the lane's row minima (recording the chunk where one fell) and into the
// points' minima over the lane's rows; returns lane t's column key for point
// t, the warp's least (d, row), or all ones for a point past the span's end
// (`point_ok` false).
__device__ __forceinline__ Key sweep_chunk(const float4* tc, int c, const float (&xr)[kR][3],
                                           float (&best)[kR], int (&kbest)[kR], int lane,
                                           int row0, int Nr, bool point_ok) {
  float prev[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) prev[r] = best[r];
  unsigned cmin[kChunk];  // each point's minimum over this lane's rows, as bits
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    const float4 v = tc[t];
    float m = INFINITY;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float d = dist3(xr[r], v);
      best[r] = fminf(best[r], d);
      m = r == 0 ? d : fminf(m, d);
    }
    cmin[t] = __float_as_uint(m);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) kbest[r] = best[r] < prev[r] ? c : kbest[r];

  // the warp's minimum of each point and the lanes at it; lane t keeps point t's
  unsigned mine = 0, at = 0;
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    const unsigned v = __reduce_min_sync(kFull, cmin[t]);
    const unsigned who = __ballot_sync(kFull, cmin[t] == v);
    if (lane == t) {
      mine = v;
      at = who;
    }
  }
  const int w = __ffs(at) - 1;  // the lowest lane at the minimum
  const float4 v = tc[lane];
  const float dv = __uint_as_float(mine);
  int rw = 0;
#pragma unroll
  for (int r = kR - 1; r >= 0; --r) {  // its first row at the minimum
    float a[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) a[k] = __shfl_sync(kFull, xr[r][k], w);
    if (dist3(a, v) == dv) rw = r;
  }
  const int n = row0 + (w - lane) * kR + rw;
  return point_ok && n < Nr ? make_key(dv, n) : ~Key(0);
}

// rows (B, Nr, 3), cols (B, Mc, 3); row_key (B, Nr), col_key (B, Mc), all
// ones on entry.  Block (tile, span, sample); span_chunks chunks a span.
// Dynamic shared memory: the span's points, then the warps' column keys of
// kFlush chunks.
__global__ void __launch_bounds__(kThreads, 2)
nn_sweep(const float* __restrict__ rows, const float* __restrict__ cols,
         Key* __restrict__ row_key, Key* __restrict__ col_key, int Nr, int Mc,
         int span_chunks) {
  extern __shared__ float4 tg[];  // the span's column points, then column keys
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bi = blockIdx.z;
  const int span0 = blockIdx.y * span_chunks * kChunk;
  const int span_len = min(span_chunks * kChunk, Mc - span0);
  const int chunks = (span_len + kChunk - 1) / kChunk;
  const int stages = (chunks + kStageChunks - 1) / kStageChunks;
  const float* cb = cols + (static_cast<size_t>(bi) * Mc + span0) * 3;

  // the span by cp.async, one group a stage; the ragged chunk's tail +inf
  for (int s = 0; s < stages; ++s) {
    const int e1 = min(span_len, (s + 1) * kStageChunks * kChunk);
    for (int e = s * kStageChunks * kChunk + threadIdx.x; e < e1; e += kThreads) {
      float* dst = reinterpret_cast<float*>(tg + e);
#pragma unroll
      for (int k = 0; k < 3; ++k) cp_async4(dst + k, cb + static_cast<size_t>(e) * 3 + k);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int e = span_len + threadIdx.x; e < chunks * kChunk; e += kThreads)
    tg[e] = make_float4(INFINITY, INFINITY, INFINITY, 0.f);

  const int row0 = blockIdx.x * kTileRows + warp * kWarpRows + lane * kR;
  const bool warp_live = blockIdx.x * kTileRows + warp * kWarpRows < Nr;
  const float* rb = rows + static_cast<size_t>(bi) * Nr * 3;
  float xr[kR][3], best[kR];
  int kbest[kR];  // the chunk where each row's minimum last fell
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int n = row0 + r;
#pragma unroll
    for (int k = 0; k < 3; ++k) xr[r][k] = n < Nr ? rb[static_cast<size_t>(n) * 3 + k] : INFINITY;
    best[r] = INFINITY;
    kbest[r] = 0;
  }
  Key* const ck = col_key + static_cast<size_t>(bi) * Mc + span0;
  Key* const cs = reinterpret_cast<Key*>(tg + span_chunks * kChunk);  // [kFlush][kWarps][32]

  for (int s = 0; s < stages; ++s) {
    cp_async_wait_upto(stages - 1 - s);
    __syncthreads();
    const int c1 = min(chunks, (s + 1) * kStageChunks);
    for (int c = s * kStageChunks; c < c1; ++c) {
      const Key key = warp_live ? sweep_chunk(tg + c * kChunk, c, xr, best, kbest, lane,
                                              row0, Nr, c * kChunk + lane < span_len)
                                : ~Key(0);
      cs[((c % kFlush) * kWarps + warp) * 32 + lane] = key;
      if (c % kFlush == kFlush - 1 || c == chunks - 1) {  // the block's least key a point
        __syncthreads();
        const int cj = c - c % kFlush + warp;  // thread (warp, lane): point lane of chunk cj
        if (cj <= c) {
          Key m = cs[(warp * kWarps) * 32 + lane];
#pragma unroll
          for (int u = 1; u < kWarps; ++u) {
            const Key o = cs[(warp * kWarps + u) * 32 + lane];
            m = o < m ? o : m;
          }
          if (m != ~Key(0)) atomicMin(ck + cj * kChunk + lane, m);
        }
        __syncthreads();
      }
    }
  }

  // the rows: the first point at the minimum in the chunk where it last fell
  if (!warp_live) return;
  Key* const rk = row_key + static_cast<size_t>(bi) * Nr;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float4* tc = tg + kbest[r] * kChunk;
    int tt = kChunk;
#pragma unroll 4
    for (int u = 0; u < kChunk; ++u) {
      const int t = (u + lane) % kChunk;
      if (dist3(xr[r], tc[t]) == best[r]) tt = min(tt, t);
    }
    const int n = row0 + r;
    if (n < Nr)
      atomicMin(rk + n, make_key(best[r], span0 + kbest[r] * kChunk + (tt == kChunk ? 0 : tt)));
  }
}

// keys -> distances and indices; a key never proposed -> (+inf, 0).
__global__ void __launch_bounds__(kThreads)
split_keys(const Key* __restrict__ key, float* __restrict__ dist, int* __restrict__ idx,
           int64_t count) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < count;
       e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const Key k = key[e];
    const bool none = k == ~Key(0);
    dist[e] = none ? INFINITY : __uint_as_float(static_cast<unsigned>(k >> 32));
    idx[e] = none ? 0 : static_cast<int>(static_cast<unsigned>(k));
  }
}

// Chunks a span: the cost of a choice is its waves of resident blocks times
// a block's chunks (plus about one for the row rescan and set-up); the
// least cost, ties to the longer span (fewer row proposals).
int choose_span(int64_t base_blocks, int chunks_total, int slots) {
  int best_sc = 1;
  int64_t best_cost = -1;
  for (int sc = std::min(kMaxChunks, chunks_total); sc >= 1; --sc) {
    const int64_t spans = (chunks_total + sc - 1) / sc;
    const int64_t waves = (base_blocks * spans + slots - 1) / slots;
    const int64_t cost = waves * (2 * sc + 3);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_sc = sc;
    }
  }
  return best_sc;
}

void split(const Key* key, float* dist, int* idx, int64_t count, cudaStream_t st) {
  if (count == 0) return;
  const int64_t need = (count + kThreads - 1) / kThreads;
  split_keys<<<static_cast<unsigned>(need < 65535 ? need : 65535), kThreads, 0, st>>>(
      key, dist, idx, count);
}

}  // namespace

// x: (B, N, 3), y: (B, M, 3) float32 -> d_xy, i_xy (B, N) and d_yx, i_yx
// (B, M), float32 and int32; keys: (B, N + M) 64-bit scratch.
VNK_EXPORT int chamfer_nn_bidir(const void* x, const void* y, void* d_xy, void* i_xy,
                                void* d_yx, void* i_yx, void* keys, int B, int N, int M,
                                void* stream) {
  if (B == 0 || (N == 0 && M == 0)) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool x_rows = N >= M;
  const int Nr = x_rows ? N : M, Mc = x_rows ? M : N;
  Key* row_key = static_cast<Key*>(keys);
  Key* col_key = row_key + static_cast<int64_t>(B) * Nr;
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(Key) * B * (static_cast<int64_t>(N) + M), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Mc > 0) {
    constexpr int kKeyBytes = kFlush * kWarps * 32 * static_cast<int>(sizeof(Key));
    const int most = kMaxChunks * kChunk * static_cast<int>(sizeof(float4)) + kKeyBytes;
    const int slots = vnk_resident_blocks(reinterpret_cast<const void*>(nn_sweep), kThreads,
                                          most);
    if (slots == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (Nr + kTileRows - 1) / kTileRows;
    const int chunks_total = (Mc + kChunk - 1) / kChunk;
    const int sc = choose_span(static_cast<int64_t>(tiles) * B, chunks_total, slots);
    const int spans = (chunks_total + sc - 1) / sc;
    const int bytes = sc * kChunk * static_cast<int>(sizeof(float4)) + kKeyBytes;
    nn_sweep<<<dim3(tiles, spans, B), kThreads, bytes, st>>>(
        static_cast<const float*>(x_rows ? x : y), static_cast<const float*>(x_rows ? y : x),
        row_key, col_key, Nr, Mc, sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* const dr = static_cast<float*>(x_rows ? d_xy : d_yx);
  float* const dc = static_cast<float*>(x_rows ? d_yx : d_xy);
  int* const ir = static_cast<int*>(x_rows ? i_xy : i_yx);
  int* const ic = static_cast<int*>(x_rows ? i_yx : i_xy);
  split(row_key, dr, ir, static_cast<int64_t>(B) * Nr, st);
  split(col_key, dc, ic, static_cast<int64_t>(B) * Mc, st);
  return static_cast<int>(cudaGetLastError());
}
