// Kernels K1, K2, K3: the k smallest entries of each row of a distance
// matrix, ascending, ties to the lowest column index.
//
// K1 (topk_min) replaces vn_pointcloudcompletion_tpu/ops/knn_pallas.py
// ::topk_min_pallas (the pallas_call at :110): the k smallest of each row of
// a given (B, N, M) matrix.
// K2 (knn_min) replaces ::knn_min_pallas (:201, body _fused_kernel :158):
// the same selection over ||q||^2 + ||r||^2 - 2 q.r computed in the kernel,
// so the (B, N, M) matrix never exists in device memory.
// K3 (edge_knn_gather) replaces ::edge_knn_gather (:350, body _edge_kernel
// :298): the kNN of K2 over the columns of one (B, D, N) array, then
// out[b, c, kk, q] = u[b, c, idx[q, kk]] + v[b, c, q], the front of a VN
// EdgeConv stage.
//
// Semantics kept from the TPU kernels: the distance is (q_sq + r_sq) -
// 2 * cross with each sum taken over the coordinates in order and every
// operation rounded (the file is built with --fmad=false), negatives are not
// clamped and self-matches stay; the k smallest come out ascending, and of
// equal values the lower index comes first (knn_pallas.py:38-63).  The plain
// versions in ops/knn_pallas.py do the same operations in the same order, so
// kernel and plain version pick the same indices.
//
// Design.  The TPU kernels hold a (256, M) tile in VMEM and make k passes of
// min / argmin / mask over it.  Here the parent designs of K1 and K2
// ("warp") give one warp one query row: each lane walks the columns lane,
// lane + 32, ... in ascending order and keeps its own k best (value, index)
// pairs sorted in registers (an insertion that bubbles the candidate down
// the list), then k rounds of a butterfly argmin over the 32 lanes' heads
// merge the lists.  Nothing is written but the k results.
//
// K1 runs one of two designs, chosen in ops/knn_pallas.py::topk_design and
// passed in (both give the same indices and bits):
//  - "stream" (M a multiple of 4, the matrix 16-byte aligned: knn()'s
//    matrix at D > 512): a warp takes 8 rows and copies them through a
//    ring of its own, 3 stages of 64 columns by cp.async (16 bytes a copy,
//    one warp barrier a stage, no block barrier); each row gets 4 lanes,
//    lane l the 16-byte vectors l, l + 4, ... of a stage, which select as
//    K2's coords design does (BufferedSelect), then 2 butterfly rounds a
//    merge.  The parent design kept ~one 128-byte line in flight a warp
//    and made nearly every lane insert; a first version with one ring for
//    the block (a block barrier a stage) let a warp that flushed hold up
//    the block's copies, and ran slower than a ring a warp.  Of 2 and 4
//    lanes a row, stages of 32, 64 and 128 columns and 2 to 4 stages
//    (tools/probe_topk.py), 4 lanes and 3 stages of 64 ran fastest at
//    k 16 (2 lanes ran ~7% faster at k 40 and 64, ~4% slower at k 16).
//  - "warp" (the parent design) where a row is not whole 16-byte vectors.
//
// K2 runs one of two designs, chosen by shape in ops/knn_pallas.py
// ::knn_design and passed in (both give the same indices and bits):
//  - "coords" (D <= 4: every K2 call of the models' paths, over
//    coordinates): a block takes 64 queries of one sample and stages the
//    sample's references and |r|^2 (each computed once, in the plain
//    version's order) in shared memory as one float4 a reference; each
//    query gets 4 lanes, each lane a LaneList over the references lane,
//    lane + 4, ...; a lane buffers the distances that pass its tests and
//    the warp pushes the buffers into the lists together (see
//    BufferedSelect), then 2 butterfly rounds a merge.  q and r are
//    read at their own strides, so the wrapper copies neither.  Of 2, 4,
//    8 and 16 lanes a query, 4 ran fastest at (8, 2048 vs 2048) (a
//    probe on the card; 8 was faster at 128 vs 128, where 64 queries a
//    block leave the card nearly empty).
//  - "warp" (the parent design) above D 4: one warp a query over the
//    references transposed to (B, D, M), |r|^2 formed for every pair.
//
// K3 runs one of three designs, chosen by shape in ops/knn_pallas.py
// ::edge_design and passed in (every one gives the same indices and bits):
//  - "coords" (D <= 4, the coordinates of the VN DGCNN's conv4/conv5) and
//    "tiled" (D > 4 at N <= 512, the features of vn_pointr's grouper):
//    two launches of one call.  The selection writes idx: a block takes 32
//    queries, 8 lanes a query, each lane a LaneList over the columns lane,
//    lane + 8, ... and 3 butterfly rounds a merge.  "coords" stages the
//    sample's D planes and |x|^2 in shared memory and forms each distance
//    as it scans (a broadcast read); "tiled" forms the (32, N) distance
//    tile first, a register-tiled product (8 queries x up to 8 references
//    a thread) over x rows staged by cp.async 8 at a time, each pair's
//    cross and |r|^2 sums in order over e, then selects from the tile in
//    shared memory.  The gather then streams the (B, C3, k, N) output over
//    the whole card: a block owns a run of (sample, channel) rows, keeps
//    its share of the sample's indices in registers (the same queries and
//    neighbour slots for every channel), stages each row's u and v by
//    cp.async (a 4-stage ring) and writes 16-byte streaming stores (__stcs,
//    so the output does not evict u from L2); no division is left in the
//    row loop.
//  - "warp" (the parent design) where those do not reach: the gather's
//    split does not fit (gather_kpt: N not whole 16-byte runs, more than
//    256 runs, k not 1, 2, 4 or 8 slots a thread), k > 32, or D > 4 at N >
//    512 or N not a multiple of 8.  A block of 32 queries (8 warps,
//    4 rows each, one warp a query as K2), their indices in shared memory,
//    then the gathered rows with neighbouring threads on neighbouring
//    queries, so every store is a full 128-byte line.
//
// K3's bf16 mode (the bfloat16 compute policy; knn_pallas.py:298-333 on
// bf16 features): x is read as bf16 or float32 and upcast exactly, so the
// distances and the selection are the float32 mode's on those values; u and
// v are bf16, the gather is exact, and out = bf16(float(u[idx]) + float(v))
// rounded to nearest even, the TPU kernel's `g.astype(v.dtype) + v`.
//
// Bound on the H100.  K1: bytes, one read of the matrix (134 MB at (8,
// 2048, 2048), 0.041 ms at 3.35 TB/s); the stream design's copies and
// scan alone (its selection taken out: tools/probe_topk.py floor) take
// 0.053 ms, 77% of that bound, and the selection adds ~0.012 ms at k 16,
// ~0.2 at k 40 and 64 (a push into a lane's 64-entry list is ~450
// instructions).  K2 at the main
// path's D = 3: operations, 10 FP32 ones per (query, reference) pair for
// the distance and the compare (2 D + 4), on the CUDA cores; what the card
// issues is more, 17.25 instructions a pair a lane in the coords design's
// scan (its SASS: the shared load, the distance, the test, the predicated
// append, the loop; chip_smoke.py::knn_scan_issue counts them in the build
// it runs) plus the pushes of the candidates that pass.  K3: bytes, the
// (B, C3, k, N) output written once (201 MB at conv5 in float32); at vn_pointr's D 192
// the distance product is ~0.8 G FP32 instructions (--fmad=false: a multiply
// and an add a term), ~27 us on the card's FP32 issue.
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "vn_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kEdgeQueries = 32;  // queries per block of K3
constexpr unsigned kFull = 0xffffffffu;

// One lane's K best (value, index) pairs, ascending.  A lane sees its
// columns in ascending order, so the strict < puts a candidate behind every
// equal value already held (an earlier index); from there on the entries
// shift down one place unconditionally, so equal values keep their order.
// (Carrying each displaced entry on with the same strict < would let it
// pass an equal one behind it: duplicate points, as resample padding makes,
// would then come out with the higher index first.)
template <int K>
struct LaneList {
  float v[K];
  int i[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      v[t] = INFINITY;
      i[t] = INT_MAX;
    }
  }

  __device__ __forceinline__ void push(float cv, int ci) {
    if (!(cv < v[K - 1])) return;
    bool placed = false;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const bool take = placed || cv < v[t];
      const float tv = v[t];
      const int ti = i[t];
      v[t] = take ? cv : tv;
      i[t] = take ? ci : ti;
      cv = take ? tv : cv;
      ci = take ? ti : ci;
      placed = take;
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int t = 0; t + 1 < K; ++t) {
      v[t] = v[t + 1];
      i[t] = i[t + 1];
    }
    v[K - 1] = INFINITY;
    i[K - 1] = INT_MAX;
  }
};

// The k smallest pairs from the lane lists of `Lanes` neighbouring lanes
// (32: the warp; 8: K3's selection): round r finds the smallest head
// (value, then index) with a butterfly over the lanes, the owning lane
// drops its head, and the group's first lane hands (r, value, index) to
// emit.
template <int K, int Lanes = 32, typename Emit>
__device__ __forceinline__ void warp_merge(LaneList<K>& l, int k, Emit emit) {
  const bool first = (threadIdx.x & (Lanes - 1)) == 0;
  for (int r = 0; r < k; ++r) {
    float bv = l.v[0];
    int bi = l.i[0];
#pragma unroll
    for (int off = Lanes / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (l.i[0] == bi) l.pop();
    if (first) emit(r, bv, bi);
  }
}

// ---- the buffered selection (K1's "stream" design, K2's "coords" design) ----

constexpr int kKnnBatch = 8;  // values offered between two flush tests
constexpr int kKnnFlush = 8;  // a lane's buffered candidates that start a flush
constexpr int kKnnCap = kKnnFlush + kKnnBatch - 1;  // a lane's buffer

// The selection of one row (K1) or query (K2) spread over kLanes
// neighbouring lanes, each a LaneList over the columns it owns, offered in
// ascending index order.  A lane's sorted insertion costs ~100
// instructions, and the warp waits for any lane that inserts: scanning and
// inserting in turn, nearly every step of a scan had an insertion
// somewhere in the warp.  So a lane only tests each value (offer) and
// appends the ones that pass to its buffer in shared memory (in ascending
// index order, as its list would have taken them); when a lane of the warp
// holds kKnnFlush after a batch (step), every lane pushes its buffer into
// its list at once (flush).  The test is against the last value of the
// lane's list (strict: a later equal value has a higher index) and a bound
// for the row: the largest over its lanes of each lane's (K / lanes)-th
// value, below which the row already holds K >= k values, so a larger value
// cannot be among the k smallest (an equal one passes: it may tie with a
// higher index).  Every lane of the warp calls step and flush together.
template <int K, int kLanes>
struct BufferedSelect {
  static_assert(K % kLanes == 0, "the row's bound needs K / lanes values a lane");
  LaneList<K> l;
  float* bufv;  // this thread's column of the block's (kKnnCap, kThreads) buffers
  int* bufi;
  float thr;  // a value passes below it
  int cnt;    // the lane's buffered candidates

  __device__ __forceinline__ BufferedSelect(float* bv, int* bi)
      : bufv(bv + threadIdx.x), bufi(bi + threadIdx.x), thr(INFINITY), cnt(0) {
    l.init();
  }

  __device__ __forceinline__ void offer(float v, int j) {
    if (v < thr) {
      bufv[cnt * kThreads] = v;
      bufi[cnt * kThreads] = j;
      ++cnt;
    }
  }

  __device__ __forceinline__ void flush() {
    const int most = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(cnt)));
    for (int t = 0; t < most; ++t) {
      if (t < cnt) l.push(bufv[t * kThreads], bufi[t * kThreads]);
    }
    cnt = 0;
    float bound = l.v[K / kLanes - 1];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      bound = fmaxf(bound, __shfl_xor_sync(kFull, bound, off));
    }
    thr = fminf(l.v[K - 1], nextafterf(bound, INFINITY));
  }

  __device__ __forceinline__ void step() {
    if (__any_sync(kFull, cnt >= kKnnFlush)) flush();
  }
};

// The squared distance of query row qrow (D floats, shared memory) to
// column j of a (D, M) array (float32 or bf16, read as float32), in the
// plain version's order.
template <typename X>
__device__ __forceinline__ float sq_dist(const float* qrow, float qsq,
                                         const X* __restrict__ cols,
                                         int D, int M, int j) {
  float cross = 0.f, rsq = 0.f;
  for (int e = 0; e < D; ++e) {
    const float re = vnk_load(cols[static_cast<int64_t>(e) * M + j]);
    cross = cross + qrow[e] * re;
    rsq = rsq + re * re;
  }
  return (qsq + rsq) - 2.f * cross;
}

__device__ __forceinline__ float sq_norm(const float* qrow, int D) {
  float s = 0.f;
  for (int e = 0; e < D; ++e) s = s + qrow[e] * qrow[e];
  return s;
}

// K1, the "warp" design: d (rows, M) -> vals, idx (rows, k).
template <int K>
__global__ void __launch_bounds__(kThreads)
topk_min_kernel(const float* __restrict__ d, float* __restrict__ vals,
                int* __restrict__ idx, int rows, int M, int k) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* dr = d + static_cast<int64_t>(row) * M;
  LaneList<K> l;
  l.init();
  for (int j = lane; j < M; j += 32) l.push(dr[j], j);
  float* vo = vals + static_cast<int64_t>(row) * k;
  int* io = idx + static_cast<int64_t>(row) * k;
  warp_merge(l, k, [&](int r, float v, int i) {
    vo[r] = v;
    io[r] = i;
  });
}

// ---- K1's "stream" design ----

constexpr int kTopkLanes = 4;                        // lanes that select from one row
constexpr int kTopkWarpRows = 32 / kTopkLanes;       // rows a warp
constexpr int kTopkRows = kWarps * kTopkWarpRows;    // rows a block
constexpr int kTopkCols = 64;                        // columns of a stage
constexpr int kTopkVecs = kTopkCols / 4;             // 16-byte vectors of a staged row
constexpr int kTopkStride = kTopkCols + 16;          // floats: the two rows a quarter-warp reads
                                                     // lie 64 bytes apart mod 128, 16 banks
constexpr int kTopkStages = 3;
constexpr int kTopkRing = kTopkStages * kTopkWarpRows * kTopkStride;  // a warp's ring (floats)
// every warp's ring, then each thread's candidate buffer: 90 KB, two
// blocks an SM
constexpr int kTopkSmem =
    static_cast<int>(sizeof(float)) * kWarps * kTopkRing + 8 * kKnnCap * kThreads;

// K1 "stream": d (rows, M) float32, M a multiple of 4, 16-byte aligned ->
// vals, idx (rows, k).  A warp takes 8 rows and streams them through a ring
// of its own, kTopkStages stages of 64 columns (cp.async, 16 bytes a copy):
// two stages are in flight while its lanes select from the one that
// landed, and no warp waits for another (a warp barrier a stage, no block
// barrier), so a warp that flushes keeps its copies in flight and holds up
// no other warp's.  A row has 4 lanes; lane l takes the 16-byte vectors l,
// l + 4, l + 8, l + 12 of each stage, so it sees its columns in ascending
// order, and offers each value to its BufferedSelect.
template <int K>
__global__ void __launch_bounds__(kThreads, K <= 32 ? 2 : 1)
topk_min_stream(const float* __restrict__ d, float* __restrict__ vals, int* __restrict__ idx,
                int rows, int M, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int r = wl / kTopkLanes, lane = wl % kTopkLanes;
  float* ring = reinterpret_cast<float*>(smem_raw) + warp * kTopkRing;  // (stages, 8, stride)
  float* bufv = reinterpret_cast<float*>(smem_raw) + kWarps * kTopkRing;  // (kKnnCap, kThreads)
  int* bufi = reinterpret_cast<int*>(bufv + kKnnCap * kThreads);          // (kKnnCap, kThreads)
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTopkRows + warp * kTopkWarpRows;
  if (row0 >= rows) return;  // no barrier waits for this warp
  // rows past the last read the last one and write nothing (the merge's
  // shuffles need every lane of the warp)
  const int64_t last = rows - 1;
  const int tiles = (M + kTopkCols - 1) / kTopkCols;
  auto load = [&](int c) {  // stage c % kTopkStages: columns c * kTopkCols ... of the 8 rows
    if (c < tiles) {
      const int nv = min(kTopkCols, M - c * kTopkCols) / 4;
      float* dst = ring + (c % kTopkStages) * kTopkWarpRows * kTopkStride;
#pragma unroll
      for (int e = wl; e < kTopkWarpRows * kTopkVecs; e += 32) {
        const int rr = e / kTopkVecs, v = e % kTopkVecs;
        if (v < nv) {
          cp_async16(dst + rr * kTopkStride + 4 * v,
                     d + min(row0 + rr, last) * M + c * kTopkCols + 4 * v);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kTopkStages - 1; ++c) load(c);
  BufferedSelect<K, kTopkLanes> sel(bufv, bufi);
  for (int c = 0; c < tiles; ++c) {
    cp_async_wait<kTopkStages - 2>();
    __syncwarp();  // stage c landed for every lane; every lane done with stage c - 1
    load(c + kTopkStages - 1);
    const int c0 = c * kTopkCols, nv = min(kTopkCols, M - c0) / 4;
    const float* row = ring + ((c % kTopkStages) * kTopkWarpRows + r) * kTopkStride;
    constexpr int kBatchVecs = kKnnBatch / 4;
#pragma unroll
    for (int t = 0; t < kTopkVecs / kTopkLanes; t += kBatchVecs) {
      float4 x[kBatchVecs];  // loaded before the offers, which store to shared memory
#pragma unroll
      for (int u = 0; u < kBatchVecs; ++u) {
        const int v = lane + kTopkLanes * (t + u);
        if (v < nv) x[u] = *reinterpret_cast<const float4*>(row + 4 * v);
      }
#pragma unroll
      for (int u = 0; u < kBatchVecs; ++u) {
        const int v = lane + kTopkLanes * (t + u);
        if (v < nv) {
          const int j = c0 + 4 * v;
          sel.offer(x[u].x, j);
          sel.offer(x[u].y, j + 1);
          sel.offer(x[u].z, j + 2);
          sel.offer(x[u].w, j + 3);
        }
      }
      sel.step();
    }
  }
  sel.flush();
  const int64_t row = row0 + r;
  warp_merge<K, kTopkLanes>(sel.l, k, [&](int rr, float v, int i) {
    if (row < rows) {
      vals[row * k + rr] = v;
      idx[row * k + rr] = i;
    }
  });
}

// K2, the "warp" design: q (B, N, D), rt (B, D, M) -> vals, idx (B, N, k).
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_min_kernel(const float* __restrict__ q, const float* __restrict__ rt,
               float* __restrict__ vals, int* __restrict__ idx, int N, int M,
               int D, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  float* qrow = smem + warp * D;
  const float* qb = q + (static_cast<int64_t>(b) * N + n) * D;
  for (int e = lane; e < D; e += 32) qrow[e] = qb[e];
  __syncwarp();
  const float qsq = sq_norm(qrow, D);
  const float* r = rt + static_cast<int64_t>(b) * D * M;
  LaneList<K> l;
  l.init();
  for (int j = lane; j < M; j += 32) l.push(sq_dist(qrow, qsq, r, D, M, j), j);
  const int64_t o = (static_cast<int64_t>(b) * N + n) * k;
  warp_merge(l, k, [&](int rr, float v, int i) {
    vals[o + rr] = v;
    idx[o + rr] = i;
  });
}

// ---- K2's "coords" design ----

constexpr int kKnnLanes = 4;                       // lanes that scan one query's references
constexpr int kKnnQueries = kThreads / kKnnLanes;  // queries a block
constexpr int kKnnMaxM = 4096;                     // the TPU kernel's row cap (knn_pallas.py:30)

// Shared memory of the coords design at M references, D <= 4: one float4 a
// reference, {r0, r1, r2, |r|^2} at D <= 3 (the coordinates past D zero), or
// {r0, r1, r2, r3} followed by the M values |r|^2 at D = 4; then each
// thread's candidate buffer, kKnnCap (value, index) pairs.
inline int knn_coords_smem(int M, int D) {
  return (D == 4 ? 20 : 16) * M + 8 * kKnnCap * kThreads;
}

// The distance to one staged reference, in the plain version's order.
// Past D the query's and the reference's coordinates are zero: adding their
// product changes no distance (at most the sign of a zero cross term, which
// the subtraction from |q|^2 + |r|^2 >= 0 absorbs).
template <bool kD4>
__device__ __forceinline__ float coords_dist(const float4* refs, const float* rsq4,
                                             const float (&qv)[4], float qsq, int j) {
  const float4 c = refs[j];
  float cross = qv[0] * c.x;
  cross = cross + qv[1] * c.y;
  cross = cross + qv[2] * c.z;
  float rsq;
  if constexpr (kD4) {
    cross = cross + qv[3] * c.w;
    rsq = rsq4[j];
  } else {
    rsq = c.w;
  }
  return (qsq + rsq) - 2.f * cross;
}

// K2 "coords": q (B, N, D), r (B, M, D) float32 at element strides (qsb,
// qsn, qse) and (rsb, rsm, rse), D <= 4, M <= 4096 -> vals, idx (B, N, k);
// each query's 4 lanes select as BufferedSelect says.
template <int K, bool kD4>
__global__ void __launch_bounds__(kThreads)
knn_select_coords(const float* __restrict__ q, const float* __restrict__ r,
                  float* __restrict__ vals, int* __restrict__ idx, int N, int M, int D,
                  int k, int64_t qsb, int64_t qsn, int64_t qse, int64_t rsb, int64_t rsm,
                  int64_t rse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* refs = reinterpret_cast<float4*>(smem_raw);              // (M)
  float* rsq4 = reinterpret_cast<float*>(refs + M);                 // (M), D = 4 only
  float* bufv = rsq4 + (kD4 ? M : 0);                               // (kKnnCap, kThreads)
  int* bufi = reinterpret_cast<int*>(bufv + kKnnCap * kThreads);  // (kKnnCap, kThreads)
  const int b = blockIdx.y, tid = threadIdx.x;
  const float* rb = r + b * rsb;
  for (int j = tid; j < M; j += kThreads) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < D) {
        c[e] = rb[j * rsm + e * rse];
        sq = sq + c[e] * c[e];
      }
    }
    if constexpr (kD4) {
      refs[j] = make_float4(c[0], c[1], c[2], c[3]);
      rsq4[j] = sq;
    } else {
      refs[j] = make_float4(c[0], c[1], c[2], sq);
    }
  }
  __syncthreads();
  // queries past N compute on the last one and write nothing (the merge's
  // shuffles need every lane of the warp)
  const int qi = blockIdx.x * kKnnQueries + tid / kKnnLanes;
  const int n = min(qi, N - 1);
  const float* qp = q + b * qsb + n * qsn;
  float qv[4];
  float qsq = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    qv[e] = e < D ? qp[e * qse] : 0.f;
    if (e < D) qsq = qsq + qv[e] * qv[e];
  }
  BufferedSelect<K, kKnnLanes> sel(bufv, bufi);
  // the lane's references j0 + lane + kKnnLanes t, t < kKnnBatch, for j0 a
  // multiple of kSpan: the same trip count for every lane (the flush is
  // warp-wide)
  constexpr int kSpan = kKnnBatch * kKnnLanes;
  const int lane = tid & (kKnnLanes - 1);
  int j0 = 0;
  for (; j0 + kSpan <= M; j0 += kSpan) {
    float dv[kKnnBatch];
#pragma unroll
    for (int t = 0; t < kKnnBatch; ++t) {
      dv[t] = coords_dist<kD4>(refs, rsq4, qv, qsq, j0 + lane + t * kKnnLanes);
    }
#pragma unroll
    for (int t = 0; t < kKnnBatch; ++t) sel.offer(dv[t], j0 + lane + t * kKnnLanes);
    sel.step();
  }
#pragma unroll
  for (int t = 0; t < kKnnBatch; ++t) {  // the last M % kSpan references
    const int j = j0 + lane + t * kKnnLanes;
    if (j < M) sel.offer(coords_dist<kD4>(refs, rsq4, qv, qsq, j), j);
  }
  sel.flush();
  const int64_t o = (static_cast<int64_t>(b) * N + n) * k;
  warp_merge<K, kKnnLanes>(sel.l, k, [&](int rr, float v, int i) {
    if (qi < N) {
      vals[o + rr] = v;
      idx[o + rr] = i;
    }
  });
}

// K3: x (B, D, N), u, v (B, C3, N) -> out (B, C3, k, N), idx (B, N, k);
// x of type X, u, v and out of type T.
template <int K, typename X, typename T>
__global__ void __launch_bounds__(kThreads)
edge_knn_gather_kernel(const X* __restrict__ x, const T* __restrict__ u,
                       const T* __restrict__ v, T* __restrict__ out,
                       int* __restrict__ idx, int N, int D, int C3, int k) {
  extern __shared__ float smem[];
  int* sidx = reinterpret_cast<int*>(smem + kWarps * D);  // (kEdgeQueries, k)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kEdgeQueries;
  const X* xb = x + static_cast<int64_t>(b) * D * N;
  float* qrow = smem + warp * D;
  for (int qq = warp; qq < kEdgeQueries; qq += kWarps) {
    const int n = q0 + qq;
    if (n >= N) break;
    for (int e = lane; e < D; e += 32) qrow[e] = vnk_load(xb[static_cast<int64_t>(e) * N + n]);
    __syncwarp();
    const float qsq = sq_norm(qrow, D);
    LaneList<K> l;
    l.init();
    for (int j = lane; j < N; j += 32) l.push(sq_dist(qrow, qsq, xb, D, N, j), j);
    int* io = idx + (static_cast<int64_t>(b) * N + n) * k;
    warp_merge(l, k, [&](int r, float, int i) {
      sidx[qq * k + r] = i;
      io[r] = i;
    });
    __syncwarp();
  }
  __syncthreads();
  const int ql = threadIdx.x & 31;
  const int n = q0 + ql;
  if (n >= N) return;
  const int64_t bc = static_cast<int64_t>(b) * C3;
  for (int e = threadIdx.x >> 5; e < C3 * k; e += kWarps) {
    const int c = e / k, kk = e - c * k;
    const int64_t row = (bc + c) * N;
    out[((bc + c) * k + kk) * N + n] =
        vnk_cast<T>(vnk_load(u[row + sidx[ql * k + kk]]) + vnk_load(v[row + n]));
  }
}

// ---- K3's "coords" and "tiled" designs: a selection, then the gather ----

constexpr int kSelLanes = 8;                       // lanes that scan one query's columns
constexpr int kSelQueries = kThreads / kSelLanes;  // queries a selection block
constexpr int kCoordsMaxD = 4;
constexpr int kTiledMaxN = 512;
constexpr int kTileRows = 8;      // x rows a stage of the tiled product
constexpr int kTileQ = 8;         // queries a thread of the tiled product
constexpr int kTileR = 64;        // threads along the references (r = tr + 64 j)
constexpr int kGatherStages = 4;  // u, v rows in flight in a gather block

// "coords": x (B, D, N), D <= 4 -> idx (B, N, k).  The block stages the
// sample's planes and |x_j|^2 (the plain version's sq_norms, in order); a
// query's 8 lanes each scan every 8th column from shared memory.
template <int K, typename X>
__global__ void __launch_bounds__(kThreads)
edge_select_coords(const X* __restrict__ x, int* __restrict__ idx, int N, int D, int k) {
  extern __shared__ float smem[];  // (D, N) planes, then |x_j|^2 (N)
  float* rsq = smem + D * N;
  const int b = blockIdx.y;
  const X* xb = x + static_cast<int64_t>(b) * D * N;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    float sq = 0.f;
    for (int e = 0; e < D; ++e) {
      const float r = vnk_load(xb[static_cast<int64_t>(e) * N + j]);
      smem[e * N + j] = r;
      sq = sq + r * r;
    }
    rsq[j] = sq;
  }
  __syncthreads();
  // rows past N compute on the last point and write nothing (the merge's
  // shuffles need every lane of the warp)
  const int q = blockIdx.x * kSelQueries + threadIdx.x / kSelLanes;
  const int n = min(q, N - 1);
  float qv[kCoordsMaxD];
#pragma unroll
  for (int e = 0; e < kCoordsMaxD; ++e) qv[e] = e < D ? smem[e * N + n] : 0.f;
  const float qsq = rsq[n];
  LaneList<K> l;
  l.init();
  for (int j = threadIdx.x % kSelLanes; j < N; j += kSelLanes) {
    float cross = 0.f;
#pragma unroll
    for (int e = 0; e < kCoordsMaxD; ++e) {
      if (e < D) cross = cross + qv[e] * smem[e * N + j];
    }
    l.push((qsq + rsq[j]) - 2.f * cross, j);
  }
  int* io = idx + (static_cast<int64_t>(b) * N + n) * k;
  warp_merge<K, kSelLanes>(l, k, [&](int r, float, int i) {
    if (q < N) io[r] = i;
  });
}

// 8 consecutive elements of a shared-memory row (16 or 32 bytes aligned),
// as float32.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = c.x, f[5] = c.y, f[6] = c.z, f[7] = c.w;
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void load8(const vnk_bf16* p, float (&f)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    f[2 * m] = bf16_lo(w[m]);
    f[2 * m + 1] = bf16_hi(w[m]);
  }
}

// Shared memory of the tiled selection at N columns: the distance tile
// (32 rows of ds floats), |x_j|^2, two stages of kTileRows x rows.
__host__ __device__ inline int tiled_row_stride(int N) { return ((N + 31) & ~31) + 8; }  // rows 8 banks apart

template <typename X>
inline int tiled_smem(int N) {
  return static_cast<int>(sizeof(float)) * (kSelQueries * tiled_row_stride(N) + N) +
         2 * kTileRows * N * static_cast<int>(sizeof(X));
}

// "tiled": x (B, D, N), N <= 512 (N a multiple of 8, 16-byte rows) -> idx
// (B, N, k).  Thread (tq, tr) of the product holds the cross sums of
// queries q0 + 8 tq + i (i < 8) with references tr + 64 j (j < RJ), summed
// over e in order; the threads also sum |x_j|^2 of columns tid, tid + 256.
template <int K, int RJ, typename X>
__global__ void __launch_bounds__(kThreads)
edge_select_tiled(const X* __restrict__ x, int* __restrict__ idx, int N, int D, int k) {
  constexpr int kV = 16 / static_cast<int>(sizeof(X));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ds = tiled_row_stride(N);
  float* dist = reinterpret_cast<float*>(smem_raw);  // (kSelQueries, ds)
  float* rsq = dist + kSelQueries * ds;              // (N)
  X* ring = reinterpret_cast<X*>(rsq + N);           // (2, kTileRows, N)
  const int b = blockIdx.y, q0 = blockIdx.x * kSelQueries;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int tq = warp >> 1, tr = ((warp & 1) << 5) | (tid & 31);
  const X* xb = x + static_cast<int64_t>(b) * D * N;
  // queries and references past N read the last ones; their sums go unused
  const int qbase = min(q0 + tq * kTileQ, N - kTileQ);
  int rj[RJ];
#pragma unroll
  for (int j = 0; j < RJ; ++j) rj[j] = min(tr + kTileR * j, N - 1);
  float acc[kTileQ][RJ];
#pragma unroll
  for (int i = 0; i < kTileQ; ++i) {
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;
  }
  float rs[2] = {0.f, 0.f};
  const int chunks = (D + kTileRows - 1) / kTileRows;
  // stage c: x rows c * kTileRows ..., whole rows, so one contiguous run
  auto load = [&](int c) {
    if (c < chunks) {
      const int rows = min(kTileRows, D - c * kTileRows);
      const X* src = xb + static_cast<int64_t>(c) * kTileRows * N;
      X* dst = ring + (c & 1) * kTileRows * N;
      for (int e = tid; e < rows * N / kV; e += kThreads) cp_async16(dst + e * kV, src + e * kV);
    }
    cp_async_commit();
  };
  load(0);
  for (int c = 0; c < chunks; ++c) {
    load(c + 1);
    cp_async_wait<1>();
    __syncthreads();  // stage c & 1 published
    const X* tile = ring + (c & 1) * kTileRows * N;
    const int rows = min(kTileRows, D - c * kTileRows);
    for (int ee = 0; ee < rows; ++ee) {
      const X* row = tile + ee * N;
      float qv[kTileQ], rv[RJ];
      load8(row + qbase, qv);
#pragma unroll
      for (int j = 0; j < RJ; ++j) rv[j] = vnk_load(row[rj[j]]);
#pragma unroll
      for (int i = 0; i < kTileQ; ++i) {
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[i][j] = acc[i][j] + qv[i] * rv[j];
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int col = tid + m * kThreads;
        if (col < N) {
          const float r = vnk_load(row[col]);
          rs[m] = rs[m] + r * r;
        }
      }
    }
    __syncthreads();  // stage c & 1 free for load(c + 2)
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (tid + m * kThreads < N) rsq[tid + m * kThreads] = rs[m];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTileQ; ++i) {
    const int ql = tq * kTileQ + i;
    const float qsq = rsq[min(q0 + ql, N - 1)];
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int r = tr + kTileR * j;
      if (r < N) dist[ql * ds + r] = (qsq + rsq[r]) - 2.f * acc[i][j];
    }
  }
  __syncthreads();
  const int ql = tid >> 3, q = q0 + ql;
  const float* drow = dist + ql * ds;
  LaneList<K> l;
  l.init();
  for (int j = tid & (kSelLanes - 1); j < N; j += kSelLanes) l.push(drow[j], j);
  int* io = idx + (static_cast<int64_t>(b) * N + min(q, N - 1)) * k;
  warp_merge<K, kSelLanes>(l, k, [&](int r, float, int i) {
    if (q < N) io[r] = i;
  });
}

// 16 bytes of T at p (shared memory, aligned) as float32: 4 or 8 values.
__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}

__device__ __forceinline__ void load_vec(const vnk_bf16* p, float (&f)[8]) { load8(p, f); }

// 16 bytes of T from float32 values, by a streaming store (evict first).
__device__ __forceinline__ void store_stream(float* p, const float (&f)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
}

__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

__device__ __forceinline__ void store_stream(vnk_bf16* p, const float (&f)[8]) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                                                 bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7])));
}

// KPT consecutive ints (aligned to min(KPT, 4) ints) into dst.
template <int KPT>
__device__ __forceinline__ void load_ints(const int* p, int (&dst)[KPT]) {
  if constexpr (KPT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < KPT; j += 4) {
      const int4 a = *reinterpret_cast<const int4*>(p + j);
      dst[j] = a.x, dst[j + 1] = a.y, dst[j + 2] = a.z, dst[j + 3] = a.w;
    }
  } else if constexpr (KPT == 2) {
    const int2 a = *reinterpret_cast<const int2*>(p);
    dst[0] = a.x, dst[1] = a.y;
  } else {
    dst[0] = p[0];
  }
}

// Neighbour slots a gather thread takes: thread t owns the 16-byte run of
// queries (t % QC) * V ... (QC = N / V runs, V = 16 / sizeof(T)) and slots
// (t / QC) * KPT ... + KPT - 1; KPT in {1, 2, 4, 8}, or 0 where the shape
// does not fit (ops/knn_pallas.py::gather_slots says the same).
inline int gather_kpt(int N, int k, int vec) {
  if (N % vec != 0 || N / vec > kThreads) return 0;
  const int ks = kThreads / (N / vec);
  if (k % ks != 0) return 0;
  const int kpt = k / ks;
  return kpt == 1 || kpt == 2 || kpt == 4 || kpt == 8 ? kpt : 0;
}

// The gather: out[b, c, kk, q] = T(float(u[b, c, idx[b, q, kk]]) + float(v[b,
// c, q])) for the rows (b, c) of this block's run of the B * C3 rows.
template <typename T, int KPT>
__global__ void __launch_bounds__(kThreads)
edge_gather_kernel(const T* __restrict__ u, const T* __restrict__ v,
                   const int* __restrict__ idx, T* __restrict__ out, int N, int C3, int k,
                   int64_t rows) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // kGatherStages x (u row, v row)
  const int runs = N / kV, tid = threadIdx.x;
  const int q = (tid % runs) * kV, kk0 = (tid / runs) * KPT;
  const bool active = kk0 < k;
  const int64_t r0 = rows * blockIdx.x / gridDim.x;
  const int64_t r1 = rows * (blockIdx.x + 1) / gridDim.x;
  for (int64_t seg = r0; seg < r1;) {  // the rows of one sample at a time
    const int64_t b = seg / C3;
    const int64_t end = min(r1, (b + 1) * C3);
    int ix[kV][KPT];
    if (active) {
#pragma unroll
      for (int e = 0; e < kV; ++e) load_ints<KPT>(idx + (b * N + q + e) * k + kk0, ix[e]);
    }
    int done = 0;  // rows go through the ring in order
    pipeline<kGatherStages>(
        static_cast<int>(end - seg),
        [&](int st, int i) {
          const T* us = u + (seg + i) * N;
          const T* vs = v + (seg + i) * N;
          T* dst = ring + st * 2 * N;
          for (int e = tid; e < 2 * runs; e += kThreads) {
            cp_async16(dst + e * kV, e < runs ? us + e * kV : vs + (e - runs) * kV);
          }
        },
        [&](int st) {
          const int64_t row = seg + done++;
          if (!active) return;
          const T* us = ring + st * 2 * N;
          float vf[kV];
          load_vec(us + N + q, vf);
          T* o = out + (row * k + kk0) * N + q;
#pragma unroll
          for (int j = 0; j < KPT; ++j) {
            float g[kV];
#pragma unroll
            for (int e = 0; e < kV; ++e) g[e] = vnk_load(us[ix[e][j]]) + vf[e];
            store_stream(o + static_cast<int64_t>(j) * N, g);
          }
        });
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next sample's rows
    seg = end;
  }
}
template <template <int> class Launch, typename... Args>
int by_k(int k, Args... args) {
  if (k <= 16) return Launch<16>::run(args...);
  if (k <= 32) return Launch<32>::run(args...);
  if (k <= 64) return Launch<64>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1's designs (ops/knn_pallas.py::topk_design)
enum TopkDesign { kTopkWarp = 0, kTopkStream = 1 };

template <int K>
struct LaunchTopk {
  static int run(const float* d, float* vals, int* idx, int rows, int M, int k, int design,
                 cudaStream_t s) {
    if (design == kTopkWarp) {
      topk_min_kernel<K><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
          d, vals, idx, rows, M, k);
      return static_cast<int>(cudaGetLastError());
    }
    if (design != kTopkStream || !aligned16(d, M, 4)) {  // 16-byte copies of whole rows
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto kernel = &topk_min_stream<K>;
    if (vnk_resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, kTopkSmem) == 0) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    kernel<<<(rows + kTopkRows - 1) / kTopkRows, kThreads, kTopkSmem, s>>>(d, vals, idx, rows,
                                                                           M, k);
    return static_cast<int>(cudaGetLastError());
  }
};

// K2's designs (ops/knn_pallas.py::knn_design)
enum KnnDesign { kKnnWarp = 0, kKnnCoords = 1 };

template <int K>
struct LaunchKnn {
  static int run(const float* q, const float* r, float* vals, int* idx, int B, int N, int M,
                 int D, int k, int design, int64_t qsb, int64_t qsn, int64_t qse, int64_t rsb,
                 int64_t rsm, int64_t rse, cudaStream_t s) {
    if (design == kKnnWarp) {  // q (B, N, D) and r as (B, D, M), both packed
      if (qsb != static_cast<int64_t>(N) * D || qsn != D || qse != 1 ||
          rsb != static_cast<int64_t>(D) * M || rsm != 1 || rse != M) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const dim3 grid((N + kWarps - 1) / kWarps, B);
      const size_t shmem = sizeof(float) * kWarps * D;
      knn_min_kernel<K><<<grid, kThreads, shmem, s>>>(q, r, vals, idx, N, M, D, k);
      return static_cast<int>(cudaGetLastError());
    }
    if (design != kKnnCoords || D < 1 || D > kCoordsMaxD || M > kKnnMaxM) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    using Kernel = void (*)(const float*, const float*, float*, int*, int, int, int, int, int64_t,
                            int64_t, int64_t, int64_t, int64_t, int64_t);
    const Kernel kernel = D == 4 ? &knn_select_coords<K, true> : &knn_select_coords<K, false>;
    const int smem = knn_coords_smem(M, D);
    if (vnk_resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, smem) == 0) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const dim3 grid((N + kKnnQueries - 1) / kKnnQueries, B);
    kernel<<<grid, kThreads, static_cast<size_t>(smem), s>>>(q, r, vals, idx, N, M, D, k, qsb,
                                                              qsn, qse, rsb, rsm, rse);
    return static_cast<int>(cudaGetLastError());
  }
};

// K3's designs (ops/knn_pallas.py::edge_design)
enum EdgeDesign { kEdgeWarp = 0, kEdgeCoords = 1, kEdgeTiled = 2 };

template <typename T>
int launch_gather(const T* u, const T* v, const int* idx, T* out, int B, int N, int C3, int k,
                  cudaStream_t s) {
  using Kernel = void (*)(const T*, const T*, const int*, T*, int, int, int, int64_t);
  Kernel kernel = nullptr;
  switch (gather_kpt(N, k, 16 / static_cast<int>(sizeof(T)))) {
    case 1: kernel = &edge_gather_kernel<T, 1>; break;
    case 2: kernel = &edge_gather_kernel<T, 2>; break;
    case 4: kernel = &edge_gather_kernel<T, 4>; break;
    case 8: kernel = &edge_gather_kernel<T, 8>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kGatherStages * 2 * N * static_cast<int>(sizeof(T));
  const int slots = vnk_resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, smem);
  if (slots == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t rows = static_cast<int64_t>(B) * C3;  // as many blocks as the card holds
  if (rows == 0) return 0;
  const int grid = static_cast<int>(rows < slots ? rows : slots);
  kernel<<<grid, kThreads, static_cast<size_t>(smem), s>>>(u, v, idx, out, N, C3, k, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
struct LaunchEdge {
  template <typename X, typename T>
  static int run(const X* x, const T* u, const T* v, T* out, int* idx, int B,
                 int N, int D, int C3, int k, int design, cudaStream_t s) {
    if (design == kEdgeWarp) {
      const dim3 grid((N + kEdgeQueries - 1) / kEdgeQueries, B);
      const size_t shmem = sizeof(float) * kWarps * D + sizeof(int) * kEdgeQueries * k;
      edge_knn_gather_kernel<K, X, T><<<grid, kThreads, shmem, s>>>(
          x, u, v, out, idx, N, D, C3, k);
      return static_cast<int>(cudaGetLastError());
    }
    if constexpr (K > 32) {  // the lane lists of the new designs hold at most 32
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return run_select_gather(x, u, v, out, idx, B, N, D, C3, k, design, s);
    }
  }

  // "coords" or "tiled": the selection, then the gather; both take 16-byte rows
  template <typename X, typename T>
  static int run_select_gather(const X* x, const T* u, const T* v, T* out, int* idx, int B,
                               int N, int D, int C3, int k, int design, cudaStream_t s) {
    constexpr int kVt = 16 / static_cast<int>(sizeof(T));
    if (gather_kpt(N, k, kVt) == 0 || !aligned16(u, N, kVt) ||
        !aligned16(v, N, kVt) || !aligned16(out, N, kVt)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (design == kEdgeCoords) {
      const dim3 grid((N + kSelQueries - 1) / kSelQueries, B);
      if (D > kCoordsMaxD) return static_cast<int>(cudaErrorInvalidValue);
      const int smem = static_cast<int>(sizeof(float)) * (D + 1) * N;
      auto kernel = &edge_select_coords<K, X>;
      if (vnk_resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, smem) == 0) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
      }
      kernel<<<grid, kThreads, static_cast<size_t>(smem), s>>>(x, idx, N, D, k);
    } else if (design == kEdgeTiled) {
      constexpr int kVx = 16 / static_cast<int>(sizeof(X));
      if (N > kTiledMaxN || N % kTileQ != 0 || !aligned16(x, N, kVx)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      using Kernel = void (*)(const X*, int*, int, int, int);
      const int rj = (N + kTileR - 1) / kTileR;
      const Kernel kernel = rj <= 1   ? &edge_select_tiled<K, 1, X>
                            : rj <= 2 ? &edge_select_tiled<K, 2, X>
                            : rj <= 4 ? &edge_select_tiled<K, 4, X>
                                      : &edge_select_tiled<K, 8, X>;
      const int smem = tiled_smem<X>(N);
      const dim3 grid((N + kSelQueries - 1) / kSelQueries, B);
      if (vnk_resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, smem) == 0) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
      }
      kernel<<<grid, kThreads, static_cast<size_t>(smem), s>>>(x, idx, N, D, k);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_gather<T>(u, v, idx, out, B, N, C3, k, s);
  }
};

}  // namespace

// d: (rows, M) float32 -> vals (rows, k) float32, idx (rows, k) int32;
// design: 0 warp, 1 stream (M a multiple of 4, d 16-byte aligned)
// (ops/knn_pallas.py::topk_design; a design that cannot take the shape
// returns cudaErrorInvalidValue).
VNK_EXPORT int topk_min(const void* d, void* vals, void* idx, int rows, int M,
                        int k, int design, void* stream) {
  if (rows == 0) return 0;
  return by_k<LaunchTopk>(k, static_cast<const float*>(d), static_cast<float*>(vals),
                          static_cast<int*>(idx), rows, M, k, design,
                          static_cast<cudaStream_t>(stream));
}

// q: (B, N, D), r: (B, M, D) float32 at element strides (qsb, qsn, qse) and
// (rsb, rsm, rse) -> vals, idx (B, N, k); D <= 512; design: 0 warp (q
// packed, r packed as (B, D, M): rsm 1, rse M), 1 coords (D <= 4, M <= 4096,
// any strides) (ops/knn_pallas.py::knn_design; a design that cannot take the
// shape returns cudaErrorInvalidValue).
VNK_EXPORT int knn_min(const void* q, const void* r, void* vals, void* idx, int B, int N,
                       int M, int D, int k, int design, int64_t qsb, int64_t qsn, int64_t qse,
                       int64_t rsb, int64_t rsm, int64_t rse, void* stream) {
  if (B == 0 || N == 0) return 0;
  return by_k<LaunchKnn>(k, static_cast<const float*>(q), static_cast<const float*>(r),
                         static_cast<float*>(vals), static_cast<int*>(idx), B, N, M, D, k,
                         design, qsb, qsn, qse, rsb, rsm, rse,
                         static_cast<cudaStream_t>(stream));
}

// x: (B, D, N), u, v: (B, C3, N) float32 -> out (B, C3, k, N) float32,
// idx (B, N, k) int32; D <= 512; design: 0 warp, 1 coords, 2 tiled
// (ops/knn_pallas.py::edge_design; a design that cannot take the shape
// returns cudaErrorInvalidValue).
VNK_EXPORT int edge_knn_gather(const void* x, const void* u, const void* v,
                               void* out, void* idx, int B, int N, int D, int C3,
                               int k, int design, void* stream) {
  if (B == 0 || N == 0) return 0;
  return by_k<LaunchEdge>(k, static_cast<const float*>(x), static_cast<const float*>(u),
                          static_cast<const float*>(v), static_cast<float*>(out),
                          static_cast<int*>(idx), B, N, D, C3, k, design,
                          static_cast<cudaStream_t>(stream));
}

// The bf16 mode: u, v bfloat16 -> out (B, C3, k, N) bfloat16, idx int32;
// x (B, D, N) bfloat16 when x_bf16 is set, else float32; D <= 512; design
// as above.
VNK_EXPORT int edge_knn_gather_bf16(const void* x, const void* u, const void* v,
                                    void* out, void* idx, int B, int N, int D,
                                    int C3, int k, int x_bf16, int design, void* stream) {
  if (B == 0 || N == 0) return 0;
  const vnk_bf16* ub = static_cast<const vnk_bf16*>(u);
  const vnk_bf16* vb = static_cast<const vnk_bf16*>(v);
  vnk_bf16* ob = static_cast<vnk_bf16*>(out);
  int* ib = static_cast<int*>(idx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return by_k<LaunchEdge>(k, static_cast<const vnk_bf16*>(x), ub, vb, ob, ib, B,
                            N, D, C3, k, design, st);
  return by_k<LaunchEdge>(k, static_cast<const float*>(x), ub, vb, ob, ib, B, N,
                          D, C3, k, design, st);
}
