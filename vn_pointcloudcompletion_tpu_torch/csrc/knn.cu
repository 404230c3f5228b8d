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
// min / argmin / mask over it.  Here one warp owns one query row: each lane
// walks the columns lane, lane + 32, ... in ascending order and keeps its own
// k best (value, index) pairs sorted in registers (an insertion that bubbles
// the candidate down the list), then k rounds of a butterfly argmin over the
// 32 lanes' heads merge the lists.  Nothing is written but the k results.
// K3 gives each block 32 queries (8 warps, 4 rows each), keeps their indices
// in shared memory and writes the gathered rows with neighbouring threads on
// neighbouring queries, so every store is a full 128-byte line.
//
// K3's bf16 mode (the bfloat16 compute policy; knn_pallas.py:298-333 on
// bf16 features): x is read as bf16 or float32 and upcast exactly, so the
// distances and the selection are the float32 mode's on those values; u and
// v are bf16, the gather is exact, and out = bf16(float(u[idx]) + float(v))
// rounded to nearest even, the TPU kernel's `g.astype(v.dtype) + v`.
//
// Bound on the H100.  K1: bytes (one read of the matrix).  K2 at the main
// path's D = 3: operations, about 12 per (query, reference) pair for the
// distance and the compare, on the CUDA cores.  K3: bytes, the (B, C3, k, N)
// output written once.  The gather reads of u hit L2 (u is at most 1.6 MB per
// sample).
#include <limits.h>
#include <math.h>

#include "common.cuh"

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

// The warp's k smallest pairs from the 32 lane lists: round r finds the
// smallest head (value, then index) with a butterfly over the lanes, the
// owning lane drops its head, and lane 0 hands (r, value, index) to emit.
template <int K, typename Emit>
__device__ __forceinline__ void warp_merge(LaneList<K>& l, int k, Emit emit) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    float bv = l.v[0];
    int bi = l.i[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (l.i[0] == bi) l.pop();
    if (lane == 0) emit(r, bv, bi);
  }
}

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

// K1: d (rows, M) -> vals, idx (rows, k).
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

// K2: q (B, N, D), rt (B, D, M) -> vals, idx (B, N, k).
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

template <template <int> class Launch, typename... Args>
int by_k(int k, Args... args) {
  if (k <= 16) return Launch<16>::run(args...);
  if (k <= 32) return Launch<32>::run(args...);
  if (k <= 64) return Launch<64>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int K>
struct LaunchTopk {
  static int run(const float* d, float* vals, int* idx, int rows, int M, int k,
                 cudaStream_t s) {
    topk_min_kernel<K><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        d, vals, idx, rows, M, k);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int K>
struct LaunchKnn {
  static int run(const float* q, const float* rt, float* vals, int* idx, int B,
                 int N, int M, int D, int k, cudaStream_t s) {
    const dim3 grid((N + kWarps - 1) / kWarps, B);
    const size_t shmem = sizeof(float) * kWarps * D;
    knn_min_kernel<K><<<grid, kThreads, shmem, s>>>(q, rt, vals, idx, N, M, D, k);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int K>
struct LaunchEdge {
  template <typename X, typename T>
  static int run(const X* x, const T* u, const T* v, T* out, int* idx, int B,
                 int N, int D, int C3, int k, cudaStream_t s) {
    const dim3 grid((N + kEdgeQueries - 1) / kEdgeQueries, B);
    const size_t shmem = sizeof(float) * kWarps * D + sizeof(int) * kEdgeQueries * k;
    edge_knn_gather_kernel<K, X, T><<<grid, kThreads, shmem, s>>>(
        x, u, v, out, idx, N, D, C3, k);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// d: (rows, M) float32 -> vals (rows, k) float32, idx (rows, k) int32.
VNK_EXPORT int topk_min(const void* d, void* vals, void* idx, int rows, int M,
                        int k, void* stream) {
  if (rows == 0) return 0;
  return by_k<LaunchTopk>(k, static_cast<const float*>(d), static_cast<float*>(vals),
                          static_cast<int*>(idx), rows, M, k,
                          static_cast<cudaStream_t>(stream));
}

// q: (B, N, D), rt: (B, D, M) float32 -> vals, idx (B, N, k); D <= 512.
VNK_EXPORT int knn_min(const void* q, const void* rt, void* vals, void* idx,
                       int B, int N, int M, int D, int k, void* stream) {
  if (B == 0 || N == 0) return 0;
  return by_k<LaunchKnn>(k, static_cast<const float*>(q), static_cast<const float*>(rt),
                         static_cast<float*>(vals), static_cast<int*>(idx), B, N, M,
                         D, k, static_cast<cudaStream_t>(stream));
}

// x: (B, D, N), u, v: (B, C3, N) float32 -> out (B, C3, k, N) float32,
// idx (B, N, k) int32; D <= 512.
VNK_EXPORT int edge_knn_gather(const void* x, const void* u, const void* v,
                               void* out, void* idx, int B, int N, int D, int C3,
                               int k, void* stream) {
  if (B == 0 || N == 0) return 0;
  return by_k<LaunchEdge>(k, static_cast<const float*>(x), static_cast<const float*>(u),
                          static_cast<const float*>(v), static_cast<float*>(out),
                          static_cast<int*>(idx), B, N, D, C3, k,
                          static_cast<cudaStream_t>(stream));
}

// The bf16 mode: u, v bfloat16 -> out (B, C3, k, N) bfloat16, idx int32;
// x (B, D, N) bfloat16 when x_bf16 is set, else float32; D <= 512.
VNK_EXPORT int edge_knn_gather_bf16(const void* x, const void* u, const void* v,
                                    void* out, void* idx, int B, int N, int D,
                                    int C3, int k, int x_bf16, void* stream) {
  if (B == 0 || N == 0) return 0;
  const vnk_bf16* ub = static_cast<const vnk_bf16*>(u);
  const vnk_bf16* vb = static_cast<const vnk_bf16*>(v);
  vnk_bf16* ob = static_cast<vnk_bf16*>(out);
  int* ib = static_cast<int*>(idx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return by_k<LaunchEdge>(k, static_cast<const vnk_bf16*>(x), ub, vb, ob, ib, B,
                            N, D, C3, k, st);
  return by_k<LaunchEdge>(k, static_cast<const float*>(x), ub, vb, ob, ib, B, N,
                          D, C3, k, st);
}
