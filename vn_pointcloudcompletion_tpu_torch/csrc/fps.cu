// Kernel F: greedy furthest-point sampling.
//
// Replaces vn_pointcloudcompletion_tpu/ops/fps_pallas.py
// ::furthest_point_sample_pallas (the pallas_call at :85, body _kernel :38).
//
// Semantics kept from the TPU kernel: the first sample is index 0; every
// step updates each point's running minimum of the squared distance to the
// samples so far, in the difference form d0*d0 + d1*d1 + d2*d2 with each
// operation rounded (the file is built with --fmad=false), and takes the
// first point of largest minimum (lowest index on ties).  Exact duplicate
// points (resample padding makes them) then behave as in the JAX package:
// once every minimum is 0 the argmax returns index 0 again.  The plain
// version in ops/fps_pallas.py does the same operations in the same order.
//
// Bound on the H100: operations, about 10 per point per step, far below
// what the algorithm allows, since each of the S - 1 steps depends on the
// one before: the time is (S - 1) x the latency of one step's chain, a
// block-wide argmax and the load of the new sample's coordinates.  The
// design shortens that chain:
//  - one block per sample, sized by N (P = N / threads <= 4 points a thread
//    at 128-1024 threads, 512 at N = 2048; up to 16 above N = 4096), P a
//    template, so no predicated-off iterations; a thread keeps its points'
//    running minima (and, at P <= 8, coordinates) in registers.  More
//    warps make the barrier and the last reduction longer, fewer make each
//    thread's argmax chain longer; of 2, 4 and 8 points a thread, 4 ran
//    fastest at 2048 -> 512 on the H100, and a tree argmax (fmaxf, then the
//    first slot equal to it) was no faster than the running compare;
//  - the whole cloud is copied once into shared memory (3 planes, 196 KB
//    at N = 16384), read from (B, N, 3) with any strides, so the wrapper
//    launches no transpose and each step's new sample is one broadcast
//    shared load;
//  - each candidate is one 64-bit key, (float bits of its minimum) << 32 |
//    (0xFFFFFFFF - index): minima are >= +0, so the largest key is the
//    largest minimum with the lowest index; a warp takes the largest by
//    two __reduce_max_sync (the high word, then the low word of the lanes
//    that hold it);
//  - ONE __syncthreads a step: lane 0 of each warp writes its key to a slot
//    of the step's parity (double-buffered, so step s + 1 cannot overwrite
//    what a slow warp still reads of step s: to write it again a warp must
//    pass step s + 1's barrier, which every warp reaches only after its
//    reads of step s), and every warp then reduces all slots itself, so no
//    second barrier and no broadcast of the pick;
//  - the S picks collect in shared memory and are stored once at the end.
// fps_kernel<P, true> (the entry furthest_point_sample_chain) is the same
// kernel with the per-point arithmetic taken out: the step's chain alone,
// whose time, (S - 1) x one step, is the design's dependency floor.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPoints = 4;      // points a thread up to N = 4096: sizes the block
constexpr int kRegPoints = 8;   // points a thread keeps in registers
constexpr int kMaxPoints = 16;  // N <= 16384 = 1024 x 16, the gate of fps_pallas.eligible
constexpr int kMaxWarps = kMaxThreads / 32;

// The largest of the warp's 64-bit keys (hi, lo), on every lane.
__device__ __forceinline__ uint2 warp_max_key(unsigned hi, unsigned lo) {
  const unsigned wh = __reduce_max_sync(0xffffffffu, hi);
  const unsigned wl = __reduce_max_sync(0xffffffffu, hi == wh ? lo : 0u);
  return make_uint2(wh, wl);
}

// One block per sample; P points a thread (point p = tid + t * blockDim.x).
// kChain: the step's chain without the per-point arithmetic (the floor).
template <int P, bool kChain>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, int64_t sb, int64_t sn, int64_t sc,
           int* __restrict__ idx, int N, int S) {
  constexpr bool kRegs = P <= kRegPoints;
  extern __shared__ float smem[];
  float* px = smem;  // the three coordinate planes, N each
  float* py = px + N;
  float* pz = py + N;
  uint2* slots = reinterpret_cast<uint2*>(smem + ((3 * N + 1) & ~1));  // [2][kMaxWarps]
  int* picks = reinterpret_cast<int*>(slots + 2 * kMaxWarps);          // [S]
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = T >> 5;

  const float* src = xyz + static_cast<int64_t>(blockIdx.x) * sb;
  for (int p = tid; p < N; p += T) {
    const float* pt = src + p * sn;
    px[p] = pt[0];
    py[p] = pt[sc];
    pz[p] = pt[2 * sc];
  }
  __syncthreads();

  // running minima: +inf for a point, -1 for a slot past N (never the
  // argmax: fminf keeps it at -1, and every real minimum is >= +0)
  float md[P];
  float cx[kRegs ? P : 1], cy[kRegs ? P : 1], cz[kRegs ? P : 1];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int p = tid + t * T;
    md[t] = p < N ? INFINITY : -1.f;
    if constexpr (kRegs) {
      cx[t] = p < N ? px[p] : 0.f;
      cy[t] = p < N ? py[p] : 0.f;
      cz[t] = p < N ? pz[p] : 0.f;
    }
  }
  const unsigned chain_lo = ~static_cast<unsigned>(tid % N);
  if (tid == 0) picks[0] = 0;
  int cur = 0;
  for (int s = 1; s < S; ++s) {
    const float l0 = px[cur], l1 = py[cur], l2 = pz[cur];
    unsigned hi, lo;
    if constexpr (kChain) {  // a key that depends on the loaded sample, no points
      hi = __float_as_uint(fabsf(l0 + l1 + l2)) ^ static_cast<unsigned>(tid);
      lo = chain_lo;
    } else {
      float bv = -1.f;
      int bt = 0;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        float x0, x1, x2;
        if constexpr (kRegs) {
          x0 = cx[t], x1 = cy[t], x2 = cz[t];
        } else {
          const int p = min(tid + t * T, N - 1);
          x0 = px[p], x1 = py[p], x2 = pz[p];
        }
        const float d0 = x0 - l0;
        const float d1 = x1 - l1;
        const float d2 = x2 - l2;
        md[t] = fminf(md[t], d0 * d0 + d1 * d1 + d2 * d2);
        if (md[t] > bv) {  // p rises with t: the strict > keeps the first
          bv = md[t];
          bt = t;
        }
      }
      const bool any = bv >= 0.f;  // a thread whose slots all lie past N offers key 0
      hi = any ? __float_as_uint(bv) : 0u;
      lo = any ? ~static_cast<unsigned>(tid + bt * T) : 0u;
    }
    const uint2 wk = warp_max_key(hi, lo);
    uint2* slot = slots + (s & 1) * kMaxWarps;
    if (lane == 0) slot[warp] = wk;
    __syncthreads();
    const uint2 k = lane < warps ? slot[lane] : make_uint2(0u, 0u);
    cur = static_cast<int>(~warp_max_key(k.x, k.y).y);
    if (tid == 0) picks[s] = cur;
  }
  __syncthreads();
  int* out = idx + static_cast<int64_t>(blockIdx.x) * S;
  for (int s = tid; s < S; s += T) out[s] = picks[s];
}

template <bool kChain>
int launch_fps(const float* xyz, int64_t sb, int64_t sn, int64_t sc, int* idx, int B, int N,
               int S, cudaStream_t stream) {
  if (B == 0 || S == 0) return 0;
  if (N <= 0 || N > kMaxThreads * kMaxPoints || S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads = 128;  // the fewest threads with at most kPoints points each
  while (threads < kMaxThreads && threads * kPoints < N) threads *= 2;
  const int per = (N + threads - 1) / threads;
  const int smem = static_cast<int>(sizeof(float)) * ((3 * N + 1) & ~1) +
                   static_cast<int>(sizeof(uint2)) * 2 * kMaxWarps +
                   static_cast<int>(sizeof(int)) * S;
  using Kernel = void (*)(const float*, int64_t, int64_t, int64_t, int*, int, int);
  Kernel kernel = nullptr;
  switch (per) {
#define VNK_FPS_CASE(p) \
  case p:               \
    kernel = &fps_kernel<p, kChain>; \
    break;
    VNK_FPS_CASE(1) VNK_FPS_CASE(2) VNK_FPS_CASE(3) VNK_FPS_CASE(4)
    VNK_FPS_CASE(5) VNK_FPS_CASE(6) VNK_FPS_CASE(7) VNK_FPS_CASE(8)
    VNK_FPS_CASE(9) VNK_FPS_CASE(10) VNK_FPS_CASE(11) VNK_FPS_CASE(12)
    VNK_FPS_CASE(13) VNK_FPS_CASE(14) VNK_FPS_CASE(15) VNK_FPS_CASE(16)
#undef VNK_FPS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // allows the shared memory above 48 KB; 0: the card cannot hold the block
  if (vnk_resident_blocks(reinterpret_cast<const void*>(kernel), threads, smem) == 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  kernel<<<B, threads, static_cast<size_t>(smem), stream>>>(xyz, sb, sn, sc, idx, N, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz: (B, N, 3) float32 at strides (sb, sn, sc) elements -> idx (B, S)
// int32; N <= 16384.
VNK_EXPORT int furthest_point_sample(const void* xyz, void* idx, int B, int N, int S,
                                     int64_t sb, int64_t sn, int64_t sc, void* stream) {
  return launch_fps<false>(static_cast<const float*>(xyz), sb, sn, sc, static_cast<int*>(idx),
                           B, N, S, static_cast<cudaStream_t>(stream));
}

// The same launch with the per-point arithmetic taken out: its
// time is (S - 1) steps of the chain alone; idx gets indices of no meaning.
VNK_EXPORT int furthest_point_sample_chain(const void* xyz, void* idx, int B, int N, int S,
                                           int64_t sb, int64_t sn, int64_t sc, void* stream) {
  return launch_fps<true>(static_cast<const float*>(xyz), sb, sn, sc, static_cast<int*>(idx),
                          B, N, S, static_cast<cudaStream_t>(stream));
}
