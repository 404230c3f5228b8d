// Building blocks of the wide designs at Cin, Cout >= 16: the matrix passes
// of S' and C' (vn_layer_bwd.cu, "the wide passes") and kernel C's forward
// (vn_layer_fused.cu): a ring of shared-memory stages filled by cp.async,
// the bf16 tensor-core product of one warp (mma.sync m16n8k16, float32
// accumulators) with its operands read by ldmatrix, and the W^T scratch
// the rings stage from.  Kernels S and B, the narrow passes and the fused
// B' keep vn_tile.cuh.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 operands), lane =
// 4 * group + tig:
//   A (16 x 16, row-major): a0 (row group, cols 2 tig, +1), a1 (row group
//     + 8, the same cols), a2, a3 as a0, a1 at cols + 8;
//   B (16 x 8): b0 (rows 2 tig, +1, col group), b1 at rows + 8;
//   C (16 x 8, float32): c0, c1 (row group, cols 2 tig, +1), c2, c3 at row
//     group + 8.
// ldmatrix.x4 hands lane l, for each of four 8 x 8 matrices whose row
// addresses lanes 8i .. 8i+7 give, the elements (row l / 4, cols 2 (l % 4),
// +1); with .trans the elements (rows 2 (l % 4), +1, col l / 4).  So a
// tile stored with the reduction axis contiguous is read plain and one
// stored with the reduction axis strided is read with .trans.
#pragma once

#include "common.cuh"

namespace {

constexpr int kWideThreads = 256;  // 8 warps: the blocks of the wide passes but one

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 16 bytes of a row into shared memory: elements col .. col + 16/sizeof(T)
// - 1 of `row`, of which the first `len` exist (zeros past them).  Whole
// vectors of an `aligned` row go by cp.async; the ragged edge (or an
// unaligned row) is loaded and stored by the thread, visible after the next
// barrier like the copies.
template <typename T>
__device__ __forceinline__ void stage16(T* dst, const T* row, int col, int len, bool aligned) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  if (aligned && col + kV <= len) {
    cp_async16(dst, row + col);
  } else {
#pragma unroll
    for (int e = 0; e < kV; ++e) dst[e] = col + e < len ? row[col + e] : vnk_cast<T>(0.f);
  }
}

// A kRows x kCols tile of a row-major matrix (row stride `gstride`) into
// shared memory at row stride `sstride`, by the kNT threads of the block;
// rows past `rows` and columns past `cols` read as zero.  kCols is a
// multiple of the 16-byte vector.
template <typename T, int kRows, int kCols, int kNT = kWideThreads>
__device__ __forceinline__ void stage_tile(T* dst, int sstride, const T* src, size_t gstride,
                                           int rows, int cols, bool aligned) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kCols / kV;
  static_assert(kCols % kV == 0, "a tile row is whole 16-byte vectors");
#pragma unroll
  for (int e = threadIdx.x; e < kRows * kPerRow; e += kNT) {
    const int r = e / kPerRow, c = (e % kPerRow) * kV;
    stage16(dst + r * sstride + c, src + r * gstride, c, r < rows ? cols : 0, aligned);
  }
}

// The ring: tile t of `tiles` is loaded into stage t % kStages by
// load(stage, t) kStages - 1 tiles ahead of compute(stage).  One barrier a
// tile: it publishes tile t and retires the stage that tile t + kStages - 1
// then overwrites (read by compute of tile t - 1).  A load that goes
// through registers (to widen bf16) finishes with store(stage) after the
// compute that overlaps it.
template <int kStages, typename Load, typename Compute, typename Store>
__device__ __forceinline__ void pipeline(int tiles, Load&& load, Compute&& compute,
                                         Store&& store) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      load(s, s);
      store(s);
    }
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < tiles) load(next % kStages, next);
    cp_async_commit();
    compute(t % kStages);
    if (next < tiles) store(next % kStages);
  }
}

template <int kStages, typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int tiles, Load&& load, Compute&& compute) {
  pipeline<kStages>(tiles, load, compute, [](int) {});
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: exact products of bf16 values, summed into float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows m0 .. m0+15, reduction columns k0 .. k0+15 of a
// bf16 tile stored [m][k] (stride ld elements, k contiguous).
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const vnk_bf16* s, int ld, int m0,
                                       int k0) {
  const int l = threadIdx.x % 32, i = l / 8, r = l % 8;
  ldsm_x4(a, s + (m0 + r + (i & 1) * 8) * ld + k0 + (i >> 1) * 8);
}

// The same fragment from a tile stored [k][m] (m contiguous).
__device__ __forceinline__ void frag_a_t(unsigned (&a)[4], const vnk_bf16* s, int ld, int m0,
                                         int k0) {
  const int l = threadIdx.x % 32, i = l / 8, r = l % 8;
  ldsm_x4_t(a, s + (k0 + r + (i >> 1) * 8) * ld + m0 + (i & 1) * 8);
}

// B fragments of two neighbouring n8 tiles (columns n0 .. n0+15),
// reduction rows k0 .. k0+15: b = {b0, b1 of n0; b0, b1 of n0 + 8}.  From a
// tile stored [n][k] (k contiguous):
__device__ __forceinline__ void frag_b2(unsigned (&b)[4], const vnk_bf16* s, int ld, int n0,
                                        int k0) {
  const int l = threadIdx.x % 32, i = l / 8, r = l % 8;
  ldsm_x4(b, s + (n0 + r + (i >> 1) * 8) * ld + k0 + (i & 1) * 8);
}

// ... and from a tile stored [k][n] (n contiguous).
__device__ __forceinline__ void frag_b2_t(unsigned (&b)[4], const vnk_bf16* s, int ld, int n0,
                                          int k0) {
  const int l = threadIdx.x % 32, i = l / 8, r = l % 8;
  ldsm_x4_t(b, s + (k0 + r + (i & 1) * 8) * ld + n0 + (i >> 1) * 8);
}

// Sum over the four lanes of a quad (the tig of one fragment row), in a
// fixed order; every lane of the quad ends with the sum.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Allow a kernel dynamic shared memory above the 48 KB default (before
// each launch; the call costs about a microsecond).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

// A 16-byte-aligned pointer whose rows (of `stride` elements) start
// 16-byte-aligned too: the tiles of that matrix go by cp.async.
inline bool aligned16(const void* p, int64_t stride, int vec) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride % vec == 0;
}

template <int kNT = kWideThreads, typename Kernel, typename... Args>
cudaError_t launch_wide(Kernel kernel, dim3 grid, int bytes, cudaStream_t st, Args... args) {
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kNT, bytes, st>>>(args...);
  return cudaGetLastError();
}

// W^T (and Wd^T) in the activations' type: wt (1 or 2, Cin, Cout), rounded to
// bf16 in the bf16 mode (the rounding vn_tile.cuh gives W as it stages it).
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
transpose_weights(const float* __restrict__ w, const float* __restrict__ wd,
                  T* __restrict__ wt, int Cin, int Cout) {
  const int64_t total = static_cast<int64_t>(Cin) * Cout;
  const int64_t all = wd != nullptr ? 2 * total : total;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kWideThreads + threadIdx.x; e < all;
       e += static_cast<int64_t>(gridDim.x) * kWideThreads) {
    const int64_t r = e % total;
    const int k = static_cast<int>(r / Cout), c = static_cast<int>(r % Cout);
    wt[e] = vnk_cast<T>((e < total ? w : wd)[static_cast<size_t>(c) * Cin + k]);
  }
}

// Launch transpose_weights: W (and Wd, if not null) into wt.
template <typename T>
void launch_transpose(const float* w, const float* wd, T* wt, int Cin, int Cout,
                      cudaStream_t st) {
  const int64_t n_w = static_cast<int64_t>(Cin) * Cout * (wd != nullptr ? 2 : 1);
  const int64_t need = (n_w + kWideThreads - 1) / kWideThreads;
  const unsigned blocks = static_cast<unsigned>(need < 4096 ? need : 4096);
  transpose_weights<T><<<blocks, kWideThreads, 0, st>>>(w, wd, wt, Cin, Cout);
}

}  // namespace
