// The tensor cores' k16 step on crafted operands, read back as float32
// (tools/probe_k16.py).  Each problem is D = C + A B with A (64 x K), B
// (K x 64) bf16 and C, D (64 x 64) float32, all given:
//   a (P, K, 64): A stored [k][m] (the rows of A contiguous: W^T's layout
//     in the kernels); b (P, K, 64): B stored [k][n]; c, d (P, 64, 64): [m][n].
// probe_mma runs it as mma.sync: one warp an m16n8 tile, its k steps
// chained through the float32 accumulator in ascending k (k16: the
// m16n8k16 step of pd_wide_mma and proj_wide_mma; k8: m16n8k8 steps, to
// tell a k16 step from two k8 halves).  probe_wgmma runs it as
// wgmma.m64n64k16 with both operands MN-major in 128-byte swizzled shared
// memory, as pd_wgmma and proj_wgmma read W^T and x: one warpgroup a
// problem, its K / 16 products either in one commit group (the kernels'
// way: `grouped`) or each committed and waited on alone.  The accumulators
// go out unrounded, so the float32 result of every step is seen, not only
// its bf16 rounding.
#include "../vn_pointcloudcompletion_tpu_torch/csrc/vn_wgmma.cuh"

namespace {

__device__ __forceinline__ unsigned pack2(const vnk_bf16* p0, const vnk_bf16* p1) {
  return static_cast<unsigned>(__bfloat16_as_ushort(*p0)) |
         static_cast<unsigned>(__bfloat16_as_ushort(*p1)) << 16;
}

__device__ __forceinline__ void mma_k8(float (&c)[4], unsigned a0, unsigned a1, unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Warp w of the grid: problem w / 32, its m16n8 tile w % 32 (rows 16 (t /
// 8), columns 8 (t % 8)).
__global__ void probe_mma_kernel(const vnk_bf16* __restrict__ a, const vnk_bf16* __restrict__ b,
                                 const float* __restrict__ c, float* __restrict__ d, int P, int K,
                                 int k8) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (warp >= P * 32) return;
  const int pr = warp / 32, tile = warp % 32, m0 = tile / 8 * 16, n0 = tile % 8 * 8;
  const int grp = lane / 4, tig = lane % 4;
  const vnk_bf16* A = a + static_cast<size_t>(pr) * K * 64;  // A(m, k) = A[k * 64 + m]
  const vnk_bf16* B = b + static_cast<size_t>(pr) * K * 64;  // B(k, n) = B[k * 64 + n]
  const float* C = c + static_cast<size_t>(pr) * 4096;
  float acc[4];
  for (int e = 0; e < 4; ++e)
    acc[e] = C[(m0 + grp + 8 * (e / 2)) * 64 + n0 + 2 * tig + e % 2];
  auto at = [&](const vnk_bf16* base, int k, int col) { return base + k * 64 + col; };
  const int step = k8 ? 8 : 16;
  for (int k0 = 0; k0 < K; k0 += step) {
    const int kc = k0 + 2 * tig;
    const unsigned a0 = pack2(at(A, kc, m0 + grp), at(A, kc + 1, m0 + grp));
    const unsigned a1 = pack2(at(A, kc, m0 + grp + 8), at(A, kc + 1, m0 + grp + 8));
    const unsigned b0 = pack2(at(B, kc, n0 + grp), at(B, kc + 1, n0 + grp));
    if (k8) {
      mma_k8(acc, a0, a1, b0);
    } else {
      const unsigned af[4] = {a0, a1, pack2(at(A, kc + 8, m0 + grp), at(A, kc + 9, m0 + grp)),
                              pack2(at(A, kc + 8, m0 + grp + 8), at(A, kc + 9, m0 + grp + 8))};
      mma_bf16(acc, af, b0, pack2(at(B, kc + 8, n0 + grp), at(B, kc + 9, n0 + grp)));
    }
  }
  float* D = d + static_cast<size_t>(pr) * 4096;
  for (int e = 0; e < 4; ++e) D[(m0 + grp + 8 * (e / 2)) * 64 + n0 + 2 * tig + e % 2] = acc[e];
}

// Byte offset of element (row, col) of a tile of 128-byte rows in TMA's
// 128-byte swizzle (its 16-byte chunks permuted by the row within each
// 1024-byte atom).
__device__ __forceinline__ int swizzled(int row, int col) {
  const int byte = row * 128 + col * 2;
  return byte ^ (((byte >> 7) & 7) << 4);
}

__global__ void __launch_bounds__(128, 1)
probe_wgmma_kernel(const vnk_bf16* __restrict__ a, const vnk_bf16* __restrict__ b,
                   const float* __restrict__ c, float* __restrict__ d, int K, int grouped) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sa = align1024(smem_raw);
  unsigned char* const sb = sa + K * 128;
  const int pr = blockIdx.x, t = threadIdx.x;
  const vnk_bf16* A = a + static_cast<size_t>(pr) * K * 64;
  const vnk_bf16* B = b + static_cast<size_t>(pr) * K * 64;
  for (int e = t; e < K * 64; e += 128) {
    *reinterpret_cast<vnk_bf16*>(sa + swizzled(e / 64, e % 64)) = A[e];
    *reinterpret_cast<vnk_bf16*>(sb + swizzled(e / 64, e % 64)) = B[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // thread t holds d[4 i + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2),
  // column 8 i + 2 (t % 4) + e % 2
  const int row0 = 16 * (t / 32) + (t % 32) / 4, col0 = 2 * (t % 4);
  const float* C = c + static_cast<size_t>(pr) * 4096;
  float acc[32];
  for (int i = 0; i < 8; ++i)
    for (int e = 0; e < 4; ++e) acc[4 * i + e] = C[(row0 + 8 * (e / 2)) * 64 + 8 * i + col0 + e % 2];
  fence_acc(acc);
  wgmma_fence();
  for (int kk = 0; kk < K / 16; ++kk) {
    wgmma_m64n64k16_tt(acc, gmma_desc(sa + kk * 16 * 128, 8192, 1024),
                       gmma_desc(sb + kk * 16 * 128, 8192, 1024));
    if (!grouped) {
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      wgmma_fence();
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
  float* D = d + static_cast<size_t>(pr) * 4096;
  for (int i = 0; i < 8; ++i)
    for (int e = 0; e < 4; ++e) D[(row0 + 8 * (e / 2)) * 64 + 8 * i + col0 + e % 2] = acc[4 * i + e];
}

}  // namespace

// P problems of depth K (a multiple of 16; 8 for k8) as mma.sync k16
// (k8 = 0) or k8 (k8 = 1) steps.
VNK_EXPORT int probe_mma(const void* a, const void* b, const void* c, void* d, int P, int K,
                         int k8, void* stream) {
  const int threads = P * 32 * 32;
  probe_mma_kernel<<<(threads + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vnk_bf16*>(a), static_cast<const vnk_bf16*>(b),
      static_cast<const float*>(c), static_cast<float*>(d), P, K, k8);
  return static_cast<int>(cudaGetLastError());
}

// ... as wgmma.m64n64k16 (K a multiple of 16, at most 256).
VNK_EXPORT int probe_wgmma(const void* a, const void* b, const void* c, void* d, int P, int K,
                           int grouped, void* stream) {
  if (K % 16 != 0 || K > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = 1024 + 2 * K * 128;
  const cudaError_t err = allow_smem(probe_wgmma_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_wgmma_kernel<<<P, 128, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vnk_bf16*>(a), static_cast<const vnk_bf16*>(b),
      static_cast<const float*>(c), static_cast<float*>(d), K, grouped);
  return static_cast<int>(cudaGetLastError());
}
