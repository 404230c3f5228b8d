// Hopper's warpgroup tensor-core products fed by the Tensor Memory
// Accelerator: passes 2 and 3 of the wide bf16 S' and C' ("wgmma" design,
// vn_layer_bwd.cu; ops/vn_layer_fused.py::wide_bf16_design), the product
// of pass 1 of S and S' ("wgmma_p" design, pd_wgmma in vn_layer_bwd.cu,
// whose epilogue needs the layer's arguments) and bf16 C (proj_wgmma in
// vn_layer_fused.cu, the "wgmma" design of fwd_bf16_design).
//
// A block is three warpgroups' worth of warps: two consumer warpgroups
// (warps 0-7; wgmma needs whole, aligned warpgroups), each owning 64 rows
// of the block's 128-row output tile, and one producer warp (warp 8) whose
// first lane keeps TMA loads in flight.  The operands go through a ring of
// shared-memory stages, each with two mbarriers: `full` (the producer's
// arrive.expect_tx, completed by the TMA engine when the stage's bytes have
// landed) and `empty` (one arrival from each of the 256 consumer threads
// once their wgmma products on the stage have completed).  Tiles are 64
// bf16 wide in the reduction or the point axis, 128 bytes a row, in TMA's
// 128-byte swizzle, which the wgmma descriptors name (layout type 1):
//   K-major operand (the reduction axis contiguous: W^T in pass 2, dp, dd
//     and x in pass 3): rows of 128 bytes, 8-row groups 1024 bytes apart
//     (SBO); a 16-deep slice of the 64-deep stage starts 32 bytes further;
//   MN-major operand (dp, dd in pass 2: the points, pass 2's N, contiguous):
//     64-point boxes of 64 reduction rows, 8 KB apart (LBO), 8-row groups
//     of the reduction 1024 bytes apart (SBO); a 16-deep slice starts 2048
//     bytes further.
// Every stage base is 1024-byte aligned, so the descriptors' base offset
// is 0.  The accumulators (m64n128k16, float32) lie as mma.sync's C
// fragments: thread t of a warpgroup holds, for each 8-column block i,
// d[4 i + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 i +
// 2 (t % 4) + e % 2.
//
// The tensor maps are encoded on the host for each launch
// (cuTensorMapEncodeTiled, fetched from the driver at run time: the library
// links against the runtime only) and passed as __grid_constant__
// parameters.  Out-of-range boxes (ragged N, a 64-channel half tile) fill
// with zeros, which add nothing to a product.
#pragma once

#include <cuda.h>

#include "vn_mma.cuh"

namespace {

constexpr int kWgThreads = 288;  // two consumer warpgroups + the producer warp
constexpr int kWgTile = 128;     // output rows and columns of a block
constexpr int kWgDepth = 64;     // reduction depth of a stage (128 bytes of bf16)

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of `planes` bf16 matrices of rows x cols (cols contiguous, a
// plane rows * cols elements), read in boxes of box_cols x box_rows of one
// plane, 128-byte swizzled.  Needs cols % 8 == 0 and a 16-byte aligned base.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int cols, int rows, int planes,
                              int box_cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * rows * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Shared memory of a wgmma kernel: its stages, 1024 bytes of slack to align
// them, and the two barriers of each stage.
constexpr int wg_smem(int stage_bytes, int stages) {
  return 1024 + stages * stage_bytes + 2 * stages * 8;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const unsigned a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One box of a 3-D tensor map into shared memory; the bytes count towards
// `bar`'s expected transaction.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The wgmma descriptor of a 128-byte swizzled operand at `p` (1024-byte
// aligned atoms; `lbo`, `sbo` in bytes).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, unsigned lbo, unsigned sbo) {
  uint64_t d = (smem_addr(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= 1ull << 62;  // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most kPending of the warpgroup's committed groups of
// products are still in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, float32) += A (64 x 16) B (16 x 64), both MN-major (A's rows
// and B's columns contiguous: W^T and x in pass 1 of S and S'): bf16
// operands, exact products summed into float32.
__device__ __forceinline__ void wgmma_m64n64k16_tt(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, K-major) B (16 x 128): bf16 operands,
// exact products summed into float32.  kTransB: B is MN-major.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
}

// Pass 2, dx[bj, m, n] = sum_c W^T[m, c] g1[bj, c, n] (+ Wd^T g2): a block
// owns 128 input channels x 128 points of one plane; its reduction runs
// over the Cout channels of (W^T, g1), then of (Wd^T, g2), 64 a stage.
// Stage: A (128 rows of W^T, 64 channels; K-major) then B (64 channels x
// 128 points as two 64-point boxes; MN-major).  Two blocks an SM.  The
// epilogue writes the bf16 tile into the freed stages first and stores it
// in whole 16-byte pieces of a row: dx is a third of the pass's bytes, and
// each thread storing its own bf16 pairs (16 bytes of a row a warp) was
// the slower on the card, with the same bits, in a one-off comparison the
// repository does not keep (so its times are not recorded).
struct DxWg {
  static constexpr int kA = kWgTile * kWgDepth * 2, kB = kWgDepth * kWgTile * 2;
  static constexpr int kStage = kA + kB, kStages = 3;
  static constexpr int kBytes = wg_smem(kStage, kStages);
  static constexpr int kOutLd = kWgTile + 8;  // bf16 a row of the staged output
};

// The two consumer warpgroups (named barrier 1; the producer warp may have
// left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <bool kTwo>
__global__ void __launch_bounds__(kWgThreads, 2)
dx_wgmma(const __grid_constant__ CUtensorMap tm_wt, const __grid_constant__ CUtensorMap tm_g1,
         const __grid_constant__ CUtensorMap tm_g2, vnk_bf16* __restrict__ dx, int Cin, int Cout,
         int N) {
  using P = DxWg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const tiles = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(tiles + P::kStages * P::kStage);
  uint64_t* const empty = full + P::kStages;
  const int m0 = blockIdx.x * kWgTile, n0 = blockIdx.y * kWgTile, bj = blockIdx.z;
  const int nk = (Cout + kWgDepth - 1) / kWgDepth;
  const int steps = kTwo ? 2 * nk : nk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp: its first lane issues the loads
    if (threadIdx.x == 256) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % P::kStages;
        mbar_wait(&empty[s], ((it / P::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], P::kStage);
        const int mat = it >= nk ? 1 : 0, c0 = (it - mat * nk) * kWgDepth;
        unsigned char* st = tiles + s * P::kStage;
        tma_load(st, &tm_wt, &full[s], c0, m0, mat);
        const CUtensorMap* g = mat ? &tm_g2 : &tm_g1;
        tma_load(st + P::kA, g, &full[s], n0, c0, bj);
        tma_load(st + P::kA + P::kB / 2, g, &full[s], n0 + 64, c0, bj);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int s = it % P::kStages;
    mbar_wait(&full[s], (it / P::kStages) & 1);
    const unsigned char* st = tiles + s * P::kStage;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgDepth / 16; ++kk) {
      const uint64_t a = gmma_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t b = gmma_desc(st + P::kA + kk * 16 * 128, P::kB / 2, 1024);
      wgmma_m64n128k16<1>(d, a, b);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(d);
    mbar_arrive(&empty[s]);
  }

  // the stages are free once both warpgroups are past their last one
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  consumers_sync();
  vnk_bf16* out = reinterpret_cast<vnk_bf16*>(tiles);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    vnk_bf16* row = out + (wg * 64 + w * 16 + grp + 8 * r) * P::kOutLd;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + 2 * tig) =
          __floats2bfloat162_rn(d[4 * i + 2 * r], d[4 * i + 2 * r + 1]);
  }
  consumers_sync();
  constexpr int kPieces = kWgTile / 8;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < kWgTile * kPieces; e += 256) {
    const int r = e / kPieces, c = (e % kPieces) * 8;
    const int m = m0 + r, n = n0 + c;  // N % 8 == 0: a piece is in or out whole
    if (m < Cin && n < N)
      *reinterpret_cast<uint4*>(dx + (static_cast<size_t>(bj) * Cin + m) * N + n) =
          *reinterpret_cast<const uint4*>(out + r * P::kOutLd + c);
  }
}

// Pass 3, split K: part[s, c, k] = sum over the stages of chunk s of
// g1[bj, c, n] x[bj, k, n] (part2 with g2).  Stage t of the B*3 planes'
// ceil(N / 64) each is plane t / tiles_n, points (t % tiles_n) 64 ..; chunk
// s is stages s * chunk .. (s + 1) * chunk - 1.  A block owns 128 output
// channels x 128 input channels; a stage holds g1 (and g2) at 128 channels
// x 64 points and x at 128 channels x 64 points, all K-major.
template <bool kTwo>
struct DwWg {
  static constexpr int kA = kWgTile * kWgDepth * 2, kB = kWgTile * kWgDepth * 2;
  static constexpr int kStage = (kTwo ? 2 : 1) * kA + kB, kStages = kTwo ? 4 : 6;
  static constexpr int kBytes = wg_smem(kStage, kStages);
};

template <bool kTwo>
__global__ void __launch_bounds__(kWgThreads, 1)
dw_wgmma(const __grid_constant__ CUtensorMap tm_g1, const __grid_constant__ CUtensorMap tm_g2,
         const __grid_constant__ CUtensorMap tm_x, float* __restrict__ part,
         float* __restrict__ part2, int Cin, int Cout, int N, int planes, int chunk) {
  using P = DwWg<kTwo>;
  constexpr int kNh = kTwo ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const tiles = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(tiles + P::kStages * P::kStage);
  uint64_t* const empty = full + P::kStages;
  const int k0 = blockIdx.x * kWgTile, c0 = blockIdx.y * kWgTile, s = blockIdx.z;
  const int tiles_n = (N + kWgDepth - 1) / kWgDepth;
  const int t0 = s * chunk;
  const int count = min(chunk, planes * tiles_n - t0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      for (int it = 0; it < count; ++it) {
        const int st_i = it % P::kStages;
        mbar_wait(&empty[st_i], ((it / P::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st_i], P::kStage);
        const int t = t0 + it, bj = t / tiles_n, n0 = (t % tiles_n) * kWgDepth;
        unsigned char* st = tiles + st_i * P::kStage;
        tma_load(st, &tm_g1, &full[st_i], n0, c0, bj);
        if (kTwo) tma_load(st + P::kA, &tm_g2, &full[st_i], n0, c0, bj);
        tma_load(st + kNh * P::kA, &tm_x, &full[st_i], n0, k0, bj);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  float d[kNh][64];
#pragma unroll
  for (int h = 0; h < kNh; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[h][i] = 0.f;
  for (int it = 0; it < count; ++it) {
    const int st_i = it % P::kStages;
    mbar_wait(&full[st_i], (it / P::kStages) & 1);
    const unsigned char* st = tiles + st_i * P::kStage;
#pragma unroll
    for (int h = 0; h < kNh; ++h) fence_acc(d[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgDepth / 16; ++kk) {
      const uint64_t b = gmma_desc(st + kNh * P::kA + kk * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < kNh; ++h)
        wgmma_m64n128k16<0>(d[h], gmma_desc(st + h * P::kA + wg * 64 * 128 + kk * 32, 16, 1024),
                            b);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < kNh; ++h) fence_acc(d[h]);
    mbar_arrive(&empty[st_i]);
  }

  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
#pragma unroll
  for (int h = 0; h < kNh; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = c0 + wg * 64 + w * 16 + grp + 8 * r;
      if (c >= Cout) continue;
      float* row = (h == 0 ? part : part2) + (static_cast<size_t>(s) * Cout + c) * Cin;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + 8 * i + 2 * tig;  // Cin % 64 == 0: both columns or neither
        if (k < Cin)
          *reinterpret_cast<float2*>(row + k) =
              make_float2(d[h][4 * i + 2 * r], d[h][4 * i + 2 * r + 1]);
      }
    }
}

}  // namespace
