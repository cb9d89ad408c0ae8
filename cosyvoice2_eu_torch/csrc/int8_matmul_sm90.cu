// Int8 weight-only matmul (kernel K2) at prefill, on Hopper's tensor cores
// (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel cosyvoice2_eu_tpu/ops/pallas/int8_matmul.py::_kernel
// for bfloat16 x with more rows than a decode tile (M > 8; int8_matmul.cu
// keeps decode, float32 x and K not a multiple of 16).  It computes
//   y32 = x @ w_q^T, unscaled: x (M, K) bfloat16, w_q (N, K) int8, y32 (M, N) fp32;
// the caller multiplies by the per-output-channel scale and adds the bias.
//
// Numerics.  Every int8 code is an integer of magnitude <= 128, exact in
// bf16, so every product is exact and the tensor cores sum them in fp32:
// the kernel differs from x.float() @ w_q.float().T only in the order of the
// fp32 sums (per 16-wide k-step, per K split).
//
// What bounds it on the H100: at the LM's prefill shapes (M = 128 for one
// request, 512 for a batch of four; (N, K) = (896, 896), (128, 896),
// (4864, 896), (896, 4864)) a launch does 2 M N K operations on N K int8
// weight bytes, M K bf16 input bytes and M N fp32 output bytes: 0.03-1.1
// GFLOP at M = 128 and 0.12-4.5 GFLOP at M = 512.  The bytes at 3.35 TB/s
// (the fp32 output the most) bound every shape but (512, 896, 4864), whose
// operations at the bf16 tensor-core rate of 989 TFLOP/s take 4.5 us: the
// bounds run from 0.12 us (M = 128, N = 128) to 4.5 us.  int8_matmul.cu, the
// decode design, is far from that at prefill, for four reasons; this design
// answers each:
//   * no tensor cores, every product an fp32 FMA (67 TFLOP/s): here every
//     product is a wgmma (m64nBNk16, bf16 in, fp32 accumulate).  The sides are
//     swapped, y^T = w_q x^T: 64 output channels are wgmma's M side and up to
//     BN = 128 rows of x its N side, so a ragged M pads only to the next
//     multiple of 8 inside the tile (TMA reads zeros past M) and both operands
//     stay K-major as they are stored;
//   * row tiles of at most 8, so each weight was read 64 times at M = 512:
//     here a block owns 64 channels x BN (64 or 128) rows, so a weight is read
//     once per 128 rows, and the x tile once per 64 channels, from L2;
//   * x re-staged to fp32 by every thread with two __syncthreads per chunk
//     and no overlap of loads and math: here one thread starts TMA loads of
//     the bf16 x tile (64 K x BN rows, 128-byte swizzle: one 128-byte row is
//     64 bf16 of K, the layout wgmma reads as its B operand) and of the int8
//     weight tile (64 K x 64 channels, 64-byte swizzle) into a 3-stage ring of
//     mbarriers (expect_tx completion); a stage is refilled as soon as the
//     warpgroup has released it, so two tiles load while one is multiplied;
//   * a 4-warp block owned only 8 channels and ended with shuffle reductions:
//     here the accumulator holds the block's whole 64 x BN tile in registers
//     (BN / 2 fp32 a thread) and is written once, transposed into y.
// Weights through registers (the RS form of wgmma): each thread reads from
// the swizzled weight tile exactly the 16 bytes of its A fragments (two rows,
// eight 32-bit words; the swizzle makes the reads of a warp conflict-free),
// and turns two int8 into two bf16 with one byte permute, two logic ops and
// one bf16x2 subtraction (i8x2_to_bf16x2, exact for all 256 codes).  The
// alternative, converting into a shared-memory tile in the swizzled layout
// for the SS form, would write and read every weight once more and need a
// barrier between the writes and the wgmma; the register form needs neither.
// Each tile's products are waited for before the stage is released; the
// latency this leaves is covered by other blocks: with 3 stages a block takes
// 61 KB of shared memory (BN = 128) and 106 registers a thread, so three
// blocks fit on an SM and one block's conversion and waits overlap the
// others' products.
// Enough blocks: one 128-thread block per (64 channels, BN rows, K split).
// The caller picks BN and the K splits (ops/int8_matmul.py::sm90_config):
// one split when the output tiles fill half the 132 SMs, else enough for
// about 1.5 blocks per SM, each split at least 3 K tiles of 64.  Split 0
// writes y, split s > 0 its own slice of a workspace, and a second kernel
// adds the slices to y in the order s = 1, 2, ... (no atomics: the sums are
// the same in every run).  The grids of the prefill shapes (channel tiles x
// row tiles x splits):
//   M = 128: (896, 896) 14x1x4, (128, 896) 2x1x4, (4864, 896) 76x1x1,
//            (896, 4864) 14x1x13;
//   M = 512: (896, 896) 14x4x4, (128, 896) 2x4x4, (4864, 896) 76x4x1,
//            (896, 4864) 14x4x4.

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BC = 64;              // output channels per block: wgmma's M side
constexpr int BK = 64;              // K per stage: one 128-byte row of bf16 x
constexpr int STAGES = 3;           // ring depth
constexpr int THREADS = 128;        // one warpgroup
constexpr int W_BYTES = BC * BK;    // int8 weight tile, 64-byte rows

template <int BN>
struct Tile {
  static constexpr int X_BYTES = BN * BK * 2;           // bf16 x tile, 128-byte rows
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;  // a multiple of 1024
  // + 1024 bytes of alignment slack and the barriers
  static constexpr int SMEM_BYTES = 1024 + STAGE_BYTES * STAGES + 2 * STAGES * 8;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 2-D tensor map at (inner, outer) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 (bits 62-63)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses to the accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 fp32) += A B^T: A 64x16 bf16 in registers (4 x bf16x2 a thread),
// B 64x16 bf16 in shared memory, K-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128 fp32) += A B^T: as above with B 128x16
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Two int8 (the bytes picked by sel into the low byte of each 16-bit half)
// -> two bf16, exactly.  With b the byte of w: 0x4300 | (b & 0x7f) is the
// bf16 128 + (b & 0x7f), and 0x4300 | (b & 0x80) is 128 (w >= 0) or 256
// (w < 0, b = w + 256); their difference is w, an integer of magnitude <= 128
// that bf16 holds exactly, so the rounded subtraction returns it.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t word, uint32_t sel) {
  const uint32_t b = __byte_perm(word, 0u, sel);
  const uint32_t lo = (b & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (b & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&d);
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
int8_matmul_sm90(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, float* __restrict__ y,
                 float* __restrict__ ws, int m, int n, int k, int tiles_per_split) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: stages start on that boundary
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);  // the same bytes, for plain loads
  auto x_s = [&](int s) { return base + T::STAGE_BYTES * s; };
  auto w_off = [&](int s) { return T::STAGE_BYTES * s + T::X_BYTES; };
  const uint32_t bars = base + T::STAGE_BYTES * STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * BC;  // first output channel of the block
  const int r0 = blockIdx.y * BN;  // first row of x
  const int kt0 = blockIdx.z * tiles_per_split;
  // > 0: the entry point refuses a split with no tile
  const int n_tiles = min((k + BK - 1) / BK, kt0 + tiles_per_split) - kt0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < STAGES && s < n_tiles; ++s) {
      mbar_expect_tx(full(s), T::STAGE_BYTES);
      tma_load(x_s(s), &map_x, full(s), (kt0 + s) * BK, r0);
      tma_load(base + w_off(s), &map_w, full(s), (kt0 + s) * BK, c0);
    }
  }

  // This thread's A fragments: rows ch and ch + 8 of the weight tile, and of
  // each 16-wide k-step the K pairs 2 (lane % 4) and 8 + 2 (lane % 4): the
  // half (lane & 1) of word (lane % 4) / 2 and of the word two after it.  The
  // 64-byte swizzle moves 16-byte chunk j of row r to chunk j ^ ((r >> 1) & 3),
  // the same for rows ch and ch + 8 (512 bytes apart).
  const int ch = warp * 16 + lane / 4;
  const int row_off = ch * BK + 4 * ((lane & 3) >> 1);
  const int swz = (ch >> 1) & 3;
  const uint32_t sel = (lane & 1) ? 0x4342u : 0x4140u;  // bytes 2,3 or 0,1 to the low bytes

  constexpr int NACC = BN / 2;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % STAGES;
    const uint32_t parity = (kt / STAGES) & 1;
    mbar_wait(full(s), parity);

    // a[4 kk + 2 h + i]: k-step kk, K pair 2 (lane % 4) + 8 h, row ch + 8 i
    uint32_t a[16];
    const uint8_t* wt = smem + w_off(s) + row_off;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a[4 * kk + 2 * h + i] = i8x2_to_bf16x2(
              *reinterpret_cast<const uint32_t*>(wt + 512 * i + ((kk ^ swz) << 4) + 8 * h), sel);

    // y^T tile += W X^T: 4 k-steps of 16; a k-step is 32 bytes into the swizzled x rows
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a + 4 * kk, sw128_desc(x_s(s) + 32 * kk, 16, 1024));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);

    // release the stage; once the warpgroup has, refill it STAGES tiles on
    mbar_arrive(empty(s));
    if (tid == 0 && kt + STAGES < n_tiles) {
      mbar_wait(empty(s), parity);
      mbar_expect_tx(full(s), T::STAGE_BYTES);
      tma_load(x_s(s), &map_x, full(s), (kt0 + kt + STAGES) * BK, r0);
      tma_load(base + w_off(s), &map_w, full(s), (kt0 + kt + STAGES) * BK, c0);
    }
    __syncwarp();
  }

  // acc[4 j + 2 i + c]: channel c0 + ch + 8 i, row r0 + 8 j + 2 (lane % 4) + c
  float* out = blockIdx.z == 0 ? y : ws + (size_t)(blockIdx.z - 1) * m * n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = r0 + 8 * j + 2 * (lane & 3) + c;
        const int chan = c0 + ch + 8 * i;
        if (row < m && chan < n) out[(size_t)row * n + chan] = acc[4 * j + 2 * i + c];
      }
}

// y += ws[0] + ws[1] + ... + ws[parts - 1], in this order, per element
__global__ void add_splits(float* __restrict__ y, const float* __restrict__ ws, size_t count,
                           int parts) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = y[i];
    for (int p = 0; p < parts; ++p) sum += ws[p * count + i];
    y[i] = sum;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver API, through the runtime
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a row-major (rows, k) matrix read in (64, box_rows) boxes; out-of-bounds
// rows and columns read as zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
              int elem_bytes, int rows, int k, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * elem_bytes};  // bytes, dim 1
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const CUtensorMap& map_x, const CUtensorMap& map_w, float* y, float* ws, int m, int n,
           int k, int per, int splits, cudaStream_t stream) {
  static bool allowed = false;  // above 48 KB a block's shared memory must be allowed per kernel
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(int8_matmul_sm90<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Tile<BN>::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const dim3 grid((n + BC - 1) / BC, (m + BN - 1) / BN, splits);
  int8_matmul_sm90<BN><<<grid, THREADS, Tile<BN>::SMEM_BYTES, stream>>>(map_x, map_w, y, ws, m, n,
                                                                        k, per);
  return (int)cudaGetLastError();
}

}  // namespace

// x (m, k) bfloat16, w (n, k) int8, y (m, n) float32, all contiguous, x and w
// on 16-byte boundaries, k a multiple of 16.  A block owns 64 channels and
// `rows` (64 or 128) rows of x.  K is cut into `splits` runs of equal numbers
// of 64-wide tiles (the last may be shorter, none empty); with splits > 1, ws
// holds (splits - 1) float32 (m, n) slices.  Returns a cudaError_t.
extern "C" int cosy_int8_matmul_sm90(const void* x, const void* w, void* y, void* ws, int m, int n,
                                     int k, int rows, int splits, void* stream) {
  const int tiles = (k + BK - 1) / BK;
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 != 0 || (rows != 64 && rows != 128) || splits < 1 ||
      splits > tiles || (m + rows - 1) / rows > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per = (tiles + splits - 1) / splits;
  if ((tiles + per - 1) / per != splits) return (int)cudaErrorInvalidValue;  // an empty split
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;  // TMA reads from 16-byte aligned bases only
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_x, map_w;
  if (!make_map(encode, &map_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, k, rows,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(encode, &map_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, k, BC,
                CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  float* out = static_cast<float*>(y);
  float* part = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = rows == 64 ? launch<64>(map_x, map_w, out, part, m, n, k, per, splits, s)
                             : launch<128>(map_x, map_w, out, part, m, n, k, per, splits, s);
  if (err != 0 || splits == 1) return err;
  const size_t count = (size_t)m * n;
  const int blocks = (int)((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  add_splits<<<blocks, 256, 0, s>>>(out, part, count, splits - 1);
  return (int)cudaGetLastError();
}
