// Flash-attention forward in bf16 on Hopper's tensor cores (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel cosyvoice2_eu_tpu/ops/pallas/flash_attention.py::
// _attn_kernel for bfloat16 inputs (flash_attention.cu keeps float32).  It
// computes softmax(Q K^T * scale) V per (batch*head) with an online softmax
// and builds the mask per tile from the scalars length[b] and chunk, exactly
// as flash_attention.cu does:
//   key j is visible to query i iff j < length[b] and, when chunk > 0,
//   j < (i / chunk + 1) * chunk.
// A key at or past T gets -inf; a key at or past the row's limit gets the
// TPU kernel's finite -1e30; l is clamped at 1e-30.  Key tiles past the chunk
// bound are skipped, and so are tiles past length[b] when length[b] > 0.  So
// a row with no visible key (length[b] == 0) is the mean of V over the
// visited keys: all T keys at chunk 0, as the plain version gives; with
// chunk > 0 the visited keys end at this kernel's 128-key tile boundary.
//
// Inputs q, k, v: (B*H, T, 64) bfloat16, contiguous, 16-byte aligned; output
// o in bfloat16; optional fp32 natural-log log-sum-exp (B*H, T).
//
// Numerics.  S = Q K^T is exact bf16 products summed in fp32 by the tensor
// cores, scaled afterwards in fp32 by scale*log2(e) (Q is not pre-scaled in
// bf16, which would add a rounding).  The softmax is base 2 in fp32.  P is
// rounded to bf16 to feed P V, the one rounding the plain version does not
// have (about 2^-9 |v| / sqrt(n_eff) on O); the row sum l is taken from the
// fp32 P before that rounding, so the LSE keeps fp32 accuracy.
//
// What bounds it on the H100: at the TTS shapes (B*H = 16, D = 64, T 1280 to
// 1536) a launch does 4*D flops per visible (query, key) pair, 5-9 GFLOP on
// 10-13 MB, far above the card's ~295 FLOP/byte ridge: operations bound, at
// the bf16 tensor-core rate of 989 TFLOP/s (about 7 us).  flash_attention.cu's
// first design ran both products on the fp32 FMA units (67 TFLOP/s), widened
// bf16 to fp32 in shared memory (twice the bytes, K transposed), loaded with
// every thread synchronously and had three __syncthreads per tile, so no load
// overlapped any math.  This design answers each:
//   * both products on the tensor cores: S by wgmma m64n128k16 with Q and K
//     from shared memory (both D-contiguous, so no transpose), O += P V by
//     wgmma m64n64k16 with P from registers and V from shared memory in
//     MN-major form (the transpose bit of 16-bit types);
//   * Q, K and V stay bf16 in shared memory, loaded by TMA with 128-byte
//     swizzle (a 64-wide bf16 row is exactly 128 bytes), the layout wgmma
//     reads without bank conflicts;
//   * one thread starts the loads; K/V tiles of 128 keys come through a
//     2-stage ring of mbarriers (expect_tx completion), so the next tile
//     loads while this one is multiplied; no __syncthreads in the loop: a
//     stage is refilled once both warpgroups have released it;
//   * P never leaves registers: the S accumulator's row/column layout is the
//     A-operand layout of the P V product, so the softmax is done on the
//     accumulator (quad shuffles) and converted in place.
// Blocks: one per (128-query tile, b*h), 256 threads = two consumer
// warpgroups of 64 query rows each, sharing the K/V tiles.  About 81 KB of
// shared memory and at most 128 registers a thread, so two blocks fit on
// each of the 132 SMs: the TTS grid (160-192 blocks) is resident at once, and
// one block's softmax overlaps the other's products.  128-key tiles halve the
// per-tile overhead (barriers, O rescale) against 64, and a 128-query block
// reads each K/V tile once for two warpgroups.  The tensor map is 3-D (D, T,
// B*H), so a tile past T is filled with zeros and never reads the next head.

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                     // head dim: one 128-byte bf16 row
constexpr int BQ = 128;                   // query rows per block
constexpr int BK = 128;                   // keys per K/V tile
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int THREADS = 256;              // two warpgroups
constexpr int TILE_BYTES = BK * D * 2;    // 16 KB: one Q, K or V tile (BQ == BK)
constexpr int SMEM_BYTES = 1024 + TILE_BYTES * (1 + 2 * STAGES) + 64;  // 1024-B alignment slack
constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// one (D, 128, 1) box of a (D, T, B*H) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(bh)
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

// d (64x128 fp32) = A B^T (+ d if accumulate): A 64x16 and B 128x16, both
// K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64x64 fp32) += A B: A 64x16 bf16 in registers (4 x bf16x2 a thread),
// B 16x64 bf16 in shared memory, MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_sm90(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const int* __restrict__ lengths,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int heads, int t,
               int chunk, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t q_s = base;  // Q tile, then K and V of stage s at base + (1 + 2s, 2 + 2s) tiles
  const uint32_t bars = base + TILE_BYTES * (1 + 2 * STAGES);
  const uint32_t bar_q = bars;
  auto k_s = [&](int s) { return base + TILE_BYTES * (1 + 2 * s); };
  auto v_s = [&](int s) { return base + TILE_BYTES * (2 + 2 * s); };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int length = lengths[bh / heads];

  // number of key tiles any row of this block can see
  const int q_last = min(q0 + BQ, t) - 1;
  int kv_end = t;
  if (chunk > 0) kv_end = min(kv_end, (q_last / chunk + 1) * chunk);
  if (length > 0) kv_end = min(kv_end, length);
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, TILE_BYTES);
    tma_load(q_s, &map_q, bar_q, q0, bh);
    for (int s = 0; s < STAGES && s < n_tiles; ++s) {
      mbar_expect_tx(full(s), 2 * TILE_BYTES);
      tma_load(k_s(s), &map_k, full(s), s * BK, bh);
      tma_load(v_s(s), &map_v, full(s), s * BK, bh);
    }
  }

  // this thread's two rows of the accumulators: r0 and r0 + 8; its columns
  // of each 8-column group j: 8j + 2 (lane % 4) + {0, 1}
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  int limit[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    limit[i] = chunk > 0 ? min((row / chunk + 1) * chunk, length) : length;
  }
  const int mask_from = min(t, min(limit[0], limit[1]));  // first key that needs masking

  float acc[32];  // O, 64 x 64 per warpgroup
  float s_acc[64];  // S, 64 x 128 per warpgroup
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s_acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum

  const uint32_t q_wg = q_s + wg * 64 * D * 2;  // this warpgroup's 64 query rows
  mbar_wait(bar_q, 0);

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int s = kb % STAGES;
    const uint32_t parity = (kb / STAGES) & 1;
    mbar_wait(full(s), parity);

    // S = Q K^T: 4 k-steps of 16 over D; a k-step is 32 bytes into the swizzled rows
    reg_fence(s_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(s_acc, sw128_desc(q_wg + 32 * kk, 16, 1024), sw128_desc(k_s(s) + 32 * kk, 16, 1024),
               kk);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s_acc);

    // mask and online softmax in base 2 on the accumulator's layout
    const int k0 = kb * BK;
    const int col0 = k0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 64; ++i) s_acc[i] *= scale_log2;
    if (k0 + BK > mask_from) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = col0 + 8 * j + c;
            float& x = s_acc[4 * j + 2 * i + c];
            if (key >= t) x = -INFINITY;
            else if (key >= limit[i]) x = NEG_INF;
          }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mx[i] = fmaxf(mx[i], fmaxf(s_acc[4 * j + 2 * i], s_acc[4 * j + 2 * i + 1]));
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row lives on the 4 threads of a quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
    // P in bf16 pairs: p[2j] row r0, p[2j + 1] row r0 + 8, columns of group j.
    // Groups 2kk and 2kk + 1 are the A fragment of k-step kk of P V.
    uint32_t p[32];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(s_acc[4 * j + 2 * i] - mx[i]);
        const float p1 = exp2f(s_acc[4 * j + 2 * i + 1] - mx[i]);
        rs[i] += p0 + p1;  // the row sum from fp32 P, before rounding
        p[2 * j + i] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }

    // O += P V: 8 k-steps of 16 keys; a k-step is 16 rows of V, 2048 bytes.
    // MN-major: 8-key groups 1024 bytes apart; the 64 columns are one
    // swizzle atom wide, so the stride between atoms is never used
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               sw128_desc(v_s(s) + kk * 16 * D * 2, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);

    // release the stage; once both warpgroups have, refill it two tiles on
    mbar_arrive(empty(s));
    if (tid == 0 && kb + STAGES < n_tiles) {
      mbar_wait(empty(s), parity);
      mbar_expect_tx(full(s), 2 * TILE_BYTES);
      tma_load(k_s(s), &map_k, full(s), (kb + STAGES) * BK, bh);
      tma_load(v_s(s), &map_v, full(s), (kb + STAGES) * BK, bh);
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= t) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* out = o + ((size_t)bh * t + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv_l, acc[4 * j + 2 * i + 1] * inv_l);
    if (lse != nullptr && lane % 4 == 0) {
      // natural-log lse; a row with no visible key keeps the TPU kernel's -1e30
      const float m_nat = m[i] == NEG_INF ? NEG_INF : m[i] * LN2;
      lse[(size_t)bh * t + row] = m_nat + logf(fmaxf(l[i], 1e-30f));
    }
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

// (D, T, B*H) bf16 map read in (D, 128, 1) boxes with 128-byte swizzle;
// out-of-bounds rows read as zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh, int t) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)t * D * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// above 48 KB a block's dynamic shared memory must be allowed per kernel
cudaError_t allow_smem() {
  static bool done = false;  // the attribute is per kernel and idempotent
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

// Same arguments as cosy_flash_attention_fwd (flash_attention.cu); dtype
// must be 1 (bfloat16) and d 64.  lse may be null.  Returns a cudaError_t.
extern "C" int cosy_flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                                             const int* lengths, void* o, float* lse, int bh,
                                             int heads, int t, int d, int chunk, float sm_scale,
                                             int dtype, void* stream) {
  if (bh <= 0 || t <= 0 || heads <= 0 || bh % heads != 0 || chunk < 0 || d != D || dtype != 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;  // TMA reads from 16-byte aligned bases only
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_q, map_k, map_v;
  if (!make_map(encode, &map_q, q, bh, t) || !make_map(encode, &map_k, k, bh, t) ||
      !make_map(encode, &map_v, v, bh, t))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_sm90<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, lengths, static_cast<__nv_bfloat16*>(o), lse, heads, t, chunk,
      sm_scale * LOG2E);
  return (int)cudaGetLastError();
}
