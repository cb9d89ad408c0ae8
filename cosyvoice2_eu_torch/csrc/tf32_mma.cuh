// The 3xTF32 tile product on Hopper's tensor cores (sm_90a), shared by the
// flash-attention forward in fp32 (flash_attention.cu, K1) and its backward
// (flash_attention_bwd.cu, K3 and K4).  Each library is one translation unit
// that includes this header once.
//
// A block is 4 warps over a 64-row tile; each warp owns a 16-row slab of it
// as the A side of mma.sync.m16n8k8 (tf32 operands, fp32 accumulators).  The
// other side streams through shared memory in 32-row tiles of the (T, 64)
// operands, loaded by cp.async (load_tile) and split once into TF32 hi and lo
// by the threads that loaded them (split_tile).
//
// 3xTF32 precision.  Each fp32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), where tf32() is cvt.rna.tf32.f32's rounding (10
// explicit mantissa bits, round to nearest, ties away from zero) done as two
// integer operations on the bits: it equals the instruction on every finite
// input and spares the conversion unit, whose lower issue rate the splits
// would otherwise wait on.  x - hi is exact in fp32 and |x - hi - lo| <=
// 2^-22 |x|.  A product a*b is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
// (small terms first, three mma into one fp32 accumulator): each TF32
// product is exact, and the dropped lo_a*lo_b and the split residuals are
// ~2^-21 of |a*b|.  What remains is the tensor core's fp32 accumulation,
// which does not round to nearest.
//
// Fragment layouts (lane = 4g + t): an m16n8 accumulator c[e] holds row
// g + 8 (e >> 1), column 2t + (e & 1); an m16n8k8 A fragment a[0..3] holds
// (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); a B fragment b[0..1]
// holds (k t, column g) and (k t + 4, g).
//
// Shared tiles are fp32 with a row stride of RS = 68 floats: the scalar
// fragment loads over D and the 16-byte loads over the sequence are both
// free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 64;           // head dim
constexpr int BM = 64;          // rows of a block's own tile (queries in K1 and K3, keys in K4)
constexpr int SN = 32;          // rows of a streamed tile (keys in K1 and K3, queries in K4)
constexpr int NT = SN / 8;      // 8-column tiles of a warp's score accumulator
constexpr int KS = D / 8;       // 8-deep k-steps of a product over D
constexpr int WARPS = 4;        // each owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
constexpr int RS = D + 4;       // shared row stride in floats
constexpr int STILE = SN * RS;  // floats of one streamed array
constexpr float LOG2E = 1.4426950408889634f;

// first key past what row `row` may see:
//   key j is visible to query i iff j < length and, when chunk > 0,
//   j < (i / chunk + 1) * chunk.
__device__ __forceinline__ int visible_end(int row, int chunk, int length) {
  return chunk > 0 ? min((row / chunk + 1) * chunk, length) : length;
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !in (src must still be valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// floats a thread moves per chunk in load_tile: 4 (16-byte copies) or 8 (16
// bytes of bf16 widened)
template <typename T>
__host__ __device__ constexpr int chunk_floats() {
  return std::is_same<T, float>::value ? 4 : 8;
}

// Rows r0 .. r0+ROWS-1 of a (t, 64) matrix into a shared fp32 tile, zeros
// past t.  fp32 by 16-byte cp.async; bf16 widened through registers.
template <int ROWS, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int t, int tid) {
  constexpr int CH = chunk_floats<T>(), PER_ROW = D / CH;
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / PER_ROW, col = (c % PER_ROW) * CH;
    const bool in = r0 + r < t;
    if constexpr (std::is_same<T, float>::value) {
      cp_async16(dst + r * RS + col, src + (size_t)(in ? r0 + r : 0) * D + col, in);
    } else {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (in) raw = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + col));
      // a bf16 is the high half of its fp32
      *reinterpret_cast<uint4*>(dst + r * RS + col) =
          make_uint4(raw.x << 16, raw.x & 0xffff0000u, raw.y << 16, raw.y & 0xffff0000u);
      *reinterpret_cast<uint4*>(dst + r * RS + col + 4) =
          make_uint4(raw.z << 16, raw.z & 0xffff0000u, raw.w << 16, raw.w & 0xffff0000u);
    }
  }
}

// ---------------------------------------------------------------------------
// the 3xTF32 tile product
// ---------------------------------------------------------------------------

// cvt.rna.tf32.f32 on a finite x: add half of the 13 dropped bits to the
// magnitude and clear them (round to nearest, ties away from zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The chunks this thread loaded with load_tile<ROWS, T>, split in place: hi
// over the fp32 values, lo into `lo` at the same offsets.  The thread's own
// copies are visible to it after cp.async.wait_group, so no barrier is needed.
template <int ROWS, typename T>
__device__ __forceinline__ void split_tile(float* hi, float* lo, int tid) {
  constexpr int CH = chunk_floats<T>(), PER_ROW = D / CH;
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int off = (c / PER_ROW) * RS + (c % PER_ROW) * CH;
#pragma unroll
    for (int u = 0; u < CH; u += 4) {
      const float4 x = *reinterpret_cast<const float4*>(hi + off + u);
      uint4 h, l;
      split(x.x, h.x, l.x);
      split(x.y, h.y, l.y);
      split(x.z, h.z, l.z);
      split(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi + off + u) = h;
      *reinterpret_cast<uint4*>(lo + off + u) = l;
    }
  }
}

// c += a b for one m16n8k8 tile, tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[nt0 + j] += A B[j] for M n-tiles in 3xTF32: lo*hi, hi*lo, then hi*hi
template <int M, int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], int nt0, const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const uint32_t (&bhi)[M][2],
                                     const uint32_t (&blo)[M][2]) {
#pragma unroll
  for (int j = 0; j < M; ++j) mma(c[nt0 + j], alo, bhi[j]);
#pragma unroll
  for (int j = 0; j < M; ++j) mma(c[nt0 + j], ahi, blo[j]);
#pragma unroll
  for (int j = 0; j < M; ++j) mma(c[nt0 + j], ahi, bhi[j]);
}

// A warp's 16 x 64 A operand of a product over D, split once into
// registers: the fragments of its KS k-steps.
struct SplitA {
  uint32_t hi[KS][4], lo[KS][4];
};

// The A fragment of k-step ks: from a warp's fp32 slab in shared memory (row
// stride RS), split here, or from fragments split before.
__device__ __forceinline__ void a_fragment(const float* A, int ks, int lane, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const float* a = A + (lane >> 2) * RS + ks * 8 + (lane & 3);
  split(a[0], hi[0], lo[0]);
  split(a[8 * RS], hi[1], lo[1]);
  split(a[4], hi[2], lo[2]);
  split(a[8 * RS + 4], hi[3], lo[3]);
}

__device__ __forceinline__ void a_fragment(const SplitA& A, int ks, int, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = A.hi[ks][i];
    lo[i] = A.lo[ks][i];
  }
}

// acc (16 x SN) += A (16 x 64) B^T, B (SN x 64) a streamed tile as hi and lo,
// the product over D.  A is the warp's fp32 slab in shared memory, split once
// a k-step, or a SplitA.  acc[nt][e]: row g + 8 (e >> 1), column
// nt * 8 + 2t + (e & 1) of B's rows.
template <typename A>
__device__ __forceinline__ void score_product(float (&acc)[NT][4], const A& a, const float* Bhi,
                                              const float* Blo, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ahi[4], alo[4];
    a_fragment(a, ks, lane, ahi, alo);
    uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int ob = (j * 8 + g) * RS + ks * 8 + t;
      bhi[j][0] = __float_as_uint(Bhi[ob]);
      bhi[j][1] = __float_as_uint(Bhi[ob + 4]);
      blo[j][0] = __float_as_uint(Blo[ob]);
      blo[j][1] = __float_as_uint(Blo[ob + 4]);
    }
    mma3(acc, 0, ahi, alo, bhi, blo);
  }
}

// acc (16 x 64) += P (16 x SN) X, X (SN x 64) a streamed tile as hi and lo;
// the product over the sequence, with P in score_product's accumulator
// layout, split here once.  k-step j is P's n-tile j: k = t is sequence
// j*8 + 2t, k = t + 4 is j*8 + 2t + 1.  acc[nt][e]: row g + 8 (e >> 1),
// column 8t + 4 (e & 1) + (nt & 3) + 32 (nt >> 2) of X.
__device__ __forceinline__ void value_product(float (&acc)[8][4], const float (&p)[NT][4],
                                              const float* Xhi, const float* Xlo, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ahi[4], alo[4];
    split(p[j][0], ahi[0], alo[0]);
    split(p[j][2], ahi[1], alo[1]);
    split(p[j][1], ahi[2], alo[2]);
    split(p[j][3], ahi[3], alo[3]);
    const int o = (j * 8 + 2 * t) * RS + 4 * g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 uh = *reinterpret_cast<const uint4*>(Xhi + o + 32 * h);
      const uint4 wh = *reinterpret_cast<const uint4*>(Xhi + o + RS + 32 * h);
      const uint4 ul = *reinterpret_cast<const uint4*>(Xlo + o + 32 * h);
      const uint4 wl = *reinterpret_cast<const uint4*>(Xlo + o + RS + 32 * h);
      const uint32_t bhi[4][2] = {{uh.x, wh.x}, {uh.y, wh.y}, {uh.z, wh.z}, {uh.w, wh.w}};
      const uint32_t blo[4][2] = {{ul.x, wl.x}, {ul.y, wl.y}, {ul.z, wl.z}, {ul.w, wl.w}};
      mma3(acc, h * 4, ahi, alo, bhi, blo);
    }
  }
}

// 8 contiguous outputs x[0..7] * scale, rounded once to T
template <typename T>
__device__ __forceinline__ void store8(T* out, const float (&x)[8], float scale) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(out) =
        make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
    *reinterpret_cast<float4*>(out + 4) =
        make_float4(x[4] * scale, x[5] * scale, x[6] * scale, x[7] * scale);
  } else {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i] * scale, x[2 * i + 1] * scale);
    *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(h);
  }
}

// Rows g and g + 8 of a warp's value_product accumulator (scaled) to `out`
// (the warp's first row), rows at or past `rows` skipped.
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[8][4], float scale, int rows,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = acc[4 * h + i][2 * r];
        x[4 + i] = acc[4 * h + i][2 * r + 1];
      }
      store8(out + (size_t)row * D + 8 * t + 32 * h, x, scale);
    }
  }
}

// The dynamic shared memory attribute of `kern`, set once (it is per kernel
// and idempotent).
template <typename K>
cudaError_t set_smem(K kern, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

// Arguments the kernels do not take.  The estimator's head dim is 64 (8
// heads x 64 = 512 wide at every width).
inline bool bad_args(int bh, int heads, int t, int d, int chunk) {
  return bh <= 0 || t <= 0 || heads <= 0 || bh % heads != 0 || chunk < 0 || d != D ||
         (t + BM - 1) / BM > 65535;
}

}  // namespace
