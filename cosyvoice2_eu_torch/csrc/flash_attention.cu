// Flash-attention forward in float32 on Hopper's tensor cores (sm_90a) in
// 3xTF32, plain C interface for ctypes.
//
// Replaces the TPU kernel cosyvoice2_eu_tpu/ops/pallas/flash_attention.py::
// _attn_kernel (launched by _flash_call / flash_attention) for float32
// inputs, the training path's forward with LSE; bfloat16 inputs go to
// flash_attention_sm90.cu.  It computes softmax(Q K^T * scale) V per
// (batch*head) with an online fp32 softmax and builds the mask per tile from
// the scalars length[b] and chunk:
//   key j is visible to query i iff j < length[b] and, when chunk > 0,
//   j < (i / chunk + 1) * chunk.
// Masked scores take the same finite NEG_INF = -1e30 as the TPU kernel and l
// is clamped at 1e-30, so a row with no visible key (length[b] == 0) gives
// the mean of V over the visited keys, as the TPU kernel does, not NaN, and
// its LSE is -1e30.  At chunk 0 that is every key below T; with chunk > 0
// the visited keys end at the 32-key tile boundary past the block's chunk
// bound, not at the TPU kernel's wider block (no path makes such a row).
// Keys past T are excluded outright.  Key tiles past the chunk bound are
// skipped, and so are tiles past length[b] when length[b] > 0 (their
// weights are exactly 0).  Each block owns its outputs, so two launches on
// the same inputs are bit-equal.
//
// Inputs q, k, v: (B*H, T, 64) contiguous float32, k and v 16-byte aligned;
// scores, softmax, accumulator and output in fp32; optional fp32 natural-log
// log-sum-exp (B*H, T).
//
// What bounds it on the H100.  At the training shapes (B*H = 32, T = 740, or
// B*H = 16, T = 1480, D = 64) it does 4*D operations per visible (query,
// key) pair, 3.9 and 8.2 GFLOP at chunk 0, on ~24 MB, so operations bound
// it.  fp32 has no fp32-accurate tensor-core path but 3xTF32 (plain TF32
// would break the train step's gradient parity): three TF32 products at the
// dense 495 TFLOP/s, 0.024 / 0.049 ms; on the fp32 FMA units (67 TFLOP/s)
// 0.058 / 0.122 ms.
//
// What this design does about it (the tile product is tf32_mma.cuh's,
// shared with the backward):
//   * Both products run on the tensor cores: mma.sync.m16n8k8 with tf32
//     operands and fp32 accumulators, three products per k-step.
//   * A block is 4 warps and owns 64 query rows, 16 per warp.  Each warp
//     loads its Q rows once, pre-scales them by scale * log2(e) in fp32 and
//     keeps them split into TF32 hi and lo A fragments in registers (64 a
//     thread) for all key tiles.
//   * K and V stream in 32-key tiles through a 2-stage cp.async ring (zero
//     filled past T), so tile i+1 is in flight while tile i is multiplied.
//     Each thread splits its own landed chunks in place into hi and lo, so a
//     tile is split once for all four warps.
//   * S = Q K^T lands in registers; the mask and the base-2 online softmax
//     work on the accumulators (row max and sum over the lane quad by two
//     shuffles each), and alpha rescales the O accumulator in registers.
//   * O += P V takes P from the score accumulator as its A operand (columns
//     2t and 2t+1 read as k = t and t+4, V's rows permuted to match), split
//     once a tile: P never goes to shared memory.
//   * Tiles that every row of a warp sees whole (below the chunk bound of
//     its first row, and below T) skip the mask.
//   * Two barriers a tile (the landed tile split by all; the stage read by
//     all before it is refilled).  70 KB of shared memory and at most 168
//     registers a thread (launch bounds of 128 threads and 3 blocks), so
//     three blocks fit an SM: 384 blocks at both training shapes, 0.97 waves
//     of the 132 SMs (two blocks, at ~196 registers, took 1.45 waves and
//     ran longer at chunk 0).  The Q fragments (64 registers) and the O
//     accumulator (32) leave little room, so each thread keeps its rows'
//     running max and sum in shared memory between tiles, and a full K/V
//     tile is loaded from one pointer a thread with constant offsets: both
//     keep ptxas from spilling under the 168-register cap.  The grid is
//     (B*H, 64-query tiles), and blocks start with the last query tile, the
//     heaviest under a chunk mask.
//
// Precision: 3xTF32 products (~2^-21 of |a*b|) summed by the tensor core's
// fp32 accumulation, which truncates; both stay inside the plain version's
// 1e-4 on O and 1e-5 on the LSE.

#include "tf32_mma.cuh"

namespace {

constexpr int MIN_BLOCKS = 3;  // blocks an SM, for the register budget
constexpr float NEG_INF = -1.0e30f;
constexpr float LN2 = 0.6931471805599453f;
// Ring: 2 stages x K, V x hi, lo; then each thread's running max and sum.
constexpr int SMEM_BYTES = (8 * STILE + 4 * THREADS) * 4;

// K and V rows r0 .. r0+SN-1 into a ring stage: a full tile by one pointer a
// thread and constant offsets, the last (partial) one zero-filled past t
__device__ __forceinline__ void load_kv(float* st, const float* k, const float* v, int r0, int t,
                                        int tid) {
  if (r0 + SN <= t) {
    const size_t at = (size_t)r0 * D + tid * 4;  // chunk i: row tid / 16 + 8 i
    float* dst = st + (tid >> 4) * RS + (tid & 15) * 4;
#pragma unroll
    for (int i = 0; i < SN * D / 4 / THREADS; ++i) {
      cp_async16(dst + 8 * i * RS, k + at + 8 * i * D, true);
      cp_async16(dst + 2 * STILE + 8 * i * RS, v + at + 8 * i * D, true);
    }
  } else {
    load_tile<SN>(st, k, r0, t, tid);
    load_tile<SN>(st + 2 * STILE, v, r0, t, tid);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ o, float* __restrict__ lse, int heads, int t, int chunk,
                 float scale_log2) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // stage s: K hi, K lo, V hi, V lo [SN][RS] from 4s

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's running max (base 2) and sum of its two rows
  float4* ml = reinterpret_cast<float4*>(ring + 8 * STILE) + tid;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // last query tile first
  const int length = lengths[bh / heads];
  const size_t base = (size_t)bh * t * D;

  // key tiles any row of this block can see
  const int q_last = min(q0 + BM, t) - 1;
  int kv_end = t;
  if (chunk > 0) kv_end = min(kv_end, (q_last / chunk + 1) * chunk);
  if (length > 0) kv_end = min(kv_end, length);
  const int n_tiles = (kv_end + SN - 1) / SN;

  load_kv(ring, k + base, v + base, 0, t, tid);
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16; their Q fragments,
  // scaled and split, while the first tile flies
  const int row0 = q0 + warp * 16;
  SplitA qa;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float* qr = q + base + (size_t)min(row, t - 1) * D + tq;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // columns ks*8 + tq and ks*8 + tq + 4
        const float x = row < t ? __ldg(qr + ks * 8 + 4 * c) * scale_log2 : 0.f;
        split(x, qa.hi[ks][r + 2 * c], qa.lo[ks][r + 2 * c]);
      }
    }
  }

  // every row of the warp sees the keys below full_end (visible_end grows
  // with the row): the tiles under it need no mask
  const int full_end = min(visible_end(row0, chunk, length), t);

  *ml = make_float4(NEG_INF, NEG_INF, 0.f, 0.f);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int s = kb & 1;
    float* Khi = ring + 4 * s * STILE;
    float* Klo = Khi + STILE;
    float* Vhi = Khi + 2 * STILE;
    float* Vlo = Khi + 3 * STILE;
    if (kb + 1 < n_tiles) {  // the next tile flies while this one is multiplied
      float* next = ring + 4 * (s ^ 1) * STILE;
      load_kv(next, k + base, v + base, (kb + 1) * SN, t, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    split_tile<SN, float>(Khi, Klo, tid);
    split_tile<SN, float>(Vhi, Vlo, tid);
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
    score_product(sc, qa, Khi, Klo, lane);  // S = Q K^T, in base 2

    // mask + online softmax on the accumulators
    const int k0 = kb * SN;
    if (k0 + SN > full_end) {
      const int row_end[2] = {visible_end(row0 + g, chunk, length),
                              visible_end(row0 + g + 8, chunk, length)};
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + i * 8 + 2 * tq + (e & 1);
          if (key >= t) sc[i][e] = -INFINITY;
          else if (key >= row_end[e >> 1]) sc[i][e] = NEG_INF;
        }
    }
    const float4 ml0 = *ml;
    const float m[2] = {ml0.x, ml0.y};
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[i][e]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[i][e] = exp2f(sc[i][e] - mx[e >> 1]);
        rs[e >> 1] += sc[i][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    }
    *ml = make_float4(mx[0], mx[1], ml0.z * alpha[0] + rs[0], ml0.w * alpha[1] + rs[1]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];
    value_product(acc, sc, Vhi, Vlo, lane);  // O += P V
    __syncthreads();                         // stage s read by all before it is refilled
  }

  const float4 ml1 = *ml;
  const float m[2] = {ml1.x, ml1.y}, l[2] = {ml1.z, ml1.w};
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] *= inv_l[e >> 1];
  store_rows(o + base + (size_t)row0 * D, acc, 1.f, t - row0, lane);
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= t) continue;
      // natural-log lse; a row with no visible key keeps the TPU kernel's -1e30
      const float m_nat = m[r] == NEG_INF ? NEG_INF : m[r] * LN2;
      lse[(size_t)bh * t + row] = m_nat + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

cudaError_t prepare() {
  static bool done = false;
  return set_smem(flash_fwd_kernel, SMEM_BYTES, &done);
}

}  // namespace

// dtype must be 0 (float32); bfloat16 is flash_attention_sm90.cu's.  lse may
// be null.  Returns a cudaError_t.
extern "C" int cosy_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        const int* lengths, void* o, float* lse, int bh,
                                        int heads, int t, int d, int chunk, float sm_scale,
                                        int dtype, void* stream) {
  if (bad_args(bh, heads, t, d, chunk) || dtype != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (t + BM - 1) / BM);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      lengths, static_cast<float*>(o), lse, heads, t, chunk, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM: the occupancy the launch gets.
// Returns a cudaError_t.
extern "C" int cosy_flash_attention_fwd_occupancy(int* blocks) {
  cudaError_t err = prepare();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_fwd_kernel, THREADS,
                                                        SMEM_BYTES);
  return (int)err;
}
