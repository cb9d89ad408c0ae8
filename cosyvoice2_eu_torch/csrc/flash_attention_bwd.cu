// Flash-attention backward on Hopper's tensor cores (sm_90a) in 3xTF32, plain
// C interface for ctypes.
//
// Replaces the TPU kernels of cosyvoice2_eu_tpu/ops/pallas/flash_attention.py
// launched by _flash_bwd:
//   K3  _dq_kernel  (:125):  dQ = scale * sum_k [P o (dP - delta)] K
//   K4  _dkv_kernel (:172):  dV = sum_q P^T dO,  dK = sum_q dS^T (Q * scale)
// with P = exp(S - LSE) under the forward's mask (S = Q K^T * scale, LSE the
// forward's natural-log log-sum-exp), dP = dO V^T, delta = rowsum(dO o O)
// (computed by the caller) and dS = P o (dP - delta).  The mask is built per
// tile from the scalars length[b] and chunk, as in flash_attention.cu:
//   key j is visible to query i iff j < length[b] and, when chunk > 0,
//   j < (i / chunk + 1) * chunk.
// A batch with length[b] == 0 has no visible key and gets zero gradients, as
// the TPU kernels give it.  Every query row below T takes part (pad rows
// included); keys at or past length[b] get dK = dV = 0 exactly.  Each block
// owns its outputs (no atomics), so two launches on the same inputs are
// bit-equal.
//
// Layout: q, k, v, dO, dQ, dK, dV (B*H, T, 64) contiguous, float32 or
// bfloat16, 16-byte aligned; lse, delta (B*H, T) float32.  Outputs are
// rounded once to the input type.  Scores are kept in base 2 as in the
// forward: s2 = (q . k) * scale * log2(e), P = exp2(s2 - lse * log2(e)).
//
// What bounds it on the H100.  At the training shapes (B*H = 32, T = 740, or
// B*H = 16, T = 1480, D = 64, fp32) K3 does 6*D and K4 8*D operations per
// visible (query, key) pair: 5.8 and 7.8 GFLOP at T = 740, 12.2 and 16.3 at
// T = 1480, on ~25-35 MB, so operations bound both.  On the fp32 FMA units
// (67 TFLOP/s) that is 0.087 / 0.116 ms and 0.183 / 0.243 ms.  In 3xTF32 on
// the tensor cores (three TF32 products at the dense 495 TFLOP/s, ~165
// TFLOP/s of fp32-accurate work) it is 0.035 / 0.047 ms and 0.074 / 0.099 ms.
// The first design ran every product on the FMA units with 4x4 register
// tiles fed from shared memory (as many shared loads as FMAs), and loaded
// each tile synchronously through registers, so no copy overlapped any math.
//
// What this design does about it:
//   * Every product runs on the tensor cores: mma.sync.m16n8k8 with tf32
//     operands and fp32 accumulators, three products per k-step (below).
//   * A block is 4 warps and owns a 64-row stationary tile (Q and dO in K3,
//     K and V in K4); each warp owns a 16-row slab of it.  The block streams
//     32-row tiles of the other side (K and V in K3, Q and dO in K4).  S and
//     dP (K3), or S^T and dP^T (K4), are products over D with both operands
//     read from shared memory; the mask, P and dS are formed on the
//     accumulators in registers.
//   * P and dS never leave registers: the m16n8 accumulator holds, per
//     thread, the two adjacent columns 2t and 2t+1 of each 8-column tile,
//     and an m16n8k8 A fragment holds columns t and t+4.  The second product
//     (dQ += dS K in K3; dV += P^T dO and dK += dS^T Q in K4) sums over the
//     sequence, so each 8-column tile of the accumulator becomes a k-step
//     with k = t read as sequence 2t and k = t+4 as 2t+1, and its B rows
//     are permuted the same way.  The output column of n-tile nt and lane
//     group g is 4g + (nt & 3) + 32 (nt >> 2), so the B fragments of four
//     n-tiles are one 16-byte shared load and each thread writes 8
//     contiguous outputs of each of its rows.
//   * Shared tiles are fp32 with a row stride of 68 floats: the scalar
//     fragment loads over D and the 16-byte loads over the sequence are both
//     free of bank conflicts.
//   * The streamed tiles (with LSE and delta in K4) come through a 2-stage
//     ring by cp.async (16-byte cp.async.cg for the tiles, 4-byte
//     cp.async.ca for LSE and delta, zero-filled past T), so tile i+1 is in
//     flight while tile i is multiplied.  Once its own copies have landed,
//     each thread splits them in place into hi and lo (no barrier needed),
//     so a streamed tile is split once per load for all four warps and both
//     of its products.  bf16 inputs are widened to fp32 as they land in
//     shared memory, by loads through registers (no path runs the backward
//     in bf16); their lo part is then 0.
//   * The stationary tile stays fp32 and is split as its fragments are
//     loaded, once a k-step and streamed tile.  Kept as hi and lo it would
//     need 35 KB more: one block an SM at 32-row streamed tiles, or 16-row
//     streamed tiles with twice the barriers and mask work per query or key.
//   * 104 KB of shared memory and at most 255 registers a thread (launch
//     bounds of 128 threads and 2 blocks; ptxas used 136-194 with no spill),
//     so two blocks fit on an SM: 384 blocks at both training shapes, 1.45
//     waves of the 132 SMs.  The grid is (B*H, 64-row tiles), and blocks
//     start in order of blockIdx.y: K3 maps it to the last query tile first
//     and K4 to the first key tile first, the heaviest blocks under a chunk
//     mask.
//
// 3xTF32 precision (tf32_mma.cuh, which holds the tile product shared with
// the forward): what remains after the split is the tensor core's fp32
// accumulation, which does not round to nearest: over the hundreds of
// k-steps of a long sequence it leaves errors of ~1e-5 of the largest output
// (at T = 2048), against the plain version's 1e-4 bound.  P and dS are split
// once per tile.

#include "tf32_mma.cuh"

namespace {

constexpr int MIN_BLOCKS = 2;   // blocks an SM, for the register budget
constexpr int TILE = BM * RS;   // floats of one stationary tensor

// Stationary: two fp32 tensors (Q, dO in K3; K, V in K4).  Ring: 2 stages x
// two tensors (K, V in K3; Q, dO in K4) x hi and lo.  K4 adds per stage the
// tile's LSE, delta and visible ends.
constexpr int DQ_BYTES = (2 * TILE + 8 * STILE) * 4;
constexpr int DKV_BYTES = DQ_BYTES + 2 * 3 * SN * 4;

// ---------------------------------------------------------------------------
// K3: dQ
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ lengths,
                T* __restrict__ dq, int heads, int t, int chunk, float scale_log2,
                float sm_scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // stationary [BM][RS]
  float* dOs = Qs + TILE;
  float* ring = dOs + TILE;  // stage s: K hi, K lo, V hi, V lo [SN][RS] from 4s

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // last query tile first
  const int length = min(lengths[bh / heads], t);   // keys past T do not exist
  const size_t base = (size_t)bh * t * D;

  // key tiles any row of this block can see: the forward's bound, and none
  // at all when length == 0
  const int q_last = min(q0 + BM, t) - 1;
  int kv_end = length;
  if (chunk > 0) kv_end = min(kv_end, (q_last / chunk + 1) * chunk);
  const int n_tiles = kv_end > 0 ? (kv_end + SN - 1) / SN : 0;

  if (n_tiles > 0) {
    load_tile<BM>(Qs, q + base, q0, t, tid);
    load_tile<BM>(dOs, dout + base, q0, t, tid);
    load_tile<SN>(ring, k + base, 0, t, tid);
    load_tile<SN>(ring + 2 * STILE, v + base, 0, t, tid);
    cp_async_commit();
  }

  // this thread's rows: g and g + 8 of the warp's slab
  int row_end[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool in = row < t;
    row_end[r] = in ? visible_end(row, chunk, length) : 0;
    lse2[r] = in ? lse[(size_t)bh * t + row] * LOG2E : 0.f;
    dlt[r] = in ? delta[(size_t)bh * t + row] : 0.f;
  }

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
      load_tile<SN>(next, k + base, (kb + 1) * SN, t, tid);
      load_tile<SN>(next + 2 * STILE, v + base, (kb + 1) * SN, t, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    split_tile<SN, T>(Khi, Klo, tid);
    split_tile<SN, T>(Vhi, Vlo, tid);
    __syncthreads();

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
    const int slab = warp * 16 * RS;
    score_product(sc, Qs + slab, Khi, Klo, lane);   // S = Q K^T
    score_product(dp, dOs + slab, Vhi, Vlo, lane);  // dP = dO V^T

    // dS = P (dP - delta), P = exp2(s2 - lse2) on visible keys, else 0
    const int k0 = kb * SN;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + i * 8 + 2 * tq + (e & 1);
        const float p = key < row_end[r] ? exp2f(sc[i][e] * scale_log2 - lse2[r]) : 0.f;
        dp[i][e] = p * (dp[i][e] - dlt[r]);
      }
    value_product(acc, dp, Khi, Klo, lane);  // dQ += dS K
    __syncthreads();                         // stage s read by all before it is refilled
  }

  const int row0 = q0 + warp * 16;
  store_rows(dq + base + (size_t)row0 * D, acc, sm_scale, t - row0, lane);
}

// ---------------------------------------------------------------------------
// K4: dK, dV
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ lengths,
                 T* __restrict__ dk, T* __restrict__ dv, int heads, int t, int chunk,
                 float scale_log2, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // stationary [BM][RS]
  float* Vs = Ks + TILE;
  float* ring = Vs + TILE;         // stage s: Q hi, Q lo, dO hi, dO lo [SN][RS] from 4s
  float* rows = ring + 8 * STILE;  // stage s: lse, delta, end [SN] each

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM;  // first key tile first
  const int length = min(lengths[bh / heads], t);
  const size_t base = (size_t)bh * t * D;
  const int row0 = k0 + warp * 16;

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  if (k0 >= length) {  // no query sees these keys: their gradients are zero
    store_rows(dk + base + (size_t)row0 * D, dk_acc, 1.f, t - row0, lane);
    store_rows(dv + base + (size_t)row0 * D, dv_acc, 1.f, t - row0, lane);
    return;
  }

  // queries in chunks before this key tile's chunk see none of it
  const int qb_start = chunk > 0 ? ((k0 / chunk) * chunk) / SN : 0;
  const int n_qtiles = (t + SN - 1) / SN;

  // Q and dO tile qb, with its LSE, delta and visible ends, into stage s
  auto issue = [&](int qb, int s) {
    const int q0 = qb * SN;
    float* st = ring + 4 * s * STILE;
    load_tile<SN>(st, q + base, q0, t, tid);
    load_tile<SN>(st + 2 * STILE, dout + base, q0, t, tid);
    float* rs = rows + s * 3 * SN;
    if (tid < SN) {
      const int row = q0 + tid;
      const bool in = row < t;
      const size_t at = (size_t)bh * t + (in ? row : 0);
      cp_async4(rs + tid, lse + at, in);
      cp_async4(rs + SN + tid, delta + at, in);
      reinterpret_cast<int*>(rs + 2 * SN)[tid] = in ? visible_end(row, chunk, length) : 0;
    }
  };

  load_tile<BM>(Ks, k + base, k0, t, tid);
  load_tile<BM>(Vs, v + base, k0, t, tid);
  issue(qb_start, 0);
  cp_async_commit();

  for (int qb = qb_start; qb < n_qtiles; ++qb) {
    const int s = (qb - qb_start) & 1;
    float* Qhi = ring + 4 * s * STILE;
    float* Qlo = Qhi + STILE;
    float* dOhi = Qhi + 2 * STILE;
    float* dOlo = Qhi + 3 * STILE;
    if (qb + 1 < n_qtiles) {
      issue(qb + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    split_tile<SN, T>(Qhi, Qlo, tid);
    split_tile<SN, T>(dOhi, dOlo, tid);
    __syncthreads();
    const float* lse_s = rows + s * 3 * SN;
    const float* dlt_s = lse_s + SN;
    const int* end_s = reinterpret_cast<const int*>(lse_s + 2 * SN);

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
    const int slab = warp * 16 * RS;
    score_product(sc, Ks + slab, Qhi, Qlo, lane);   // S^T = K Q^T
    score_product(dp, Vs + slab, dOhi, dOlo, lane);  // dP^T = V dO^T

    // P^T and dS^T on visible (key, query) pairs, else 0
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i * 8 + 2 * tq + (e & 1);
        const int key = row0 + g + 8 * (e >> 1);
        const float p = key < end_s[col] ? exp2f(sc[i][e] * scale_log2 - lse_s[col] * LOG2E) : 0.f;
        sc[i][e] = p;
        dp[i][e] = p * (dp[i][e] - dlt_s[col]);
      }
    value_product(dv_acc, sc, dOhi, dOlo, lane);  // dV += P^T dO
    value_product(dk_acc, dp, Qhi, Qlo, lane);    // dK += dS^T Q
    __syncthreads();
  }

  store_rows(dk + base + (size_t)row0 * D, dk_acc, sm_scale, t - row0, lane);
  store_rows(dv + base + (size_t)row0 * D, dv_acc, 1.f, t - row0, lane);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t prepare_dq() {
  static bool done = false;
  return set_smem(flash_dq_kernel<T>, DQ_BYTES, &done);
}

template <typename T>
cudaError_t prepare_dkv() {
  static bool done = false;
  return set_smem(flash_dkv_kernel<T>, DKV_BYTES, &done);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* lengths, void* dq, int bh, int heads, int t,
              int chunk, float sm_scale, cudaStream_t stream) {
  cudaError_t err = prepare_dq<T>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (t + BM - 1) / BM);
  flash_dq_kernel<T><<<grid, THREADS, DQ_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, lengths, static_cast<T*>(dq), heads, t, chunk,
      sm_scale * LOG2E, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* lengths, void* dk, void* dv, int bh, int heads,
               int t, int chunk, float sm_scale, cudaStream_t stream) {
  cudaError_t err = prepare_dkv<T>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (t + BM - 1) / BM);
  flash_dkv_kernel<T><<<grid, THREADS, DKV_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, lengths, static_cast<T*>(dk),
      static_cast<T*>(dv), heads, t, chunk, sm_scale * LOG2E, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int which, int* blocks) {
  cudaError_t err;
  if (which == 0) {
    err = prepare_dq<T>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_dq_kernel<T>, THREADS,
                                                          DQ_BYTES);
  } else {
    err = prepare_dkv<T>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_dkv_kernel<T>, THREADS,
                                                          DKV_BYTES);
  }
  return (int)err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int cosy_flash_attention_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       const int* lengths, void* dq, int bh, int heads, int t,
                                       int d, int chunk, float sm_scale, int dtype,
                                       void* stream) {
  if (bad_args(bh, heads, t, d, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, dout, lse, delta, lengths, dq, bh, heads, t, chunk,
                            sm_scale, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, lengths, dq, bh, heads, t,
                                    chunk, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cosy_flash_attention_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        const int* lengths, void* dk, void* dv, int bh,
                                        int heads, int t, int d, int chunk, float sm_scale,
                                        int dtype, void* stream) {
  if (bad_args(bh, heads, t, d, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, dout, lse, delta, lengths, dk, dv, bh, heads, t, chunk,
                             sm_scale, s);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, lengths, dk, dv, bh, heads, t,
                                     chunk, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of K3 (which = 0) or K4 (which = 1) resident on one SM, for dtype
// as above: the occupancy the launch gets.  Returns a cudaError_t.
extern "C" int cosy_flash_attention_bwd_occupancy(int which, int dtype, int* blocks) {
  if (dtype == 0) return occupancy<float>(which, blocks);
  if (dtype == 1) return occupancy<__nv_bfloat16>(which, blocks);
  return (int)cudaErrorInvalidValue;
}
