// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels of cosyvoice2_eu_tpu/ops/pallas/flash_attention.py
// launched by _flash_bwd:
//   K3  _dq_kernel:  dQ = scale * sum_k [P o (dP - delta)] K
//   K4  _dkv_kernel: dV = sum_q P^T dO,  dK = sum_q dS^T (Q * scale)
// with P = exp(S - LSE) under the forward's mask (S = Q K^T * scale, LSE the
// forward's natural-log log-sum-exp), dP = dO V^T, delta = rowsum(dO o O)
// (computed by the caller) and dS = P o (dP - delta).  The mask is built per
// tile from the scalars length[b] and chunk, as in flash_attention.cu:
//   key j is visible to query i iff j < length[b] and, when chunk > 0,
//   j < (i / chunk + 1) * chunk.
// A batch with length[b] == 0 has no visible key and gets zero gradients, as
// the TPU kernels give it.  Every query row below T takes part (pad rows
// included); keys at or past length[b] get dK = dV = 0 exactly.
//
// Layout: q, k, v, dO, dQ, dK, dV (B*H, T, D) contiguous, float32 or
// bfloat16; lse, delta (B*H, T) float32.  All products and sums in fp32;
// outputs rounded once to the input type.  Scores are kept in base 2 as in
// the forward: s2 = (q . k) * scale * log2(e), P = exp2(s2 - lse * log2(e)).
//
// Grid and order.  K3 gives one 256-thread block per (64-query tile, b*h)
// and loops over the key tiles its rows can see (the forward's bound).  K4
// gives one block per (64-key tile, b*h) and loops over the query tiles from
// the first one that can see the key tile (qb_start, from this kernel's
// 64-row tiles) to the end.  Each block owns its outputs: no atomics, and
// the result does not depend on scheduling.
//
// What bounds it on the H100: at the training shapes (B*H = 32, T = 740, or
// B*H = 16, T = 1480, D = 64) K3 does 6*D and K4 8*D operations per visible
// (query, key) pair, some 7-13 GFLOP per launch on ~25 MB, far above the
// ~20 FLOP/byte ridge of fp32 FMA, so operations bound both.  This first
// design is simple and right, not fast: tiles staged in shared memory as
// fp32, every product on the fp32 FMA units (67 TFLOP/s peak, no tensor
// cores), each thread owning a 4x4 block of the 64x64 score tile and 4x4
// blocks of its outputs.  wgmma and TMA are the way to the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
struct Smem {
  static constexpr int RS = D + 4;   // row-major stride (float4-aligned, bank offset)
  static constexpr int TS = BK + 1;  // transposed stride (conflict-free transpose)
  static constexpr int PS = BK + 4;  // score-tile stride
  // K3: Qs, dOs [BQ][RS]; Kt, Vt [D][TS]; dS [BQ][PS]
  static constexpr int DQ_BYTES = (2 * BQ * RS + 2 * D * TS + BQ * PS) * 4;
  // K4: Ks, Vs [BK][RS]; Qt, dOt [D][TS]; P, dS [BK][PS]; lse2, delta [BQ]
  static constexpr int DKV_BYTES = (2 * BK * RS + 2 * D * TS + 2 * BK * PS + 2 * BQ) * 4;
};

// first key past what row `row` may see
__device__ __forceinline__ int visible_end(int row, int chunk, int length) {
  return chunk > 0 ? min((row / chunk + 1) * chunk, length) : length;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ lengths,
                T* __restrict__ dq, int heads, int t, int chunk, float scale_log2,
                float sm_scale) {
  constexpr int NC = D / 16;  // output columns per thread
  using S = Smem<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                // [BQ][RS], pre-scaled by scale*log2(e)
  float* dOs = Qs + BQ * S::RS;    // [BQ][RS]
  float* Kt = dOs + BQ * S::RS;    // [D][TS]  (K transposed)
  float* Vt = Kt + D * S::TS;      // [D][TS]  (V transposed)
  float* dSs = Vt + D * S::TS;     // [BQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int length = min(lengths[bh / heads], t);  // keys past T do not exist
  const size_t base = (size_t)bh * t * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    int r = e / D, c = e % D;
    int row = q0 + r;
    bool in = row < t;
    Qs[r * S::RS + c] = in ? to_float(q[base + (size_t)row * D + c]) * scale_log2 : 0.f;
    dOs[r * S::RS + c] = in ? to_float(dout[base + (size_t)row * D + c]) : 0.f;
  }

  // key tiles any row of this block can see: the forward's bound, and none
  // at all when length == 0
  const int q_last = min(q0 + BQ, t) - 1;
  int kv_end = min(t, length);
  if (chunk > 0) kv_end = min(kv_end, (q_last / chunk + 1) * chunk);
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  int row_end[4];
  float lse2[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool in = row < t;
    row_end[i] = in ? visible_end(row, chunk, length) : 0;
    lse2[i] = in ? lse[(size_t)bh * t + row] * LOG2E : 0.f;
    dlt[i] = in ? delta[(size_t)bh * t + row] : 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // previous tile fully consumed (and Qs/dOs written)
    for (int e = tid; e < BK * D; e += THREADS) {
      int r = e / D, c = e % D;
      int key = k0 + r;
      float kval = 0.f, vval = 0.f;
      if (key < t) {
        kval = to_float(k[base + (size_t)key * D + c]);
        vval = to_float(v[base + (size_t)key * D + c]);
      }
      Kt[c * S::TS + r] = kval;
      Vt[c * S::TS + r] = vval;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows ty*4+i, keys tx+16*j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * S::RS + d]);
        ov[i] = *reinterpret_cast<const float4*>(&dOs[(ty * 4 + i) * S::RS + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float k0v = Kt[(d + 0) * S::TS + c], k1v = Kt[(d + 1) * S::TS + c];
        const float k2v = Kt[(d + 2) * S::TS + c], k3v = Kt[(d + 3) * S::TS + c];
        const float v0 = Vt[(d + 0) * S::TS + c], v1 = Vt[(d + 1) * S::TS + c];
        const float v2 = Vt[(d + 2) * S::TS + c], v3 = Vt[(d + 3) * S::TS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, k0v, s[i][j]);
          s[i][j] = fmaf(qv[i].y, k1v, s[i][j]);
          s[i][j] = fmaf(qv[i].z, k2v, s[i][j]);
          s[i][j] = fmaf(qv[i].w, k3v, s[i][j]);
          dp[i][j] = fmaf(ov[i].x, v0, dp[i][j]);
          dp[i][j] = fmaf(ov[i].y, v1, dp[i][j]);
          dp[i][j] = fmaf(ov[i].z, v2, dp[i][j]);
          dp[i][j] = fmaf(ov[i].w, v3, dp[i][j]);
        }
      }
    }

    // dS = P (dP - delta), P = exp2(s2 - lse2) on visible keys, else 0
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const float p = key < row_end[i] ? exp2f(s[i][j] - lse2[i]) : 0.f;
        dSs[(ty * 4 + i) * S::PS + tx + 16 * j] = p * (dp[i][j] - dlt[i]);
      }
    __syncthreads();

    // acc += dS K for rows ty*4+i, columns tx+16*j (K[c][col] = Kt[col][c])
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(&dSs[(ty * 4 + i) * S::PS + c]);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float* kc = &Kt[(tx + 16 * j) * S::TS + c];
        const float w0 = kc[0], w1 = kc[1], w2 = kc[2], w3 = kc[3];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(sv[i].x, w0, acc[i][j]);
          acc[i][j] = fmaf(sv[i].y, w1, acc[i][j]);
          acc[i][j] = fmaf(sv[i].z, w2, acc[i][j]);
          acc[i][j] = fmaf(sv[i].w, w3, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dq[base + (size_t)row * D + tx + 16 * j] = from_float<T>(acc[i][j] * sm_scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ lengths,
                 T* __restrict__ dk, T* __restrict__ dv, int heads, int t, int chunk,
                 float scale_log2, float sm_scale) {
  constexpr int NC = D / 16;
  using S = Smem<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;                // [BK][RS]
  float* Vs = Ks + BK * S::RS;     // [BK][RS]
  float* Qt = Vs + BK * S::RS;     // [D][TS]  (Q transposed, unscaled)
  float* dOt = Qt + D * S::TS;     // [D][TS]  (dO transposed)
  float* Ps = dOt + D * S::TS;     // [BK][PS] P^T tile (keys x queries)
  float* dSs = Ps + BK * S::PS;    // [BK][PS] dS^T tile
  float* lse2s = dSs + BK * S::PS; // [BQ]
  float* dlts = lse2s + BQ;        // [BQ]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int length = min(lengths[bh / heads], t);  // keys past T do not exist
  const size_t base = (size_t)bh * t * D;

  if (k0 >= length) {  // no query sees these keys: their gradients are zero
    for (int e = tid; e < BK * D; e += THREADS) {
      int key = k0 + e / D;
      if (key < t) {
        dk[base + (size_t)key * D + e % D] = from_float<T>(0.f);
        dv[base + (size_t)key * D + e % D] = from_float<T>(0.f);
      }
    }
    return;
  }

  for (int e = tid; e < BK * D; e += THREADS) {
    int r = e / D, c = e % D;
    int key = k0 + r;
    bool in = key < t;
    Ks[r * S::RS + c] = in ? to_float(k[base + (size_t)key * D + c]) : 0.f;
    Vs[r * S::RS + c] = in ? to_float(v[base + (size_t)key * D + c]) : 0.f;
  }

  // queries in chunks before this key tile's chunk see none of it
  const int qb_start = chunk > 0 ? ((k0 / chunk) * chunk) / BQ : 0;
  const int n_qtiles = (t + BQ - 1) / BQ;

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qb = qb_start; qb < n_qtiles; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();  // previous tile fully consumed (and Ks/Vs written)
    for (int e = tid; e < BQ * D; e += THREADS) {
      int r = e / D, c = e % D;
      int row = q0 + r;
      float qval = 0.f, oval = 0.f;
      if (row < t) {
        qval = to_float(q[base + (size_t)row * D + c]);
        oval = to_float(dout[base + (size_t)row * D + c]);
      }
      Qt[c * S::TS + r] = qval;
      dOt[c * S::TS + r] = oval;
    }
    if (tid < BQ) {
      const int row = q0 + tid;
      lse2s[tid] = row < t ? lse[(size_t)bh * t + row] * LOG2E : 0.f;
      dlts[tid] = row < t ? delta[(size_t)bh * t + row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for keys ty*4+i, queries tx+16*j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(&Ks[(ty * 4 + i) * S::RS + d]);
        vv[i] = *reinterpret_cast<const float4*>(&Vs[(ty * 4 + i) * S::RS + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float q0v = Qt[(d + 0) * S::TS + c], q1v = Qt[(d + 1) * S::TS + c];
        const float q2v = Qt[(d + 2) * S::TS + c], q3v = Qt[(d + 3) * S::TS + c];
        const float o0 = dOt[(d + 0) * S::TS + c], o1 = dOt[(d + 1) * S::TS + c];
        const float o2 = dOt[(d + 2) * S::TS + c], o3 = dOt[(d + 3) * S::TS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(kv[i].x, q0v, s[i][j]);
          s[i][j] = fmaf(kv[i].y, q1v, s[i][j]);
          s[i][j] = fmaf(kv[i].z, q2v, s[i][j]);
          s[i][j] = fmaf(kv[i].w, q3v, s[i][j]);
          dp[i][j] = fmaf(vv[i].x, o0, dp[i][j]);
          dp[i][j] = fmaf(vv[i].y, o1, dp[i][j]);
          dp[i][j] = fmaf(vv[i].z, o2, dp[i][j]);
          dp[i][j] = fmaf(vv[i].w, o3, dp[i][j]);
        }
      }
    }

    // P^T and dS^T on visible (key, query) pairs, else 0
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = tx + 16 * j;
      const int row = q0 + qc;
      const int end = row < t ? visible_end(row, chunk, length) : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
        const float p = key < end ? exp2f(s[i][j] * scale_log2 - lse2s[qc]) : 0.f;
        Ps[(ty * 4 + i) * S::PS + qc] = p;
        dSs[(ty * 4 + i) * S::PS + qc] = p * (dp[i][j] - dlts[qc]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for keys ty*4+i, columns tx+16*j
#pragma unroll 2
    for (int c = 0; c < BQ; c += 4) {
      float4 pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * S::PS + c]);
        sv[i] = *reinterpret_cast<const float4*>(&dSs[(ty * 4 + i) * S::PS + c]);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float* oc = &dOt[(tx + 16 * j) * S::TS + c];
        const float* qc = &Qt[(tx + 16 * j) * S::TS + c];
        const float o0 = oc[0], o1 = oc[1], o2 = oc[2], o3 = oc[3];
        const float w0 = qc[0], w1 = qc[1], w2 = qc[2], w3 = qc[3];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pv[i].x, o0, dv_acc[i][j]);
          dv_acc[i][j] = fmaf(pv[i].y, o1, dv_acc[i][j]);
          dv_acc[i][j] = fmaf(pv[i].z, o2, dv_acc[i][j]);
          dv_acc[i][j] = fmaf(pv[i].w, o3, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i].x, w0, dk_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i].y, w1, dk_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i].z, w2, dk_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i].w, w3, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= t) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk[base + (size_t)key * D + tx + 16 * j] = from_float<T>(dk_acc[i][j] * sm_scale);
      dv[base + (size_t)key * D + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kern, int bytes, bool* done) {
  if (*done) return cudaSuccess;  // the attribute is per kernel and idempotent
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* lengths, void* dq, int bh, int heads, int t,
              int chunk, float sm_scale, cudaStream_t stream) {
  static bool smem_set = false;
  const int smem = Smem<D>::DQ_BYTES;
  cudaError_t err = set_smem(flash_dq_kernel<T, D>, smem, &smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + BQ - 1) / BQ, bh);
  flash_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, lengths, static_cast<T*>(dq), heads, t, chunk,
      sm_scale * LOG2E, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* lengths, void* dk, void* dv, int bh, int heads,
               int t, int chunk, float sm_scale, cudaStream_t stream) {
  static bool smem_set = false;
  const int smem = Smem<D>::DKV_BYTES;
  cudaError_t err = set_smem(flash_dkv_kernel<T, D>, smem, &smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + BK - 1) / BK, bh);
  flash_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, lengths, static_cast<T*>(dk),
      static_cast<T*>(dv), heads, t, chunk, sm_scale * LOG2E, sm_scale);
  return (int)cudaGetLastError();
}

bool bad_args(int bh, int heads, int t, int d, int chunk) {
  // the estimator's head dim is 64 (8 heads x 64 = 512 wide at every width)
  return bh <= 0 || t <= 0 || heads <= 0 || bh % heads != 0 || chunk < 0 || d != 64;
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
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, lengths, dq, bh, heads, t, chunk,
                                sm_scale, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, lengths, dq, bh, heads, t,
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
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, lengths, dk, dv, bh, heads, t,
                                 chunk, sm_scale, s);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, lengths, dk, dv, bh,
                                         heads, t, chunk, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
