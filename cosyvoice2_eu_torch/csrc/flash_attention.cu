// Flash-attention forward in float32 for Hopper (sm_90a), plain C interface
// for ctypes.
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
// the mean of V over the visited keys, as the TPU kernel does, not NaN (with
// chunk > 0 the visited keys end at this kernel's 64-key tile boundary, not
// at the TPU kernel's wider block).  Keys past T are excluded outright.  Key
// tiles past the chunk bound are skipped, and so are tiles past length[b]
// when length[b] > 0 (their weights are exactly 0).
//
// Inputs q, k, v: (B*H, T, D) contiguous float32; scores, softmax,
// accumulator and output in fp32; optional fp32 log-sum-exp (B*H, T).
//
// What bounds it on the H100: fp32 has no dense tensor-core path other than
// TF32, which would break the train step's gradient parity, so the bound is
// the fp32 FMA rate (67 TFLOP/s).  The design is simple and right: one
// 256-thread block per (64-query tile, batch*head), K/V tiles of 64 keys
// staged in shared memory, each thread owning a 4x4 score block and a
// 4x(D/16) output block.  Its gap to that bound is the block's shared-memory
// traffic (about 2.5 FMAs per shared load) and loads that overlap no math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int QS = D + 4;   // Q row stride (float4-aligned, bank offset)
  static constexpr int KS = BK + 1;  // K^T row stride (conflict-free transpose)
  static constexpr int PS = BK + 4;  // P row stride
  static constexpr int BYTES = (BQ * QS + D * KS + BK * D + BQ * PS) * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ o, float* __restrict__ lse,
                 int heads, int t, int chunk, float scale_log2) {
  constexpr int NC = D / 16;  // output columns per thread
  using S = Smem<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                 // [BQ][QS], pre-scaled by scale*log2(e)
  float* Kt = Qs + BQ * S::QS;      // [D][KS]  (K transposed)
  float* Vs = Kt + D * S::KS;       // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int length = lengths[bh / heads];
  const size_t base = (size_t)bh * t * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    int r = e / D, c = e % D;
    int row = q0 + r;
    Qs[r * S::QS + c] = row < t ? q[base + (size_t)row * D + c] * scale_log2 : 0.f;
  }

  // number of key tiles any row of this block can see
  const int q_last = min(q0 + BQ, t) - 1;
  int kv_end = t;
  if (chunk > 0) kv_end = min(kv_end, (q_last / chunk + 1) * chunk);
  if (length > 0) kv_end = min(kv_end, length);
  const int n_tiles = (kv_end + BK - 1) / BK;

  int row_limit[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = q0 + ty * 4 + i;
    row_limit[i] = chunk > 0 ? min((row / chunk + 1) * chunk, length) : length;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // previous tile fully consumed (and Qs written)
    for (int e = tid; e < BK * D; e += THREADS) {
      int r = e / D, c = e % D;
      int key = k0 + r;
      float kval = 0.f, vval = 0.f;
      if (key < t) {
        kval = k[base + (size_t)key * D + c];
        vval = v[base + (size_t)key * D + c];
      }
      Kt[c * S::KS + r] = kval;
      Vs[r * D + c] = vval;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * S::QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float k0v = Kt[(d + 0) * S::KS + c], k1v = Kt[(d + 1) * S::KS + c];
        float k2v = Kt[(d + 2) * S::KS + c], k3v = Kt[(d + 3) * S::KS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, k0v, s[i][j]);
          s[i][j] = fmaf(qv[i].y, k1v, s[i][j]);
          s[i][j] = fmaf(qv[i].z, k2v, s[i][j]);
          s[i][j] = fmaf(qv[i].w, k3v, s[i][j]);
        }
      }
    }

    // mask + online softmax (base 2; scores already carry log2(e))
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key >= t) s[i][j] = -INFINITY;
        else if (key >= row_limit[i]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mx);
        rs += p;
        Ps[(ty * 4 + i) * S::PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty*4+i, columns tx+16*j
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * S::PS + c]);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = tx + 16 * j;
        float v0 = Vs[(c + 0) * D + col], v1 = Vs[(c + 1) * D + col];
        float v2 = Vs[(c + 2) * D + col], v3 = Vs[(c + 3) * D + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(pv[i].x, v0, acc[i][j]);
          acc[i][j] = fmaf(pv[i].y, v1, acc[i][j]);
          acc[i][j] = fmaf(pv[i].z, v2, acc[i][j]);
          acc[i][j] = fmaf(pv[i].w, v3, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= t) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      o[base + (size_t)row * D + tx + 16 * j] = acc[i][j] * inv_l;
    if (lse != nullptr && tx == 0) {
      // natural-log lse; a row with no visible key keeps the TPU kernel's -1e30
      const float m_nat = m[i] == NEG_INF ? NEG_INF : m[i] * LN2;
      lse[(size_t)bh * t + row] = m_nat + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* lengths, float* o,
           float* lse, int bh, int heads, int t, int chunk, float sm_scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D>;
  const int smem = Smem<D>::BYTES;
  static bool smem_set = false;  // the attribute is per kernel and idempotent
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((t + BQ - 1) / BQ, bh);
  kern<<<grid, THREADS, smem, stream>>>(q, k, v, lengths, o, lse, heads, t, chunk,
                                        sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype must be 0 (float32); bfloat16 is flash_attention_sm90.cu's.  lse may
// be null.  Returns a cudaError_t.
extern "C" int cosy_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        const int* lengths, void* o, float* lse, int bh,
                                        int heads, int t, int d, int chunk, float sm_scale,
                                        int dtype, void* stream) {
  // the estimator's head dim is 64 (8 heads x 64 = 512 wide at every width)
  if (bh <= 0 || t <= 0 || heads <= 0 || bh % heads != 0 || chunk < 0 || d != 64 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch<64>(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), lengths, static_cast<float*>(o), lse, bh, heads,
                    t, chunk, sm_scale, static_cast<cudaStream_t>(stream));
}
