// Int8 weight-only matmul (kernel K2) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel cosyvoice2_eu_tpu/ops/pallas/int8_matmul.py::_kernel
// (launched by int8_matmul).  It computes y32 = x @ w_q^T, unscaled:
//   x (M, K) float32 or bfloat16, w_q (N, K) int8 with |w| <= 127,
//   y32 (M, N) float32;
// the caller multiplies by the per-output-channel scale and adds the bias.
// The weights are read from device memory once, as int8, and converted to
// fp32 in registers.  Integers up to 127 are exact in fp32, and so is the
// product of a bf16 value and such an integer, so the kernel differs from
// x.float() @ w_q.float().T only in the order of the fp32 sums.  Unlike the
// TPU kernel it takes any K: a ragged K tail (like ragged M and N) is masked
// inside.
//
// What it serves: ops/int8_matmul.py::design sends it what the other two
// designs cannot take: K not a multiple of 16 (no bulk copy or TMA of such
// rows), x or w_q off a 16-byte boundary, float32 x above 8 rows (the wgmma
// design takes bf16 only: TF32 would round x), and decode K past what 8
// cluster ranks hold in shared memory (32768).  The LM's decode (M <= 8) goes
// to int8_matmul_decode_sm90.cu (bulk copies into a shared-memory ring,
// split-K across a thread-block cluster), its bf16 prefill to
// int8_matmul_sm90.cu (wgmma).  chip_smoke.py still times this design at
// the decode shapes beside the decode one.
//
// What bounds it: at M <= 8 the bytes (N*K int8 read once, far below the
// ~295 operations a byte where the tensor cores would be the limit); at
// larger M every 8-row tile reads the weights again, from L2.
//
// The design: it streams the weights at 16 bytes a lane.  One 128-thread
// block owns BN = 8 output channels (4 warps x 2 channels) and a tile of BM
// rows (1 at M = 1, 4 at M <= 4, else 8); the grid is (cdiv(N, 8),
// cdiv(M, BM)).  Per K-chunk of 1024 each lane first starts its weight loads
// (2 channels x 2 groups of 16 int8, neighbouring lanes on neighbouring
// addresses), then the block stages x as fp32 in shared memory, laid out so
// that the warp's 16-byte reads of it are conflict-free.  Each lane converts
// its int8 with a byte permute and one fp32 subtraction, FMAs them against
// the staged rows, and the warp reduces its sums with shuffles.  A ragged K
// tail and unaligned weights go through byte loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int CW = 2;                // output channels per warp
constexpr int BN = WARPS * CW;       // output channels per block
constexpr int KC = 1024;             // K-chunk staged in shared memory
constexpr int NG = KC / 16;          // groups of 16 K-elements per chunk
constexpr int GPL = NG / 32;         // groups per lane per chunk

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 int8 weights of one channel at K-offset kg, zero past N or K.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ w, int ch, int kg, int n,
                                        int k) {
  if (ch >= n || kg >= k) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = w + (size_t)ch * k + kg;
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (kg + e < k) word[e >> 2] |= (uint32_t)(uint8_t)__ldg(p + e) << (8 * (e & 3));
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// Four int8 in one word -> four exact floats.  Flipping the sign bit makes
// each byte u = w + 128; placed in the low mantissa of 2^23 it gives the
// float 2^23 + u, and subtracting 2^23 + 128 leaves w.
__device__ __forceinline__ void i8x4_to_f32(uint32_t word, float* out) {
  const uint32_t u = word ^ 0x80808080u;
  out[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  out[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  out[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  out[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

template <typename T, int BM, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, float* __restrict__ y,
                   int m, int n, int k) {
  // x chunk as fp32: element kk of row r sits in float4 r*(KC/4) + (kk%16/4)*NG + kk/16,
  // component kk%4, so group g's four float4 are read by lane g at consecutive addresses
  __shared__ float4 xs[BM * KC / 4];
  float* xf = reinterpret_cast<float*>(xs);
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BN + (threadIdx.x >> 5) * CW;
  const int m0 = blockIdx.y * BM;

  float acc[BM][CW];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < k; k0 += KC) {
    uint4 raw[GPL][CW];  // loads start before the staging, used after it
#pragma unroll
    for (int j = 0; j < GPL; ++j)
#pragma unroll
      for (int c = 0; c < CW; ++c)
        raw[j][c] = load16<VEC>(w, n0 + c, k0 + (lane + 32 * j) * 16, n, k);

    __syncthreads();  // the previous chunk has been read
    for (int i = threadIdx.x; i < BM * KC; i += WARPS * 32) {
      const int r = i / KC, kk = i % KC;
      const int row = m0 + r, col = k0 + kk;
      xf[r * KC + ((kk & 15) >> 2) * NG * 4 + (kk >> 4) * 4 + (kk & 3)] =
          (row < m && col < k) ? to_float(x[(size_t)row * k + col]) : 0.f;
    }
    __syncthreads();

    const int kend = min(KC, k - k0);
#pragma unroll
    for (int j = 0; j < GPL; ++j) {
      const int g = lane + 32 * j;
      if (g * 16 >= kend) break;
      float wf[CW][16];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        i8x4_to_f32(raw[j][c].x, wf[c]);
        i8x4_to_f32(raw[j][c].y, wf[c] + 4);
        i8x4_to_f32(raw[j][c].z, wf[c] + 8);
        i8x4_to_f32(raw[j][c].w, wf[c] + 12);
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        float xv[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = xs[r * (KC / 4) + q * NG + g];
          xv[4 * q] = v.x;
          xv[4 * q + 1] = v.y;
          xv[4 * q + 2] = v.z;
          xv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < CW; ++c)
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[r][c] = fmaf(xv[e], wf[c][e], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (m0 + r < m && n0 + c < n) y[(size_t)(m0 + r) * n + n0 + c] = acc[r][c];
  }
}

template <typename T, int BM>
int launch(const void* x, const int8_t* w, float* y, int m, int n, int k, bool vec,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (vec)
    int8_matmul_kernel<T, BM, true><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), w, y, m, n, k);
  else
    int8_matmul_kernel<T, BM, false><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), w, y, m, n, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* x, const int8_t* w, float* y, int m, int n, int k, bool vec,
                cudaStream_t stream) {
  if (m == 1) return launch<T, 1>(x, w, y, m, n, k, vec, stream);
  if (m <= 4) return launch<T, 4>(x, w, y, m, n, k, vec, stream);
  return launch<T, 8>(x, w, y, m, n, k, vec, stream);
}

}  // namespace

// x (m, k) of dtype 0 = float32 or 1 = bfloat16, w (n, k) int8, y (m, n)
// float32, all contiguous.  Returns a cudaError_t.
extern "C" int cosy_int8_matmul(const void* x, const void* w, void* y, int m, int n, int k,
                                int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + 7) / 8 > 65535) return (int)cudaErrorInvalidValue;
  const int8_t* wq = static_cast<const int8_t*>(w);
  // 16-byte weight loads need every row to start on a 16-byte boundary
  const bool vec = k % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rows<float>(x, wq, out, m, n, k, vec, s);
  if (dtype == 1) return launch_rows<__nv_bfloat16>(x, wq, out, m, n, k, vec, s);
  return (int)cudaErrorInvalidValue;
}
