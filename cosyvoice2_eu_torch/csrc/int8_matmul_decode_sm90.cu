// Int8 weight-only matmul (kernel K2) at decode, for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel cosyvoice2_eu_tpu/ops/pallas/int8_matmul.py::_kernel
// (launched by int8_matmul) for x with at most 8 rows (the LM's decode: M = 1
// for one request, 4 for a batch of four), K a multiple of 16 and 16-byte
// aligned weights; int8_matmul_sm90.cu takes bf16 x above 8 rows, and
// int8_matmul.cu what neither takes.  It computes
//   y32 = x @ w_q^T, unscaled: x (M, K) float32 or bfloat16, w_q (N, K) int8,
//   y32 (M, N) float32;
// the caller multiplies by the per-output-channel scale and adds the bias.
//
// Numerics.  Every int8 code is exact in fp32, and so is its product with a
// bf16 or fp32 x (the FMA rounds only the sum), so the kernel differs from
// x.float() @ w_q.float().T only in the order of the fp32 sums: per lane in
// increasing K, then a fixed shuffle tree over the warp's lanes, then the
// cluster's ranks added in rank order.  No atomics: two launches on the same
// inputs give the same bits.
//
// What bounds it on the H100: a launch reads N K int8 weight bytes, M K x
// bytes and writes M N fp32 bytes, and does 2 M N K operations; at M <= 8
// that is at most 16 operations a weight byte, far below the ~295 a byte
// where the tensor cores would be the limit.  So the bytes bound it: at
// 3.35 TB/s the decode shapes' bounds run from 0.035 us (128 x 896) to 1.8 us
// (6564 x 896), and one decode token's 363.7 MB of int8 projections from
// 0.109 ms.  Little's law at ~1 us of DRAM latency wants ~3.3 MB in flight
// across the card, ~25 KB an SM.  What the design does about it:
//   * weights by asynchronous bulk copy into a ring: a producer warp starts,
//     per stage, one 1-D cp.async.bulk of each of the block's CH channel rows
//     (SK = 512 bytes of K each; lane 0 arms the barriers, then each lane
//     starts one row) into a ring of up to STAGES = 4 shared-memory stages.
//     Each stage has one mbarrier per consumer warp, which completes when
//     that warp's rows have landed (expect_tx), and one that the four
//     consumer warps release it on; the producer then refills it.  A 1-D copy
//     needs no tensor map, so nothing is encoded on the host per launch
//     (decode launches K2 169 times a step), but it needs 16-byte aligned
//     addresses and sizes: hence K % 16 == 0 and aligned bases;
//   * x once per block: while the first copies fly, the consumer warps stage
//     the block's K-run of the M rows as fp32 in shared memory, once (16-byte
//     loads), behind one named barrier that the producer joins without
//     waiting, in a layout where lane g's four float4 of its 16-wide K group
//     sit at consecutive addresses across the warp (conflict-free);
//   * arithmetic on the FMA units: each of the 4 consumer warps owns CH / 4
//     channels; lane l takes 16-byte group l of each of its channel rows of a
//     stage, converts the int8 to fp32 with a byte permute and one
//     subtraction (exact for all 256 codes), and each converted weight feeds
//     all M rows' FMAs (converted once, used M times).  At M = 4 that is ~6.5
//     instructions a weight, ~1 us of the whole card's instruction slots at
//     896 x 4864, as long as its bytes take: mma.sync on weights converted to
//     bf16 is the step after this one if that shows;
//   * split-K across a thread-block cluster: a cluster of C in {1, 2, 4, 8}
//     blocks shares one group of CH output channels, each block (rank) a
//     contiguous run of K.  Each warp reduces its lanes with shuffles (the
//     warps own disjoint channels, so that is the whole in-block reduction).
//     With C = 1 lane 0 writes y.  Otherwise every rank writes its M x CH
//     partials into its own slot of rank 0's shared memory (mapa /
//     st.shared::cluster; every block arrives on the cluster barrier when it
//     starts and waits before its first such write, so all are running),
//     one cluster barrier (release / acquire) follows, and rank 0 adds the
//     slots in rank order and writes y.  One launch, no workspace, no second
//     kernel, no block's shared memory read by another after the barrier.
// Enough blocks, few partial sums: the caller picks CH and C
// (ops/int8_matmul.py::decode_config).  CH is 8, or 16 where 8-channel blocks
// would be more than 5 an SM; C is the smallest power of two that gives 1.5
// blocks an SM (198), as long as each rank keeps at least 1024 K, and large
// enough that a run fits shared memory (<= 4096 K).  The grids of the decode
// shapes (the same at M = 1 and 4; 160 threads a block):
//   (N, K) = (128, 896):  16 blocks of 8 channels, C 1, runs of 896 K;
//            (896, 896):  112 blocks of 8, C 1;
//            (4864, 896): 608 blocks of 8, C 1;
//            (896, 4864): 112 groups of 8 x C 2 = 224 blocks, runs of 2432 K;
//            (6564, 896): 411 blocks of 16, C 1 (the last group holds 4
//                         channels).
// Bytes in flight an SM: at K = 896 a run is 2 stages, so each block requests
// all its weight bytes at once: 4864 x 896, 608 blocks x 7.2 KB, 4.6 an SM,
// ~33 KB; 6564 x 896, 411 x 14.3 KB, 3.1 an SM, ~45 KB; the 128- and
// 896-channel matrices (0.11 and 0.80 MB) are whole in flight.  At 896 x
// 4864 a run is 5 stages, 4 in flight: 224 blocks x 16 KB, 1.7 an SM, ~27
// KB; int8_matmul.cu keeps ~8 KB an SM in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 4;          // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);  // + one producer warp
constexpr int SK = 512;               // K bytes of one channel row per stage: 32 lanes x 16
constexpr int STAGES = 4;             // ring depth
constexpr int MAX_RUN = 4096;         // K of one rank, so that x fits shared memory
constexpr int MAX_ROWS = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes `bytes` transactions on the barrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// The cluster barrier, which every thread of every block of the cluster
// passes: arrive (release, or relaxed: no ordering), then wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

// v to this shared address in the block of cluster rank `rank`
__device__ __forceinline__ void store_remote(uint32_t addr, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
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

// four bf16 in two words (low half first) -> four exact floats
__device__ __forceinline__ float4 bf16x4_to_f32(uint32_t a, uint32_t b) {
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xFFFF0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xFFFF0000u));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Dynamic shared memory of a launch: the ring, x's run as fp32, the cluster's
// partials (in rank 0) and the barriers (a full one per stage and consumer
// warp, an empty one per stage).
__host__ __device__ constexpr int smem_bytes(int ch, int depth, int rows, int per, int ranks) {
  return depth * ch * SK + rows * per * 4 + ranks * rows * ch * 4 + depth * (CONSUMERS + 1) * 8;
}

// The ring's barriers from `bars`: full(s, v), consumer warp v's rows of
// stage s have landed; empty(s), all consumer warps have read stage s.
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s, int v) {
  return bars + 8 * (s * CONSUMERS + v);
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int depth, int s) {
  return bars + 8 * (depth * CONSUMERS + s);
}

// The producer warp starts stages t0 .. t0 + count - 1 of the block's run of
// `run` K from k0, channel rows c0 .. c0 + valid - 1 of w: lane 0 arms each
// consumer warp's barrier with the bytes of its rows, then the lanes start
// one channel row each, into the ring at `ring` (depth stages of CH rows).
template <int CH>
__device__ __forceinline__ void start_stages(int t0, int count, int lane, uint32_t ring,
                                             uint32_t bars, int depth, const int8_t* w, int k,
                                             int c0, int k0, int run, int valid) {
  constexpr int CPW = CH / CONSUMERS;
  if (lane == 0)
    for (int t = t0; t < t0 + count; ++t)
      for (int v = 0; v < CONSUMERS; ++v)
        mbar_expect_tx(full_bar(bars, t % depth, v),
                       max(0, min(CPW, valid - v * CPW)) * min(SK, run - t * SK));
  __syncwarp();
  for (int j = lane; j < count * CH; j += 32) {
    const int t = t0 + j / CH, c = j % CH;
    if (c < valid)
      bulk_copy(ring + ((t % depth) * CH + c) * SK, w + (size_t)(c0 + c) * k + k0 + t * SK,
                min(SK, run - t * SK), full_bar(bars, t % depth, c / CPW));
  }
}

// Blocks an SM the registers must allow: 5 of 8 channels and 4 of 16 at M <= 4,
// so that the grids of 608 and 411 blocks fit the card at once; 1 at M = 8.
// (Left to itself ptxas held some instances to 56-64 registers and spilled.)
template <int BM, int CH>
constexpr int min_blocks() {
  return BM == 8 ? 1 : CH == 8 ? 5 : 4;
}

// One block: CH channels from c0 = (blockIdx.x / C) * CH, K from
// k0 = rank * per to min(k, k0 + per), BM >= m rows.
template <typename T, int BM, int CH>
__global__ void __launch_bounds__(THREADS, min_blocks<BM, CH>())
int8_matmul_decode(const T* __restrict__ x, const int8_t* __restrict__ w, float* __restrict__ y,
                   int m, int n, int k, int per, int depth) {
  constexpr int CPW = CH / CONSUMERS;  // channels per consumer warp
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t rank = cluster_rank(), ranks = cluster_size();
  const int c0 = (blockIdx.x / ranks) * CH;
  const int k0 = rank * per;
  const int run = min(k, k0 + per) - k0;  // > 0: the entry point refuses an empty rank
  const int stages = (run + SK - 1) / SK;
  const int valid = min(CH, n - c0);      // channels of this block that exist
  const int ng = per / 16;                // 16-wide K groups of a row of x
  uint8_t* ring = smem;
  float* xf = reinterpret_cast<float*>(smem + depth * CH * SK);
  const float4* xs = reinterpret_cast<const float4*>(xf);
  float* part = xf + BM * per;            // [rank][row][channel], used in rank 0
  const uint32_t bars = smem_u32(part + ranks * BM * CH);
  const uint32_t ring_s = smem_u32(ring);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a block may write into another's shared memory only once that one runs:
  // every thread arrives now and waits before its first such write
  if (ranks > 1) cluster_arrive_relaxed();
  if (warp == CONSUMERS) {
    // set up the ring, start the first copies, tell the consumers (named
    // barrier 1, without waiting), then refill each stage once released
    if (lane == 0) {
      for (int s = 0; s < depth; ++s) {
        for (int v = 0; v < CONSUMERS; ++v) mbar_init(full_bar(bars, s, v), 1);
        mbar_init(empty_bar(bars, depth, s), CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    start_stages<CH>(0, min(stages, depth), lane, ring_s, bars, depth, w, k, c0, k0, run, valid);
    asm volatile("bar.arrive 1, %0;" ::"n"(THREADS) : "memory");
    for (int t = depth; t < stages; ++t) {
      if (lane == 0) mbar_wait(empty_bar(bars, depth, t % depth), (t / depth - 1) & 1);
      __syncwarp();
      start_stages<CH>(t, 1, lane, ring_s, bars, depth, w, k, c0, k0, run, valid);
    }
    if (ranks > 1) cluster_wait();
  } else {
    // x's run as fp32: element kk of row r at float r per + ((kk % 16) / 4) 4
    // ng + (kk / 16) 4 + kk % 4, so lane g's float4 q of group g sits at q ng
    // + g.  16 bytes a load (8 bf16 or 4 fp32, within one group), a thread's
    // loads all in flight before its stores.
    constexpr int VEC = 16 / sizeof(T);
    constexpr int UNROLL = 4;
    constexpr int STAGERS = CONSUMERS * 32;
    const int chunks = per / VEC;  // loads per row
    for (int i0 = 0; i0 < BM * chunks; i0 += STAGERS * UNROLL) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * STAGERS + tid, r = i / chunks, kk = (i % chunks) * VEC;
        v[u] = i < BM * chunks && r < m && kk < run
                   ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * k + k0 + kk))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * STAGERS + tid, r = i / chunks, kk = (i % chunks) * VEC;
        if (i >= BM * chunks) continue;
        float4* dst = reinterpret_cast<float4*>(xf) + r * (per / 4) + ((kk & 15) >> 2) * ng +
                      (kk >> 4);
        if constexpr (VEC == 8) {  // bf16: the two float4 q and q + 1 of group kk / 16
          dst[0] = bf16x4_to_f32(v[u].x, v[u].y);
          dst[ng] = bf16x4_to_f32(v[u].z, v[u].w);
        } else {
          dst[0] = make_float4(__uint_as_float(v[u].x), __uint_as_float(v[u].y),
                               __uint_as_float(v[u].z), __uint_as_float(v[u].w));
        }
      }
    }
    // x staged and the ring's barriers set up (the producer has arrived)
    asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");

    float acc[BM][CPW];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < CPW; ++c) acc[r][c] = 0.f;
    for (int t = 0; t < stages; ++t) {
      const int s = t % depth;
      mbar_wait(full_bar(bars, s, warp), (t / depth) & 1);
      const int g = t * (SK / 16) + lane;  // this lane's 16-wide K group of the run
      if (g * 16 < run) {
        uint4 raw[CPW];
#pragma unroll
        for (int c = 0; c < CPW; ++c)
          raw[c] = *reinterpret_cast<const uint4*>(ring + (s * CH + warp * CPW + c) * SK +
                                                   lane * 16);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 xv[BM];
#pragma unroll
          for (int r = 0; r < BM; ++r) xv[r] = xs[r * (per / 4) + q * ng + g];
#pragma unroll
          for (int c = 0; c < CPW; ++c) {
            float wf[4];
            i8x4_to_f32(word(raw[c], q), wf);
#pragma unroll
            for (int r = 0; r < BM; ++r) {
              acc[r][c] = fmaf(xv[r].x, wf[0], acc[r][c]);
              acc[r][c] = fmaf(xv[r].y, wf[1], acc[r][c]);
              acc[r][c] = fmaf(xv[r].z, wf[2], acc[r][c]);
              acc[r][c] = fmaf(xv[r].w, wf[3], acc[r][c]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(bars, depth, s));  // the warp has read stage s
    }
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < CPW; ++c)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
    // lane 0 holds the warp's sums: straight to y, or into rank 0's slot of
    // this rank in distributed shared memory
    if (ranks > 1) cluster_wait();
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          const int ch = warp * CPW + c;
          if (ranks == 1) {
            if (r < m && ch < valid) y[(size_t)r * n + c0 + ch] = acc[r][c];
          } else {
            store_remote(smem_u32(part + (rank * BM + r) * CH + ch), 0, acc[r][c]);
          }
        }
  }
  if (ranks == 1) return;

  // Rank 0 waits for every rank's partials, the others for theirs to land;
  // after it no block's shared memory is touched by another.
  cluster_sync();
  if (rank == 0)
    for (int i = tid; i < BM * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      if (r < m && c < valid) {
        float sum = part[i];
        for (uint32_t q = 1; q < ranks; ++q) sum += part[q * BM * CH + i];  // in rank order
        y[(size_t)r * n + c0 + c] = sum;
      }
    }
}

template <typename T, int BM, int CH>
int launch(const void* x, const int8_t* w, float* y, int m, int n, int k, int per, int depth,
           int cluster, cudaStream_t stream) {
  const auto kernel = int8_matmul_decode<T, BM, CH>;
  static bool allowed = false;  // above 48 KB a block's shared memory must be allowed per kernel
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem_bytes(CH, STAGES, BM, MAX_RUN, 8));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + CH - 1) / CH * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(CH, depth, BM, per, cluster);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), w, y, m, n, k, per, depth);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T, int CH>
int launch_rows(const void* x, const int8_t* w, float* y, int m, int n, int k, int per, int depth,
                int cluster, cudaStream_t s) {
  if (m == 1) return launch<T, 1, CH>(x, w, y, m, n, k, per, depth, cluster, s);
  if (m == 2) return launch<T, 2, CH>(x, w, y, m, n, k, per, depth, cluster, s);
  if (m <= 4) return launch<T, 4, CH>(x, w, y, m, n, k, per, depth, cluster, s);
  return launch<T, 8, CH>(x, w, y, m, n, k, per, depth, cluster, s);
}

template <typename T>
int launch_channels(const void* x, const int8_t* w, float* y, int m, int n, int k, int per,
                    int depth, int channels, int cluster, cudaStream_t s) {
  if (channels == 8) return launch_rows<T, 8>(x, w, y, m, n, k, per, depth, cluster, s);
  return launch_rows<T, 16>(x, w, y, m, n, k, per, depth, cluster, s);
}

}  // namespace

// x (m, k) of dtype 0 = float32 or 1 = bfloat16, w (n, k) int8, y (m, n)
// float32, all contiguous; 1 <= m <= 8, k a multiple of 16, x and w on
// 16-byte boundaries.  A block owns `channels` (8 or 16) output channels;
// `cluster` (1, 2, 4 or 8) blocks split K into runs of cdiv(k / 16, cluster)
// groups of 16, none empty and none longer than 4096.  Returns a cudaError_t.
extern "C" int cosy_int8_matmul_decode(const void* x, const void* w, void* y, int m, int n, int k,
                                       int dtype, int channels, int cluster, void* stream) {
  if (m < 1 || m > MAX_ROWS || n <= 0 || k <= 0 || k % 16 != 0 ||
      (channels != 8 && channels != 16) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return (int)cudaErrorInvalidValue;
  const int units = k / 16;
  const int per = (units + cluster - 1) / cluster * 16;
  const int groups = (n + channels - 1) / channels;
  if ((cluster - 1) * per >= k || per > MAX_RUN || groups > 0x7fffffff / cluster)
    return (int)cudaErrorInvalidValue;  // an empty rank, or a run past shared memory
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;  // 16-byte loads of x, bulk copies of w
  const int depth = (per + SK - 1) / SK < STAGES ? (per + SK - 1) / SK : STAGES;
  const int8_t* wq = static_cast<const int8_t*>(w);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_channels<float>(x, wq, out, m, n, k, per, depth, channels, cluster, s);
  if (dtype == 1)
    return launch_channels<__nv_bfloat16>(x, wq, out, m, n, k, per, depth, channels, cluster, s);
  return (int)cudaErrorInvalidValue;
}
