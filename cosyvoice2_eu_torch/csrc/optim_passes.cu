// The optimizer's two fused passes over flat fp32 state buffers, plain C
// interface for ctypes (ops/optim_passes.py).
//
// Replaces no TPU kernel: the JAX package leaves the optax chain
// (MultiSteps(apply_if_finite(chain(clip_by_global_norm, adam|adamw)))) to
// XLA, which fuses it.  The port ran it as some twenty multi-tensor stages
// over every leaf, and its host time grew with the number of leaves (1,122
// in the flow).  Here the state of a tree lies in one flat buffer per
// quantity, each leaf on a 256-byte boundary with zeros between leaves, and
// two launches do the work:
//
// - pass A, once a micro-step: the running mean a + (g - a) / (n + 1) into a
//   new buffer, the gradient read where autograd left each leaf (a table of
//   addresses); the sum of g^2; on the emitting micro-step also the sum of
//   the new mean squared and the count of its non-finite elements.  Mode
//   NORM (accum_grad 1) only sums g^2 and counts g's non-finite elements.
// - pass B, once per finite emission: optax's clip (g / norm) * max when
//   norm >= max, Adam's moments, the fp32 bias corrections, eps, AdamW's
//   decay and -lr into new mu, nu and parameter buffers, and a * 0, the
//   mean's reset (non-finite stays non-finite, as in optax).
//
// What bounds it: bytes.  Pass A reads 8 and writes 4 bytes an element
// (4 and 0 in NORM mode), pass B reads 16 and writes 16 (12 and 12 from the
// table, accum_grad 1); a handful of operations an element.  The design
// streams 16 bytes a lane: a block of 256 threads takes one tile of at most
// 8192 elements of one leaf at a time (a table of (leaf, tile) pairs made
// once a layout), the grid of 1056 blocks (8 per SM) strides over the
// tiles.  Gradient leaves off a 16-byte boundary, and a leaf's ragged end,
// go through scalar loads.  Each element's arithmetic is rounded operation
// by operation (no contraction into FMAs), as the plain PyTorch version
// rounds it.  The sums are float64: per thread, then per block in a fixed
// tree, then over the blocks in block order by the last block to finish
// (a counter in device memory, which that block resets), so they do not
// depend on the schedule.  Outputs: out[0] = |g|, out[1] = the clip's norm,
// out[2] = the non-finite count, as float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 8192;  // elements; ops/optim_passes.py::TILE
constexpr int GRID = 1056;  // ops/optim_passes.py::GRID
constexpr int ALIGN = 64;   // fp32 elements in 256 bytes
enum { ACC = 0, EMIT = 1, NORM = 2 };

struct Extent {
  long long flat;   // the tile's first element in the flat buffers
  long long start;  // ... in its leaf
  int valid;        // elements of the leaf in the tile
  int extent;       // elements of the flat buffers in the tile (leaf and padding)
  const float* g;   // the leaf's gradient at the tile, or null
};

__device__ __forceinline__ Extent tile_extent(const int2* tiles, int t, const long long* offsets,
                                              const long long* numels,
                                              const unsigned long long* grads) {
  const int2 tl = tiles[t];
  const long long n = numels[tl.x];
  Extent e;
  e.start = static_cast<long long>(tl.y) * TILE;
  e.flat = offsets[tl.x] + e.start;
  const long long padded = (n + ALIGN - 1) / ALIGN * ALIGN;
  e.extent = static_cast<int>(min(static_cast<long long>(TILE), padded - e.start));
  e.valid = static_cast<int>(max(0LL, min(static_cast<long long>(TILE), n - e.start)));
  e.g = grads ? reinterpret_cast<const float*>(grads[tl.x]) + e.start : nullptr;
  return e;
}

// 4 gradient values from element i of the tile, zeros past the leaf's end
__device__ __forceinline__ float4 load_grad(const float* g, int i, int valid, bool vec) {
  if (vec && i + 4 <= valid) return __ldcs(reinterpret_cast<const float4*>(g + i));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < valid) v.x = g[i];
  if (i + 1 < valid) v.y = g[i + 1];
  if (i + 2 < valid) v.z = g[i + 2];
  if (i + 3 < valid) v.w = g[i + 3];
  return v;
}

__device__ __forceinline__ double squares(float4 v) {
  const double x = v.x, y = v.y, z = v.z, w = v.w;
  return x * x + y * y + z * z + w * w;
}

__device__ __forceinline__ int nonfinite(float4 v) {
  return !isfinite(v.x) + !isfinite(v.y) + !isfinite(v.z) + !isfinite(v.w);
}

// a + (g - a) / d, each operation rounded
__device__ __forceinline__ float mean1(float a, float g, float d) {
  return __fadd_rn(__fdiv_rn(__fsub_rn(g, a), d), a);
}

// the three sums of a block in a fixed tree; thread 0 holds the result
__device__ __forceinline__ void block_sums(double (*s)[THREADS], double v0, double v1,
                                           double v2) {
  const int tid = threadIdx.x;
  s[0][tid] = v0;
  s[1][tid] = v1;
  s[2][tid] = v2;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) {
      s[0][tid] += s[0][tid + half];
      s[1][tid] += s[1][tid + half];
      s[2][tid] += s[2][tid + half];
    }
    __syncthreads();
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    accumulate_kernel(const int2* __restrict__ tiles, int ntiles,
                      const long long* __restrict__ offsets, const long long* __restrict__ numels,
                      const unsigned long long* __restrict__ grads, const float* __restrict__ a_in,
                      float* __restrict__ a_out, float d, double* partials, unsigned* counter,
                      float* __restrict__ out) {
  __shared__ double s[3][THREADS];
  __shared__ bool last;
  double sg = 0.0, sa = 0.0;
  int bad = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Extent e = tile_extent(tiles, t, offsets, numels, grads);
    const bool vec = (reinterpret_cast<uintptr_t>(e.g) & 15) == 0;
    for (int i = threadIdx.x * 4; i < e.extent; i += THREADS * 4) {
      const float4 g = load_grad(e.g, i, e.valid, vec);
      sg += squares(g);
      if (MODE == NORM) {
        bad += nonfinite(g);
      } else {
        const float4 a = __ldcs(reinterpret_cast<const float4*>(a_in + e.flat + i));
        const float4 m = make_float4(mean1(a.x, g.x, d), mean1(a.y, g.y, d),
                                     mean1(a.z, g.z, d), mean1(a.w, g.w, d));
        __stcs(reinterpret_cast<float4*>(a_out + e.flat + i), m);
        if (MODE == EMIT) {
          sa += squares(m);
          bad += nonfinite(m);
        }
      }
    }
  }
  block_sums(s, sg, sa, static_cast<double>(bad));
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x] = s[0][0];
    partials[3 * blockIdx.x + 1] = s[1][0];
    partials[3 * blockIdx.x + 2] = s[2][0];
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double v0 = 0.0, v1 = 0.0, v2 = 0.0;
  for (int b = threadIdx.x; b < gridDim.x; b += THREADS) {
    v0 += __ldcg(partials + 3 * b);
    v1 += __ldcg(partials + 3 * b + 1);
    v2 += __ldcg(partials + 3 * b + 2);
  }
  __syncthreads();
  block_sums(s, v0, v1, v2);
  if (threadIdx.x == 0) {
    const float gnorm = static_cast<float>(sqrt(s[0][0]));
    out[0] = gnorm;
    out[1] = MODE == EMIT ? static_cast<float>(sqrt(s[1][0])) : MODE == NORM ? gnorm : 0.f;
    out[2] = static_cast<float>(s[2][0]);
    *counter = 0u;
  }
}

struct Hyper {
  float norm, max_norm, b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr;
};

// optax's clip, adam|adamw, scale by -lr and apply_updates on one element,
// each operation rounded (ops/optim_passes.py::adam_update)
template <bool CLIP, bool DECAY>
__device__ __forceinline__ void adam1(float g, float& m, float& v, float& w, const Hyper& h) {
  if (CLIP) g = __fmul_rn(__fdiv_rn(g, h.norm), h.max_norm);
  m = __fadd_rn(__fmul_rn(g, h.omb1), __fmul_rn(m, h.b1));
  v = __fadd_rn(__fmul_rn(__fmul_rn(g, g), h.omb2), __fmul_rn(v, h.b2));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (DECAY) u = __fadd_rn(u, __fmul_rn(w, h.wd));
  w = __fadd_rn(w, __fmul_rn(u, h.neg_lr));
}

struct Update {
  const int2* tiles;
  int ntiles;
  const long long* offsets;
  const long long* numels;
  const unsigned long long* grads;  // the address table, or null: the gradient is a_in
  const float* a_in;
  const float *mu, *nu, *p;
  float *mu_out, *nu_out, *p_out;
  float* a_out;  // a_in * 0, or null
  Hyper h;
};

template <bool TABLE, bool CLIP, bool DECAY, bool RESET>
__global__ void __launch_bounds__(THREADS) update_kernel(const Update u) {
  for (int t = blockIdx.x; t < u.ntiles; t += gridDim.x) {
    const Extent e = tile_extent(u.tiles, t, u.offsets, u.numels, TABLE ? u.grads : nullptr);
    const bool vec = (reinterpret_cast<uintptr_t>(e.g) & 15) == 0;
    for (int i = threadIdx.x * 4; i < e.extent; i += THREADS * 4) {
      const long long f = e.flat + i;
      const float4 g = TABLE ? load_grad(e.g, i, e.valid, vec)
                             : __ldcs(reinterpret_cast<const float4*>(u.a_in + f));
      float4 m = __ldcs(reinterpret_cast<const float4*>(u.mu + f));
      float4 v = __ldcs(reinterpret_cast<const float4*>(u.nu + f));
      float4 w = __ldcs(reinterpret_cast<const float4*>(u.p + f));
      adam1<CLIP, DECAY>(g.x, m.x, v.x, w.x, u.h);
      adam1<CLIP, DECAY>(g.y, m.y, v.y, w.y, u.h);
      adam1<CLIP, DECAY>(g.z, m.z, v.z, w.z, u.h);
      adam1<CLIP, DECAY>(g.w, m.w, v.w, w.w, u.h);
      __stcs(reinterpret_cast<float4*>(u.mu_out + f), m);
      __stcs(reinterpret_cast<float4*>(u.nu_out + f), v);
      __stcs(reinterpret_cast<float4*>(u.p_out + f), w);
      if (RESET)
        __stcs(reinterpret_cast<float4*>(u.a_out + f),
               make_float4(__fmul_rn(g.x, 0.f), __fmul_rn(g.y, 0.f), __fmul_rn(g.z, 0.f),
                           __fmul_rn(g.w, 0.f)));
    }
  }
}

template <bool TABLE, bool RESET>
cudaError_t launch_update(const Update& u, bool clip, bool decay, cudaStream_t s) {
  if (clip && decay) update_kernel<TABLE, true, true, RESET><<<GRID, THREADS, 0, s>>>(u);
  else if (clip) update_kernel<TABLE, true, false, RESET><<<GRID, THREADS, 0, s>>>(u);
  else if (decay) update_kernel<TABLE, false, true, RESET><<<GRID, THREADS, 0, s>>>(u);
  else update_kernel<TABLE, false, false, RESET><<<GRID, THREADS, 0, s>>>(u);
  return cudaGetLastError();
}

}  // namespace

// Pass A.  grads: the leaves' addresses (int64, on the card); a_in/a_out:
// the old and the new flat mean (null in NORM mode); d = n + 1; partials:
// 3 * GRID doubles of scratch; counter: one unsigned, 0 between launches.
extern "C" int cosy_optim_accumulate(const void* tiles, int ntiles, const void* offsets,
                                     const void* numels, const void* grads, const void* a_in,
                                     void* a_out, float d, int mode, void* partials,
                                     void* counter, void* out, void* stream) {
  if (ntiles < 0 || mode < ACC || mode > NORM || (mode != NORM && (!a_in || !a_out)))
    return (int)cudaErrorInvalidValue;
  const int2* t = static_cast<const int2*>(tiles);
  const long long* o = static_cast<const long long*>(offsets);
  const long long* n = static_cast<const long long*>(numels);
  const unsigned long long* g = static_cast<const unsigned long long*>(grads);
  const float* a = static_cast<const float*>(a_in);
  float* am = static_cast<float*>(a_out);
  double* part = static_cast<double*>(partials);
  unsigned* c = static_cast<unsigned*>(counter);
  float* res = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == ACC)
    accumulate_kernel<ACC><<<GRID, THREADS, 0, s>>>(t, ntiles, o, n, g, a, am, d, part, c, res);
  else if (mode == EMIT)
    accumulate_kernel<EMIT><<<GRID, THREADS, 0, s>>>(t, ntiles, o, n, g, a, am, d, part, c, res);
  else
    accumulate_kernel<NORM><<<GRID, THREADS, 0, s>>>(t, ntiles, o, n, g, a, am, d, part, c, res);
  return (int)cudaGetLastError();
}

// Pass B.  The gradient from the address table grads (accum_grad 1) or
// from the flat mean a_in (grads null); a_out (the mean times 0) may be
// null.  clip: norm >= max_norm; decay: AdamW.
extern "C" int cosy_optim_update(const void* tiles, int ntiles, const void* offsets,
                                 const void* numels, const void* grads, const void* a_in,
                                 const void* mu, const void* nu, const void* p, void* mu_out,
                                 void* nu_out, void* p_out, void* a_out, int clip, int decay,
                                 float norm, float max_norm, float b1, float omb1, float b2,
                                 float omb2, float bc1, float bc2, float eps, float wd,
                                 float neg_lr, void* stream) {
  if (ntiles < 0 || (!grads && !a_in) || (grads && a_out)) return (int)cudaErrorInvalidValue;
  const Update u{static_cast<const int2*>(tiles), ntiles, static_cast<const long long*>(offsets),
                 static_cast<const long long*>(numels),
                 static_cast<const unsigned long long*>(grads), static_cast<const float*>(a_in),
                 static_cast<const float*>(mu), static_cast<const float*>(nu),
                 static_cast<const float*>(p), static_cast<float*>(mu_out),
                 static_cast<float*>(nu_out), static_cast<float*>(p_out),
                 static_cast<float*>(a_out),
                 Hyper{norm, max_norm, b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a table only with accum_grad 1, where there is no mean to reset
  if (grads) return (int)launch_update<true, false>(u, clip, decay, s);
  if (a_out) return (int)launch_update<false, true>(u, clip, decay, s);
  return (int)launch_update<false, false>(u, clip, decay, s);
}
