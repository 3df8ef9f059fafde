// K8 on Hopper: the optimizer's AdamW step, fused into two passes.
//
// Replaces no TPU kernel: on the TPU, XLA fused the reference's
// apply_updates (src/repro/optim/adamw.py) by itself.  The port ran it
// eagerly, as kernels/ref.py's adamw_global_norm_ref and adamw_update_ref
// still do on the CPU: about 20 float32 elementwise passes over every
// slice of 2^24 elements, some 170 bytes of device-memory traffic and
// about 21 launches a slice.
//
// Function.  Pass 1, the global norm (norm_kernel): every gradient
// element squared and summed in float32, one partial a block written to a
// scratch buffer the wrapper allocates; finalize_kernel then sums the
// partials in a fixed order (in double, no atomics, so a run repeats bit
// for bit) and writes, as device float32 scalars,
//   gnorm = sqrt(float(sum))
//   scale = min(1, (1 / (gnorm + 1e-9)) * grad_clip)
// (``grad_clip / t`` is ``reciprocal(t) * grad_clip`` in PyTorch; a NaN
// norm gives a NaN scale, as torch.clamp does).  Nothing goes to the
// host.  Pass 2, the update (update_kernel), element by element in
// float32, the plain version's operations in its order, each rounded as
// PyTorch's CPU kernels round them (add_ with alpha and addcmul_ end in
// one fused multiply-add):
//   gf = g * scale
//   m  = fma(gf, 1 - b1, m * b1)
//   v  = fma((1 - b2) * gf, gf, v * b2)
//   u  = (m / bc1) / (sqrt(v / bc2) + eps)
//   u  = fma(p, wd, u)                    only where the leaf decays
//   p  = P(p - lr * u)                    one rounding to p's type
// stored in place.  Each step is a __f*_rn intrinsic, which nvcc never
// contracts.
//
// Bound.  A few flops against 24 bytes a parameter of bf16 params and
// grads: the norm reads the gradient once (2 B), the update reads p, g, m
// and v (2 + 2 + 4 + 4 B) and writes p, m and v (2 + 4 + 4 B).  Far below
// the ridge, so device-memory bytes bound it: 75.9 GB, about 22.7 ms at
// 3.35 TB/s, for Mixtral-8x7B's 3.16e9 parameters.  What the design does
// about it: no float32 temporary ever reaches device memory, every byte
// is read or written once a pass with 16-byte streaming loads and stores
// (__ldcs / __stcs), and the moments stay in registers between their
// load and store.  The launches are few: the leaves of one (param, grad)
// type pair go kMaxLeaves at a time in a table passed by value as a
// __grid_constant__ parameter (segments.cuh's idiom), one block a tile on
// a grid sized to the work, so a step of 13 leaves takes 1 norm launch,
// 1 finalize and 1 update launch.  A leaf whose four pointers are not all
// 16-byte aligned (a view at an odd offset, as a bucket may hand in)
// takes a scalar loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kThreads = 256;
constexpr int kFinalThreads = 1024;
constexpr int64_t kMaxGrid = int64_t(1) << 30;
// norm pass: 16-byte words of gradient a thread a tile (64 B in flight)
constexpr int kNormWords = 4;
// update pass: elements a unit, units a thread a tile
constexpr int kUnit = 8;
constexpr int kUnroll = 2;

struct Leaf {
  void* p;           // the param (update pass only)
  const void* g;     // the gradient
  float* m;          // the float32 moments (update pass only)
  float* v;
  int64_t n;         // elements, >= 1
  float wd;          // weight decay, 0 where the leaf does not decay
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int64_t first_tile[kMaxLeaves + 1];
  int count;
  uint32_t vector_mask;   // bit s: leaf s takes the 16-byte vector path
};

struct Hyper {
  float lr, b1, omb1, b2, omb2, bc1, bc2, eps;   // omb = 1 - b
};

// Eight elements of T as the 16-byte words that hold them, to float and
// back; one element alone.
template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static constexpr int kWords = 2;
  static __device__ __forceinline__ void get(const uint4* w, float* f) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      f[4 * k] = __uint_as_float(w[k].x);
      f[4 * k + 1] = __uint_as_float(w[k].y);
      f[4 * k + 2] = __uint_as_float(w[k].z);
      f[4 * k + 3] = __uint_as_float(w[k].w);
    }
  }
  static __device__ __forceinline__ void put(const float* f, uint4* w) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      w[k] = make_uint4(__float_as_uint(f[4 * k]),
                        __float_as_uint(f[4 * k + 1]),
                        __float_as_uint(f[4 * k + 2]),
                        __float_as_uint(f[4 * k + 3]));
  }
  static __device__ __forceinline__ float one(const void* x, int64_t i) {
    return static_cast<const float*>(x)[i];
  }
  static __device__ __forceinline__ void set(void* x, int64_t i, float f) {
    static_cast<float*>(x)[i] = f;
  }
};
template <> struct Cvt<__nv_bfloat16> {
  static constexpr int kWords = 1;
  static __device__ __forceinline__ void pair(uint32_t u, float* f) {
    f[0] = __uint_as_float(u << 16);
    f[1] = __uint_as_float(u & 0xFFFF0000u);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162_raw r = __float22bfloat162_rn(make_float2(a, b));
    return uint32_t(r.x) | (uint32_t(r.y) << 16);
  }
  static __device__ __forceinline__ void get(const uint4* w, float* f) {
    pair(w->x, f);
    pair(w->y, f + 2);
    pair(w->z, f + 4);
    pair(w->w, f + 6);
  }
  static __device__ __forceinline__ void put(const float* f, uint4* w) {
    *w = make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                    pack(f[6], f[7]));
  }
  static __device__ __forceinline__ float one(const void* x, int64_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  }
  static __device__ __forceinline__ void set(void* x, int64_t i, float f) {
    static_cast<__nv_bfloat16*>(x)[i] = __float2bfloat16_rn(f);
  }
};

// The leaf that tile ``tile`` of the table belongs to.
__device__ __forceinline__ int leaf_of(const Table& t, int64_t tile) {
  int s = 0;
  while (s + 1 < t.count && t.first_tile[s + 1] <= tile) ++s;
  return s;
}

// The sum of x over the block, in a fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();   // the previous tile's thread 0 has read warp_sums
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int k = 0; k < kThreads / 32; ++k) s = __fadd_rn(s, warp_sums[k]);
  return s;
}

// Pass 1: partials[tile] = the float32 sum of squares of the tile's
// gradient elements.
template <typename G>
__global__ void __launch_bounds__(kThreads)
norm_kernel(const __grid_constant__ Table t, float* partials) {
  constexpr int kVec = 16 / int(sizeof(G));
  constexpr int64_t kTile = int64_t(kThreads) * kNormWords * kVec;
  const int64_t n_tiles = t.first_tile[t.count];
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int s = leaf_of(t, tile);
    const Leaf& L = t.leaf[s];
    const int64_t e0 = (tile - t.first_tile[s]) * kTile;
    float acc = 0.0f;
    if ((t.vector_mask >> s) & 1u) {
      const int64_t n_words = L.n / kVec;
      const int64_t w0 = e0 / kVec + threadIdx.x;
      uint4 w[kNormWords];
#pragma unroll
      for (int k = 0; k < kNormWords; ++k) {
        const int64_t i = w0 + int64_t(k) * kThreads;
        w[k] = i < n_words ? __ldcs(static_cast<const uint4*>(L.g) + i)
                           : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kNormWords; ++k) {
        float f[kVec];
        if constexpr (kVec == 8) {
          Cvt<G>::get(&w[k], f);
        } else {
          f[0] = __uint_as_float(w[k].x);
          f[1] = __uint_as_float(w[k].y);
          f[2] = __uint_as_float(w[k].z);
          f[3] = __uint_as_float(w[k].w);
        }
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc = __fmaf_rn(f[j], f[j], acc);
      }
      // the n % kVec elements past the last whole word, in the last tile
      if (e0 + kTile >= L.n) {
        const int64_t i = n_words * kVec + threadIdx.x;
        if (i < L.n) {
          const float x = Cvt<G>::one(L.g, i);
          acc = __fmaf_rn(x, x, acc);
        }
      }
    } else {
      const int64_t end = e0 + kTile < L.n ? e0 + kTile : L.n;
      for (int64_t i = e0 + threadIdx.x; i < end; i += kThreads) {
        const float x = Cvt<G>::one(L.g, i);
        acc = __fmaf_rn(x, x, acc);
      }
    }
    acc = block_sum(acc);
    if (threadIdx.x == 0) partials[tile] = acc;
  }
}

// The sum of the n partials, in double in a fixed order, to gnorm and
// scale (out[0], out[1]).
__global__ void __launch_bounds__(kFinalThreads)
finalize_kernel(const float* partials, int64_t n, float grad_clip,
                float* out) {
  __shared__ double sums[kFinalThreads];
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < n; i += kFinalThreads)
    s += double(partials[i]);
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int w = kFinalThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sums[threadIdx.x] += sums[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float gnorm = __fsqrt_rn(float(sums[0]));
    float scale = __fmul_rn(__frcp_rn(__fadd_rn(gnorm, 1e-9f)), grad_clip);
    if (scale > 1.0f) scale = 1.0f;
    out[0] = gnorm;
    out[1] = scale;
  }
}

// One element's AdamW step (the header's formula).
__device__ __forceinline__ void adamw(float& p, float g, float& m,
                                      float& v, float scale, float wd,
                                      const Hyper& h) {
  const float gf = __fmul_rn(g, scale);
  m = __fmaf_rn(gf, h.omb1, __fmul_rn(m, h.b1));
  v = __fmaf_rn(__fmul_rn(h.omb2, gf), gf, __fmul_rn(v, h.b2));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (wd != 0.0f) u = __fmaf_rn(p, wd, u);
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

template <typename P, typename G>
struct Unit {
  uint4 p[Cvt<P>::kWords], g[Cvt<G>::kWords], m[2], v[2];
};

template <typename P, typename G>
__device__ __forceinline__ void scalar_step(const Leaf& L, int64_t i,
                                            float scale, const Hyper& h) {
  float p = Cvt<P>::one(L.p, i), m = L.m[i], v = L.v[i];
  adamw(p, Cvt<G>::one(L.g, i), m, v, scale, L.wd, h);
  Cvt<P>::set(L.p, i, p);
  L.m[i] = m;
  L.v[i] = v;
}

// Pass 2: the AdamW step of every element of the table's leaves, in
// place.
template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
update_kernel(const __grid_constant__ Table t, const float* scale_ptr,
              const Hyper h) {
  constexpr int64_t kTile = int64_t(kThreads) * kUnroll * kUnit;
  constexpr int kWP = Cvt<P>::kWords, kWG = Cvt<G>::kWords;
  const float scale = *scale_ptr;
  const int64_t n_tiles = t.first_tile[t.count];
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int s = leaf_of(t, tile);
    const Leaf& L = t.leaf[s];
    const int64_t e0 = (tile - t.first_tile[s]) * kTile;
    if ((t.vector_mask >> s) & 1u) {
      const int64_t n_units = L.n / kUnit;
      const int64_t u0 = e0 / kUnit + threadIdx.x;
      Unit<P, G> w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = u0 + int64_t(u) * kThreads;
        if (i >= n_units) continue;
#pragma unroll
        for (int k = 0; k < kWP; ++k)
          w[u].p[k] = __ldcs(static_cast<const uint4*>(L.p) + i * kWP + k);
#pragma unroll
        for (int k = 0; k < kWG; ++k)
          w[u].g[k] = __ldcs(static_cast<const uint4*>(L.g) + i * kWG + k);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          w[u].m[k] = __ldcs(reinterpret_cast<const uint4*>(L.m) + 2 * i + k);
          w[u].v[k] = __ldcs(reinterpret_cast<const uint4*>(L.v) + 2 * i + k);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = u0 + int64_t(u) * kThreads;
        if (i >= n_units) continue;
        float p[8], g[8], m[8], v[8];
        Cvt<P>::get(w[u].p, p);
        Cvt<G>::get(w[u].g, g);
        Cvt<float>::get(w[u].m, m);
        Cvt<float>::get(w[u].v, v);
#pragma unroll
        for (int j = 0; j < kUnit; ++j)
          adamw(p[j], g[j], m[j], v[j], scale, L.wd, h);
        Cvt<P>::put(p, w[u].p);
        Cvt<float>::put(m, w[u].m);
        Cvt<float>::put(v, w[u].v);
#pragma unroll
        for (int k = 0; k < kWP; ++k)
          __stcs(static_cast<uint4*>(L.p) + i * kWP + k, w[u].p[k]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          __stcs(reinterpret_cast<uint4*>(L.m) + 2 * i + k, w[u].m[k]);
          __stcs(reinterpret_cast<uint4*>(L.v) + 2 * i + k, w[u].v[k]);
        }
      }
      // the n % kUnit elements past the last whole unit, in the last tile
      if (e0 + kTile >= L.n) {
        const int64_t i = n_units * kUnit + threadIdx.x;
        if (i < L.n) scalar_step<P, G>(L, i, scale, h);
      }
    } else {
      const int64_t end = e0 + kTile < L.n ? e0 + kTile : L.n;
      for (int64_t i = e0 + threadIdx.x; i < end; i += kThreads)
        scalar_step<P, G>(L, i, scale, h);
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Elements a tile of the norm pass for a gradient of dtype code g_dtype.
int64_t norm_tile(int g_dtype) {
  return int64_t(kThreads) * kNormWords * (g_dtype == 0 ? 4 : 8);
}

// The table's tile prefixes (``tile`` elements a tile) and, with
// ``vector_mask``, its vector mask; the number of tiles, or -1 for a
// table the kernels do not take.
int64_t plan(Table& t, int64_t tile) {
  if (t.count < 1 || t.count > kMaxLeaves) return -1;
  t.vector_mask = 0;
  t.first_tile[0] = 0;
  for (int s = 0; s < t.count; ++s) {
    const Leaf& L = t.leaf[s];
    if (L.n < 1) return -1;
    if (aligned16(L.p) && aligned16(L.g) && aligned16(L.m) &&
        aligned16(L.v))
      t.vector_mask |= 1u << s;
    t.first_tile[s + 1] = t.first_tile[s] + (L.n + tile - 1) / tile;
  }
  return t.first_tile[t.count];
}

int grid_of(int64_t tiles) {
  return int(tiles < kMaxGrid ? tiles : kMaxGrid);
}

template <typename P, typename G>
void launch_update(const Table& t, int grid, const float* scale,
                   const Hyper& h, cudaStream_t s) {
  update_kernel<P, G><<<grid, kThreads, 0, s>>>(t, scale, h);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  Every launching function
// returns a cudaError_t (0 on success); cudaErrorInvalidValue for a dtype,
// length, table size or scratch size the kernels do not take.

// Elements a tile of the norm pass: k8_norm writes one partial a tile.
int64_t k8_norm_tile(int g_dtype) { return norm_tile(g_dtype); }

// Pass 1 over ``count`` (1-16) gradients of dtype g_dtype, ``table``
// holding a row of int64 (g, n >= 1) for each: one float32 partial a tile
// into partials[0 .. tiles), tiles = the sum of ceil(n / k8_norm_tile) over
// the rows, which must not exceed ``capacity``.
int k8_norm(const int64_t* table, int count, int g_dtype, float* partials,
            int64_t capacity, void* stream) {
  if (count < 1 || count > kMaxLeaves || (g_dtype != 0 && g_dtype != 1))
    return int(cudaErrorInvalidValue);
  Table t{};
  t.count = count;
  for (int s = 0; s < count; ++s) {
    t.leaf[s].g = reinterpret_cast<const void*>(table[2 * s]);
    t.leaf[s].n = table[2 * s + 1];
  }
  // p, m and v stay null, which counts as aligned: g's alignment alone
  // decides a leaf's path
  const int64_t tiles = plan(t, norm_tile(g_dtype));
  if (tiles < 0 || tiles > capacity) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0)
    norm_kernel<float><<<grid_of(tiles), kThreads, 0, s>>>(t, partials);
  else
    norm_kernel<__nv_bfloat16><<<grid_of(tiles), kThreads, 0, s>>>(
        t, partials);
  return int(cudaGetLastError());
}

// The n partials summed to out[0] = gnorm and out[1] = scale.
int k8_norm_finalize(const float* partials, int64_t n, float grad_clip,
                     float* out, void* stream) {
  if (n < 0) return int(cudaErrorInvalidValue);
  finalize_kernel<<<1, kFinalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n, grad_clip, out);
  return int(cudaGetLastError());
}

// Pass 2 over ``count`` (1-16) leaves of one (param, grad) dtype pair,
// ``table`` holding a row of int64 (p, g, m, v, n >= 1) for each and
// ``wd`` a float each; ``scale`` a device float32 scalar; ``hyper`` the
// host floats (lr, b1, 1 - b1, b2, 1 - b2, bc1, bc2, eps).  *n_vector
// (when not null) gets the number of leaves on the 16-byte vector path.
int k8_update(const int64_t* table, const float* wd, int count, int p_dtype,
              int g_dtype, const float* scale, const float* hyper,
              void* stream, int* n_vector) {
  if (count < 1 || count > kMaxLeaves) return int(cudaErrorInvalidValue);
  Table t{};
  t.count = count;
  for (int s = 0; s < count; ++s) {
    const int64_t* r = table + 5 * s;
    t.leaf[s] = Leaf{reinterpret_cast<void*>(r[0]),
                     reinterpret_cast<const void*>(r[1]),
                     reinterpret_cast<float*>(r[2]),
                     reinterpret_cast<float*>(r[3]), r[4], wd[s]};
  }
  const int64_t tiles = plan(t, int64_t(kThreads) * kUnroll * kUnit);
  if (tiles < 0) return int(cudaErrorInvalidValue);
  const Hyper h{hyper[0], hyper[1], hyper[2], hyper[3],
                hyper[4], hyper[5], hyper[6], hyper[7]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_of(tiles);
  switch (p_dtype * 2 + g_dtype) {
    case 0: launch_update<float, float>(t, grid, scale, h, s); break;
    case 1: launch_update<float, __nv_bfloat16>(t, grid, scale, h, s); break;
    case 2: launch_update<__nv_bfloat16, float>(t, grid, scale, h, s); break;
    case 3:
      launch_update<__nv_bfloat16, __nv_bfloat16>(t, grid, scale, h, s);
      break;
    default: return int(cudaErrorInvalidValue);
  }
  if (n_vector) *n_vector = __builtin_popcount(t.vector_mask);
  return int(cudaGetLastError());
}

const char* k8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
