// K2-K5 on Hopper: the wire codecs of the compressed secondary routes.
//
// Replaces the TPU kernels of src/repro/kernels/codec.py:
//   K2 fp8_encode_2d            (_fp8_encode_kernel)
//   K3 fp8_decode_accumulate_2d (_fp8_decode_accum_kernel)
//   K4 fp8_decode_2d            (_fp8_decode_kernel)
//   K5 bf16_pack_2d             (_pack_kernel)
//
// Wire form.  The TPU kernels take [rows, 128] tiles (ops._pad_2d) with
// one f32 scale per 128-lane row.  Here every array is flat: values [n]
// and scales [ceil(n / 128)], scale g covering elements 128g .. 128g+127
// (the last group covers the tail).  The reference pads with zeros, which
// change no group's abs-max, so both forms carry the same bytes.
//
// Arithmetic, fixed so the results are the reference's bit for bit:
//   K2  amax  = max |x| over the group, NaN propagating (fmaxf would drop
//               NaN; jnp.max keeps it)
//       scale = max(amax, 1e-30) * fp32(1 / FP8_MAX)   (XLA turns the
//               reference's division by a constant into this multiply)
//       v     = fp8(x / scale), a true division (__fdiv_rn), converted
//               with __NV_NOSAT as jnp converts: out of range gives NaN;
//               every NaN is written as one canonical byte (0x7F e4m3,
//               0x7E e5m2, the reference's positive NaN), since the sign
//               of an arithmetic NaN differs between CPU and card
//   K3  out   = cast_b(fma(v, scale, b)), one rounding (__fmaf_rn), as
//               XLA fuses the reference's v * scale + b
//   K4  out   = cast_out(v * scale)          (__fmul_rn)
//   K5  out   = bf16(x), round to nearest even   (a bit copy for bf16
//               input)
// The _rn intrinsics are explicit so no compiler flag changes a rounding.
//
// Bound.  Each is an elementwise pass of a few operations per element
// against 2-10 bytes moved, far below the H100's ridge: all four are
// bound by device-memory bytes.  What the design does about it:
// - K2 gives each 128-element group 16 lanes (bf16 input) or 32 (float32),
//   each lane one 16-byte load, and a warp issues the loads of kEncUnroll
//   such units (2 or 1 groups each) before it computes any: 32 bytes a
//   lane in flight (64 were slower).  The abs-max is an unsigned max of
//   the |x| bit patterns (4 or 5 shuffle steps inside the group's lanes),
//   x / scale stays a true division, and pairs convert with the hardware
//   cvt.rn.satfinite e4m3x2/e5m2x2.  satfinite gives __NV_NOSAT's bytes
//   here: a group's largest quotient fl(amax / scale) stays below the
//   format's overflow midpoint (464 e4m3, 61440 e5m2; checked
//   exhaustively on the CPU by tests/test_torch_codec_quotient.py), and a
//   NaN quotient needs a non-finite scale, so only such groups take the
//   canonical-NaN fix-up.  A group of zeros skips the division.  A lane
//   stores its fp8 bytes with one 8- or 4-byte store.
// - K3/K4 give each thread units of 8 (bf16 output) or 4 (float32) fp8
//   values, so that a unit's output is one 16-byte store, kDecUnroll units
//   a thread and a chunk of consecutive units a block, each warp
//   instruction on one contiguous span (16 fp8 values a thread, stored as
//   32 or 64 bytes with that stride between lanes, were slower than the
//   old kernel).  Pairs decode with the exact hardware
//   cvt.rn.f16x2.e4m3x2 / e5m2x2; K3 loads b as one 16-byte load a unit.
// - Operands that are not 16-byte aligned (a sub-chunk sliced at an odd
//   offset) take the scalar loops, as do K2's partial last group and the
//   n % 8 (or % 4) tail of K3/K4, inside the same launch.  K2-K4 launch
//   a block for each chunk of work (loops over chunks only past 2^20
//   blocks).
// - K5 runs on segments.cuh: one launch packs every sub-chunk of a ring
//   step (up to 8 segments in a __grid_constant__ table), on a grid sized
//   to the work.  A float32 unit is 8 values: two 16-byte streaming loads,
//   four cvt.rn.bf16x2.f32 pair conversions (F2FP), one 16-byte store;
//   long tables keep 2 units a thread in flight.  bfloat16 input is a copy
//   of 16-byte words.  Unaligned segments take the scalar loop.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.cuh"

namespace {

constexpr int kGroup = 128;
constexpr int kThreads = 256;
constexpr int64_t kChunkBlocks = 1 << 20;  // K2-K4: blocks before a loop
constexpr float kScaleTiny = 1e-30f;
constexpr int kEncUnroll = 2;   // K2: 16-byte loads a lane issues at once
constexpr int kDecUnroll = 4;   // K3/K4: 16-byte output units a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// max that keeps a NaN from either side
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// fmt codes: 0 = e4m3, 1 = e5m2
template <int FMT> struct Fmt;
template <> struct Fmt<0> {
  static constexpr __nv_fp8_interpretation_t kInterp = __NV_E4M3;
  static constexpr float kInvMax = 1.0f / 448.0f;     // fp32(1 / FP8_MAX)
  static constexpr uint8_t kNanByte = 0x7F;
};
template <> struct Fmt<1> {
  static constexpr __nv_fp8_interpretation_t kInterp = __NV_E5M2;
  static constexpr float kInvMax = 1.0f / 57344.0f;
  static constexpr uint8_t kNanByte = 0x7E;
};

template <int FMT>
__device__ __forceinline__ uint8_t quantize(float q) {
  if (isnan(q)) return Fmt<FMT>::kNanByte;
  return (uint8_t)__nv_cvt_float_to_fp8(q, __NV_NOSAT, Fmt<FMT>::kInterp);
}

// two quotients at once (a in the low byte), by cvt.rn.satfinite: the
// bytes of quantize() for every |q| below the overflow midpoint (header)
template <int FMT>
__device__ __forceinline__ uint32_t quantize2(float a, float b) {
  return __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE,
                                  Fmt<FMT>::kInterp);
}

template <int FMT>
__device__ __forceinline__ float dequant(uint8_t v) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)v,
                                         Fmt<FMT>::kInterp);
  return __half2float(__half(h));       // exact: fp8 fits in half
}

// the two fp8 values of a 16-bit word (the low byte first), exactly
template <int FMT>
__device__ __forceinline__ float2 dequant2(uint32_t pair) {
  __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(pair & 0xFFFFu), Fmt<FMT>::kInterp);
  return __half22float2(__half2(h));
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 32-bit word j of a 16-byte vector (j a compile-time index once unrolled)
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// 16 bytes of input as f32: 4 floats, or 8 bf16 (the low half of a word
// first, as they lie in memory)
__device__ __forceinline__ void unpack16(const uint4& w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x); v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z); v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(const uint4& w, float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(u[k] << 16);
    v[2 * k + 1] = __uint_as_float(u[k] & 0xFFFF0000u);
  }
}

// max |x| of 16 bytes of input, as f32 bits.  For floats of one sign the
// unsigned order of the bit patterns is the numeric order, with NaN above
// inf, so an unsigned max of the |x| patterns is the NaN-keeping abs-max.
__device__ __forceinline__ uint32_t absmax_bits(const uint4& w, float) {
  constexpr uint32_t kAbs = 0x7FFFFFFFu;
  return max(max(w.x & kAbs, w.y & kAbs), max(w.z & kAbs, w.w & kAbs));
}
__device__ __forceinline__ uint32_t absmax_bits(const uint4& w,
                                                __nv_bfloat16) {
  constexpr uint32_t kHi = 0x7FFF0000u, kLo = 0x7FFFu;
  const uint32_t hi = max(max(w.x & kHi, w.y & kHi), max(w.z & kHi, w.w & kHi));
  const uint32_t lo = max(max(w.x & kLo, w.y & kLo), max(w.z & kLo, w.w & kLo));
  return max(hi, lo << 16);
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// -- K2 -----------------------------------------------------------------------

// The first n_full groups (0 unless x is 16-byte aligned) by the vector
// path; the rest (the partial last group, or every group of an unaligned
// x) by the scalar path, one warp a group, 4 elements a lane.
template <typename T, int FMT>
__global__ void __launch_bounds__(kThreads)
fp8_encode_kernel(const T* __restrict__ x, uint8_t* __restrict__ vals,
                  float* __restrict__ scales, int64_t n, int64_t n_groups,
                  int64_t n_full) {
  constexpr int kPer = 16 / sizeof(T);       // elements a lane: 8 or 4
  constexpr int kLanes = kGroup / kPer;      // lanes a group: 16 or 32
  constexpr int kGpw = 32 / kLanes;          // groups a warp-wide unit
  constexpr int kStep = kGpw * kEncUnroll;   // groups a warp a pass
  constexpr float kInvMax = Fmt<FMT>::kInvMax;
  const int lane = threadIdx.x & 31;
  const int sub = lane / kLanes, l = lane % kLanes;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  // g0 is the same on every lane of a warp, so every lane reaches the
  // shuffles; a lane past n_full shuffles zeros and stores nothing
  for (int64_t g0 = warp * kStep; g0 < n_full; g0 += n_warps * kStep) {
    uint4 w[kEncUnroll];
#pragma unroll
    for (int u = 0; u < kEncUnroll; ++u) {
      const int64_t g = g0 + u * kGpw + sub;
      w[u] = g < n_full ? ld16(x + g * kGroup + l * kPer)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kEncUnroll; ++u) {
      const int64_t g = g0 + u * kGpw + sub;
      uint32_t m = absmax_bits(w[u], T());
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
      // max(amax, 1e-30) as bits: both are non-negative
      const float scale = __fmul_rn(
          __uint_as_float(max(m, __float_as_uint(kScaleTiny))), kInvMax);
      float v[kPer];
      unpack16(w[u], v);
      float q[kPer];
      // a group of zeros (and a lane past n_full) divides by the clamped
      // scale, which sends __fdiv_rn down its slow path; x / scale is x
      // there (signed zeros), so the division is skipped
      if (m == 0u) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) q[k] = v[k];
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) q[k] = __fdiv_rn(v[k], scale);
      }
      uint32_t out[kPer / 4];
#pragma unroll
      for (int k = 0; k < kPer; k += 4)
        out[k / 4] = quantize2<FMT>(q[k], q[k + 1]) |
                     (quantize2<FMT>(q[k + 2], q[k + 3]) << 16);
      if (!isfinite(scale)) {   // a NaN or inf in the group: NaN fix-up
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (isnan(q[k]))
            out[k / 4] = (out[k / 4] & ~(0xFFu << (8 * (k % 4)))) |
                         ((uint32_t)Fmt<FMT>::kNanByte << (8 * (k % 4)));
      }
      if (g < n_full) {
        uint8_t* dst = vals + g * kGroup + l * kPer;
        if constexpr (kPer == 8)
          *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
        else
          *reinterpret_cast<uint32_t*>(dst) = out[0];
        if (l == 0) scales[g] = scale;
      }
    }
  }
  for (int64_t g = n_full + warp; g < n_groups; g += n_warps) {
    const int64_t base = g * kGroup + lane * 4;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = base + k < n ? to_f32(x[base + k]) : 0.0f;   // zero padding
    float m = nanmax(nanmax(fabsf(v[0]), fabsf(v[1])),
                     nanmax(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float scale = __fmul_rn(nanmax(m, kScaleTiny), kInvMax);
    uint8_t q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = quantize<FMT>(__fdiv_rn(v[k], scale));
    if ((g + 1) * kGroup <= n) {   // vals is the wrapper's: 4-byte aligned
      *reinterpret_cast<uint32_t*>(vals + base) =
          (uint32_t)q[0] | ((uint32_t)q[1] << 8) | ((uint32_t)q[2] << 16) |
          ((uint32_t)q[3] << 24);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (base + k < n) vals[base + k] = q[k];
    }
    if (lane == 0) scales[g] = scale;
  }
}

// -- K3 and K4 ----------------------------------------------------------------

// K3 (ACCUM = true): out = cast(fma(v, s, b));  K4: out = cast(v * s)
template <typename TO, bool ACCUM, int FMT>
__device__ __forceinline__ float decode1(uint8_t q, float s, const TO* b,
                                         int64_t i) {
  const float d = dequant<FMT>(q);
  return ACCUM ? __fmaf_rn(d, s, to_f32(b[i])) : __fmul_rn(d, s);
}

// VEC: every pointer 16-byte aligned.  A unit is the kOut values whose
// output is one 16-byte store (8 bf16 or 4 float32), read by one 8- or
// 4-byte load of fp8 values (and one 16-byte load of b).  A block takes
// chunks of kDecUnroll * kThreads consecutive units, thread t units
// t + u * kThreads of its chunk, so that each load and store
// instruction of a warp covers one contiguous span and a block one
// contiguous chunk.  Then the tail, one element a thread.  Otherwise 4
// consecutive elements a thread by scalar loads, then the n % 4 tail.
template <typename TO, bool ACCUM, int FMT, bool VEC>
__global__ void __launch_bounds__(kThreads)
fp8_decode_kernel(const uint8_t* __restrict__ vals,
                  const float* __restrict__ scales, const TO* __restrict__ b,
                  TO* __restrict__ out, int64_t n) {
  constexpr int kOut = 16 / sizeof(TO);            // values a unit: 8 or 4
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if constexpr (VEC) {
    const int64_t n_units = n / kOut;
    constexpr int64_t kChunk = (int64_t)kDecUnroll * kThreads;
    for (int64_t c = blockIdx.x; c * kChunk < n_units; c += gridDim.x) {
      const int64_t i0 = c * kChunk + threadIdx.x;
      uint32_t w[kDecUnroll][kOut / 4];            // the unit's fp8 bytes
      float s[kDecUnroll];
      uint4 bw[ACCUM ? kDecUnroll : 1];
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        const int64_t i = i0 + u * kThreads;
        if (i < n_units) {
          if constexpr (kOut == 8) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(vals) + i);
            w[u][0] = v.x;
            w[u][1] = v.y;
          } else {
            w[u][0] = __ldg(reinterpret_cast<const unsigned int*>(vals) + i);
          }
          s[u] = __ldg(scales + i * kOut / kGroup);  // kOut | 128
          if constexpr (ACCUM) bw[u] = ld16(b + i * kOut);
        }
      }
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        const int64_t i = i0 + u * kThreads;
        if (i >= n_units) break;
        float r[kOut];
#pragma unroll
        for (int k = 0; k < kOut; k += 2) {
          const float2 d = dequant2<FMT>(w[u][k / 4] >> (8 * (k % 4)));
          if constexpr (ACCUM) {
            float b0, b1;
            if constexpr (kOut == 4) {
              b0 = __uint_as_float(word(bw[u], k));
              b1 = __uint_as_float(word(bw[u], k + 1));
            } else {
              const uint32_t h = word(bw[u], k / 2);
              b0 = __uint_as_float(h << 16);
              b1 = __uint_as_float(h & 0xFFFF0000u);
            }
            r[k] = __fmaf_rn(d.x, s[u], b0);
            r[k + 1] = __fmaf_rn(d.y, s[u], b1);
          } else {
            r[k] = __fmul_rn(d.x, s[u]);
            r[k + 1] = __fmul_rn(d.y, s[u]);
          }
        }
        uint4 o;
        if constexpr (kOut == 4) {
          o = make_uint4(__float_as_uint(r[0]), __float_as_uint(r[1]),
                         __float_as_uint(r[2]), __float_as_uint(r[3]));
        } else {
          uint32_t h[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(r[2 * k],
                                                           r[2 * k + 1]);
            h[k] = *reinterpret_cast<const uint32_t*>(&v);
          }
          o = make_uint4(h[0], h[1], h[2], h[3]);
        }
        *reinterpret_cast<uint4*>(out + i * kOut) = o;
      }
    }
    done = n_units * kOut;
  } else {
    const int64_t n4 = n / 4;
    for (int64_t i4 = tid; i4 < n4; i4 += stride) {
      const int64_t i = i4 * 4;
      const float s = scales[i / kGroup];     // 4 | 128: one group per quad
      float r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r[k] = decode1<TO, ACCUM, FMT>(vals[i + k], s, b, i + k);
#pragma unroll
      for (int k = 0; k < 4; ++k) out[i + k] = from_f32<TO>(r[k]);
    }
    done = n4 * 4;
  }
  // the tail
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = from_f32<TO>(decode1<TO, ACCUM, FMT>(vals[i], scales[i / kGroup],
                                                  b, i));
}

// -- K5 -----------------------------------------------------------------------

// The segments.cuh Op of K5 on float32 input: in0 = x, out bfloat16.  A
// unit is 8 values, converted in pairs with cvt.rn.bf16x2.f32 (the
// rounding of __float2bfloat16_rn).  bfloat16 input is copied bit for bit
// by segments.cuh's Copy<2>.
template <typename T> struct Bf16Pack;
template <> struct Bf16Pack<float> {
  static constexpr int kVec = 8;
  static constexpr int kLongUnroll = 2;
  struct Unit { uint4 lo, hi; };

  static __device__ __forceinline__ void load(const seg::Segment& g,
                                              int64_t i, Unit& w) {
    const uint4* x = static_cast<const uint4*>(g.in0) + 2 * i;
    w.lo = __ldcs(x);
    w.hi = __ldcs(x + 1);
  }

  // two floats' bits (lo first in memory) -> their bf16 pair's word
  static __device__ __forceinline__ uint32_t pack2(uint32_t lo, uint32_t hi) {
    const __nv_bfloat162_raw r = __float22bfloat162_rn(
        make_float2(__uint_as_float(lo), __uint_as_float(hi)));
    return uint32_t(r.x) | (uint32_t(r.y) << 16);
  }

  static __device__ __forceinline__ void store(const seg::Segment& g,
                                               int64_t i, const Unit& w) {
    __stcs(static_cast<uint4*>(g.out) + i,
           make_uint4(pack2(w.lo.x, w.lo.y), pack2(w.lo.z, w.lo.w),
                      pack2(w.hi.x, w.hi.y), pack2(w.hi.z, w.hi.w)));
  }

  static __device__ __forceinline__ void scalar(const seg::Segment& g,
                                                int64_t i) {
    static_cast<__nv_bfloat16*>(g.out)[i] =
        __float2bfloat16_rn(static_cast<const float*>(g.in0)[i]);
  }
};
int launch_pack(const seg::Table& t, int dtype, cudaStream_t s,
                int* n_vector) {
  switch (dtype) {
    case 0: return seg::launch<Bf16Pack<float>>(t, s, n_vector);
    case 1: return seg::launch<seg::Copy<2>>(t, s, n_vector);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TO, bool ACCUM, int FMT>
int launch_decode_fmt(const void* vals, const void* scales, const void* b,
                      void* out, int64_t n, cudaStream_t s) {
  const bool vec = aligned(vals, 16) && aligned(out, 16) &&
                   (!ACCUM || aligned(b, 16));
  const int64_t items = vec ? n / (16 / sizeof(TO) * kDecUnroll) : n / 4;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : blocks > kChunkBlocks ? kChunkBlocks : blocks;
  const int grid = (int)blocks;
  const uint8_t* v = static_cast<const uint8_t*>(vals);
  const float* sc = static_cast<const float*>(scales);
  const TO* tb = static_cast<const TO*>(b);
  TO* to = static_cast<TO*>(out);
  if (vec)
    fp8_decode_kernel<TO, ACCUM, FMT, true><<<grid, kThreads, 0, s>>>(
        v, sc, tb, to, n);
  else
    fp8_decode_kernel<TO, ACCUM, FMT, false><<<grid, kThreads, 0, s>>>(
        v, sc, tb, to, n);
  return (int)cudaGetLastError();
}

template <typename TO, bool ACCUM>
int launch_decode(const void* vals, const void* scales, const void* b,
                  void* out, int64_t n, int fmt, cudaStream_t s) {
  return fmt == 0
             ? launch_decode_fmt<TO, ACCUM, 0>(vals, scales, b, out, n, s)
             : launch_decode_fmt<TO, ACCUM, 1>(vals, scales, b, out, n, s);
}

template <typename T, int FMT>
int launch_encode(const void* x, void* vals, void* scales, int64_t n,
                  cudaStream_t s) {
  constexpr int kGroupsPerWarp = 32 / (kGroup * (int)sizeof(T) / 16);
  const int64_t groups = (n + kGroup - 1) / kGroup;
  const int64_t n_full = aligned(x, 16) ? n / kGroup : 0;
  // warps: the vector path's passes, or one a group on the scalar path
  int64_t warps = (n_full + kGroupsPerWarp * kEncUnroll - 1) /
                  (kGroupsPerWarp * kEncUnroll);
  if (groups - n_full > warps) warps = groups - n_full;
  int64_t blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > kChunkBlocks) blocks = kChunkBlocks;
  fp8_encode_kernel<T, FMT><<<(int)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(vals),
      static_cast<float*>(scales), n, groups, n_full);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  fmt codes: 0 = fp8_e4m3
// (float8_e4m3fn), 1 = fp8_e5m2.  n >= 1.  Every function returns a
// cudaError_t (0 on success); cudaErrorInvalidValue for a code or length
// it does not take.

// K2: x [n] -> vals [n] fp8 bytes, scales [ceil(n/128)] f32
int codec_fp8_encode(const void* x, void* vals, void* scales, int64_t n,
                     int dtype, int fmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || (fmt != 0 && fmt != 1)) return (int)cudaErrorInvalidValue;
  switch (dtype * 2 + fmt) {
    case 0: return launch_encode<float, 0>(x, vals, scales, n, s);
    case 1: return launch_encode<float, 1>(x, vals, scales, n, s);
    case 2: return launch_encode<__nv_bfloat16, 0>(x, vals, scales, n, s);
    case 3: return launch_encode<__nv_bfloat16, 1>(x, vals, scales, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4: (vals, scales) -> out [n] of dtype out_dtype
int codec_fp8_decode(const void* vals, const void* scales, void* out,
                     int64_t n, int out_dtype, int fmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || (fmt != 0 && fmt != 1)) return (int)cudaErrorInvalidValue;
  switch (out_dtype) {
    case 0: return launch_decode<float, false>(vals, scales, nullptr, out, n,
                                               fmt, s);
    case 1: return launch_decode<__nv_bfloat16, false>(vals, scales, nullptr,
                                                       out, n, fmt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3: (vals, scales, b) -> out [n] of b's dtype
int codec_fp8_decode_accumulate(const void* vals, const void* scales,
                                const void* b, void* out, int64_t n,
                                int dtype, int fmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || (fmt != 0 && fmt != 1)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_decode<float, true>(vals, scales, b, out, n, fmt,
                                              s);
    case 1: return launch_decode<__nv_bfloat16, true>(vals, scales, b, out,
                                                      n, fmt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5: x [n] (float32 or bfloat16) -> out [n] bfloat16: a table of one
int codec_bf16_pack(const void* x, void* out, int64_t n, int dtype,
                    void* stream) {
  seg::Table t{};
  t.count = 1;
  t.seg[0] = {x, nullptr, out, n};
  return launch_pack(t, dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// K5 over ``count`` (1-8) segments in one launch, ``table`` holding a row
// of int64 (x, out, n >= 1) for each; *n_vector (when not null) gets the
// number of segments that took the 16-byte vector path
int codec_bf16_pack_segments(const int64_t* table, int count, int dtype,
                             void* stream, int* n_vector) {
  if (count < 1 || count > seg::kMaxSegments)
    return (int)cudaErrorInvalidValue;
  return launch_pack(seg::table_from_rows(table, count, false), dtype,
                     static_cast<cudaStream_t>(stream), n_vector);
}

const char* codec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
