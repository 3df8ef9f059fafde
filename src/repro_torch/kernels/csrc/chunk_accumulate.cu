// K1 on Hopper: the staged ring's per-step chunk accumulate.
//
// Replaces the TPU kernel src/repro/kernels/chunk_accumulate.py
// (chunk_accumulate_2d, body _accum_kernel).  Same function, elementwise:
//   out[i] = T(float(a[i]) + float(b[i]))
// with an fp32 accumulator and one round-to-nearest-even back to the
// payload type T (float32, bfloat16 or float16) per ring step.
//
// The same pass also takes a float32 ``a`` with a bfloat16 ``b`` (out
// float32): the decode of the bf16_pack wire codec, where the local fp32
// chunk meets the received bf16 one (src/repro/kernels/ops.py:139).
//
// Layout.  a, b and out are flat contiguous arrays.  The TPU kernel needed
// [rows % 8 == 0, cols % 128 == 0] tiles (ops._pad_2d); here any length
// goes, with no padding copy.
//
// Bound.  One add per element against 3 x sizeof(T) bytes moved (two reads
// and one write): far below the H100's ridge, so the kernel is bound by
// device-memory bytes, and at the ring's sub-chunk lengths (2^17-2^20
// elements) by its launch floor.  What the design does about it
// (segments.cuh): one launch takes every sub-chunk of a ring step, up to
// 8 (a, b, out) segments in a __grid_constant__ table; a unit is one
// 16-byte word of b and one (two for the float32 + bfloat16 call) of a
// and out; long tables keep 4 units (2 mixed) of loads in flight a thread
// with streaming hints, on a grid sized to the work.  Pairs of elements
// convert back with one cvt.rn.bf16x2 / f16x2 (the same rounding as
// __float2bfloat16_rn / __float2half_rn).  A segment whose pointers are
// not 16-byte aligned (a sub-chunk sliced at an odd offset) takes the
// scalar loop.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Element pair p (elements 2p and 2p + 1) of an array of 32-bit words
// holding T values as they lie in memory, as float2, and back.
template <typename T> struct Pairs;
template <> struct Pairs<float> {
  static __device__ __forceinline__ float2 get(const uint32_t* w, int p) {
    return make_float2(__uint_as_float(w[2 * p]),
                       __uint_as_float(w[2 * p + 1]));
  }
  static __device__ __forceinline__ void put(uint32_t* w, int p, float2 v) {
    w[2 * p] = __float_as_uint(v.x);
    w[2 * p + 1] = __float_as_uint(v.y);
  }
};
template <> struct Pairs<__nv_bfloat16> {
  static __device__ __forceinline__ float2 get(const uint32_t* w, int p) {
    return make_float2(__uint_as_float(w[p] << 16),
                       __uint_as_float(w[p] & 0xFFFF0000u));
  }
  static __device__ __forceinline__ void put(uint32_t* w, int p, float2 v) {
    const __nv_bfloat162_raw r = __float22bfloat162_rn(v);
    w[p] = uint32_t(r.x) | (uint32_t(r.y) << 16);
  }
};
template <> struct Pairs<__half> {
  static __device__ __forceinline__ float2 get(const uint32_t* w, int p) {
    __half2_raw r;
    r.x = uint16_t(w[p] & 0xFFFFu);
    r.y = uint16_t(w[p] >> 16);
    return __half22float2(__half2(r));
  }
  static __device__ __forceinline__ void put(uint32_t* w, int p, float2 v) {
    const __half2_raw r = __float22half2_rn(v);
    w[p] = uint32_t(r.x) | (uint32_t(r.y) << 16);
  }
};

__device__ __forceinline__ void unpack(const uint4& v, uint32_t* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// The segments.cuh Op of K1: in0 = a, in1 = b, out of a's type.  A unit is
// the elements of one 16-byte word of b (TB is never wider than TA).
template <typename TA, typename TB>
struct Accumulate {
  static constexpr int kVec = 16 / sizeof(TB);
  static constexpr int kWordsA = kVec * int(sizeof(TA)) / 16;   // 1 or 2
  static constexpr int kLongUnroll = 4 / kWordsA;
  struct Unit { uint4 a[kWordsA]; uint4 b; };

  static __device__ __forceinline__ void load(const seg::Segment& g,
                                              int64_t i, Unit& w) {
    const uint4* a = static_cast<const uint4*>(g.in0) + i * kWordsA;
#pragma unroll
    for (int k = 0; k < kWordsA; ++k) w.a[k] = __ldcs(a + k);
    w.b = __ldcs(static_cast<const uint4*>(g.in1) + i);
  }

  static __device__ __forceinline__ void store(const seg::Segment& g,
                                               int64_t i, const Unit& w) {
    uint32_t a[4 * kWordsA], b[4], o[4 * kWordsA];
#pragma unroll
    for (int k = 0; k < kWordsA; ++k) unpack(w.a[k], a + 4 * k);
    unpack(w.b, b);
#pragma unroll
    for (int p = 0; p < kVec / 2; ++p) {
      const float2 x = Pairs<TA>::get(a, p), y = Pairs<TB>::get(b, p);
      Pairs<TA>::put(o, p, make_float2(__fadd_rn(x.x, y.x),
                                       __fadd_rn(x.y, y.y)));
    }
    uint4* out = static_cast<uint4*>(g.out) + i * kWordsA;
#pragma unroll
    for (int k = 0; k < kWordsA; ++k)
      __stcs(out + k, make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2],
                                 o[4 * k + 3]));
  }

  static __device__ __forceinline__ void scalar(const seg::Segment& g,
                                                int64_t i) {
    const TA a = static_cast<const TA*>(g.in0)[i];
    const TB b = static_cast<const TB*>(g.in1)[i];
    static_cast<TA*>(g.out)[i] = from_f32<TA>(__fadd_rn(to_f32(a),
                                                        to_f32(b)));
  }
};

int launch(seg::Table t, int a_dtype, int b_dtype, cudaStream_t s,
           int* n_vector) {
  switch (a_dtype * 3 + b_dtype) {
    case 0: return seg::launch<Accumulate<float, float>>(t, s, n_vector);
    case 4:
      return seg::launch<Accumulate<__nv_bfloat16, __nv_bfloat16>>(
          t, s, n_vector);
    case 8: return seg::launch<Accumulate<__half, __half>>(t, s, n_vector);
    case 1:
      return seg::launch<Accumulate<float, __nv_bfloat16>>(t, s, n_vector);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  The operands
// share a dtype, or a is float32 and b bfloat16; out has a's dtype.  Every
// function returns a cudaError_t (0 on success); cudaErrorInvalidValue
// for a dtype pair, length or segment count the kernel does not take.

// One launch over ``count`` (1-8) segments, ``table`` holding a row of
// int64 (a, b, out, n >= 1) for each; *n_vector (when not null) gets the
// number of segments that took the 16-byte vector path.
int ca_chunk_accumulate_segments(const int64_t* table, int count,
                                 int a_dtype, int b_dtype, void* stream,
                                 int* n_vector) {
  if (count < 1 || count > seg::kMaxSegments)
    return int(cudaErrorInvalidValue);
  return launch(seg::table_from_rows(table, count, true), a_dtype, b_dtype,
                static_cast<cudaStream_t>(stream), n_vector);
}

// One (a, b, out) of n >= 1 elements: a table of one.
int ca_chunk_accumulate(const void* a, const void* b, void* out, int64_t n,
                        int a_dtype, int b_dtype, void* stream) {
  seg::Table t{};
  t.count = 1;
  t.seg[0] = {a, b, out, n};
  return launch(t, a_dtype, b_dtype, static_cast<cudaStream_t>(stream),
                nullptr);
}

const char* ca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
