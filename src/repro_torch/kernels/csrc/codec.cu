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
//   K5  out   = bf16(x)                      (a bit copy for bf16 input)
// The _rn intrinsics are explicit so no compiler flag changes a rounding.
//
// Bound.  Each is an elementwise pass of a few operations per element
// against 2-10 bytes moved, far below the H100's ridge: all four are
// bound by device-memory bytes.  What the design does about it: K2 gives
// one warp to each 128-element group, 4 elements a lane with one 16-byte
// (f32) or 8-byte (bf16) load when the input is aligned, the abs-max by
// warp shuffle, and one 4-byte store of the lane's fp8 values; K3, K4 and
// K5 take 4 consecutive elements a thread per grid-stride step, with
// vector loads and stores when every pointer is aligned, and a scalar
// loop otherwise (a sub-chunk sliced at an odd offset).  Grids are a few
// waves of the 132 SMs, so the loop, not the launch, covers long arrays.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr float kScaleTiny = 1e-30f;

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

struct Fmt {
  __nv_fp8_interpretation_t interp;
  float inv_max;      // fp32(1 / FP8_MAX)
  uint8_t nan_byte;
};

__device__ __forceinline__ Fmt fmt_of(int code) {
  if (code == 0) return {__NV_E4M3, 1.0f / 448.0f, 0x7F};
  return {__NV_E5M2, 1.0f / 57344.0f, 0x7E};
}

__device__ __forceinline__ uint8_t quantize(float q, const Fmt& f) {
  if (isnan(q)) return f.nan_byte;
  return (uint8_t)__nv_cvt_float_to_fp8(q, __NV_NOSAT, f.interp);
}

__device__ __forceinline__ float dequant(uint8_t v, const Fmt& f) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)v, f.interp);
  return __half2float(__half(h));       // exact: fp8 fits in half
}

// four consecutive elements as f32, from one vector load
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(e[k]);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 q;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = from_f32<__nv_bfloat16>(v[k]);
  *reinterpret_cast<uint2*>(p) = q;
}

int grid_for(int64_t work_items) {
  int64_t blocks = (work_items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// -- K2 -----------------------------------------------------------------------

template <typename T>
__global__ void fp8_encode_kernel(const T* __restrict__ x,
                                  uint8_t* __restrict__ vals,
                                  float* __restrict__ scales, int64_t n,
                                  int64_t n_groups, int fmt_code, bool vec) {
  const Fmt f = fmt_of(fmt_code);
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  // g is the same on every lane of a warp, so the shuffles below see
  // the whole warp
  for (int64_t g = warp; g < n_groups; g += n_warps) {
    const int64_t base = g * kGroup + lane * 4;
    const bool full = (g + 1) * kGroup <= n;
    float v[4];
    if (full && vec) {
      load4(x + base, v);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = base + k < n ? to_f32(x[base + k]) : 0.0f;   // zero padding
    }
    float m = nanmax(nanmax(fabsf(v[0]), fabsf(v[1])),
                     nanmax(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float scale = __fmul_rn(nanmax(m, kScaleTiny), f.inv_max);
    uint8_t q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = quantize(__fdiv_rn(v[k], scale), f);
    if (full) {
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
template <typename TO, bool ACCUM, bool VEC>
__global__ void fp8_decode_kernel(const uint8_t* __restrict__ vals,
                                  const float* __restrict__ scales,
                                  const TO* __restrict__ b,
                                  TO* __restrict__ out, int64_t n,
                                  int fmt_code) {
  const Fmt f = fmt_of(fmt_code);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = n / 4;
  for (int64_t i4 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i4 < n4;
       i4 += stride) {
    const int64_t i = i4 * 4;
    const float s = scales[i / kGroup];     // 4 | 128: one group per quad
    uint8_t q[4];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (VEC) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(vals + i);
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = (uint8_t)(w >> (8 * k));
      if (ACCUM) load4(b + i, acc);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        q[k] = vals[i + k];
        if (ACCUM) acc[k] = to_f32(b[i + k]);
      }
    }
    float r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r[k] = ACCUM ? __fmaf_rn(dequant(q[k], f), s, acc[k])
                   : __fmul_rn(dequant(q[k], f), s);
    if (VEC) {
      store4(out + i, r);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) out[i + k] = from_f32<TO>(r[k]);
    }
  }
  // tail of n % 4 elements
  for (int64_t i = n4 * 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float s = scales[i / kGroup];
    const float d = dequant(vals[i], f);
    out[i] = from_f32<TO>(ACCUM ? __fmaf_rn(d, s, to_f32(b[i]))
                                : __fmul_rn(d, s));
  }
}

// -- K5 -----------------------------------------------------------------------

template <bool VEC>
__global__ void bf16_pack_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = n / 4;
  for (int64_t i4 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i4 < n4;
       i4 += stride) {
    const int64_t i = i4 * 4;
    float v[4];
    if (VEC) {
      load4(x + i, v);
      store4(out + i, v);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) out[i + k] = from_f32<__nv_bfloat16>(x[i + k]);
    }
  }
  for (int64_t i = n4 * 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = from_f32<__nv_bfloat16>(x[i]);
}

// bfloat16 input: the pack is a copy of the 16-bit patterns
__global__ void bf16_copy_kernel(const uint16_t* __restrict__ x,
                                 uint16_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = x[i];
}

template <typename TO, bool ACCUM>
int launch_decode(const void* vals, const void* scales, const void* b,
                  void* out, int64_t n, int fmt, cudaStream_t s) {
  const bool vec = aligned(vals, 4) && aligned(out, 4 * sizeof(TO)) &&
                   (!ACCUM || aligned(b, 4 * sizeof(TO)));
  const int grid = grid_for(n / 4 > 0 ? n / 4 : 1);
  const uint8_t* v = static_cast<const uint8_t*>(vals);
  const float* sc = static_cast<const float*>(scales);
  const TO* tb = static_cast<const TO*>(b);
  TO* to = static_cast<TO*>(out);
  if (vec)
    fp8_decode_kernel<TO, ACCUM, true><<<grid, kThreads, 0, s>>>(v, sc, tb,
                                                                  to, n, fmt);
  else
    fp8_decode_kernel<TO, ACCUM, false><<<grid, kThreads, 0, s>>>(v, sc, tb,
                                                                   to, n, fmt);
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
  const int64_t groups = (n + kGroup - 1) / kGroup;
  int64_t blocks = (groups + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  uint8_t* v = static_cast<uint8_t*>(vals);
  float* sc = static_cast<float*>(scales);
  switch (dtype) {
    case 0:
      fp8_encode_kernel<float><<<(int)blocks, kThreads, 0, s>>>(
          static_cast<const float*>(x), v, sc, n, groups, fmt,
          aligned(x, 16));
      break;
    case 1:
      fp8_encode_kernel<__nv_bfloat16><<<(int)blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), v, sc, n, groups, fmt,
          aligned(x, 8));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

// K5: x [n] (float32 or bfloat16) -> out [n] bfloat16
int codec_bf16_pack(const void* x, void* out, int64_t n, int dtype,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return (int)cudaErrorInvalidValue;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (dtype) {
    case 0: {
      const float* xf = static_cast<const float*>(x);
      const int grid = grid_for(n / 4 > 0 ? n / 4 : 1);
      if (aligned(x, 16) && aligned(out, 8))
        bf16_pack_kernel<true><<<grid, kThreads, 0, s>>>(xf, o, n);
      else
        bf16_pack_kernel<false><<<grid, kThreads, 0, s>>>(xf, o, n);
      break;
    }
    case 1:
      bf16_copy_kernel<<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* codec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
