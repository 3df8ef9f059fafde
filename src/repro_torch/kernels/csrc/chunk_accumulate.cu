// K1 on Hopper: the staged ring's per-step chunk accumulate.
//
// Replaces the TPU kernel src/repro/kernels/chunk_accumulate.py
// (chunk_accumulate_2d, body _accum_kernel).  Same function, elementwise:
//   out[i] = T(float(a[i]) + float(b[i]))
// with an fp32 accumulator and one round-to-nearest-even back to the
// payload type T (float32, bfloat16 or float16) per ring step.
//
// Layout.  a, b and out are flat contiguous arrays of n elements.  The TPU
// kernel needed [rows % 8 == 0, cols % 128 == 0] tiles (ops._pad_2d); here
// a grid-stride loop takes any n, so the wrapper hands over the flat chunk
// with no padding copy.
//
// Bound.  One add per element against 3 x sizeof(T) bytes moved (two reads
// and one write): far below the H100's ridge, so the kernel is bound by
// device-memory bytes.  What this version does about it: each thread moves
// 16 bytes per operand per iteration (uint4 loads and stores, 8 bf16/f16 or
// 4 f32 values), neighbouring threads on neighbouring 16-byte words, and
// the grid is sized to a few waves of the 132 SMs so the loop, not the
// launch, covers long chunks.  Pointers that are not 16-byte aligned (a
// sub-chunk sliced at an odd offset) take the scalar loop instead.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

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

template <typename T>
__device__ __forceinline__ T add_f32(T a, T b) {
  return from_f32<T>(to_f32(a) + to_f32(b));
}

// 16-byte vector path: every pointer 16-byte aligned.  Elements past the
// last whole vector are done by the scalar tail loop in the same kernel.
template <typename T>
__global__ void accum_vec16(const T* __restrict__ a, const T* __restrict__ b,
                            T* __restrict__ out, int64_t n) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t n_vec = n / kVec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  for (int64_t v = tid; v < n_vec; v += stride) {
    uint4 av = a4[v];
    uint4 bv = b4[v];
    uint4 ov;
    const T* ae = reinterpret_cast<const T*>(&av);
    const T* be = reinterpret_cast<const T*>(&bv);
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int k = 0; k < kVec; ++k) oe[k] = add_f32(ae[k], be[k]);
    o4[v] = ov;
  }
  for (int64_t i = n_vec * kVec + tid; i < n; i += stride)
    out[i] = add_f32(a[i], b[i]);
}

template <typename T>
__global__ void accum_scalar(const T* __restrict__ a,
                             const T* __restrict__ b, T* __restrict__ out,
                             int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = add_f32(a[i], b[i]);
}

template <typename T>
int launch(const void* a, const void* b, void* out, int64_t n,
           cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t per_thread = aligned ? 16 / (int64_t)sizeof(T) : 1;
  int64_t blocks = (n / per_thread + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* to = static_cast<T*>(out);
  if (aligned)
    accum_vec16<T><<<(int)blocks, kThreads, 0, stream>>>(ta, tb, to, n);
  else
    accum_scalar<T><<<(int)blocks, kThreads, 0, stream>>>(ta, tb, to, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  n >= 1 elements.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a dtype
// code or length the kernel does not take.
int ca_chunk_accumulate(const void* a, const void* b, void* out, int64_t n,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(a, b, out, n, s);
    case 1: return launch<__nv_bfloat16>(a, b, out, n, s);
    case 2: return launch<__half>(a, b, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
