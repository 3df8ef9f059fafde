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
// Layout.  a, b and out are flat contiguous arrays of n elements.  The TPU
// kernel needed [rows % 8 == 0, cols % 128 == 0] tiles (ops._pad_2d); here
// a grid-stride loop takes any n, so the wrapper hands over the flat chunk
// with no padding copy.
//
// Bound.  One add per element against 3 x sizeof(T) bytes moved (two reads
// and one write): far below the H100's ridge, so the kernel is bound by
// device-memory bytes.  What this version does about it: each thread moves
// 16 bytes of a and of out per iteration (uint4 loads and stores, 8
// bf16/f16 or 4 f32 values) and the matching 16 or 8 bytes of b,
// neighbouring threads on neighbouring words, and the grid is sized to a
// few waves of the 132 SMs so the loop, not the launch, covers long
// chunks.  Pointers not aligned to their words (a sub-chunk sliced at an
// odd offset) take the scalar loop instead.

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

// the accumulate in the first operand's type: TA(float(a) + float(b))
template <typename TA, typename TB>
__device__ __forceinline__ TA add_f32(TA a, TB b) {
  return from_f32<TA>(to_f32(a) + to_f32(b));
}

// a word of N bytes, loaded and stored as one vector access
template <int N> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };

// Vector path: 16 bytes of a and out per thread and step (kVec elements),
// and the kVec elements of b as one 16- or 8-byte word; every pointer
// aligned to its word.  Elements past the last whole vector are done by
// the scalar tail loop in the same kernel.
template <typename TA, typename TB>
__global__ void accum_vec(const TA* __restrict__ a, const TB* __restrict__ b,
                          TA* __restrict__ out, int64_t n) {
  constexpr int kVec = 16 / sizeof(TA);
  using WordA = typename Word<16>::type;
  using WordB = typename Word<int(kVec * sizeof(TB))>::type;
  const int64_t n_vec = n / kVec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const WordA* aw = reinterpret_cast<const WordA*>(a);
  const WordB* bw = reinterpret_cast<const WordB*>(b);
  WordA* ow = reinterpret_cast<WordA*>(out);
  for (int64_t v = tid; v < n_vec; v += stride) {
    WordA av = aw[v];
    WordB bv = bw[v];
    WordA ov;
    const TA* ae = reinterpret_cast<const TA*>(&av);
    const TB* be = reinterpret_cast<const TB*>(&bv);
    TA* oe = reinterpret_cast<TA*>(&ov);
#pragma unroll
    for (int k = 0; k < kVec; ++k) oe[k] = add_f32(ae[k], be[k]);
    ow[v] = ov;
  }
  for (int64_t i = n_vec * kVec + tid; i < n; i += stride)
    out[i] = add_f32(a[i], b[i]);
}

template <typename TA, typename TB>
__global__ void accum_scalar(const TA* __restrict__ a,
                             const TB* __restrict__ b, TA* __restrict__ out,
                             int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = add_f32(a[i], b[i]);
}

template <typename TA, typename TB>
int launch(const void* a, const void* b, void* out, int64_t n,
           cudaStream_t stream) {
  constexpr int64_t kVec = 16 / sizeof(TA);
  constexpr uintptr_t kBAlign = kVec * sizeof(TB) - 1;
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(b) & kBAlign) == 0;
  const int64_t per_thread = aligned ? kVec : 1;
  int64_t blocks = (n / per_thread + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const TA* ta = static_cast<const TA*>(a);
  const TB* tb = static_cast<const TB*>(b);
  TA* to = static_cast<TA*>(out);
  if (aligned)
    accum_vec<TA, TB><<<(int)blocks, kThreads, 0, stream>>>(ta, tb, to, n);
  else
    accum_scalar<TA, TB><<<(int)blocks, kThreads, 0, stream>>>(ta, tb, to,
                                                               n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  The operands
// share a dtype, or a is float32 and b bfloat16; out has a's dtype.  n >= 1
// elements.  Returns a cudaError_t (0 on success); cudaErrorInvalidValue
// for a dtype pair or length the kernel does not take.
int ca_chunk_accumulate(const void* a, const void* b, void* out, int64_t n,
                        int a_dtype, int b_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (a_dtype * 3 + b_dtype) {
    case 0: return launch<float, float>(a, b, out, n, s);
    case 4: return launch<__nv_bfloat16, __nv_bfloat16>(a, b, out, n, s);
    case 8: return launch<__half, __half>(a, b, out, n, s);
    case 1: return launch<float, __nv_bfloat16>(a, b, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
