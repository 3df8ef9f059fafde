// K6 on Hopper: flash-decoding attention over a paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py
// (paged_flash_decode_pool, body _fd_kernel).  Same function: T packed
// single-token rows, each attending the positions < kv_valid[t] of its
// block table over one layer's pool, fp32 online softmax, GQA, optional
// sliding window, exact zeros for rows with every position masked.
//
// Layouts (all contiguous):
//   q        [T, Hq, HD]             T = float or bf16
//   k/v pool [n_blocks, bs, Hkv, HD]
//   tables   [T, maxb] int32         logical block j of row t -> pool block
//   kv_valid [T] int32
//   out      [T, Hq, HD]
//
// Design.  One CTA per (row t, KV head h); it owns the group = Hq/Hkv
// query heads of h, so every K/V byte a row needs is read from device
// memory once and reused by the whole group.  The TPU grid walked the
// logical blocks as its innermost, sequential dimension with the block
// table scalar-prefetched; here the CTA loops over j < ceil(kv_valid/bs)
// itself, reads tables[t, j], and stops at the row's last valid block, so
// padding rows (kv_valid == 0) launch no loads and the running state is
// carried in shared memory instead of VMEM scratch.
//
// Bound.  Decode attention does 4*group*HD flops per K/V element pair it
// reads (about 32 flops per 4 bytes at glm4-9b shapes in bf16), far below
// the H100's ~295 flops/byte ridge, so the kernel is bound by the bytes
// of K/V it reads.  What this version does about it: each K/V byte is
// read once (by the one CTA of its (row, head)), with 16-byte vector
// loads from a coalesced row, and blocks that are wholly masked (past
// kv_valid, or before the sliding window) are never read.  What it does
// not do yet: overlap the next block's load with this block's math
// (cp.async/TMA double buffering) or split a long context over several
// CTAs (split-KV with an LSE merge) when T*Hkv CTAs cannot fill 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;   // per-block opt-in limit on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout, in floats.  q and K rows are padded by one float
// so that the threads of a warp, which read different rows at the same
// column in the score loop, hit different banks.
__host__ __device__ inline size_t smem_floats(int group, int hd, int bs) {
  return (size_t)group * (hd + 1)   // q, scaled
       + (size_t)group * hd         // accumulator
       + (size_t)bs * (hd + 1)      // K block
       + (size_t)bs * hd            // V block
       + (size_t)group * bs         // scores / probabilities
       + 3 * (size_t)group;         // running max, denominator, rescale
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_flash_decode_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const int* __restrict__ kv_valid,
                          T* __restrict__ out, int hkv, int group, int bs,
                          int maxb, int window, float scale) {
  constexpr int QS = HD + 1;             // padded row stride of q and K
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int VROW = HD / VEC;         // 16-byte loads per K/V row
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int hq = hkv * group;

  extern __shared__ float smem[];
  float* q_s = smem;                     // [group][QS]
  float* acc_s = q_s + group * QS;       // [group][HD]
  float* k_s = acc_s + group * HD;       // [bs][QS]
  float* v_s = k_s + bs * QS;            // [bs][HD]
  float* p_s = v_s + bs * HD;            // [group][bs]
  float* m_s = p_s + group * bs;         // [group]
  float* l_s = m_s + group;              // [group]
  float* a_s = l_s + group;              // [group]

  // q for the group's heads, scaled in fp32 as _fd_kernel does
  const T* q_row = q + ((size_t)t * hq + (size_t)h * group) * HD;
  for (int e = tid; e < group * HD; e += kThreads) {
    const int gi = e / HD, d = e % HD;
    q_s[gi * QS + d] = to_float(q_row[e]) * scale;
    acc_s[e] = 0.f;
  }
  for (int gi = tid; gi < group; gi += kThreads) {
    m_s[gi] = -INFINITY;
    l_s[gi] = 0.f;
  }

  const int kvv = kv_valid[t];
  int n_blk = kvv > 0 ? (kvv + bs - 1) / bs : 0;
  if (n_blk > maxb) n_blk = maxb;
  // positions before kvv - window are masked: skip their blocks whole
  // (an all-masked block leaves the running state unchanged)
  const int first = (window >= 0 && kvv - window > 0) ? (kvv - window) / bs
                                                      : 0;

  for (int j = first; j < n_blk; ++j) {
    const int phys = tables[(size_t)t * maxb + j];
    __syncthreads();   // the previous block's K/V/p are no longer read
    for (int e = tid; e < bs * VROW; e += kThreads) {
      const int i = e / VROW, c = (e % VROW) * VEC;
      const size_t off = (((size_t)phys * bs + i) * hkv + h) * HD + c;
      const uint4 kr = *reinterpret_cast<const uint4*>(k_pool + off);
      const uint4 vr = *reinterpret_cast<const uint4*>(v_pool + off);
      const T* kt = reinterpret_cast<const T*>(&kr);
      const T* vt = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        k_s[i * QS + c + u] = to_float(kt[u]);
        v_s[i * HD + c + u] = to_float(vt[u]);
      }
    }
    __syncthreads();

    // scores, with the k_pos < kv_valid and window masks of _fd_kernel
    for (int e = tid; e < group * bs; e += kThreads) {
      const int gi = e / bs, i = e % bs;
      const int k_pos = j * bs + i;
      const bool keep = k_pos < kvv &&
                        (window < 0 || (kvv - 1 - k_pos) < window);
      float s = -INFINITY;
      if (keep) {
        const float* qr = q_s + gi * QS;
        const float* kr = k_s + i * QS;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      p_s[e] = s;
    }
    __syncthreads();

    // online softmax update per query head
    for (int gi = tid; gi < group; gi += kThreads) {
      float* pr = p_s + gi * bs;
      const float m_run = m_s[gi];
      float m_new = m_run;
      for (int i = 0; i < bs; ++i) m_new = fmaxf(m_new, pr[i]);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int i = 0; i < bs; ++i) {
        const float p = isfinite(pr[i]) ? expf(pr[i] - m_safe) : 0.f;
        pr[i] = p;
        sum += p;
      }
      const float alpha = isfinite(m_run) ? expf(m_run - m_safe) : 0.f;
      m_s[gi] = m_new;
      l_s[gi] = l_s[gi] * alpha + sum;
      a_s[gi] = alpha;
    }
    __syncthreads();

    for (int e = tid; e < group * HD; e += kThreads) {
      const int gi = e / HD, d = e % HD;
      const float* pr = p_s + gi * bs;
      float a = acc_s[e] * a_s[gi];
      for (int i = 0; i < bs; ++i) a = fmaf(pr[i], v_s[i * HD + d], a);
      acc_s[e] = a;
    }
  }
  __syncthreads();

  T* o_row = out + ((size_t)t * hq + (size_t)h * group) * HD;
  for (int e = tid; e < group * HD; e += kThreads) {
    const float denom = fmaxf(l_s[e / HD], 1e-30f);
    o_row[e] = from_float<T>(acc_s[e] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* kv_valid, void* out, int t_rows,
           int hkv, int group, int bs, int maxb, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(group, HD, bs) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_flash_decode_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(t_rows, hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_valid), static_cast<T*>(out), hkv, group,
      bs, maxb, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window < 0: no sliding window.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a
// shape or dtype this build does not take.
int fd_paged_flash_decode(const void* q, const void* k_pool,
                          const void* v_pool, const void* tables,
                          const void* kv_valid, void* out, int t_rows,
                          int hkv, int group, int hd, int bs, int maxb,
                          int window, float scale, int dtype,
                          void* stream) {
  if (t_rows <= 0 || hkv <= 0 || group <= 0 || bs <= 0 || maxb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_CASE(TYPE, HDV)                                                  \
  return launch<TYPE, HDV>(q, k_pool, v_pool, tables, kv_valid, out,       \
                           t_rows, hkv, group, bs, maxb, window, scale, st)
  if (dtype == 0 && hd == 64) FD_CASE(float, 64);
  if (dtype == 0 && hd == 128) FD_CASE(float, 128);
  if (dtype == 1 && hd == 64) FD_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) FD_CASE(__nv_bfloat16, 128);
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

const char* fd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
