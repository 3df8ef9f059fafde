// K6 on Hopper: split-KV flash-decoding attention over a paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py
// (paged_flash_decode_pool, body _fd_kernel).  Same function: T packed
// single-token rows, each attending the positions < kv_valid[t] of its
// block table over one layer's pool, fp32 online softmax, GQA, optional
// sliding window (kv_valid - 1 - pos < window), exact zeros for rows with
// every position masked; pool rows past kv_valid contribute nothing.
//
// Layouts (all contiguous):
//   q        [T, Hq, HD]             T = float or bf16, HD in {64, 112, 128}
//   k/v pool [n_blocks, bs, Hkv, HD]
//   tables   [T, maxb] int32         logical block j of row t -> pool block
//   kv_valid [T] int32
//   out      [T, Hq, HD]
//   ws       float32 [T, Hq, n_split] x (m, l) and [T, Hq, n_split, HD]
//
// Bound.  Decode attention does 4 * group flops per K/V element pair it
// reads (4 bytes in bf16): 16 flops a byte at glm4-9b's group of 16, far
// below the H100's ~295 flops/byte ridge, so the bytes of K/V bound it.
// Reaching that bound still needs the tensor cores: 16 flops a byte at
// 3.35 TB/s is 54 TFLOP/s, most of the 67 TFLOP/s fp32 CUDA-core peak.
//
// Design.
// - Split-KV grid (T, Hkv, n_split).  The host picks n_split from the
//   shapes alone (flash_decode.py::split_plan; kv_valid is never read on
//   the host), so that T * Hkv * n_split CTAs fill the 132 SMs at long
//   context.  CTA (t, h, s) takes the logical blocks [s*bps, (s+1)*bps) of
//   row t, clipped to the positions that are neither past kv_valid nor
//   before the window; a CTA whose range is empty loads no K/V and writes
//   an empty partial (m = -inf, l = 0; its acc is never read).
// - Inside a CTA, 4 warps take 16-position tiles in turn, each warp with
//   its own two-stage cp.async pipeline (the next tile's K and V in flight
//   while this one computes) and no CTA-wide barrier until the end.  Two
//   stages leave room for three CTAs (12 warps) an SM at hd 128 in bf16.
//   A position's head row is gathered with 16-byte copies (its pool row
//   comes from the block table, read one tile ahead, and for the first
//   tiles before kv_valid has arrived); positions past the range are
//   zero-filled.  A tile's copies are numbered e = lane + 32 i and copy
//   chunk e % kChunks of row e / kChunks, so a row may span two lanes'
//   passes (hd 112: 14 chunks a bf16 row, 7 copies a lane).  Shared-memory
//   rows are padded by 16 bytes (a row stride of 9, 15 or 17 16-byte
//   units at hd 64, 112, 128 in bf16: odd, so ldmatrix's 8 rows fall in 8
//   distinct bank quads).
// - bf16: the group's query heads are one m16 tile of mma.sync.m16n8k16
//   (rows >= group are zero and never stored), held in registers for the
//   whole split.  S = Q K^T takes K in its pool layout as the B operand
//   (ldmatrix); O += P V takes V through ldmatrix.trans, with P taken from
//   the S accumulators in registers as two bf16 halves (hi + lo), so that
//   its rounding stays at fp32's level.  fp32 accumulation.
// - float32 (off the full-width serve; TF32 would miss the reference's
//   atol 3e-5) computes the same tiles on CUDA cores, with the same
//   register layout for the accumulator.
// - The online softmax (running max, denominator, rescale) lives in
//   registers with quad shuffles, in base 2 with log2(e) folded into the
//   scale, and keeps _fd_kernel's isfinite guards.  The warps' (m, l, acc)
//   merge through shared memory; with n_split == 1 that writes out, else
//   a float32 partial per split that fd_merge_kernel folds with the
//   log-sum-exp rule.  All-empty rows come out as 0 / max(l, 1e-30) = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;        // positions a warp takes a step
constexpr int kRows = 16;        // the m16 tile: query heads of one KV head
constexpr int kMaxSmem = 232448; // per-block opt-in limit on sm_90
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout of one CTA, in bytes.
template <typename T, int HD> struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kStages = 2;
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kChunks = kRowBytes / 16;       // 16-B copies a row
  static constexpr int kStride = kRowBytes + 16;       // padded row
  static constexpr int kTileBytes = kTile * kStride;   // K or V of a tile
  static constexpr int kWarpBytes = kStages * 2 * kTileBytes;
  static constexpr int kPipeBytes = kWarps * kWarpBytes;
  // the warps' merge area overlays the pipelines once they are drained
  static constexpr int kAccStride = HD + 4;            // floats
  static constexpr int kMergeBytes =
      kWarps * kRows * (kAccStride + 2) * (int)sizeof(float);
  static constexpr int kMainBytes =
      kPipeBytes > kMergeBytes ? kPipeBytes : kMergeBytes;
  // fp32 only: the group's q rows and each warp's P tile
  static constexpr int kQStride = HD + 4;              // floats
  static constexpr int kPStride = kTile + 1;           // floats
  static constexpr int kQBytes = kF32 ? kRows * kQStride * 4 : 0;
  static constexpr int kPBytes = kF32 ? kWarps * kRows * kPStride * 4 : 0;
  static constexpr int kBytes = kMainBytes + kQBytes + kPBytes;
  static constexpr int kCopies = kTile * kChunks / 32;  // 16-B copies a lane
  static_assert(kBytes <= kMaxSmem, "shared memory");
  static_assert(kTile * kChunks % 32 == 0, "a tile is whole passes");
  static_assert((kStride / 16) % 2 == 1, "ldmatrix rows on distinct quads");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid false the destination is zero-filled and
// the source is not read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

// c += a * b: m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The pool head row of position p0 + lane for lanes < kTile (0 from
// p_lim on): the block-table read a tile's copies wait on.
__device__ __forceinline__ int tile_row(const int* table, int p0, int p_lim,
                                        int bs, int hkv, int h, int lane) {
  const int p = p0 + lane;
  if (lane >= kTile || p >= p_lim) return 0;
  return (int)(((unsigned)table[p / bs] * bs + p % bs) * hkv + h);
}

// Issue the copies of the K and V rows of positions [p0, p0 + kTile) into
// one pipeline stage, from the rows tile_row gave each lane; positions >=
// p_end are zero-filled.  Copy e = lane + 32 i is chunk e % kChunks of
// row e / kChunks.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(uint32_t k_dst, uint32_t v_dst,
                                          const T* k_pool, const T* v_pool,
                                          int row, int p0, int p_end,
                                          int lane) {
  using S = Smem<T, HD>;
#pragma unroll
  for (int i = 0; i < S::kCopies; ++i) {
    const int e = lane + 32 * i;
    const int r = e / S::kChunks, chunk = e % S::kChunks;
    const bool valid = p0 + r < p_end;
    const int src_row = __shfl_sync(0xffffffffu, row, r);
    const size_t off = (valid ? (size_t)src_row * S::kRowBytes : 0) +
                       chunk * 16;
    const uint32_t dst = r * S::kStride + chunk * 16;
    cp_async16(k_dst + dst, reinterpret_cast<const char*>(k_pool) + off,
               valid);
    cp_async16(v_dst + dst, reinterpret_cast<const char*>(v_pool) + off,
               valid);
  }
}

// Per-warp running state in the m16n8 accumulator layout: lane holds rows
// g = lane/4 and g + 8, columns 8*n + 2*(lane%4) + {0, 1} of each n-tile.
template <int HD> struct State {
  float o[HD / 8][4];
  float m[2];   // running max (base 2) of rows g, g + 8
  float l[2];   // this lane's share of the running denominator
};

// The online-softmax update of one tile's scores s (already scaled, -inf
// where masked), as _fd_kernel does it; leaves p in s.
template <int HD>
__device__ __forceinline__ void softmax_update(State<HD>& st,
                                               float (&s)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                     fmaxf(s[1][2 * i], s[1][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_run = st.m[i];
    const float m_new = fmaxf(m_run, mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float alpha = isfinite(m_run) ? exp2f(m_run - m_safe) : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 2 * i; j < 2 * i + 2; ++j) {
        const float p = isfinite(s[n][j]) ? exp2f(s[n][j] - m_safe) : 0.f;
        s[n][j] = p;
        sum += p;
      }
    st.m[i] = m_new;
    st.l[i] = st.l[i] * alpha + sum;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      st.o[d][2 * i] *= alpha;
      st.o[d][2 * i + 1] *= alpha;
    }
  }
}

// scale, and mask the positions >= p_end of the tile starting at p0
__device__ __forceinline__ void mask_scores(float (&s)[2][4], int p0,
                                            int p_end, int lane,
                                            float scale_log2) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pos = p0 + n * 8 + 2 * (lane & 3) + (j & 1);
      s[n][j] = pos < p_end ? s[n][j] * scale_log2 : -INFINITY;
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fd_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                const T* __restrict__ v_pool, const int* __restrict__ tables,
                const int* __restrict__ kv_valid, T* __restrict__ out,
                float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                int hkv, int group, int bs, int maxb, int bps, int window,
                float scale_log2) {
  using S = Smem<T, HD>;
  constexpr bool kF32 = S::kF32;
  const int t = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int hq = hkv * group;
  const size_t head0 = (size_t)t * hq + (size_t)h * group;  // first q head

  // this split's positions: its blocks, before kv_valid, inside the window
  const int* table = tables + (size_t)t * maxb;
  const int kvv = kv_valid[t];
  const int p_lim = min((split + 1) * bps, maxb) * bs;
  int p_begin = split * bps * bs;
  // the table rows of this warp's first kStages tiles, read without waiting
  // for kv_valid: the tiles start at the split's first position unless a
  // window moves them (then they are read again below)
  int rows[S::kStages];
#pragma unroll
  for (int i = 0; i < S::kStages; ++i)
    rows[i] = tile_row(table, p_begin + (warp + i * kWarps) * kTile, p_lim, bs,
                       hkv, h, lane);
  const int p_end = min(p_lim, kvv);
  const bool moved = window >= 0 && kvv - window > p_begin;
  if (moved) p_begin = kvv - window;

  if (p_begin >= p_end) {   // nothing to read: an empty partial
    for (int e = tid; e < group * HD; e += kThreads) {
      if (n_split == 1) {
        out[head0 * HD + e] = from_float<T>(0.f);
      } else if (e % HD == 0) {
        const size_t r = (head0 + e / HD) * n_split + split;
        ws_ml[2 * r] = -INFINITY;
        ws_ml[2 * r + 1] = 0.f;
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const T* q_row = q + head0 * HD;

  // q: bf16 as mma A fragments in registers; fp32 rows in shared memory
  uint32_t qa[kF32 ? 1 : HD / 16][4];
  float* q_s = reinterpret_cast<float*>(smem + S::kMainBytes);
  float* p_s = reinterpret_cast<float*>(smem + S::kMainBytes + S::kQBytes) +
               warp * kRows * S::kPStride;
  if constexpr (kF32) {
    for (int e = tid; e < kRows * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      q_s[r * S::kQStride + d] = r < group ? (float)q_row[r * HD + d] : 0.f;
    }
    __syncthreads();
  } else {
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q_row);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int col = (kk * 16 + 2 * c) / 2;   // in bf16 pairs
      qa[kk][0] = g < group ? qw[g * (HD / 2) + col] : 0u;
      qa[kk][1] = g + 8 < group ? qw[(g + 8) * (HD / 2) + col] : 0u;
      qa[kk][2] = g < group ? qw[g * (HD / 2) + col + 4] : 0u;
      qa[kk][3] = g + 8 < group ? qw[(g + 8) * (HD / 2) + col + 4] : 0u;
    }
  }

  State<HD> st;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) st.o[d][j] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;

  // this warp's tiles: w, w + kWarps, ... of the split's range
  const int n_tiles = (p_end - p_begin + kTile - 1) / kTile;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps
                                      : 0;
  unsigned char* pipe = smem + warp * S::kWarpBytes;
  const uint32_t pipe_addr = smem_addr(pipe);
  auto k_stage = [&](int i) {
    return pipe_addr + (i % S::kStages) * 2 * S::kTileBytes;
  };
  auto tile_p0 = [&](int i) { return p_begin + (warp + i * kWarps) * kTile; };

  // later tiles' table rows are read one tile ahead of their copies
  if (moved) {
#pragma unroll
    for (int i = 0; i < S::kStages; ++i)
      rows[i] = tile_row(table, tile_p0(i), p_lim, bs, hkv, h, lane);
  }
#pragma unroll
  for (int i = 0; i < S::kStages - 1; ++i) {
    if (i < my_tiles)
      load_tile<T, HD>(k_stage(i), k_stage(i) + S::kTileBytes, k_pool, v_pool,
                       rows[i], tile_p0(i), p_end, lane);
    cp_async_commit();
  }
  int row_next = rows[S::kStages - 1];
  for (int i = 0; i < my_tiles; ++i) {
    __syncwarp();   // every lane is done with the stage refilled below
    const int nxt = i + S::kStages - 1;
    if (nxt < my_tiles)
      load_tile<T, HD>(k_stage(nxt), k_stage(nxt) + S::kTileBytes, k_pool,
                       v_pool, row_next, tile_p0(nxt), p_end, lane);
    cp_async_commit();
    if (nxt + 1 < my_tiles)   // in flight while this tile computes
      row_next = tile_row(table, tile_p0(nxt + 1), p_lim, bs, hkv, h, lane);
    cp_async_wait<S::kStages - 1>();
    __syncwarp();   // tile i's copies of every lane have landed
    const int p0 = tile_p0(i);
    const uint32_t k_addr = k_stage(i);
    const uint32_t v_addr = k_addr + S::kTileBytes;
    float s[2][4];

    if constexpr (kF32) {
      const unsigned char* k_s = pipe + (k_addr - pipe_addr);
      const unsigned char* v_s = k_s + S::kTileBytes;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4* qr = reinterpret_cast<const float4*>(
              q_s + (g + (j >> 1) * 8) * S::kQStride);
          const float4* kr = reinterpret_cast<const float4*>(
              k_s + (n * 8 + 2 * c + (j & 1)) * S::kStride);
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < HD / 4; ++d) {
            const float4 a = qr[d], b = kr[d];
            dot = fmaf(a.x, b.x, dot);
            dot = fmaf(a.y, b.y, dot);
            dot = fmaf(a.z, b.z, dot);
            dot = fmaf(a.w, b.w, dot);
          }
          s[n][j] = dot;
        }
      mask_scores(s, p0, p_end, lane, scale_log2);
      softmax_update<HD>(st, s);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p_s[(g + (j >> 1) * 8) * S::kPStride + n * 8 + 2 * c + (j & 1)] =
              s[n][j];
      __syncwarp();
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* pr = p_s + (g + (j >> 1) * 8) * S::kPStride;
          const float* vc = reinterpret_cast<const float*>(v_s) + d * 8 +
                            2 * c + (j & 1);
          float a = st.o[d][j];
#pragma unroll
          for (int k = 0; k < kTile; ++k)
            a = fmaf(pr[k], vc[k * (S::kStride / 4)], a);
          st.o[d][j] = a;
        }
    } else {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
      // S = Q K^T: matrix i = lane/8 of the x4 is (positions (i/2)*8..,
      // head dims kk*16 + (i%2)*8..): the B fragments of both n-tiles
      const uint32_t k_lane = k_addr +
                              ((lane >> 4) * 8 + (lane & 7)) * S::kStride +
                              ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(k_lane + kk * 32, b0, b1, b2, b3);
        mma_bf16(s[0], qa[kk], b0, b1);
        mma_bf16(s[1], qa[kk], b2, b3);
      }
      mask_scores(s, p0, p_end, lane, scale_log2);
      softmax_update<HD>(st, s);
      // P as the A operand: the S accumulators of n-tiles 0 and 1 are its
      // k halves.  P = hi + lo, both bf16, so that P keeps 16 bits of
      // mantissa in the product (P rounded to bf16 once left the bf16
      // output up to 1.6e-2 off the plain version, against atol 2e-2)
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pa[2 * n + i] = pack_bf16(s[n][2 * i], s[n][2 * i + 1]);
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&pa[2 * n + i]));
          pl[2 * n + i] = pack_bf16(s[n][2 * i] - hi.x,
                                    s[n][2 * i + 1] - hi.y);
        }
      // O += P V: matrix i of the x4.trans is (positions (i%2)*8..,
      // head dims (d + i/2)*8..)
      const uint32_t v_lane = v_addr +
                              (((lane >> 3) & 1) * 8 + (lane & 7)) *
                                  S::kStride +
                              (lane >> 4) * 16;
#pragma unroll
      for (int d = 0; d < HD / 8; d += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(v_lane + d * 16, b0, b1, b2, b3);
        mma_bf16(st.o[d], pa, b0, b1);
        mma_bf16(st.o[d], pl, b0, b1);
        mma_bf16(st.o[d + 1], pa, b2, b3);
        mma_bf16(st.o[d + 1], pl, b2, b3);
      }
    }
  }
  cp_async_wait<0>();   // only empty groups can be left; drain them anyway

  // the quad's shares of the denominator
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 1);
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 2);
  }

  // merge the warps' states through shared memory
  __syncthreads();   // every pipeline is drained: the merge area overlays it
  float* m_w = reinterpret_cast<float*>(smem);           // [kWarps][kRows]
  float* l_w = m_w + kWarps * kRows;                     // [kWarps][kRows]
  float* acc_w = l_w + kWarps * kRows;                   // [kWarps][kRows][.]
  if (c == 0) {
    m_w[warp * kRows + g] = st.m[0];
    m_w[warp * kRows + g + 8] = st.m[1];
    l_w[warp * kRows + g] = st.l[0];
    l_w[warp * kRows + g + 8] = st.l[1];
  }
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc_w[(warp * kRows + g + (j >> 1) * 8) * S::kAccStride + d * 8 +
            2 * c + (j & 1)] = st.o[d][j];
  __syncthreads();

  for (int e = tid; e < group * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_w[w * kRows + r]);
    const float m_safe = isfinite(m) ? m : 0.f;
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_w[w * kRows + r];
      const float f = isfinite(mw) ? exp2f(mw - m_safe) : 0.f;
      l += f * l_w[w * kRows + r];
      acc += f * acc_w[(w * kRows + r) * S::kAccStride + d];
    }
    if (n_split == 1) {
      out[head0 * HD + e] = from_float<T>(acc / fmaxf(l, 1e-30f));
    } else {
      const size_t row = (head0 + r) * n_split + split;
      ws_acc[row * HD + d] = acc;
      if (d == 0) {
        ws_ml[2 * row] = m;
        ws_ml[2 * row + 1] = l;
      }
    }
  }
}

// Fold the n_split partials of each (row, query head) with the log-sum-exp
// rule: one CTA of HD threads per (t, query head).
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
fd_merge_kernel(const float* __restrict__ ws_ml,
                const float* __restrict__ ws_acc, T* __restrict__ out,
                int n_split) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = ws_ml + row * n_split * 2;
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[2 * s]);
  const float m_safe = isfinite(m) ? m : 0.f;
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = ml[2 * s];
    if (isfinite(ms)) {   // an empty partial's acc is never written
      const float f = exp2f(ms - m_safe);
      l += f * ml[2 * s + 1];
      acc += f * ws_acc[(row * n_split + s) * HD + d];
    }
  }
  out[row * HD + d] = from_float<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* kv_valid, void* out, void* ws,
           int t_rows, int hkv, int group, int bs, int maxb, int n_split,
           int bps, int window, float scale, cudaStream_t stream) {
  using S = Smem<T, HD>;
  auto kernel = fd_split_kernel<T, HD>;
  if (S::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t rows = (size_t)t_rows * hkv * group;
  float* ws_ml = static_cast<float*>(ws);
  float* ws_acc = ws_ml + rows * n_split * 2;
  const dim3 grid(t_rows, hkv, n_split);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_valid), static_cast<T*>(out), ws_ml, ws_acc,
      hkv, group, bs, maxb, bps, window, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  fd_merge_kernel<T, HD><<<(unsigned)rows, HD, 0, stream>>>(
      ws_ml, ws_acc, static_cast<T*>(out), n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window < 0: no sliding window.  ws:
// t_rows * hkv * group * n_split * (hd + 2) floats when n_split > 1
// (unused otherwise); split s takes logical blocks [s*bps, (s+1)*bps).
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a shape
// or dtype this build does not take.
int fd_paged_flash_decode(const void* q, const void* k_pool,
                          const void* v_pool, const void* tables,
                          const void* kv_valid, void* out, void* ws,
                          int t_rows, int hkv, int group, int hd, int bs,
                          int maxb, int n_split, int bps, int window,
                          float scale, int dtype, void* stream) {
  if (t_rows <= 0 || hkv <= 0 || group <= 0 || group > kRows || bs <= 0 ||
      maxb <= 0 || n_split <= 0 || bps <= 0 || (n_split - 1) * bps >= maxb ||
      n_split * bps < maxb || hkv > 65535 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_CASE(TYPE, HDV)                                                  \
  return launch<TYPE, HDV>(q, k_pool, v_pool, tables, kv_valid, out, ws,   \
                           t_rows, hkv, group, bs, maxb, n_split, bps,      \
                           window, scale, st)
  if (dtype == 0 && hd == 64) FD_CASE(float, 64);
  if (dtype == 0 && hd == 112) FD_CASE(float, 112);
  if (dtype == 0 && hd == 128) FD_CASE(float, 128);
  if (dtype == 1 && hd == 64) FD_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 112) FD_CASE(__nv_bfloat16, 112);
  if (dtype == 1 && hd == 128) FD_CASE(__nv_bfloat16, 128);
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the split kernel for (dtype, hd), in bytes;
// -1 for a pair this build does not take.
int fd_smem_bytes(int dtype, int hd) {
  if (dtype == 0 && hd == 64) return Smem<float, 64>::kBytes;
  if (dtype == 0 && hd == 112) return Smem<float, 112>::kBytes;
  if (dtype == 0 && hd == 128) return Smem<float, 128>::kBytes;
  if (dtype == 1 && hd == 64) return Smem<__nv_bfloat16, 64>::kBytes;
  if (dtype == 1 && hd == 112) return Smem<__nv_bfloat16, 112>::kBytes;
  if (dtype == 1 && hd == 128) return Smem<__nv_bfloat16, 128>::kBytes;
  return -1;
}

const char* fd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
