// K9 on Hopper: self-attention over one sequence on the tensor cores,
// forward and backward, for the train step and a prefill without a KV
// cache.
//
// Replaces no TPU kernel: the reference's models/layers.py
// chunked_attention is a lax.scan over 512-key chunks that XLA fused on
// the TPU.  The port's plain copy (kernels/ref.py chunked_attention)
// runs each chunk as float32 einsums on CUDA cores and about a dozen
// elementwise passes over a [B, H, S, 512] float32 score chunk, the
// masked half included.  K9 computes the same function (q_offset =
// k_offset = 0, no kv_valid, no with_stats) in three launches a layer
// and step: one forward, and a backward of one dQ launch and one dK/dV
// launch.
//
// Route: CUDA C++ with mma.sync m16n8k16 (bf16 operands, float32
// accumulators), operands staged in shared memory by cp.async and read
// into fragments by ldmatrix.  A wgmma / TMA warp-specialised design is
// later work.
//
// Bound.  A causal forward is S^2 H (d_qk + d_v) FLOPs, far above the
// card's ~295 FLOP/byte ridge at S = 4096, so the tensor cores bound it
// (989 TFLOP/s bf16 dense).  What the design does about it: the score
// tile never leaves registers; key (or query) tiles that the causal
// mask or the window wholly hide are never loaded, which halves the
// causal work; only the tiles that the diagonal, the window's edge or
// the ragged end cut pay for the mask.
//
// Precision is the plain version's float32 arithmetic on the operands
// as given.
//   * bf16 route: QK^T and dO V^T take the bf16 operands as they are (a
//     bf16 x bf16 product is exact in float32).  P and dS, float32 in the
//     plain version, enter their products (P V, P^T dO, dS K, dS^T Q) as
//     a pair hi = bf16(x), lo = bf16(x - hi) in two MMAs, keeping about
//     16 bits of each element.
//   * float32 route: every float32 operand (q, k, v, dO, P, dS) is three
//     bf16 planes x = hi + mid + lo (24 bits, float32's precision), and
//     each product sums the plane pairs (i, j) with i + j < 3: six MMAs
//     where the bf16 route takes one or two; the pairs left out are below
//     float32's rounding.  The planes of q, k, v and dO are split by
//     k9_split into scratch; P and dS are split in registers.
// The softmax statistics (running max, denominator, base-2 log-sum-exp)
// are float32 and the scale multiplies the float32 scores.  D = rowsum(
// dO * O) reads O as the forward computed it in float32 (before the bf16
// route rounds it).
//
// Design.  Blocks of 4 warps, each warp owning 16 rows of the block's
// tile (32 in the bf16 forward, so that each K and V fragment feeds two
// MMAs), so no two warps share an accumulator.  The forward (128 query
// rows) and the dQ launch (64) own query rows of one (batch, query head)
// and walk its key tiles; query head h reads KV head h / (Hq / Hkv)
// (GQA).  The dK/dV launch owns 64 keys of one (batch, KV head) and
// walks the query tiles of every query head of its group, so the
// backward uses no atomics and a step's bits repeat from run to run.  The backward recomputes P from
// the saved log-sum-exp.  Streamed tiles are double-buffered (the bf16
// route) so that the next tile's cp.async overlaps this tile's MMAs.
// Shared-memory rows are padded by 16 bytes, which keeps ldmatrix free
// of bank conflicts for every width.  Tile sizes follow the widths and
// the route, with no knob.  Strides are passed, so MLA's value (a split
// view of its kv projection) is read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // rows a block owns: 16 a warp

// One [B, S, H, D] operand: bf16 planes (1 for the bf16 route, 3 for the
// float32 route), the head dim contiguous.
struct Operand {
  const bf16* p;        // element (0, 0, 0, 0) of the first plane
  int64_t sb, ss, sh;   // strides of batch, position and head, elements
  int64_t plane;        // elements from one plane to the next
};

struct Args {
  Operand q, k, v, dout;
  bf16* o;         // [B, S, Hq, Dv] bf16 output (bf16 route), else null
  float* o32;      // [B, S, Hq, Dv] float32 output
  float* lse;      // [B, Hq, S] base-2 log-sum-exp of the scaled scores
  float* delta;    // [B, Hq, S] rowsum(dO * O)
  void* dq;        // [B, S, Hq, Dqk], [B, S, Hkv, Dqk], [B, S, Hkv, Dv]
  void* dk;        // contiguous, bf16 or float32 as the route
  void* dv;
  int b, s, hq, hkv, group;
  int causal, window;   // window 0: none
  float scale2;         // the softmax scale times log2(e)
  float scale;
};

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros when !full (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as NPL bf16 pairs whose sum is (x, y): hi, then the rest's hi...
template <int NPL>
__device__ __forceinline__ void split_pair(float x, float y,
                                           uint32_t (&out)[NPL][4], int r) {
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    out[i][r] = *reinterpret_cast<uint32_t*>(&h);
    if (i + 1 < NPL) {
      float2 f = __bfloat1622float2(h);
      x -= f.x;
      y -= f.y;
    }
  }
}

// ---------------------------------------------------------------------------
// shared-memory tiles and warp products
// ---------------------------------------------------------------------------

// A tile of ROWS rows of width D in NP planes, each row padded by 8 bf16.
template <int ROWS, int D, int NP>
struct Tile {
  static constexpr int kPitch = D + 8;
  static constexpr int kPlane = ROWS * kPitch;
  static constexpr int kElems = NP * kPlane;
};

// Rows [r0, r0 + ROWS) of one head (``head``: its row 0 in plane 0) into
// tile t, every plane; rows at or past s are zeros.
template <int ROWS, int D, int NP>
__device__ __forceinline__ void load_rows(bf16* t, const bf16* head,
                                          int64_t ss, int64_t plane, int r0,
                                          int s) {
  using T = Tile<ROWS, D, NP>;
  constexpr int kChunks = D / 8;
  constexpr int kTotal = NP * ROWS * kChunks;
#pragma unroll
  for (int j = 0; j < (kTotal + kThreads - 1) / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (kTotal % kThreads == 0 || i < kTotal) {
      const int p = i / (ROWS * kChunks);
      const int rem = i - p * (ROWS * kChunks);
      const int r = rem / kChunks;
      const int c = rem - r * kChunks;
      const int row = r0 + r;
      const bf16* src = head + p * plane +
                        int64_t(row < s ? row : s - 1) * ss + c * 8;
      cp_async16(t + p * T::kPlane + r * T::kPitch + c * 8, src, row < s);
    }
  }
}

// acc[m][n] (16 x 8 each) += A (16 MT x K) B (K x 8 N8), A row-major at
// ``a`` (the warp's first row, pitch PA, planes PLA apart), B stored
// transposed ([n][k], pitch PB, planes PLB apart): the plane pairs
// i + j < NPL, the smallest first, so that the tensor cores' float32
// sum, which drops the bits of an addend below the running sum's last,
// drops as little of them as it can.  Each B fragment feeds the warp's
// MT row blocks.
template <int MT, int N8, int K, int NP, int NPL, int PA, int PLA, int PB,
          int PLB>
__device__ __forceinline__ void gemm_nt(float (&acc)[MT][N8][4],
                                        const bf16* a, const bf16* b,
                                        int lane) {
  static_assert(N8 % 2 == 0 && K % 16 == 0, "whole MMA steps");
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[MT][NP][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NP; ++i)
        ldsm_x4(af[m][i], a + i * PLA + (16 * m + (lane & 15)) * PA +
                              kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < N8; n += 2) {
      uint32_t bfr[NP][4];
#pragma unroll
      for (int j = 0; j < NP; ++j)
        ldsm_x4(bfr[j], b + j * PLB +
                            (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * PB +
                            kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ij = NPL - 1; ij >= 0; --ij)     // the small pairs first
#pragma unroll
          for (int i = 0; i < NP; ++i)
            if (ij - i >= 0 && ij - i < NP) {
              mma(acc[m][n], af[m][i], bfr[ij - i][0], bfr[ij - i][1]);
              mma(acc[m][n + 1], af[m][i], bfr[ij - i][2], bfr[ij - i][3]);
            }
    }
  }
}

// acc[m][n] += P (16 MT x K) B (K x 8 N8): P the float32 fragments pc
// (its 16 x 8 blocks) split into NPL bf16 planes, B row-major ([k][n],
// pitch PB, NP planes PLB apart): the pairs i + j < NPL.
template <int MT, int N8, int K, int NP, int NPL, int PB, int PLB>
__device__ __forceinline__ void gemm_pn(float (&acc)[MT][N8][4],
                                        const float (&pc)[MT][K / 8][4],
                                        const bf16* b, int lane) {
  static_assert(N8 % 2 == 0 && K % 16 == 0, "whole MMA steps");
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[MT][NPL][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      split_pair<NPL>(pc[m][2 * kk][0], pc[m][2 * kk][1], af[m], 0);
      split_pair<NPL>(pc[m][2 * kk][2], pc[m][2 * kk][3], af[m], 1);
      split_pair<NPL>(pc[m][2 * kk + 1][0], pc[m][2 * kk + 1][1], af[m], 2);
      split_pair<NPL>(pc[m][2 * kk + 1][2], pc[m][2 * kk + 1][3], af[m], 3);
    }
#pragma unroll
    for (int n = 0; n < N8; n += 2) {
      uint32_t bfr[NP][4];
#pragma unroll
      for (int j = 0; j < NP; ++j)
        ldsm_x4_t(bfr[j], b + j * PLB + (kk * 16 + (lane & 15)) * PB +
                              n * 8 + (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ij = NPL - 1; ij >= 0; --ij)     // the small pairs first
#pragma unroll
          for (int i = 0; i < NPL; ++i)
            if (ij - i >= 0 && ij - i < NP) {
              mma(acc[m][n], af[m][i], bfr[ij - i][0], bfr[ij - i][1]);
              mma(acc[m][n + 1], af[m][i], bfr[ij - i][2], bfr[ij - i][3]);
            }
    }
  }
}

__device__ __forceinline__ bool keep(int qr, int kc, const Args& a) {
  return qr < a.s && kc < a.s && (!a.causal || qr >= kc) &&
         (a.window == 0 || qr - kc < a.window);
}

// Whether some pair of the query rows [m0, m0 + BM) and the keys
// [n0, n0 + BN) is masked.
__device__ __forceinline__ bool cut(int m0, int BM, int n0, int BN,
                                    const Args& a) {
  return m0 + BM > a.s || n0 + BN > a.s ||
         (a.causal && n0 + BN - 1 > m0) ||
         (a.window != 0 && m0 + BM - 1 - n0 >= a.window);
}

// The key range [lo, hi) the query rows [m0, m0 + BM) attend.
__device__ __forceinline__ void key_range(int m0, int BM, const Args& a,
                                          int* lo, int* hi) {
  *hi = a.causal ? min(a.s, m0 + BM) : a.s;
  *lo = a.window != 0 ? max(0, m0 - a.window + 1) : 0;
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y);

template <>
__device__ __forceinline__ void store_pair<float>(float* p, float x,
                                                  float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The warp's rows row0 + 16 m + g (+ 8) of its 16 MT x 8 N8 accumulator,
// times mul, to ``out`` (rows ``pitch`` apart), rows at or past s left.
template <int MT, int N8, typename T>
__device__ __forceinline__ void store_rows(T* out, int64_t pitch,
                                           const float (&acc)[MT][N8][4],
                                           int row0, int s, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * m + g + 8 * h;
      if (row < s) {
#pragma unroll
        for (int n = 0; n < N8; ++n)
          store_pair<T>(out + row * pitch + n * 8 + 2 * t,
                        acc[m][n][2 * h] * mul, acc[m][n][2 * h + 1] * mul);
      }
    }
}

template <int MT, int N8>
__device__ __forceinline__ void zero(float (&acc)[MT][N8][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
}

// acc += P B as gemm_pn.  With FRESH (the float32 route) each call's
// product is summed in a zeroed accumulator and added to acc by float32
// additions, which round: the tensor cores' own float32 sum drops the low
// bits of every addend far below the running sum, and a dK or dV row sums
// thousands of query tiles whose terms shrink along the causal diagonal.
template <bool FRESH, int MT, int N8, int K, int NP, int NPL, int PB,
          int PLB>
__device__ __forceinline__ void gemm_pn_into(float (&acc)[MT][N8][4],
                                             const float (&pc)[MT][K / 8][4],
                                             const bf16* b, int lane) {
  if constexpr (FRESH) {
    float part[MT][N8][4];
    zero(part);
    gemm_pn<MT, N8, K, NP, NPL, PB, PLB>(part, pc, b, lane);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
  } else {
    gemm_pn<MT, N8, K, NP, NPL, PB, PLB>(acc, pc, b, lane);
  }
}

// ---------------------------------------------------------------------------
// the three kernels
// ---------------------------------------------------------------------------

// Tile sizes and pipeline depth by widths and route, the fastest of a
// sweep on an H100 at the train cells' shapes that stays inside 255
// registers a thread (PERF.md, K9).  The float32 route holds three planes
// of every tile, so it takes narrower tiles and one buffer to stay inside
// the 227 KB of shared memory.
template <int DQK, int DV, bool F32>
struct Cfg {
  static constexpr int NP = F32 ? 3 : 1;       // planes of an operand
  static constexpr int NPL = F32 ? 3 : 2;      // planes of P and dS
  static constexpr int kStages = F32 ? 1 : 2;
  static constexpr int kFwdMT = F32 ? 1 : 2;     // 16-row blocks a warp
  static constexpr int kFwdM = 16 * kWarps * kFwdMT;   // query rows a block
  static constexpr int kFwdN = (F32 || DV > 64) ? 32 : 64;   // keys a step
  static constexpr int kDqN = (F32 || DQK > 128) ? 32 : 64;
  static constexpr int kDkvM = F32 ? 16 : 32;          // queries a step
  using Out = typename std::conditional<F32, float, bf16>::type;
};

// grid (B * Hq, query tiles, the longest causal tiles first)
template <int DQK, int DV, bool F32>
__global__ void __launch_bounds__(kThreads)
    forward_kernel(const Args a) {
  using C = Cfg<DQK, DV, F32>;
  constexpr int MT = C::kFwdMT, BM = C::kFwdM, BN = C::kFwdN;
  constexpr int NP = C::NP, NPL = C::NPL;
  using TQ = Tile<BM, DQK, NP>;
  using TK = Tile<BN, DQK, NP>;
  using TV = Tile<BN, DV, NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + TQ::kElems;                      // kStages tiles
  bf16* sv = sk + C::kStages * TK::kElems;

  const int bh = blockIdx.x, b = bh / a.hq, h = bh % a.hq;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / a.group;
  const bf16* qh = a.q.p + b * a.q.sb + h * a.q.sh;
  const bf16* kh = a.k.p + b * a.k.sb + hk * a.k.sh;
  const bf16* vh = a.v.p + b * a.v.sb + hk * a.v.sh;

  int lo, hi;
  key_range(m0, BM, a, &lo, &hi);
  const int n_first = lo / BN * BN;
  const int n_tiles = (hi - n_first + BN - 1) / BN;
  auto fetch = [&](int it, int buf) {
    const int n0 = n_first + it * BN;
    load_rows<BN, DQK, NP>(sk + buf * TK::kElems, kh, a.k.ss, a.k.plane, n0,
                           a.s);
    load_rows<BN, DV, NP>(sv + buf * TV::kElems, vh, a.v.ss, a.v.plane, n0,
                          a.s);
  };
  load_rows<BM, DQK, NP>(sq, qh, a.q.ss, a.q.plane, m0, a.s);
  cp_commit();
  fetch(0, 0);
  cp_commit();

  const int g = lane >> 2, t = lane & 3;
  const int w0 = m0 + 16 * MT * warp;      // the warp's first row
  float acc[MT][DV / 8][4];
  zero(acc);
  // this thread's rows: w0 + 16 m + g + 8 r, statistics [m][r]
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_run[m][r] = neg_inf();
      l_run[m][r] = 0.f;
    }

  for (int it = 0; it < n_tiles; ++it) {
    if (C::kStages == 2) {
      if (it + 1 < n_tiles) fetch(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = C::kStages == 2 ? (it & 1) : 0;
    const int n0 = n_first + it * BN;
    float sc[MT][BN / 8][4];
    zero(sc);
    gemm_nt<MT, BN / 8, DQK, NP, NPL, TQ::kPitch, TQ::kPlane, TK::kPitch,
            TK::kPlane>(sc, sq + 16 * MT * warp * TQ::kPitch,
                        sk + buf * TK::kElems, lane);
    const bool masked = cut(m0, BM, n0, BN, a);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float mx[2] = {m_run[m][0], m_run[m][1]};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[m][n][e] * a.scale2;
          if (masked && !keep(w0 + 16 * m + g + 8 * (e >> 1),
                              n0 + n * 8 + 2 * t + (e & 1), a))
            x = neg_inf();
          sc[m][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float safe[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
        // a row with every key so far masked keeps m = -inf: its p and
        // its rescale are 0, as the plain version's guards give
        safe[r] = mx[r] == neg_inf() ? 0.f : mx[r];
        alpha[r] = ex2(m_run[m][r] - safe[r]);
        m_run[m][r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[m][n][e] - safe[e >> 1]);
          sc[m][n][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l_run[m][r] = l_run[m][r] * alpha[r] + sum[r];
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] *= alpha[e >> 1];
    }
    gemm_pn_into<F32, MT, DV / 8, BN, NP, NPL, TV::kPitch, TV::kPlane>(
        acc, sc, sv + buf * TV::kElems, lane);
    __syncthreads();
    if (C::kStages == 1 && it + 1 < n_tiles) {
      fetch(it + 1, 0);
      cp_commit();
    }
  }
  cp_wait<0>();

  const int64_t pitch = int64_t(a.hq) * DV;
  const int64_t base = (int64_t(b) * a.s * a.hq + h) * DV;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[m][r];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int row = w0 + 16 * m + g + 8 * r;
      if (row >= a.s) continue;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const float x = acc[m][n][2 * r] * inv;
        const float y = acc[m][n][2 * r + 1] * inv;
        const int64_t off = base + row * pitch + n * 8 + 2 * t;
        store_pair<float>(a.o32 + off, x, y);
        if (!F32) store_pair<bf16>(a.o + off, x, y);
      }
      if (t == 0) a.lse[int64_t(bh) * a.s + row] = m_run[m][r] + log2f(l);
    }
}

// grid (B * Hq, query tiles, the longest causal tiles first).  Writes D
// for the dK/dV launch, which runs after it on the same stream.
template <int DQK, int DV, bool F32>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using C = Cfg<DQK, DV, F32>;
  constexpr int BN = C::kDqN, NP = C::NP, NPL = C::NPL;
  using TQ = Tile<kRows, DQK, NP>;
  using TO = Tile<kRows, DV, NP>;
  using TK = Tile<BN, DQK, NP>;
  using TV = Tile<BN, DV, NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + TQ::kElems;
  bf16* sk = sdo + TO::kElems;
  bf16* sv = sk + C::kStages * TK::kElems;

  const int bh = blockIdx.x, b = bh / a.hq, h = bh % a.hq;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / a.group;
  const bf16* kh = a.k.p + b * a.k.sb + hk * a.k.sh;
  const bf16* vh = a.v.p + b * a.v.sb + hk * a.v.sh;

  int lo, hi;
  key_range(m0, kRows, a, &lo, &hi);
  const int n_first = lo / BN * BN;
  const int n_tiles = (hi - n_first + BN - 1) / BN;
  auto fetch = [&](int it, int buf) {
    const int n0 = n_first + it * BN;
    load_rows<BN, DQK, NP>(sk + buf * TK::kElems, kh, a.k.ss, a.k.plane, n0,
                           a.s);
    load_rows<BN, DV, NP>(sv + buf * TV::kElems, vh, a.v.ss, a.v.plane, n0,
                          a.s);
  };
  load_rows<kRows, DQK, NP>(sq, a.q.p + b * a.q.sb + h * a.q.sh, a.q.ss,
                            a.q.plane, m0, a.s);
  load_rows<kRows, DV, NP>(sdo, a.dout.p + b * a.dout.sb + h * a.dout.sh,
                           a.dout.ss, a.dout.plane, m0, a.s);
  cp_commit();
  fetch(0, 0);
  cp_commit();

  const int g = lane >> 2, t = lane & 3;
  const int r_lo = m0 + 16 * warp + g;
  const int64_t stat0 = int64_t(bh) * a.s;
  // D = rowsum(dO * O) of the warp's 16 rows, O the forward's float32
  cp_wait<1>();
  __syncthreads();
  float lse[2], dd[2];
  {
    const int64_t pitch = int64_t(a.hq) * DV;
    const float* o = a.o32 + (int64_t(b) * a.s * a.hq + h) * DV;
    for (int r = 0; r < 16; ++r) {
      const int row = m0 + 16 * warp + r;
      float part = 0.f;
      if (row < a.s) {
        for (int c = lane; c < DV; c += 32) {
          float x = 0.f;
#pragma unroll
          for (int i = NP - 1; i >= 0; --i)
            x += __bfloat162float(
                sdo[i * TO::kPlane + (16 * warp + r) * TO::kPitch + c]);
          part += x * o[row * pitch + c];
        }
      }
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1)
        part += __shfl_xor_sync(0xffffffff, part, w);
      if (r == g) dd[0] = part;
      if (r == g + 8) dd[1] = part;
      if (lane == 0 && row < a.s) a.delta[stat0 + row] = part;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      lse[r] = row < a.s ? a.lse[stat0 + row] : 0.f;
    }
  }

  float dq[1][DQK / 8][4];
  zero(dq);
  for (int it = 0; it < n_tiles; ++it) {
    if (C::kStages == 2) {
      if (it + 1 < n_tiles) fetch(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = C::kStages == 2 ? (it & 1) : 0;
    const int n0 = n_first + it * BN;
    const bf16* kt = sk + buf * TK::kElems;
    float sc[1][BN / 8][4], dp[1][BN / 8][4];
    zero(sc);
    zero(dp);
    gemm_nt<1, BN / 8, DQK, NP, NPL, TQ::kPitch, TQ::kPlane, TK::kPitch,
            TK::kPlane>(sc, sq + 16 * warp * TQ::kPitch, kt, lane);
    gemm_nt<1, BN / 8, DV, NP, NPL, TO::kPitch, TO::kPlane, TV::kPitch,
            TV::kPlane>(dp, sdo + 16 * warp * TO::kPitch,
                        sv + buf * TV::kElems, lane);
    const bool masked = cut(m0, kRows, n0, BN, a);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(sc[0][n][e] * a.scale2 - lse[e >> 1]);
        if (masked && !keep(r_lo + 8 * (e >> 1), n0 + n * 8 + 2 * t + (e & 1),
                            a))
          p = 0.f;
        sc[0][n][e] = p * (dp[0][n][e] - dd[e >> 1]);    // dS
      }
    gemm_pn_into<F32, 1, DQK / 8, BN, NP, NPL, TK::kPitch, TK::kPlane>(
        dq, sc, kt, lane);
    __syncthreads();
    if (C::kStages == 1 && it + 1 < n_tiles) {
      fetch(it + 1, 0);
      cp_commit();
    }
  }
  cp_wait<0>();
  store_rows<1, DQK / 8, typename C::Out>(
      static_cast<typename C::Out*>(a.dq) +
          (int64_t(b) * a.s * a.hq + h) * DQK,
      int64_t(a.hq) * DQK, dq, m0 + 16 * warp, a.s, a.scale, lane);
}

// grid (B * Hkv, key tiles)
template <int DQK, int DV, bool F32>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using C = Cfg<DQK, DV, F32>;
  constexpr int BM = C::kDkvM, NP = C::NP, NPL = C::NPL;
  using TK = Tile<kRows, DQK, NP>;
  using TV = Tile<kRows, DV, NP>;
  using TQ = Tile<BM, DQK, NP>;
  using TO = Tile<BM, DV, NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + TK::kElems;
  bf16* sq = sv + TV::kElems;                       // kStages tiles
  bf16* sdo = sq + C::kStages * TQ::kElems;
  float* sstat = reinterpret_cast<float*>(sdo + C::kStages * TO::kElems);
  // sstat: kStages x [lse of BM queries, D of BM queries]

  const int bk = blockIdx.x, b = bk / a.hkv, hk = bk % a.hkv;
  const int n0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // query rows [lo, hi) that see one of the keys [n0, n0 + 64)
  const int q_lo = a.causal ? n0 : 0;
  const int q_hi = a.window != 0 ? min(a.s, n0 + kRows - 1 + a.window) : a.s;
  const int m_first = q_lo / BM * BM;
  const int per_head = (q_hi - m_first + BM - 1) / BM;
  const int n_tiles = per_head * a.group;
  auto fetch = [&](int it, int buf) {
    const int h = hk * a.group + it / per_head;
    const int m0 = m_first + (it % per_head) * BM;
    load_rows<BM, DQK, NP>(sq + buf * TQ::kElems,
                           a.q.p + b * a.q.sb + h * a.q.sh, a.q.ss,
                           a.q.plane, m0, a.s);
    load_rows<BM, DV, NP>(sdo + buf * TO::kElems,
                          a.dout.p + b * a.dout.sb + h * a.dout.sh,
                          a.dout.ss, a.dout.plane, m0, a.s);
    const int64_t stat0 = (int64_t(b) * a.hq + h) * a.s;
    const int i = threadIdx.x;
    if (i < 2 * BM) {
      const int row = m0 + (i % BM);
      const float* src = (i < BM ? a.lse : a.delta) + stat0 +
                         (row < a.s ? row : a.s - 1);
      cp_async4(sstat + buf * 2 * BM + i, src, row < a.s);
    }
  };
  load_rows<kRows, DQK, NP>(sk, a.k.p + b * a.k.sb + hk * a.k.sh, a.k.ss,
                            a.k.plane, n0, a.s);
  load_rows<kRows, DV, NP>(sv, a.v.p + b * a.v.sb + hk * a.v.sh, a.v.ss,
                           a.v.plane, n0, a.s);
  cp_commit();
  fetch(0, 0);
  cp_commit();

  const int g = lane >> 2, t = lane & 3;
  const int k_lo = n0 + 16 * warp + g;     // this thread's keys: k_lo, +8
  float dk[1][DQK / 8][4], dv[1][DV / 8][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < n_tiles; ++it) {
    if (C::kStages == 2) {
      if (it + 1 < n_tiles) fetch(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = C::kStages == 2 ? (it & 1) : 0;
    const int m0 = m_first + (it % per_head) * BM;
    const bf16* qt = sq + buf * TQ::kElems;
    const bf16* dot = sdo + buf * TO::kElems;
    const float* st = sstat + buf * 2 * BM;
    float sc[1][BM / 8][4], dp[1][BM / 8][4];   // S^T, dP^T
    zero(sc);
    zero(dp);
    gemm_nt<1, BM / 8, DQK, NP, NPL, TK::kPitch, TK::kPlane, TQ::kPitch,
            TQ::kPlane>(sc, sk + 16 * warp * TK::kPitch, qt, lane);
    gemm_nt<1, BM / 8, DV, NP, NPL, TV::kPitch, TV::kPlane, TO::kPitch,
            TO::kPlane>(dp, sv + 16 * warp * TV::kPitch, dot, lane);
    const bool masked = cut(m0, BM, n0, kRows, a);
#pragma unroll
    for (int n = 0; n < BM / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        float p = ex2(sc[0][n][e] * a.scale2 - st[col]);
        if (masked && !keep(m0 + col, k_lo + 8 * (e >> 1), a)) p = 0.f;
        sc[0][n][e] = p;                                 // P^T
        dp[0][n][e] = p * (dp[0][n][e] - st[BM + col]);  // dS^T
      }
    gemm_pn_into<F32, 1, DV / 8, BM, NP, NPL, TO::kPitch, TO::kPlane>(
        dv, sc, dot, lane);
    gemm_pn_into<F32, 1, DQK / 8, BM, NP, NPL, TQ::kPitch, TQ::kPlane>(
        dk, dp, qt, lane);
    __syncthreads();
    if (C::kStages == 1 && it + 1 < n_tiles) {
      fetch(it + 1, 0);
      cp_commit();
    }
  }
  cp_wait<0>();
  using Out = typename C::Out;
  const int64_t row0 = int64_t(b) * a.s * a.hkv + hk;
  store_rows<1, DQK / 8, Out>(static_cast<Out*>(a.dk) + row0 * DQK,
                           int64_t(a.hkv) * DQK, dk, n0 + 16 * warp, a.s,
                           a.scale, lane);
  store_rows<1, DV / 8, Out>(static_cast<Out*>(a.dv) + row0 * DV,
                          int64_t(a.hkv) * DV, dv, n0 + 16 * warp, a.s, 1.f,
                          lane);
}

// float32 [B, S, H, D] (strided, the head dim contiguous) to three bf16
// planes [3, B, S, H, D], contiguous, x = hi + mid + lo
__global__ void split_kernel(const float* x, int64_t b, int64_t s,
                             int64_t h, int64_t d, int64_t sb, int64_t ss,
                             int64_t sh, bf16* out) {
  const int64_t n = b * s * h * d;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t c = i % d, r = i / d;
    const int64_t hh = r % h, r2 = r / h;
    const int64_t ss_ = r2 % s, bb = r2 / s;
    float v = x[bb * sb + ss_ * ss + hh * sh + c];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const bf16 hi = __float2bfloat16_rn(v);
      out[p * n + i] = hi;
      v -= __bfloat162float(hi);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DQK, int DV, bool F32>
struct Smem {
  using C = Cfg<DQK, DV, F32>;
  static constexpr int kFwd =
      2 * (Tile<C::kFwdM, DQK, C::NP>::kElems +
           C::kStages * (Tile<C::kFwdN, DQK, C::NP>::kElems +
                         Tile<C::kFwdN, DV, C::NP>::kElems));
  static constexpr int kDq =
      2 * (Tile<kRows, DQK, C::NP>::kElems + Tile<kRows, DV, C::NP>::kElems +
           C::kStages * (Tile<C::kDqN, DQK, C::NP>::kElems +
                         Tile<C::kDqN, DV, C::NP>::kElems));
  static constexpr int kDkv =
      2 * (Tile<kRows, DQK, C::NP>::kElems + Tile<kRows, DV, C::NP>::kElems +
           C::kStages * (Tile<C::kDkvM, DQK, C::NP>::kElems +
                         Tile<C::kDkvM, DV, C::NP>::kElems)) +
      4 * C::kStages * 2 * C::kDkvM;
  static_assert(kFwd <= 232448 && kDq <= 232448 && kDkv <= 232448,
                "a block's shared memory");
};

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int smem, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// kind 0: forward, 1: dQ (and D), 2: dK/dV
template <int DQK, int DV, bool F32>
cudaError_t run(int kind, const Args& a, cudaStream_t stream) {
  using C = Cfg<DQK, DV, F32>;
  using S = Smem<DQK, DV, F32>;
  const unsigned q_tiles = (a.s + kRows - 1) / kRows;
  if (kind == 0)
    return launch(forward_kernel<DQK, DV, F32>,
                  dim3(a.b * a.hq, (a.s + C::kFwdM - 1) / C::kFwdM), S::kFwd,
                  a, stream);
  if (kind == 1)
    return launch(dq_kernel<DQK, DV, F32>, dim3(a.b * a.hq, q_tiles),
                  S::kDq, a, stream);
  return launch(dkdv_kernel<DQK, DV, F32>, dim3(a.b * a.hkv, q_tiles),
                S::kDkv, a, stream);
}

// One library a width pair and route (kernels/flash_attention.py builds
// each on its first use), so a first call compiles three kernels, not 24.
#if !defined(K9_DQK) || !defined(K9_DV) || !defined(K9_F32)
#error "build with -DK9_DQK=<d_qk> -DK9_DV=<d_v> -DK9_F32=<0|1>"
#endif

Operand operand(const int64_t* w) {
  return Operand{reinterpret_cast<const bf16*>(w[0]), w[1], w[2], w[3],
                 w[4]};
}

}  // namespace

extern "C" {

// Every launching function returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for widths, a route or a kind this library does
// not take.
//
// One K9 launch.  kind 0: forward (writes o, o32, lse), 1: dQ (writes
// delta and dq), 2: dK/dV (reads delta; writes dk, dv).  ``w`` holds 36
// int64: q, k, v, dO as (pointer, batch, position and head strides,
// plane stride) each; then o, o32, lse, delta, dq, dk, dv pointers (0
// where the kind does not use them); then B, S, Hq, Hkv, d_qk, d_v,
// causal, window (0: none), float32 route (0 or 1).
int k9_launch(int kind, const int64_t* w, float scale, float scale2,
              void* stream) {
  Args a;
  a.q = operand(w);
  a.k = operand(w + 5);
  a.v = operand(w + 10);
  a.dout = operand(w + 15);
  a.o = reinterpret_cast<bf16*>(w[20]);
  a.o32 = reinterpret_cast<float*>(w[21]);
  a.lse = reinterpret_cast<float*>(w[22]);
  a.delta = reinterpret_cast<float*>(w[23]);
  a.dq = reinterpret_cast<void*>(w[24]);
  a.dk = reinterpret_cast<void*>(w[25]);
  a.dv = reinterpret_cast<void*>(w[26]);
  const int64_t* d = w + 27;
  a.b = int(d[0]);
  a.s = int(d[1]);
  a.hq = int(d[2]);
  a.hkv = int(d[3]);
  a.causal = int(d[6]);
  a.window = int(d[7]);
  if (kind < 0 || kind > 2 || a.b < 1 || a.s < 1 || a.hkv < 1 ||
      a.hq % a.hkv != 0 || a.window < 0)
    return int(cudaErrorInvalidValue);
  a.group = a.hq / a.hkv;
  a.scale = scale;
  a.scale2 = scale2;
  if (d[4] != K9_DQK || d[5] != K9_DV || d[8] != K9_F32)
    return int(cudaErrorInvalidValue);
  return int(run<K9_DQK, K9_DV, bool(K9_F32)>(
      kind, a, static_cast<cudaStream_t>(stream)));
}

// float32 x [B, S, H, D] (strides sb, ss, sh; the head dim contiguous)
// to ``out``, three contiguous bf16 planes [3, B, S, H, D].
int k9_split(const float* x, int64_t b, int64_t s, int64_t h, int64_t d,
             int64_t sb, int64_t ss, int64_t sh, void* out, void* stream) {
  const int64_t n = b * s * h * d;
  if (n <= 0) return int(cudaErrorInvalidValue);
  const int64_t blocks = (n + 255) / 256;
  split_kernel<<<unsigned(blocks < 65536 ? blocks : 65536), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, b, s, h, d, sb, ss, sh, static_cast<bf16*>(out));
  return int(cudaGetLastError());
}

const char* k9_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
