// Segment tables: one launch over up to 8 segments of an elementwise pass.
//
// Shared by K1 (chunk_accumulate.cu), K5 (codec.cu) and K7
// (payload_partition.cu).  K1 and K5 are passes the staged ring runs on
// each of a step's 1-8 sub-chunks.  All sub-chunks of a step have arrived
// before the first of them is reduced (the step's point-to-point batch is
// waited on as a whole), so one launch over all of them gives up no
// overlap and pays one launch floor (5.2-5.8 us on an H100) instead of
// one a sub-chunk.  K7 is a pure copy (Copy below): its split is a table
// of one row, its merge a table of up to 8 segments a launch.
//
// A Table lists up to kMaxSegments segments: the operand pointers, the
// length and whether every pointer is 16-byte aligned (the vector path;
// a sub-chunk sliced at an odd offset takes the scalar loop).  It is
// passed by value as a __grid_constant__ kernel parameter: no host-to-
// device copy, no extra launch, and a block reads it in place.
//
// Work.  A unit is Op::kVec consecutive elements, one or two 16-byte
// words of each operand.  A tile is kThreads x UNROLL units; each segment
// is cut into whole tiles, the last one ragged, and tile t of the launch
// belongs to the segment s with first_tile[s] <= t < first_tile[s + 1]
// (a scan over at most kMaxSegments prefixes).  The grid is sized to the
// work, one block a tile; only past kMaxGrid tiles does a block loop.
// Each thread issues the loads of all its UNROLL units before any store,
// with streaming hints (__ldcs / __stcs: every byte is read or written
// once).  A table of fewer than kLongUnits units (one wave of single-unit
// blocks at full occupancy) takes UNROLL = 1, for more blocks at the
// ring's short lengths; longer tables take Op::kLongUnroll, 64 bytes of
// the widest input in flight a thread.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seg {

constexpr int kMaxSegments = 8;   // routing.py MAX_STAGED_SUBSTEPS
constexpr int kThreads = 256;
constexpr int64_t kMaxGrid = int64_t(1) << 30;
constexpr int64_t kLongUnits = int64_t(132) * 8 * kThreads;

struct Segment {
  const void* in0;
  const void* in1;    // K1's second operand; K5 and K7 have none
  void* out;
  int64_t n;          // elements, >= 1
};

struct Table {
  Segment seg[kMaxSegments];
  int64_t first_tile[kMaxSegments + 1];
  int count;
  uint32_t vector_mask;   // bit s: segment s takes the vector path
};

// Op supplies:
//   kVec, kLongUnroll              elements a unit, units a thread (long)
//   Unit                           the registers that hold a unit's loads
//   load(g, i, Unit&)              the 16-byte loads of unit i
//   store(g, i, const Unit&)       its arithmetic and 16-byte stores
//   scalar(g, i)                   element i alone
template <class Op, int UNROLL>
__global__ void __launch_bounds__(kThreads)
segments_kernel(const __grid_constant__ Table t) {
  constexpr int64_t kTile = int64_t(kThreads) * UNROLL * Op::kVec;
  const int64_t n_tiles = t.first_tile[t.count];
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int s = 0;
    while (s + 1 < t.count && t.first_tile[s + 1] <= tile) ++s;
    const Segment& g = t.seg[s];
    const int64_t e0 = (tile - t.first_tile[s]) * kTile;
    if ((t.vector_mask >> s) & 1u) {
      const int64_t n_units = g.n / Op::kVec;
      const int64_t u0 = e0 / Op::kVec + threadIdx.x;
      typename Op::Unit w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = u0 + int64_t(u) * kThreads;
        if (i < n_units) Op::load(g, i, w[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = u0 + int64_t(u) * kThreads;
        if (i < n_units) Op::store(g, i, w[u]);
      }
      // the n % kVec elements past the last whole unit, in the last tile
      if (e0 + kTile >= g.n) {
        const int64_t i = n_units * Op::kVec + threadIdx.x;
        if (i < g.n) Op::scalar(g, i);
      }
    } else {
      const int64_t end = e0 + kTile < g.n ? e0 + kTile : g.n;
#pragma unroll 4
      for (int64_t i = e0 + threadIdx.x; i < end; i += kThreads)
        Op::scalar(g, i);
    }
  }
}

// The element of ES bytes, moved whole by Copy's scalar step.
template <int ES> struct Elem;
template <> struct Elem<1> { using type = uint8_t; };
template <> struct Elem<2> { using type = uint16_t; };
template <> struct Elem<4> { using type = uint32_t; };
template <> struct Elem<8> { using type = uint64_t; };

// The Op of a pure copy of ES-byte elements (in0 -> out; K7, and K5 on
// bfloat16 input): a unit is one 16-byte word, a long thread keeps four in
// flight (64 bytes).  A segment off 16-byte alignment moves one element
// at a time, never bytes of a wider element.
template <int ES>
struct Copy {
  static constexpr int kVec = 16 / ES;
  static constexpr int kLongUnroll = 4;
  using Unit = uint4;

  static __device__ __forceinline__ void load(const Segment& g, int64_t i,
                                              Unit& w) {
    w = __ldcs(static_cast<const uint4*>(g.in0) + i);
  }

  static __device__ __forceinline__ void store(const Segment& g, int64_t i,
                                               const Unit& w) {
    __stcs(static_cast<uint4*>(g.out) + i, w);
  }

  static __device__ __forceinline__ void scalar(const Segment& g,
                                                int64_t i) {
    using T = typename Elem<ES>::type;
    static_cast<T*>(g.out)[i] = static_cast<const T*>(g.in0)[i];
  }
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Fill t's tile prefixes and vector mask (t.seg and t.count set), launch
// on ``stream`` and return a cudaError_t; *n_vector (when given) gets the
// number of segments on the vector path.
template <class Op>
int launch(Table t, cudaStream_t stream, int* n_vector) {
  if (t.count < 1 || t.count > kMaxSegments)
    return int(cudaErrorInvalidValue);
  int64_t units = 0;
  t.vector_mask = 0;
  for (int s = 0; s < t.count; ++s) {
    const Segment& g = t.seg[s];
    if (g.n < 1) return int(cudaErrorInvalidValue);
    if (aligned16(g.in0) && aligned16(g.in1) && aligned16(g.out))
      t.vector_mask |= 1u << s;
    units += (g.n + Op::kVec - 1) / Op::kVec;
  }
  const bool long_body = units >= kLongUnits;
  const int64_t tile =
      int64_t(kThreads) * (long_body ? Op::kLongUnroll : 1) * Op::kVec;
  t.first_tile[0] = 0;
  for (int s = 0; s < t.count; ++s)
    t.first_tile[s + 1] = t.first_tile[s] + (t.seg[s].n + tile - 1) / tile;
  const int64_t tiles = t.first_tile[t.count];
  const int grid = int(tiles < kMaxGrid ? tiles : kMaxGrid);
  if (long_body)
    segments_kernel<Op, Op::kLongUnroll><<<grid, kThreads, 0, stream>>>(t);
  else
    segments_kernel<Op, 1><<<grid, kThreads, 0, stream>>>(t);
  if (n_vector) *n_vector = __builtin_popcount(t.vector_mask);
  return int(cudaGetLastError());
}

// A table from ``count`` rows of int64: (in0, in1, out, n) when
// ``with_in1``, else (in0, out, n).
inline Table table_from_rows(const int64_t* rows, int count, bool with_in1) {
  Table t{};
  t.count = count;
  const int cols = with_in1 ? 4 : 3;
  for (int s = 0; s < count && s < kMaxSegments; ++s) {
    const int64_t* r = rows + s * cols;
    t.seg[s].in0 = reinterpret_cast<const void*>(r[0]);
    t.seg[s].in1 = with_in1 ? reinterpret_cast<const void*>(r[1]) : nullptr;
    t.seg[s].out = reinterpret_cast<void*>(r[cols - 2]);
    t.seg[s].n = r[cols - 1];
  }
  return t;
}

}  // namespace seg
