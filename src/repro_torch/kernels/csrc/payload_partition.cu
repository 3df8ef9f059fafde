// K7 on Hopper: the multi-path payload split (K7a) and merge (K7b).
//
// Replaces the TPU kernels src/repro/kernels/payload_partition.py:
//   K7a extract_segment (line 36): out = x[s*B : (s+n)*B], one aligned
//       VMEM block DMA per grid step;
//   K7b merge_segments (line 59): out = concat(segments), one pallas_call
//       per segment.
// Both are copies.  They take any element type: the wrapper
// (kernels/payload_partition.py) hands over elements of 1, 2, 4 or 8
// bytes (wider ones as several 8-byte elements).  The reference asserts
// that every offset and length is a whole number of B = 131072-element
// blocks; those asserts stay in the Python entry points (kernels/ops.py),
// and the kernels take any length and offset.
//
// Bound.  A copy reads and writes each byte once and does no arithmetic,
// so it is bound by device-memory bytes: 2 x nbytes at the card's rate.
// What the design does about it: both run on segments.cuh with its Copy
// Op.  K7a is a table of one row; K7b a table of up to 8 rows (source,
// destination, length) a launch, passed by value as a __grid_constant__
// parameter, so no table is copied to the card; the wrapper splits a merge
// of more segments into launches of 8, one after another on the stream.
// The grid is sized to the work, one block a tile, and a long table keeps
// 64 bytes of 16-byte loads in flight a thread, all before its stores,
// with streaming hints.  A segment whose source or destination is off
// 16-byte alignment (cut at an odd element) moves one element at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.cuh"

extern "C" {

// One launch over ``count`` (1-8) rows of int64 (src, dst, n >= 1):
// dst[0:n] = src[0:n] for each, in elements of ``elem_size`` bytes (1, 2,
// 4 or 8).  K7a is a table of one row.  Returns a cudaError_t.
int pp_copy(const int64_t* rows, int count, int elem_size, void* stream) {
  if (count < 1 || count > seg::kMaxSegments)
    return int(cudaErrorInvalidValue);
  const seg::Table t = seg::table_from_rows(rows, count, false);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1: return seg::launch<seg::Copy<1>>(t, s, nullptr);
    case 2: return seg::launch<seg::Copy<2>>(t, s, nullptr);
    case 4: return seg::launch<seg::Copy<4>>(t, s, nullptr);
    case 8: return seg::launch<seg::Copy<8>>(t, s, nullptr);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* pp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
