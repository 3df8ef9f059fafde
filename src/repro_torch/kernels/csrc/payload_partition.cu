// K7 on Hopper: the multi-path payload split (K7a) and merge (K7b).
//
// Replaces the TPU kernels src/repro/kernels/payload_partition.py:
//   K7a extract_segment (line 36): out = x[s*B : (s+n)*B], one aligned
//       VMEM block DMA per grid step;
//   K7b merge_segments (line 59): out = concat(segments), one pallas_call
//       per segment.
// Both are copies.  They take any element type: the kernels copy bytes,
// and the wrapper (kernels/payload_partition.py) turns elements into
// bytes.  The reference asserts that every offset and length is a whole
// number of B = 131072-element blocks; those asserts stay in the Python
// entry points (kernels/ops.py), and the kernels take any length.
//
// Bound.  A copy reads and writes each byte once and does no arithmetic,
// so it is bound by device-memory bytes: 2 x nbytes at the card's rate.
// What this version does about it: a grid-stride loop in which each
// thread moves 16-byte words (uint4), four loads in flight before their
// four stores, neighbouring threads on neighbouring words, with a few
// waves of blocks over the 132 SMs.  A span whose source and destination
// are not both 16-byte aligned (a segment cut at an odd element) moves
// the widest word that both allow (8, 4, 2 or 1 bytes); the bytes past
// the last whole word are the scalar tail.  K7b is ONE launch for all
// segments, where the reference made one call per segment: a small table
// in device memory holds a row per segment (source pointer, destination
// byte offset, byte count, first block), each segment gets blocks in
// proportion to its bytes (a segment of half the payload gets half the
// grid), and each block finds its row by a binary search over the first
// blocks.  No TMA, no cp.async: a plain load/store loop already streams.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

template <int W> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<1> { using type = uint8_t; };

// Threads tid, tid + stride, ... of a span copy n bytes in W-byte words,
// four words a thread per step (all four loads issued before the
// stores), then the words left over, then the tail bytes one at a time.
template <int W>
__device__ __forceinline__ void copy_words(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ dst,
                                           int64_t n, int64_t tid,
                                           int64_t stride) {
  using T = typename Word<W>::type;
  const int64_t nw = n / W;
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  int64_t i = tid;
  for (; i + 3 * stride < nw; i += 4 * stride) {
    const T a = s[i], b = s[i + stride], c = s[i + 2 * stride],
            e = s[i + 3 * stride];
    d[i] = a;
    d[i + stride] = b;
    d[i + 2 * stride] = c;
    d[i + 3 * stride] = e;
  }
  for (; i < nw; i += stride) d[i] = s[i];
  for (int64_t j = nw * W + tid; j < n; j += stride) dst[j] = src[j];
}

// The widest word both pointers are aligned to; uniform over a span, so
// every thread of a block takes the same branch.
__device__ __forceinline__ void copy_span(const uint8_t* src, uint8_t* dst,
                                          int64_t n, int64_t tid,
                                          int64_t stride) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst);
  if ((a & 15) == 0) copy_words<16>(src, dst, n, tid, stride);
  else if ((a & 7) == 0) copy_words<8>(src, dst, n, tid, stride);
  else if ((a & 3) == 0) copy_words<4>(src, dst, n, tid, stride);
  else if ((a & 1) == 0) copy_words<2>(src, dst, n, tid, stride);
  else copy_words<1>(src, dst, n, tid, stride);
}

__global__ void extract_kernel(const uint8_t* __restrict__ src,
                               uint8_t* __restrict__ dst, int64_t nbytes) {
  copy_span(src, dst, nbytes, (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
            (int64_t)gridDim.x * blockDim.x);
}

// One row of the merge table: where a segment's bytes come from, where
// they go in the output, how many there are, and the first of the blocks
// that copy them (rows in output order, first blocks ascending).
struct Segment {
  const uint8_t* src;
  int64_t dst_offset;
  int64_t nbytes;
  int64_t first_block;
};

__global__ void merge_kernel(const Segment* __restrict__ table, int n_segs,
                             uint8_t* __restrict__ out) {
  // the last row whose first block is at or before this block
  int lo = 0, hi = n_segs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid].first_block <= (int64_t)blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const Segment seg = table[lo];
  const int64_t end = lo + 1 < n_segs ? table[lo + 1].first_block
                                      : (int64_t)gridDim.x;
  copy_span(seg.src, out + seg.dst_offset, seg.nbytes,
            ((int64_t)blockIdx.x - seg.first_block) * blockDim.x +
                threadIdx.x,
            (end - seg.first_block) * blockDim.x);
}

// Blocks for a span of n bytes moved 16 at a time by each thread, capped
// at a few waves.
int blocks_for(int64_t nbytes, int cap) {
  int64_t blocks = (nbytes / 16 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > cap) blocks = cap;
  return (int)blocks;
}

}  // namespace

extern "C" {

// K7a: dst[0:nbytes] = src[0:nbytes] (the caller offsets src to the
// segment's first byte).  nbytes >= 1.  Returns a cudaError_t.
int pp_extract(const void* src, void* dst, int64_t nbytes, void* stream) {
  if (nbytes < 1) return (int)cudaErrorInvalidValue;
  extract_kernel<<<blocks_for(nbytes, kMaxBlocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes);
  return (int)cudaGetLastError();
}

// K7b: for each of the n_segs rows of ``rows`` (host memory, int64
// [n_segs][4]: src pointer, dst_offset, nbytes >= 1, and a slot this
// function fills with the row's first block),
// out[dst_offset : dst_offset + nbytes] = src[0 : nbytes].  The filled
// rows are copied on the stream to ``table`` (device memory, the same
// size) ahead of the launch.  1 <= n_segs.
int pp_merge(int64_t* rows, void* table, int n_segs, void* out,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_segs < 1) return (int)cudaErrorInvalidValue;
  int64_t total = 0;
  for (int i = 0; i < n_segs; ++i) {
    if (rows[4 * i + 2] < 1) return (int)cudaErrorInvalidValue;
    total += rows[4 * i + 2];
  }
  // each segment's share of the waves, at least one block
  int64_t first = 0;
  for (int i = 0; i < n_segs; ++i) {
    const int64_t nbytes = rows[4 * i + 2];
    const int64_t share = (kMaxBlocks * nbytes + total - 1) / total;
    rows[4 * i + 3] = first;
    first += blocks_for(nbytes, share < 1 ? 1 : (int)share);
  }
  if (first > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyAsync(table, rows, sizeof(int64_t) * 4 * n_segs,
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(unsigned)first, kThreads, 0, s>>>(
      static_cast<const Segment*>(table), n_segs,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

const char* pp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
