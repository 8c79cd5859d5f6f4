// graycode: every child of one parent as packed words — the segment
// inversion, the inverse Gray transform and the pad bits, for 2N-1 children
// at once.
//
// Replaces repro/kernels/graycode/kernel.py:graycode_children (the Pallas
// TPU kernel behind repro.kernels.graycode.ops.generate_population_packed).
// The TPU kernel XORs a segment mask into the parent's Gray words, then runs
// a within-word prefix-XOR and an exclusive cross-word parity carry: a scan
// over the W words of every child (85 at N = 2,720).  This kernel carries no
// scan.  Inverting Gray segment [s, e) flips binary bit j by the parity of
// |[s, e) ∩ [0, j]|, so each child word is the parent's binary word XOR a
// closed-form pattern: dgo::child_level with a 32-bit field per word.  Every
// output word is computed independently, and the result is bit for bit the
// TPU kernel's, pad bits (string bits >= N) zero.
//
// Word layout (repro_torch/core/encoding.py pack_bits): string bit i in
// word i / 32 at bit 31 - i % 32; uint32 values stored as int64, which the
// kernel writes directly.
//
// What bounds it: bytes.  It writes (2N-1) x W int64 words (3.70 MB at
// N = 2,720) and reads N parent bytes and two int32 bounds per child: about
// 1.1 us at 3.35 TB/s; a handful of integer operations per word are far
// below the card's rate.  The design:
//  * a group of 2^group_shift threads (up to a warp) takes a span: one
//    row when W is even, two rows when W is odd, so that a span starts on
//    a 16-byte boundary and holds whole word pairs.  Its threads take word
//    pairs and write each as one 16-byte store (two int64), a scalar store
//    for a lone last word.  The grid has a group for every span;
//  * a span's (start, end) bounds are loaded once, before the prologue so
//    the two overlap; a word's row is a comparison with W, so nothing is
//    divided per word;
//  * the prologue packs the parent's W words into shared memory: a thread
//    loads 16 bytes, turns each 4 into a nibble with one multiply, and
//    joins its neighbour's half-word by a shuffle; bytes at or past N read
//    as 0.
// Measured against the alternatives (probe_packed.py, which builds them
// from the -D switches below): warp ballots on one byte a lane for the
// prologue (GRAYCODE_BALLOTS) and two 8-byte stores a pair
// (GRAYCODE_SCALAR_STORES) were slower on an H100; GRAYCODE_NO_PROLOGUE
// and GRAYCODE_NO_BODY (wrong output) time the two parts alone.
//
// Built by kernel.py (through kernels/_build.py) with nvcc for sm_90a into a
// shared library with a plain C interface; the entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "dgo_device.cuh"

namespace graycode {

using namespace dgo;

constexpr int kThreads = 256;
constexpr unsigned kEvenBits = 0xaaaaaaaau;  // even_positions(32)

struct Span {
  int rows;          // 1 or 2 valid rows
  int s0, e0, s1, e1;
};

__device__ __forceinline__ Span load_span(const int* starts, const int* ends,
                                          int r0, int span_rows, int n_rows) {
  Span sp{min(span_rows, n_rows - r0), starts[r0], ends[r0], 0, 0};
  if (sp.rows > 1) {
    sp.s1 = starts[r0 + 1];
    sp.e1 = ends[r0 + 1];
  }
  return sp;
}

// Four 0/1 bytes (the first in the low byte) -> a nibble, the first byte
// its top bit: the product puts byte k's bit at bit 27 - k and no two
// partial products share a bit, so nothing carries into bits 24-27.
__device__ __forceinline__ unsigned nibble(unsigned four_bytes) {
  return (four_bytes * 0x08040201u) >> 24 & 15u;
}

// String bits [j0, j0 + 16) -> a half-word, MSB first; bits at or past N
// read as 0.  `parent` is 16-byte aligned.
__device__ __forceinline__ unsigned pack16(const signed char* parent, int j0,
                                           int n_bits) {
  if (j0 + 16 <= n_bits) {
    const uint4 q = *reinterpret_cast<const uint4*>(parent + j0);
    return nibble(q.x) << 12 | nibble(q.y) << 8 | nibble(q.z) << 4 |
           nibble(q.w);
  }
  unsigned half = 0u;
  for (int t = 0; t < 16 && j0 + t < n_bits; ++t)
    half |= static_cast<unsigned>(parent[j0 + t] != 0) << (15 - t);
  return half;
}

// Word x of a span (x >= W: the span's second row).
__device__ __forceinline__ unsigned child_word(const unsigned* parent_words,
                                               int x, int n_words, int n_bits,
                                               const Span& sp) {
  const bool second = x >= n_words;
  const int w = second ? x - n_words : x;
  unsigned word = child_level(parent_words[w], w, 32, second ? sp.s1 : sp.s0,
                              second ? sp.e1 : sp.e0, kEvenBits);
  // keep the word's first `valid` string bits: pad bits stay zero
  const int valid = min(max(n_bits - 32 * w, 0), 32);
  return word & static_cast<unsigned>(~((1ull << (32 - valid)) - 1ull));
}

// The parent's W words -> shared memory.
__device__ __forceinline__ void pack_parent(const signed char* parent,
                                            int n_bits, int n_words,
                                            unsigned* parent_words) {
  const int lane = threadIdx.x & 31;
#ifndef GRAYCODE_BALLOTS
  // thread p packs string bits [16p, 16p + 16) from one 16-byte load, its
  // neighbour's half-word joins it by a shuffle
  for (int base = threadIdx.x & ~31; base < 2 * n_words; base += kThreads) {
    const int p = base + lane;
    const unsigned half = pack16(parent, 16 * p, n_bits);
    const unsigned low = __shfl_down_sync(kFullMask, half, 1);
    if (!(lane & 1) && p < 2 * n_words)
      parent_words[p >> 1] = half << 16 | low;
  }
#else
  // a warp a word, a lane a byte, 16 bytes in flight a lane
  for (int w0 = threadIdx.x >> 5; w0 < n_words; w0 += kThreads / 32 * 16) {
    signed char b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = 32 * (w0 + i * kThreads / 32) + lane;
      b[i] = j < n_bits ? parent[j] : 0;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned word = __brev(__ballot_sync(kFullMask, b[i] != 0));
      const int w = w0 + i * kThreads / 32;
      if (lane == 0 && w < n_words) parent_words[w] = word;
    }
  }
#endif
}

__global__ void __launch_bounds__(kThreads)
    graycode_kernel(const signed char* parent, int n_bits, int n_words,
                    const int* starts, const int* ends, int n_rows,
                    int group_shift, long long* out) {
  extern __shared__ unsigned parent_words[];
  const int span_rows = (n_words & 1) + 1;
  const int span_words = span_rows * n_words;
  const int n_spans = (n_rows + span_rows - 1) >> (span_rows - 1);
  const int sub = threadIdx.x & ((1 << group_shift) - 1);
  const int span = blockIdx.x * (kThreads >> group_shift) +
                   (threadIdx.x >> group_shift);
  const int r0 = span * span_rows;
  Span sp{};
  if (span < n_spans) sp = load_span(starts, ends, r0, span_rows, n_rows);
#ifndef GRAYCODE_NO_PROLOGUE
  pack_parent(parent, n_bits, n_words, parent_words);
#endif
  __syncthreads();
#ifdef GRAYCODE_NO_BODY
  if (threadIdx.x == 0) out[blockIdx.x] = parent_words[0];
  return;
#endif
  if (span >= n_spans) return;
  const int valid = sp.rows * n_words;
  // r0 * W is even, so the span starts on a 16-byte boundary
  long long* dst = out + static_cast<size_t>(r0) * n_words;
  for (int x = 2 * sub; x < span_words; x += 2 << group_shift) {
    if (x + 1 < valid) {
#ifndef GRAYCODE_SCALAR_STORES
      *reinterpret_cast<longlong2*>(dst + x) = make_longlong2(
          child_word(parent_words, x, n_words, n_bits, sp),
          child_word(parent_words, x + 1, n_words, n_bits, sp));
#else
      dst[x] = child_word(parent_words, x, n_words, n_bits, sp);
      dst[x + 1] = child_word(parent_words, x + 1, n_words, n_bits, sp);
#endif
    } else if (x < valid) {
      dst[x] = child_word(parent_words, x, n_words, n_bits, sp);
    }
  }
}

}  // namespace graycode

extern "C" {

// (n_rows, n_words) int64 children of the parent's 0/1 bit string, child r
// inverting Gray segment [starts[r], ends[r]); `parent` and `out` 16-byte
// aligned.
// Dynamic shared memory: n_words * 4 bytes.
int graycode_children(const signed char* parent, int n_bits, int n_words,
                      const int* starts, const int* ends, int n_rows,
                      long long* out, void* stream) {
  using namespace graycode;
  const int span_rows = (n_words & 1) + 1;
  const int span_pairs = span_rows * n_words / 2;
  int shift = 0;
  while ((1 << shift) < span_pairs && shift < 5) ++shift;
  const long long n_spans =
      (static_cast<long long>(n_rows) + span_rows - 1) / span_rows;
  const long long groups = kThreads >> shift;
  const int grid = static_cast<int>((n_spans + groups - 1) / groups);
  const size_t smem = sizeof(unsigned) * n_words;
  graycode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      parent, n_bits, n_words, starts, ends, n_rows, shift, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
