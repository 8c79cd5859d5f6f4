// fixedpoint: packed children -> decoded search points, every variable of
// every child.
//
// Replaces repro/kernels/fixedpoint/kernel.py:fixedpoint_decode (the Pallas
// TPU kernel behind repro.kernels.fixedpoint.ops.decode_packed).  Variable v
// is the bits-wide MSB-first field at string bit v * bits; it may straddle
// two words, and bits runs up to 32.  The decode is dgo::decode_level,
// lo + level * scale with the multiply and the add rounded separately.  The
// TPU kernel's decode contracts into an FMA and differs from its own oracle
// by 1 ulp on 40-50 % of points; this one equals the oracle
// (repro/kernels/fixedpoint/ref.py) bit for bit.
//
// Word layout (repro_torch/core/encoding.py pack_bits): string bit i in
// word i / 32 at bit 31 - i % 32; uint32 values stored as int64, of which
// the low 32 bits are read.
//
// What bounds it: bytes.  It reads P x W int64 words and writes P x n_vars
// float32 (3.70 MB and 14.79 MB at the remote-sensing shape, ~5.5 us at
// 3.35 TB/s) for two float operations and a few integer ones per output.
// The design spends no division per output:
//  * a block takes a run of whole child rows, about kPoints points (one
//    row at least): one contiguous range of words in, one of points out.
//    Where that would leave multiprocessors without a block (a small
//    population, such as rastrigin's 287 x 5 words) it takes fewer, down
//    to a point a thread, so the population spreads over the card;
//  * its threads walk the run's points in order, thread t taking points
//    t, t + kThreads, ...: a warp's 4-byte stores cover 128 contiguous
//    bytes whatever the row length, and no thread idles at the end of a
//    short row.  A thread finds its first point's row and field with one
//    division and moves on by additions: 32-bit indices, no division per
//    point;
//  * where a block's threads take more than one point each, the block
//    first stages its words into shared memory as uint32 with 16-byte
//    loads (a scalar head where the range starts 8 bytes off a 16-byte
//    boundary, a scalar tail), so every word is read from device memory
//    once; where they take one point each, staging would only add a
//    barrier and a shared-memory round trip, and each point reads its
//    word in place.  Rows longer than kMaxStagedWords (48 KB of words)
//    are read in place too;
//  * a field is the word-0 part shifted into place, OR the spill from
//    word 1, at every width from 1 to 32.
// Measured against the alternatives (probe_packed.py, which builds them
// from the -D switches below): FIXEDPOINT_FLOAT4 (four points a thread,
// one 16-byte store), FIXEDPOINT_STAGE=0/1 (staging never/always where the
// rows fit), FIXEDPOINT_THREADS and FIXEDPOINT_POINTS (the block's size).
//
// Built by kernel.py (through kernels/_build.py) with nvcc for sm_90a (no
// --use_fast_math) into a shared library with a plain C interface; the entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "dgo_device.cuh"

namespace fixedpoint {

using namespace dgo;

#ifndef FIXEDPOINT_THREADS
#define FIXEDPOINT_THREADS 128
#endif
#ifndef FIXEDPOINT_POINTS
#define FIXEDPOINT_POINTS 4096
#endif
constexpr int kThreads = FIXEDPOINT_THREADS;
constexpr int kPoints = FIXEDPOINT_POINTS;  // a block's points, about
constexpr int kMaxStagedWords = 12 * 1024;  // 48 KB: no opt-in needed

struct Shape {
  int n_rows, n_words, n_vars, bits;
  int rows_per_block;   // whole rows
  bool staged;          // words in shared memory (else read in place)
  float lo, scale;
};

// The block's n words (one contiguous run of whole rows) -> shared memory,
// as uint32, 16 bytes a load.
__device__ __forceinline__ void stage(const long long* src, int n,
                                      unsigned* sm) {
  const int head =
      min(static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 3) & 1), n);
  const int pairs = (n - head) >> 1;
  const longlong2* v = reinterpret_cast<const longlong2*>(src + head);
  if (threadIdx.x == 0 && head) sm[0] = static_cast<unsigned>(__ldg(src));
  if (threadIdx.x == kThreads - 1 && ((n - head) & 1))
    sm[n - 1] = static_cast<unsigned>(__ldg(src + n - 1));
#pragma unroll 4
  for (int i = threadIdx.x; i < pairs; i += kThreads) {
    const longlong2 x = __ldg(v + i);
    sm[head + 2 * i] = static_cast<unsigned>(x.x);
    sm[head + 2 * i + 1] = static_cast<unsigned>(x.y);
  }
}

// Where a point of the block lies: its row's first word (row x W) and its
// field's first bit within the row (variable x bits).  Moving on by a fixed
// number of points adds fixed amounts to both, with at most one carry into
// the next row: no division and no multiply per point.
struct Cursor {
  int word, bit;
};

struct Walk {
  int n_vars, n_words, bits, row_bits;
  __device__ __forceinline__ Cursor at(int q) const {  // one division
    const int r = q / n_vars;
    return Cursor{r * n_words, (q - r * n_vars) * bits};
  }
  __device__ __forceinline__ void advance(Cursor& p, const Cursor& by) const {
    p.word += by.word;
    p.bit += by.bit;
    if (p.bit >= row_bits) {
      p.bit -= row_bits;
      p.word += n_words;
    }
  }
};

// The block's words, staged or in place (uint32 values held in int64).
struct Words {
  const unsigned* sm;
  const long long* g;
  bool staged;
  __device__ __forceinline__ unsigned operator[](int i) const {
    return staged ? sm[i] : static_cast<unsigned>(g[i]);
  }
};

// The point at p: its field is the word-0 part shifted into place, OR the
// spill from word 1.  Every shift stays inside [0, 31]: off <= 31,
// 32 - bits <= 31, and 64 - off - bits is in [1, 31] where the field
// spills.
__device__ __forceinline__ float point(const Words& words, const Shape& s,
                                       const Cursor& p) {
  const int i = p.word + (p.bit >> 5);
  const int off = p.bit & 31;
  unsigned level = (words[i] << off) >> (32 - s.bits);
  if (off + s.bits > 32) level |= words[i + 1] >> (64 - off - s.bits);
  return decode_level(level, s.lo, s.scale);
}

__global__ void __launch_bounds__(kThreads)
    fixedpoint_kernel(const long long* __restrict__ words, Shape s,
                      float* __restrict__ out) {
  extern __shared__ unsigned sm_words[];
  const int row0 = blockIdx.x * s.rows_per_block;
  const int rows = min(s.rows_per_block, s.n_rows - row0);
  const long long* src = words + static_cast<size_t>(row0) * s.n_words;
  float* dst = out + static_cast<size_t>(row0) * s.n_vars;
  if (s.staged) {
    stage(src, rows * s.n_words, sm_words);
    __syncthreads();
  }
  const Words w{sm_words, src, s.staged};
  const Walk walk{s.n_vars, s.n_words, s.bits, s.n_vars * s.bits};
  const int n = rows * s.n_vars;   // the block's points, row after row
#ifndef FIXEDPOINT_FLOAT4
  const Cursor step = walk.at(kThreads);
  Cursor p = walk.at(threadIdx.x);
  for (int q = threadIdx.x; q < n; q += kThreads) {
    dst[q] = point(w, s, p);
    walk.advance(p, step);
  }
#else
  // four points a thread, one 16-byte store from the block's first 16-byte
  // boundary on, scalars before it and after the last whole four
  const int head = min(static_cast<int>(
      (0u - static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst) >> 2)) &
      3u), n);
  const int fours = (n - head) >> 2;
  const int tail = head + 4 * fours;
  const int t = threadIdx.x;
  if (t < head) dst[t] = point(w, s, walk.at(t));
  if (tail + t < n) dst[tail + t] = point(w, s, walk.at(tail + t));
  const Cursor step = walk.at(4 * kThreads), next = walk.at(1);
  Cursor p = walk.at(head + 4 * t);
  for (int k = t; k < fours; k += kThreads) {
    float v[4];
    Cursor e = p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = point(w, s, e);
      walk.advance(e, next);
    }
    *reinterpret_cast<float4*>(dst + head + 4 * k) =
        make_float4(v[0], v[1], v[2], v[3]);
    walk.advance(p, step);
  }
#endif
}

}  // namespace fixedpoint

extern "C" {

// (n_rows, n_words) int64 words -> (n_rows, n_vars) float32 points, on a
// card of n_sms multiprocessors.
int fixedpoint_decode(const long long* words, int n_rows, int n_words,
                      int n_vars, int bits, float lo, float scale, int n_sms,
                      float* out, void* stream) {
  using namespace fixedpoint;
  // a block: whole rows, about kPoints points, fewer where that would
  // leave multiprocessors without a block (down to a point a thread), and
  // fewer rows where their words would pass kMaxStagedWords; staged where
  // its threads take more than one point each and the rows fit
  const long long total = static_cast<long long>(n_rows) * n_vars;
  const long long points = std::max<long long>(
      kThreads, std::min<long long>(kPoints, total / n_sms));
  const bool fits = n_words <= kMaxStagedWords;
  int rows = static_cast<int>(std::max<long long>(1, points / n_vars));
  if (fits && static_cast<long long>(rows) * n_words > kMaxStagedWords)
    rows = kMaxStagedWords / n_words;
#ifndef FIXEDPOINT_STAGE
  const bool staged = fits && static_cast<long long>(rows) * n_vars > kThreads;
#else
  const bool staged = fits && FIXEDPOINT_STAGE;
#endif
  const Shape s{n_rows, n_words, n_vars, bits, rows, staged, lo, scale};
  const int grid = static_cast<int>((n_rows + rows - 1LL) / rows);
  const size_t smem = staged ? sizeof(unsigned) * rows * n_words : 0;
  fixedpoint_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(words, s, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
