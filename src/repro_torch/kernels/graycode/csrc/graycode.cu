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
// below the card's rate.  Each thread block first packs the parent's words
// into shared memory (W words from N bytes, L2-resident), then its threads
// write a contiguous run of whole children (about ops.ROW_WORDS words),
// neighbouring threads on neighbouring words.
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

__global__ void __launch_bounds__(kThreads)
    graycode_kernel(const signed char* parent, int n_bits, int n_words,
                    const int* starts, const int* ends, int n_rows,
                    int rows_per_block, long long* out) {
  extern __shared__ unsigned parent_words[];
  for (int w = threadIdx.x; w < n_words; w += kThreads) {
    unsigned word = 0u;
    for (int t = 0; t < 32; ++t) {
      const int j = 32 * w + t;
      word = (word << 1) |
             (j < n_bits ? static_cast<unsigned>(parent[j]) : 0u);
    }
    parent_words[w] = word;
  }
  __syncthreads();

  const int row0 = blockIdx.x * rows_per_block;
  const int total = min(rows_per_block, n_rows - row0) * n_words;
  long long* block_out = out + static_cast<size_t>(row0) * n_words;
  for (int k = threadIdx.x; k < total; k += kThreads) {
    const int r = k / n_words;
    const int w = k - r * n_words;
    unsigned word = child_level(parent_words[w], w, 32, starts[row0 + r],
                                ends[row0 + r], kEvenBits);
    // keep the word's first `valid` string bits: pad bits stay zero
    const int valid = min(max(n_bits - 32 * w, 0), 32);
    word &= static_cast<unsigned>(~((1ull << (32 - valid)) - 1ull));
    block_out[k] = static_cast<long long>(word);
  }
}

}  // namespace graycode

extern "C" {

// (n_rows, n_words) int64 children of the parent's 0/1 bit string, child r
// inverting Gray segment [starts[r], ends[r]).  Dynamic shared memory:
// n_words * 4 bytes.
int graycode_children(const signed char* parent, int n_bits, int n_words,
                      const int* starts, const int* ends, int n_rows,
                      int rows_per_block, long long* out, void* stream) {
  using namespace graycode;
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  graycode_kernel<<<grid, kThreads, sizeof(unsigned) * n_words,
                    static_cast<cudaStream_t>(stream)>>>(
      parent, n_bits, n_words, starts, ends, n_rows, rows_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
