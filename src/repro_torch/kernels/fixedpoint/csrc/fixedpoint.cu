// fixedpoint: packed children -> decoded search points, every variable of
// every child.
//
// Replaces repro/kernels/fixedpoint/kernel.py:fixedpoint_decode (the Pallas
// TPU kernel behind repro.kernels.fixedpoint.ops.decode_packed).  Variable v
// is the bits-wide MSB-first field at string bit v * bits; it may straddle
// two words, and bits runs up to 32.  The field is rebuilt as the TPU kernel
// rebuilds it: the word-0 part shifted into place, OR the spill from word 1,
// with every shift kept inside [0, 31] on 32-bit values or done on 64 bits
// (a shift by 32 of a 32-bit value is undefined in C++).  The decode is
// dgo::decode_level, lo + level * scale with the multiply and the add
// rounded separately.  The TPU kernel's decode contracts into an FMA and
// differs from its own oracle by 1 ulp on 40-50 % of points; this one equals
// the oracle (repro/kernels/fixedpoint/ref.py) bit for bit.
//
// Word layout (repro_torch/core/encoding.py pack_bits): string bit i in
// word i / 32 at bit 31 - i % 32; uint32 values stored as int64, read
// directly (the low 32 bits of each).
//
// What bounds it: bytes.  It reads P x W int64 words and writes P x n_vars
// float32 (3.70 MB and 14.79 MB at the remote-sensing shape, ~5.5 us at
// 3.35 TB/s) for two float operations and a few integer ones per output.
// One thread per output value, neighbouring threads on neighbouring
// variables of one child, so the writes are coalesced and the word reads
// of a warp fall on a few neighbouring words.
//
// Built by kernel.py (through kernels/_build.py) with nvcc for sm_90a (no
// --use_fast_math) into a shared library with a plain C interface; the entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "dgo_device.cuh"

namespace fixedpoint {

using namespace dgo;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;   // grid-stride beyond this

__global__ void __launch_bounds__(kThreads)
    fixedpoint_kernel(const long long* words, int n_rows, int n_words,
                      int n_vars, int bits, float lo, float scale,
                      float* out) {
  const long long total = static_cast<long long>(n_rows) * n_vars;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += stride) {
    const long long p = i / n_vars;
    const int v = static_cast<int>(i - p * n_vars);
    const int s0 = v * bits;
    const int w0 = s0 >> 5;
    const int off = s0 & 31;
    const long long* row = words + p * n_words;
    const unsigned long long word0 = static_cast<unsigned>(row[w0]);
    // the word-0 part of the field, already shifted left by the bits that
    // spill into word 1
    unsigned level =
        static_cast<unsigned>(((word0 << off) & 0xffffffffull) >> (32 - bits));
    const int need = off + bits;
    if (need > 32) level |= static_cast<unsigned>(row[w0 + 1]) >> (64 - need);
    out[i] = decode_level(level, lo, scale);
  }
}

}  // namespace fixedpoint

extern "C" {

// (n_rows, n_words) int64 words -> (n_rows, n_vars) float32 points.
int fixedpoint_decode(const long long* words, int n_rows, int n_words,
                      int n_vars, int bits, float lo, float scale, float* out,
                      void* stream) {
  using namespace fixedpoint;
  const long long total = static_cast<long long>(n_rows) * n_vars;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  fixedpoint_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, n_rows, n_words, n_vars, bits, lo, scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
