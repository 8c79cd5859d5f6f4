// Device functions shared by the port's kernels (popstep, graycode,
// fixedpoint, popmin): the closed-form child of a Gray segment inversion,
// the bit-exact fixed-point decode, and the (min, argmin) selection rules
// with their warp and block reductions.
//
// Built into each kernel's library by repro_torch/kernels/_build.py, which
// puts this directory on the include path and hashes this file with every
// library's own sources.
#pragma once

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace dgo {

constexpr unsigned kFullMask = 0xffffffffu;

struct Cand {
  float v;
  int row;
};

// --- the child of a segment inversion ---------------------------------------

// Field mask of the positions t = 0, 2, 4, ... of a bits-wide MSB-first
// field (position t has weight 2^(bits-1-t)).
__device__ __forceinline__ unsigned even_positions(int bits) {
  unsigned m = 0u;
  for (int t = 0; t < bits; t += 2) m |= 1u << (bits - 1 - t);
  return m;
}

// Inverting Gray segment [s, e) of a string flips binary bit j iff
// (j - s) is even inside [s, e), and every j >= e iff (e - s) is odd
// (repro/core/population.py segment_patterns).  This is a bits-wide
// MSB-first field starting at string bit v * bits (a variable's level, or
// with bits = 32 one packed word) XOR that field's slice of the pattern.
__device__ __forceinline__ unsigned child_level(unsigned parent_level, int v,
                                                int bits, int s, int e,
                                                unsigned even_mask) {
  const int base = v * bits;
  const int lo_t = min(max(s - base, 0), bits);
  const int hi_t = min(max(e - base, 0), bits);
  const unsigned long long one = 1ull;
  const unsigned full = static_cast<unsigned>((one << bits) - 1ull);
  // positions inside [s, e), alternating from s
  const unsigned inside =
      static_cast<unsigned>((one << (bits - lo_t)) - (one << (bits - hi_t)));
  const unsigned alt = ((s - base) & 1) ? (full ^ even_mask) : even_mask;
  unsigned pattern = inside & alt;
  // every position at or after e flips when the segment length is odd
  if ((e - s) & 1)
    pattern |= static_cast<unsigned>((one << (bits - hi_t)) - 1ull);
  return parent_level ^ pattern;
}

// --- decode -----------------------------------------------------------------

// lo + level * scale with the multiply and the add rounded separately: a
// contracted FMA differs from the reference on most lattice points.
__device__ __forceinline__ float decode_level(unsigned level, float lo,
                                              float scale) {
  return __fadd_rn(lo, __fmul_rn(__uint2float_rn(level), scale));
}

// --- (min, argmin) ----------------------------------------------------------

// jnp.argmin's order: NaN first (smallest row among NaNs), then value,
// then row.
__device__ __forceinline__ bool nan_first_better(Cand a, Cand b) {
  const bool an = isnan(a.v), bn = isnan(b.v);
  if (an || bn) return (an && bn) ? a.row < b.row : an;
  return a.v < b.v || (a.v == b.v && a.row < b.row);
}

// The value's place in that order as an unsigned key: 0 for a NaN, then
// the value's order, with -0.0 and 0.0 equal (0x80000000).
__device__ __forceinline__ unsigned nan_first_key(float v) {
  if (isnan(v)) return 0u;
  const unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Lexicographic on (value, id).
__device__ __forceinline__ bool lex_better(float av, int aid, float bv,
                                           int bid) {
  return av < bv || (av == bv && aid < bid);
}

// Warp reductions: every lane ends with the warp's best.  Both orders are
// total (rows and ids are distinct), so the result is the same on every
// lane and for any order of the inputs.  The NaN-first one takes the
// smallest key, then the smallest row with it (two redux.sync), then the
// value from the lane that holds both, so a -0.0 keeps its sign.
__device__ __forceinline__ Cand warp_nan_first(Cand c) {
  const unsigned key = nan_first_key(c.v);
  const unsigned low = __reduce_min_sync(kFullMask, key);
  const unsigned row = __reduce_min_sync(
      kFullMask, key == low ? static_cast<unsigned>(c.row) : 0xffffffffu);
  const unsigned owner = __ballot_sync(
      kFullMask, key == low && static_cast<unsigned>(c.row) == row);
  return Cand{__shfl_sync(kFullMask, c.v, __ffs(owner) - 1),
              static_cast<int>(row)};
}

__device__ __forceinline__ void warp_lex(float& v, int& id) {
  for (int o = 16; o > 0; o >>= 1) {
    const float qv = __shfl_xor_sync(kFullMask, v, o);
    const int qi = __shfl_xor_sync(kFullMask, id, o);
    if (lex_better(qv, qi, v, id)) {
      v = qv;
      id = qi;
    }
  }
}

// The NaN-first best of every thread's candidate in a block of kThreads
// threads; valid in thread 0 (warp 0 folds the warps' winners).  Called by every thread of the block; a second call in the
// same kernel must follow a barrier after the first.
template <int kThreads>
__device__ __forceinline__ Cand block_nan_first(Cand c) {
  constexpr int kWarpsInBlock = kThreads / 32;
  static_assert(kWarpsInBlock >= 1 && kWarpsInBlock <= 32, "1..32 warps");
  c = warp_nan_first(c);
  if constexpr (kWarpsInBlock > 1) {
    __shared__ float sv[kWarpsInBlock];
    __shared__ int sk[kWarpsInBlock];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      sv[warp] = c.v;
      sk[warp] = c.row;
    }
    __syncthreads();
    if (warp == 0)
      c = warp_nan_first(lane < kWarpsInBlock ? Cand{sv[lane], sk[lane]}
                                              : Cand{CUDART_INF_F, INT_MAX});
  }
  return c;
}

}  // namespace dgo
