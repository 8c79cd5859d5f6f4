// popstep: one DGO population step on the card — child generation, decode,
// objective evaluation and the (min, argmin) selection, for every child of
// one parent, without writing a child to device memory.
//
// Replaces repro/kernels/popstep/kernel.py:_popstep_kernel (the Pallas TPU
// kernel behind repro.kernels.popstep.ops.population_step_ids).  It computes
// what that kernel computes, not its blocks:
//
//  * Child levels in closed form.  Inverting Gray segment [s, e) of the
//    parent flips binary bit j iff (j - s) is even inside [s, e), and for
//    every j >= e iff (e - s) is odd (repro/core/population.py
//    segment_patterns).  So each variable's child level is its parent level
//    (read from the parent's 0/1 bit string) XOR a mask of a few shifts —
//    no Gray round trip, no packed words, no cross-word parity scan.
//  * Decode is bit-exact with the reference: lo + level * scale with the
//    multiply and the add rounded separately (__fmul_rn / __fadd_rn; a
//    contracted FMA differs on most lattice points).
//  * Race-free selection.  The TPU kernel folds tiles in grid order, which
//    Hopper does not guarantee.  Here each thread block writes one partial
//    (value, row) for its chunk of children (chunks never straddle a virtual
//    block) and a second launch folds the partials.  Both rules are
//    associative and commutative, so the result does not depend on the order
//    blocks ran in:
//      - inside a virtual block: a NaN wins (smallest row among NaNs), else
//        the smallest value, ties to the smallest row (jnp.argmin);
//      - across virtual blocks: a NaN block is ignored, the rest fold
//        lexicographically on (value, child id) from (+inf, sentinel)
//        (repro/core/distributed.py:246-253); with one virtual block its
//        result is returned as it is.
//    The fold gives each warp whole virtual blocks (or, with one virtual
//    block, strides every thread over its partials) and reduces with
//    butterfly shuffles.  The whole population is one launch pair per step
//    (the reference makes one kernel call per virtual block).
//
// What bounds it: operations.  At the paper's largest problem (the
// 680-variable remote-sensing MLP, 5,439 children, 256 samples) a step is
// ~1.75 GFLOP against ~50 KB of inputs: ~26 us at the H100's 67 TFLOP/s for
// float32 outside the tensor cores, 0.02 us at 3.35 TB/s.  The design keeps
// every child in shared memory and registers: one warp per child, the
// decoded point in shared memory (n_vars floats per warp), the objective
// warp-cooperative with a fixed-order shuffle sum.  The remote-sensing MLP
// reads each weight once per 4 samples from a shared-memory broadcast.  The
// precise tanhf (~10,752 per child) costs more issue slots than the
// multiply-adds; tensor cores and a cheaper tanh are later work.
//
// Built by kernel.py (through kernels/_build.py) with nvcc for sm_90a (no
// --use_fast_math) into a shared library with a plain C interface; every
// entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dgo_device.cuh"
#include "objectives.cuh"

namespace popstep {

using namespace dgo;

constexpr int kWarps = 4;               // children in flight per thread block
constexpr int kThreads = kWarps * 32;
constexpr int kFoldThreads = 256;

// --- stage 1: child level ---------------------------------------------------

// Level of variable v in the parent: its bits-wide MSB-first field of the
// 0/1 bit string.
__device__ __forceinline__ unsigned parent_level(const signed char* bits_str,
                                                 int v, int bits) {
  unsigned level = 0u;
  for (int t = 0; t < bits; ++t)
    level = (level << 1) | static_cast<unsigned>(bits_str[v * bits + t]);
  return level;
}

// --- stages 2 and 3: decode_level and the (min, argmin) fold rules are in
// dgo_device.cuh ------------------------------------------------------------

struct PartialArgs {
  const signed char* parent; // (n_vars * bits,) 0/1 parent bit string
  const int* starts;         // (K,) segment starts
  const int* ends;           // (K,) segment ends
  const int* ok;             // (K,) 0 -> the row is +inf
  int n_rows;                // K
  int n_vars;
  int bits;
  float lo;
  float scale;
  ObjParams obj;
  int vblock;                // rows per virtual block
  int chunk;                 // rows per thread block
  int chunks_per_vblock;
  float* part_val;           // (n_vblocks * chunks_per_vblock,)
  int* part_row;
};

template <int OBJ>
__global__ void __launch_bounds__(kThreads)
    popstep_partials_kernel(PartialArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xs = smem + warp * a.n_vars;

  const int vb = blockIdx.x / a.chunks_per_vblock;
  const int c = blockIdx.x - vb * a.chunks_per_vblock;
  const int vb_end = min((vb + 1) * a.vblock, a.n_rows);
  const int row0 = vb * a.vblock + c * a.chunk;
  const int row_end = min(row0 + a.chunk, vb_end);
  const unsigned even_mask = even_positions(a.bits);

  Cand best{CUDART_INF_F, INT_MAX};
  for (int row = row0 + warp; row < row_end; row += kWarps) {
    Cand cand{CUDART_INF_F, row};
    if (a.ok[row]) {                      // uniform across the warp
      const int s = a.starts[row], e = a.ends[row];
      for (int v = lane; v < a.n_vars; v += 32)
        xs[v] = decode_level(
            child_level(parent_level(a.parent, v, a.bits), v, a.bits, s, e,
                        even_mask),
            a.lo, a.scale);
      __syncwarp();
      cand.v = Objective<OBJ>::eval(xs, a.n_vars, a.obj, lane);
      __syncwarp();                       // xs is rewritten by the next row
    }
    if (nan_first_better(cand, best)) best = cand;
  }

  __shared__ Cand warp_best[kWarps];
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    Cand b = warp_best[0];
    for (int w = 1; w < kWarps; ++w)
      if (nan_first_better(warp_best[w], b)) b = warp_best[w];
    a.part_val[blockIdx.x] = b.v;
    a.part_row[blockIdx.x] = b.row;
  }
}

// One block.  With one virtual block every thread strides over its
// partials; with several, each warp takes whole virtual blocks, drops the
// NaN ones and keeps the lexicographic best.
__global__ void __launch_bounds__(kFoldThreads)
    popstep_fold_kernel(const float* part_val, const int* part_row,
                        const int* ids, int n_vblocks, int parts_per_vblock,
                        int sentinel, float* out_val, int* out_id) {
  constexpr int kFoldWarps = kFoldThreads / 32;
  __shared__ float sv[kFoldWarps];
  __shared__ int sk[kFoldWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (n_vblocks == 1) {
    Cand c{CUDART_INF_F, INT_MAX};
    for (int p = threadIdx.x; p < parts_per_vblock; p += kFoldThreads) {
      const Cand q{part_val[p], part_row[p]};
      if (nan_first_better(q, c)) c = q;
    }
    const Cand b = block_nan_first<kFoldThreads>(c);
    if (threadIdx.x == 0) {
      *out_val = b.v;
      *out_id = b.row == INT_MAX ? sentinel : ids[b.row];
    }
    return;
  }

  float bv = CUDART_INF_F;
  int bid = sentinel;
  for (int vb = warp; vb < n_vblocks; vb += kFoldWarps) {
    Cand c{CUDART_INF_F, INT_MAX};
    for (int p = lane; p < parts_per_vblock; p += 32) {
      const int i = vb * parts_per_vblock + p;
      const Cand q{part_val[i], part_row[i]};
      if (nan_first_better(q, c)) c = q;
    }
    c = warp_nan_first(c);
    if (!isnan(c.v) && c.row != INT_MAX) {
      const int id = ids[c.row];
      if (lex_better(c.v, id, bv, bid)) {
        bv = c.v;
        bid = id;
      }
    }
  }
  warp_lex(bv, bid);
  if (lane == 0) {
    sv[warp] = bv;
    sk[warp] = bid;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kFoldWarps; ++w)
      if (lex_better(sv[w], sk[w], sv[0], sk[0])) {
        sv[0] = sv[w];
        sk[0] = sk[w];
      }
    *out_val = sv[0];
    *out_id = sk[0];
  }
}

}  // namespace popstep

extern "C" {

// Partials: one (value, row) per thread block of kWarps warps, one warp per
// child.  Dynamic shared memory: kWarps * n_vars floats.
int popstep_partials(const signed char* parent, const int* starts,
                     const int* ends, const int* ok, int n_rows, int n_vars,
                     int bits, float lo, float scale, int obj_id,
                     const float* c0, const float* c1, int m, float param,
                     int vblock, int chunk, int n_vblocks,
                     int chunks_per_vblock, float* part_val, int* part_row,
                     void* stream) {
  using namespace popstep;
  PartialArgs a{parent, starts, ends, ok, n_rows, n_vars, bits,
                lo, scale, ObjParams{c0, c1, m, param}, vblock, chunk,
                chunks_per_vblock, part_val, part_row};
  const dim3 grid(n_vblocks * chunks_per_vblock);
  const size_t smem = sizeof(float) * kWarps * n_vars;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obj_id) {
    case kQuadratic:
      popstep_partials_kernel<kQuadratic><<<grid, kThreads, smem, st>>>(a);
      break;
    case kRastrigin:
      popstep_partials_kernel<kRastrigin><<<grid, kThreads, smem, st>>>(a);
      break;
    case kAckley:
      popstep_partials_kernel<kAckley><<<grid, kThreads, smem, st>>>(a);
      break;
    case kGriewank:
      popstep_partials_kernel<kGriewank><<<grid, kThreads, smem, st>>>(a);
      break;
    case kShekel:
      popstep_partials_kernel<kShekel><<<grid, kThreads, smem, st>>>(a);
      break;
    case kBeckerLago:
      popstep_partials_kernel<kBeckerLago><<<grid, kThreads, smem, st>>>(a);
      break;
    case kSample2d:
      popstep_partials_kernel<kSample2d><<<grid, kThreads, smem, st>>>(a);
      break;
    case kXor:
      popstep_partials_kernel<kXor><<<grid, kThreads, smem, st>>>(a);
      break;
    case kRemoteSensing:
      popstep_partials_kernel<kRemoteSensing>
          <<<grid, kThreads, smem, st>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Fold: one block; writes the step's (value, child id).
int popstep_fold(const float* part_val, const int* part_row, const int* ids,
                 int n_vblocks, int parts_per_vblock, int sentinel,
                 float* out_val, int* out_id, void* stream) {
  using namespace popstep;
  popstep_fold_kernel<<<1, kFoldThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      part_val, part_row, ids, n_vblocks, parts_per_vblock, sentinel,
      out_val, out_id);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
