// popmin: (min, argmin) of a population's values — the MasPar rank() step
// (paper step 4, "find the minimum of the values").
//
// Replaces repro/kernels/popmin/kernel.py:popmin (the Pallas TPU kernel
// behind repro.kernels.popmin.ops.population_min).  The TPU kernel folds its
// tiles in grid order with `local < min`, which needs the grid to run in
// order (Hopper's blocks do not) and lets a NaN in any tile after the first
// hide that tile's minimum.  This port computes what repro/kernels/popmin/
// ref.py computes, jnp.min / jnp.argmin: a NaN wins at its first index, else
// the smallest value, ties to the smallest index.  Two launches, race-free:
//  * popmin_partials_kernel — one thread block per tile of values writes
//    the tile's NaN-first (value, index);
//  * popmin_fold_kernel — one thread block folds the partials by the same
//    rule (popstep's fold with one virtual block).
// The rule is a total order on (value, index), so the result does not
// depend on the order the blocks ran in.
//
// What bounds it: bytes, P float32 values read once (4.2 MB at P = 2^20,
// ~1.25 us at 3.35 TB/s); at the remote-sensing population (P = 5,439,
// 22 KB) the two launches cost more than the bytes.  Threads read
// neighbouring values, reduce in registers, then by warp shuffles and one
// shared-memory pass per block (dgo::block_nan_first).
//
// Built by kernel.py (through kernels/_build.py) with nvcc for sm_90a into a
// shared library with a plain C interface; every entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dgo_device.cuh"

namespace popmin {

using namespace dgo;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    popmin_partials_kernel(const float* vals, int n, int tile,
                           float* part_val, int* part_row) {
  const long long row0 = static_cast<long long>(blockIdx.x) * tile;
  const int row_end = static_cast<int>(min(row0 + tile,
                                           static_cast<long long>(n)));
  Cand c{CUDART_INF_F, INT_MAX};
  for (int i = static_cast<int>(row0) + threadIdx.x; i < row_end;
       i += kThreads) {
    const Cand q{vals[i], i};
    if (nan_first_better(q, c)) c = q;
  }
  const Cand b = block_nan_first<kThreads>(c);
  if (threadIdx.x == 0) {
    part_val[blockIdx.x] = b.v;
    part_row[blockIdx.x] = b.row;
  }
}

__global__ void __launch_bounds__(kThreads)
    popmin_fold_kernel(const float* part_val, const int* part_row,
                       int n_parts, float* out_val, int* out_idx) {
  Cand c{CUDART_INF_F, INT_MAX};
  for (int p = threadIdx.x; p < n_parts; p += kThreads) {
    const Cand q{part_val[p], part_row[p]};
    if (nan_first_better(q, c)) c = q;
  }
  const Cand b = block_nan_first<kThreads>(c);
  if (threadIdx.x == 0) {
    *out_val = b.v;
    *out_idx = b.row;
  }
}

}  // namespace popmin

extern "C" {

// Partials: one (value, index) per tile of `tile` values, ceil(n / tile)
// thread blocks.
int popmin_partials(const float* vals, int n, int tile, float* part_val,
                    int* part_row, void* stream) {
  using namespace popmin;
  const int grid = static_cast<int>((static_cast<long long>(n) + tile - 1) /
                                    tile);
  popmin_partials_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      vals, n, tile, part_val, part_row);
  return static_cast<int>(cudaGetLastError());
}

// Fold: one block; writes the population's (min, argmin).
int popmin_fold(const float* part_val, const int* part_row, int n_parts,
                float* out_val, int* out_idx, void* stream) {
  using namespace popmin;
  popmin_fold_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part_val, part_row, n_parts, out_val, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
