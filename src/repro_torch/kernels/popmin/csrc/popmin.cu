// popmin: (min, argmin) of a population's values — the MasPar rank() step
// (paper step 4, "find the minimum of the values").
//
// Replaces repro/kernels/popmin/kernel.py:popmin (the Pallas TPU kernel
// behind repro.kernels.popmin.ops.population_min).  The TPU kernel folds its
// tiles in grid order with `local < min`, which needs the grid to run in
// order (Hopper's blocks do not) and lets a NaN in any tile after the first
// hide that tile's minimum.  This port computes what repro/kernels/popmin/
// ref.py computes, jnp.min / jnp.argmin: a NaN wins at its first index, else
// the smallest value, ties to the smallest index (a -0.0/0.0 tie too, with
// the winner's own bits).  The rule is a total order on (value, index), so
// the result depends neither on the order blocks run in nor on the launch's
// shape.
//
// What bounds it: bytes, P float32 values read once (4.2 MB at P = 2^20,
// ~1.25 us at 3.35 TB/s; 67 MB at 2^24, ~20 us).  At the packed main path's
// populations (P = 287 and 5,439, at most 22 KB) the floor is one launch.
// One launch a call, in one of two shapes that the wrapper picks from P:
//  * one block (max_blocks = 1): the fewest threads, from a warp up to
//    kOneBlockThreads, that read every value in one round of loads (more
//    rounds past that) write (value, index).  No state, no second launch;
//  * a grid (max_blocks > 1): up to the blocks the card holds at once
//    (popmin_grid), fewer when P is smaller than a round of loads.  Each
//    block grid-strides over the values, stores its winner to a slot of
//    `state` and takes a ticket; the last block reads the slots back and
//    folds them by the same rule (fold_parts, which popmin_fold_kernel runs
//    alone, for checks), writes the result and leaves the slots and the
//    ticket zero for the next launch on the stream.  The ticket has no
//    fence, which would cost the wait for the slot store's acknowledgement:
//    a slot is non-zero once written, and the last block reads one again
//    until it is.  `state` is one int32 buffer: the ticket, a pad, then a
//    64-bit slot per block; the caller keeps one per stream, zeroed once.
//    The ticket assumes nothing of the order blocks start in; block 0
//    polling the slots (POPMIN_POLL) saved one round trip on an H100 but
//    waits on blocks that may not have started.  (Clusters of 8 or 16
//    blocks folding through distributed shared memory, with one ticket a
//    cluster or none for one cluster, measured slower at every P on an
//    H100: PERF.md.)
// Every thread has kUnroll loads of kVec values (16 bytes at kVec = 4) in
// flight before its first comparison, and compares by a cheap rule (a
// strictly smaller value wins, the thread's rows in increasing order; a
// NaN only raises a flag, and a thread that saw one walks its values again
// by the full rule), so the compares keep up with the loads: with the full
// rule on every value the compares, not the bytes, bounded a block.
// Blocks and warps fold by the full rule (dgo::block_nan_first, two
// redux.sync minima a warp).  The values before the first kVec-aligned
// address (a view such as v[1:]) and after the last whole vector are read
// one by one by block 0.  Indices fit in 32 bits (P < 2^31); vector
// offsets are 64-bit.
//
// Variants, for probe_packed.py (-D switches; the defaults are the kernel):
//  POPMIN_THREADS (512)        threads a block of the grid;
//  POPMIN_ONE_THREADS (1024)   the most threads of the one-block launch;
//  POPMIN_VEC (4)              values a load: 1, 2 or 4;
//  POPMIN_UNROLL (4)           loads a thread has in flight;
//  POPMIN_FENCED               an acquire-release ticket (the slot store
//                              acknowledged before the ticket is taken);
//  POPMIN_POLL                 no ticket: block 0 folds, reading each slot
//                              until it is written (it waits on blocks
//                              that may not have started, which only a
//                              cooperative launch rules out);
//  POPMIN_COOP                 the grid by cudaLaunchCooperativeKernel;
//  POPMIN_NO_FOLD              no ticket and no fold: each block's winner
//                              alone, block 0's written (wrong output; the
//                              cost of the fold by difference).
//
// Built by kernel.py (through kernels/_build.py) with nvcc for sm_90a into a
// shared library with a plain C interface; every entry point launches on the
// caller's stream and returns the CUDA error.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dgo_device.cuh"

#ifndef POPMIN_THREADS
#define POPMIN_THREADS 512
#endif
#ifndef POPMIN_ONE_THREADS
#define POPMIN_ONE_THREADS 1024
#endif
#ifndef POPMIN_VEC
#define POPMIN_VEC 4
#endif
#ifndef POPMIN_UNROLL
#define POPMIN_UNROLL 4
#endif

namespace popmin {

using namespace dgo;

constexpr int kThreads = POPMIN_THREADS;
constexpr int kOneBlockThreads = POPMIN_ONE_THREADS;
constexpr int kVec = POPMIN_VEC;
constexpr int kUnroll = POPMIN_UNROLL;
static_assert(kVec == 1 || kVec == 2 || kVec == 4, "POPMIN_VEC: 1, 2 or 4");
static_assert(kThreads >= 2 * kVec && kThreads % 32 == 0, "whole warps");
static_assert(kOneBlockThreads >= 32 && kOneBlockThreads <= 1024 &&
              (kOneBlockThreads & (kOneBlockThreads - 1)) == 0,
              "POPMIN_ONE_THREADS: a power of two, 32..1024");

template <int V> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

__device__ __forceinline__ void take(Cand& c, float v, int row) {
  const Cand q{v, row};
  if (nan_first_better(q, c)) c = q;
}

// Walks this thread's vectors of the body, rows in increasing order.
// kExact: the NaN-first rule (take).  Else the cheap one: a strictly
// smaller value wins, so a tie keeps the earlier row, and a NaN only sets
// any_nan.
template <int kT, bool kExact>
__device__ __forceinline__ void walk(const float* body, long long n_vec,
                                     int head, Cand& c, bool& any_nan) {
  using Vec = typename VecOf<kVec>::T;
  const Vec* vec = reinterpret_cast<const Vec*>(body);
  const long long step = static_cast<long long>(gridDim.x) * kT * kUnroll;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kT * kUnroll +
                      threadIdx.x;
       i0 < n_vec; i0 += step) {
    Vec x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * kT < n_vec) x[u] = __ldg(vec + i0 + u * kT);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kT;
      if (i < n_vec) {
        const float* e = reinterpret_cast<const float*>(&x[u]);
        const int row = head + static_cast<int>(i) * kVec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if constexpr (kExact) {
            take(c, e[k], row + k);
          } else {
            any_nan |= isnan(e[k]);
            if (e[k] < c.v) {
              c.v = e[k];
              c.row = row + k;
            }
          }
        }
      }
    }
  }
}

// This thread's NaN-first (value, index) over its share of vals[0, n).
template <int kT>
__device__ __forceinline__ Cand scan(const float* vals, int n) {
  // vals is 4-byte aligned; head values come before the first kVec-aligned
  // one, the tail after the last whole vector
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(vals) >> 2) % kVec);
  const int head = min(n, (kVec - mis) % kVec);
  const long long n_vec = (n - head) / kVec;
  const int tail_at = head + static_cast<int>(n_vec) * kVec;
  const long long first =
      static_cast<long long>(blockIdx.x) * kT * kUnroll + threadIdx.x;
  Cand c{CUDART_INF_F, INT_MAX};
  bool any_nan = false;
  walk<kT, false>(vals + head, n_vec, head, c, any_nan);
  // nothing below +inf: the thread's first row holds a +inf (or a NaN)
  if (c.row == INT_MAX && first < n_vec)
    c.row = head + static_cast<int>(first) * kVec;
  if (any_nan) {                        // rare: walk again by the full rule
    c = Cand{CUDART_INF_F, INT_MAX};
    walk<kT, true>(vals + head, n_vec, head, c, any_nan);
  }
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    if (t < head) take(c, vals[t], t);
    else if (t >= kVec && t - kVec < n - tail_at)
      take(c, vals[tail_at + t - kVec], tail_at + t - kVec);
  }
  return c;
}

// The NaN-first (value, index) of n_parts partials, part(p) giving the
// p-th, written by thread 0.  Called by every thread of a block of kT.
template <int kT, typename Part>
__device__ __forceinline__ void fold_parts(int n_parts, Part part,
                                           float* out_val, int* out_idx) {
  Cand c{CUDART_INF_F, INT_MAX};
  for (int p = threadIdx.x; p < n_parts; p += kT) {
    const Cand q = part(p);
    take(c, q.v, q.row);
  }
  const Cand b = block_nan_first<kT>(c);
  if (threadIdx.x == 0) {
    *out_val = b.v;
    *out_idx = b.row;
  }
}

using Slot = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// The grid's ticket: without a fence, so a block's slot store and its
// ticket travel together (POPMIN_FENCED: acquire-release, for the probe).
#ifdef POPMIN_FENCED
constexpr cuda::memory_order kTicketOrder = cuda::memory_order_acq_rel;
#else
constexpr cuda::memory_order kTicketOrder = cuda::memory_order_relaxed;
#endif
#ifdef POPMIN_NO_FOLD
constexpr bool kFold = false;   // block 0's winner alone: wrong, for timing
#else
constexpr bool kFold = true;
#endif
#ifdef POPMIN_POLL
constexpr bool kPoll = true;
#else
constexpr bool kPoll = false;
#endif

template <int kT>
__global__ void __launch_bounds__(kT)
    popmin_kernel(const float* vals, int n, int* state, float* out_val,
                  int* out_idx) {
  const Cand b = block_nan_first<kT>(scan<kT>(vals, n));
  if (!kFold || gridDim.x == 1) {
    if (threadIdx.x == 0 && blockIdx.x == 0) {
      *out_val = b.v;
      *out_idx = b.row;
    }
    return;
  }
  // Thread 0 stores the block's winner to its 64-bit slot (the value's
  // bits high, the row plus one low, so a slot not yet written reads 0),
  // then takes the ticket.  The last block reads every slot, again while it
  // reads 0 (a store issued before its block's ticket, not yet landed),
  // empties it for the next launch and folds; then resets the ticket.
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(state + 2);
  __shared__ int last;
  if (threadIdx.x == 0) {
    Slot(slots[blockIdx.x]).store(
        (static_cast<unsigned long long>(__float_as_uint(b.v)) << 32) |
            (static_cast<unsigned>(b.row) + 1u),
        cuda::memory_order_relaxed);
    if constexpr (kPoll) {
      last = blockIdx.x == 0;
    } else {
      cuda::atomic_ref<int, cuda::thread_scope_device> ticket(state[0]);
      last = ticket.fetch_add(1, kTicketOrder) ==
             static_cast<int>(gridDim.x) - 1;
    }
  }
  __syncthreads();
  if (!last) return;
  fold_parts<kT>(
      gridDim.x,
      [&](int p) {
        Slot s(slots[p]);
        unsigned long long w;
        while ((w = s.load(cuda::memory_order_relaxed)) == 0ull) {
        }
        s.store(0ull, cuda::memory_order_relaxed);
        return Cand{__uint_as_float(static_cast<unsigned>(w >> 32)),
                    static_cast<int>(static_cast<unsigned>(w) - 1u)};
      },
      out_val, out_idx);
  if (threadIdx.x == 0) state[0] = 0;
}

// The grid's fold alone over given partials, one block; for checks of
// fold_parts.
__global__ void __launch_bounds__(kThreads)
    popmin_fold_kernel(const float* part_val, const int* part_row,
                       int n_parts, float* out_val, int* out_idx) {
  fold_parts<kThreads>(
      n_parts, [&](int p) { return Cand{part_val[p], part_row[p]}; },
      out_val, out_idx);
}

// One block of the fewest threads, kT halved down to a warp, that read
// vals[0, n) in one round of loads.
template <int kT>
void launch_one_block(const float* vals, int n, float* out_val, int* out_idx,
                      cudaStream_t stream) {
  if constexpr (kT > 32) {
    if (n <= static_cast<long long>(kT / 2) * kUnroll * kVec) {
      launch_one_block<kT / 2>(vals, n, out_val, out_idx, stream);
      return;
    }
  }
  popmin_kernel<kT><<<1, kT, 0, stream>>>(vals, n, nullptr, out_val, out_idx);
}

}  // namespace popmin

extern "C" {

// Blocks of the grid launch that the card holds at once: the most the grid
// launch uses, and the slots its state needs.
int popmin_grid(int* blocks) {
  using namespace popmin;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, popmin_kernel<kThreads>, kThreads, 0);
  *blocks = sms * per_sm;
  return static_cast<int>(err);
}

// (min, argmin) of vals[0, n): one block when max_blocks <= 1, else a grid
// of at most max_blocks blocks (fewer when P is less than a round of loads
// for each), with `state` holding 2 + 2 * max_blocks int32, all zero, as
// the launch before on this stream leaves it.
int popmin_launch(const float* vals, int n, int max_blocks, int* state,
                  float* out_val, int* out_idx, void* stream) {
  using namespace popmin;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_blocks <= 1) {
    launch_one_block<kOneBlockThreads>(vals, n, out_val, out_idx, s);
  } else {
    const long long round = static_cast<long long>(kThreads) * kUnroll * kVec;
    const int grid = static_cast<int>(std::min(
        static_cast<long long>(max_blocks), (n + round - 1) / round));
#ifdef POPMIN_COOP
    void* args[] = {&vals, &n, &state, &out_val, &out_idx};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(popmin_kernel<kThreads>), grid,
        kThreads, args, 0, s);
    if (err) return static_cast<int>(err);
#else
    popmin_kernel<kThreads><<<grid, kThreads, 0, s>>>(vals, n, state,
                                                      out_val, out_idx);
#endif
  }
  return static_cast<int>(cudaGetLastError());
}

// The partials' fold alone: one block; writes the NaN-first (value, index).
int popmin_fold(const float* part_val, const int* part_row, int n_parts,
                float* out_val, int* out_idx, void* stream) {
  using namespace popmin;
  popmin_fold_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part_val, part_row, n_parts, out_val, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
