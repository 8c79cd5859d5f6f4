// popstep: one DGO population step on the card — child generation, decode,
// objective evaluation and the (min, argmin) selection, for every child of
// one parent, in one launch.
//
// Replaces repro/kernels/popstep/kernel.py:_popstep_kernel (the Pallas TPU
// kernel behind repro.kernels.popstep.ops.population_step_ids).  It computes
// what that kernel computes, not its blocks:
//
//  * Child levels in closed form.  Inverting Gray segment [s, e) of the
//    parent flips binary bit j iff (j - s) is even inside [s, e), and for
//    every j >= e iff (e - s) is odd (repro/core/population.py
//    segment_patterns).  So each variable's child level is its parent level
//    XOR a mask of a few shifts (dgo::child_level), and only the variables
//    that overlap the pattern are decoded again: the rest of the child's
//    point is the parent's.
//  * Decode is bit-exact with the reference: lo + level * scale with the
//    multiply and the add rounded separately (dgo::decode_level).
//  * The parent's work is done once per thread block.  Each block decodes
//    the parent into shared memory and, for the remote-sensing MLP, stages
//    the samples and labels there and computes the parent's hidden layer
//    H_p (m samples x 42 units).  Hidden unit j
//    depends only on W1[:, j] and b1[j]; a child whose pattern touches none
//    of those 8 variables has exactly the parent's activations there (the
//    same inputs through the same arithmetic), so it reads H_p[j] and
//    recomputes only the units its row's mask marks (built on the host from
//    the segment table; 14.9 of 42 on average at 680 x 4 bits).  Layer 2
//    still runs over j = 0..41 in order, so every child's value is bitwise
//    the value of a full evaluation.
//  * A persistent grid.  As many blocks as the card holds at once (fewer
//    when the population is small), one child per warp at a time; warps take
//    children in order of descending cost (the host sorts the rows by the
//    number of marked units), the first dealt round the blocks and the rest
//    from a global counter.  No second wave of blocks.  (A static snake
//    over the same order was slower, and the rows in order slower still:
//    the marked units do not price a child exactly; PERF.md.)
//  * Race-free selection in the same launch.  Each child's value goes to a
//    (K,) buffer, and its virtual block's winner is kept as a 64-bit
//    atomicMin of an order-preserving key (NaN first; the value, with -0 and
//    +0 equal; the row).  The last block to finish (an acquire-release
//    ticket) reads each block's winner back (its value from the key, or
//    from the buffer for a NaN or a zero, so that its sign survives),
//    applies the cross-block rule (fold_vblocks: NaN blocks are dropped,
//    the rest fold lexicographically on (value, child id) from (+inf,
//    sentinel), and with one virtual block its winner is the result as it
//    is; repro/core/distributed.py:246-253), writes (value, id) and resets
//    the keys, the counter and the ticket for the next launch on the
//    stream.  Both rules are associative and commutative, so the result
//    does not depend on the order warps ran in.
//    popstep_fold_kernel runs the same cross-block rule over given partials,
//    for checks.
//  * Shards.  A mesh of n_shards virtual shards (repro/core/distributed.py
//    _build_shard_step) is the virtual blocks in n_shards equal runs: each
//    run folds by the cross-block rule above, then a NaN shard wins the
//    step (the reference's jnp.min over the gathered shard values,
//    :272), which then carries no id, else the shards fold
//    lexicographically from (+inf, sentinel) (fold_shards).  A dead shard
//    is rows with ok = 0.
//  * Restarts.  One launch steps R parents over the same rows: blockIdx.y
//    is the restart, with its own parent, value buffer, virtual-block keys,
//    counter, ticket and output pair, over gridDim.x blocks of the
//    persistent grid.  A restart whose live flag is 0 (stalled, finished or
//    padding) returns at once: no child is evaluated and its outputs are
//    left as they were.  R = 1 without a live flag is the one-parent step.
//
// What bounds it: operations.  At the paper's largest problem (the
// 680-variable remote-sensing MLP, 5,439 children, 256 samples) a full
// evaluation of every child is ~1.75 GFLOP against ~170 KB of inputs and
// outputs: ~26 us at the H100's 67 TFLOP/s for float32 outside the tensor
// cores; the work that reuse leaves is ~1.23 GFLOP (~18 us).  The precise
// tanhf costs more issue slots than the multiply-adds and stays
// (tanh.approx misses the 1e-5 bar).  The MLP reads each weight once per
// 4 samples from a shared-memory broadcast, and lanes stride over the
// samples.  What limits the child loop below that is not measured (no
// ncu on the card's machine).
//
// Rastrigin's step (1,000 variables, 8 bits: 15,999 children of 1,000
// terms) was bound by issue: a precise cosf is ~40 instructions, and every
// child took one a term.  A term is one function of the variable's level
// (one lo, one scale), so at <= 8 bits each block computes the 2^bits
// terms once (fill_term_table) and a child looks its terms up
// (table_value): per term a shared load of the parent's level, at most an
// XOR, a conflict-free shared load of the term, an add.  Two shared loads
// a lane-term now bound it (H100: one warp-wide 4-byte load a clock an
// SM).  The table is the same precise cosf through rastrigin_term and the
// sum keeps eval's order, so every child's value is bitwise the cosine
// path's.  Below ops.TABLE_MIN_VARS variables the fill costs more than the
// terms it saves, and the cosine path stays.
//
// Built by kernel.py (through kernels/_build.py) with nvcc for sm_90a (no
// --use_fast_math) into a shared library with a plain C interface; every
// entry point launches on the caller's stream and returns the CUDA error.

#include <climits>

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dgo_device.cuh"
#include "objectives.cuh"

namespace popstep {

using namespace dgo;

constexpr int kWarps = 8;               // a child each (ops.WARPS)
constexpr int kThreads = kWarps * 32;
// the parent's bit string (n_vars * bits <= 32 * n_vars bytes) is staged
// in the child points' area (kWarps * n_vars floats)
static_assert(kWarps >= 8, "the parent's bit string must fit the child "
                           "points' shared memory");

// Level of variable v in the parent: its bits-wide MSB-first field of the
// 0/1 bit string (in shared memory).
__device__ __forceinline__ unsigned parent_level(const signed char* bits_str,
                                                 int v, int bits) {
  unsigned level = 0u;
  for (int t = 0; t < bits; ++t)
    level = (level << 1) | static_cast<unsigned>(bits_str[v * bits + t]);
  return level;
}

// The in-block rule as one unsigned key, smaller is better: a NaN first
// (high word 0), else the value in an order-preserving map with -0 taken
// as +0; the row in the low word breaks ties.
__device__ __forceinline__ unsigned long long cand_key(float v, int row) {
  return (static_cast<unsigned long long>(nan_first_key(v)) << 32) |
         static_cast<unsigned>(row);
}

// The value behind a key, read from ``vals`` only where the key does not
// hold it bit for bit (a NaN, or a zero that may be -0).
__device__ __forceinline__ float key_value(unsigned long long key,
                                           const float* vals) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  if (hi == 0u || hi == 0x80000000u)
    return __ldcg(vals + static_cast<unsigned>(key));
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

// The cross-block rule.  ``cand_of(vb)`` gives virtual block vb's winner
// (value, row), called by all 32 lanes of a warp and the same on each;
// row INT_MAX means none.  With one virtual block its winner is the result
// as it is (NaN included); with several, NaN blocks are dropped and the
// rest fold lexicographically on (value, ids[row]) from (+inf, sentinel).
// Called by every thread of one block of kThreads; thread 0 writes the
// result.
template <class CandOf>
__device__ void fold_vblocks(int n_vblocks, CandOf cand_of, const int* ids,
                             int sentinel, float* out_val, int* out_id) {
  __shared__ float sv[kWarps];
  __shared__ int sk[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (n_vblocks == 1) {
    if (warp == 0) {
      const Cand c = cand_of(0);
      if (lane == 0) {
        *out_val = c.v;
        *out_id = c.row == INT_MAX ? sentinel : ids[c.row];
      }
    }
    return;
  }
  float bv = CUDART_INF_F;
  int bid = sentinel;
  for (int vb = warp; vb < n_vblocks; vb += kWarps) {
    const Cand c = cand_of(vb);
    const int id = c.row == INT_MAX ? sentinel : ids[c.row];
    if (!isnan(c.v) && c.row != INT_MAX) {
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
    for (int w = 1; w < kWarps; ++w)
      if (lex_better(sv[w], sk[w], sv[0], sk[0])) {
        sv[0] = sv[w];
        sk[0] = sk[w];
      }
    *out_val = sv[0];
    *out_id = sk[0];
  }
}

// The shard-level rule: the virtual blocks in n_shards runs of
// ``per_shard``; each run folds by the cross-block rule (one block: its
// winner as it is; several: NaN blocks dropped, the rest lexicographically
// from (+inf, sentinel)), then a NaN shard wins with id ``sentinel``, else
// the shards fold lexicographically from (+inf, sentinel).  ``cand_of``
// may differ between the lanes of a warp.  Called by every thread of one
// block of kThreads; thread 0 writes the result.
template <class CandOf>
__device__ void fold_shards(int n_shards, int per_shard, CandOf cand_of,
                            const int* ids, int sentinel, float* out_val,
                            int* out_id) {
  __shared__ float sv[kWarps];
  __shared__ int sk[kWarps];
  __shared__ float snan[kWarps];
  __shared__ int shas[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float bv = CUDART_INF_F;
  int bid = sentinel;
  bool has_nan = false;
  float nan_v = 0.0f;
  for (int s = warp; s < n_shards; s += kWarps) {
    float v = CUDART_INF_F;
    int id = sentinel;
    if (per_shard == 1) {
      const Cand c = cand_of(s);
      v = c.v;
      id = c.row == INT_MAX ? sentinel : ids[c.row];
    } else {
      for (int vb = s * per_shard + lane; vb < (s + 1) * per_shard;
           vb += 32) {
        const Cand c = cand_of(vb);
        if (!isnan(c.v) && c.row != INT_MAX) {
          const int cid = ids[c.row];
          if (lex_better(c.v, cid, v, id)) {
            v = c.v;
            id = cid;
          }
        }
      }
      warp_lex(v, id);
    }
    if (isnan(v)) {
      if (!has_nan) nan_v = v;
      has_nan = true;
    } else if (lex_better(v, id, bv, bid)) {
      bv = v;
      bid = id;
    }
  }
  if (lane == 0) {
    sv[warp] = bv;
    sk[warp] = bid;
    snan[warp] = nan_v;
    shas[warp] = has_nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w)
      if (shas[w]) {
        *out_val = snan[w];
        *out_id = sentinel;
        return;
      }
    for (int w = 1; w < kWarps; ++w)
      if (lex_better(sv[w], sk[w], sv[0], sk[0])) {
        sv[0] = sv[w];
        sk[0] = sk[w];
      }
    *out_val = sv[0];
    *out_id = sk[0];
  }
}

struct StepArgs {
  const signed char* parent;       // (R, n_vars * bits) 0/1 parent bit strings
  const int* starts;               // (K,) segment starts
  const int* ends;                 // (K,) segment ends
  const int* ok;                   // (K,) 0 -> the row is +inf
  const unsigned long long* masks; // (K,) hidden units to recompute, or
                                   // null (objectives without reuse)
  const int* order;                // (K,) rows, costliest first, or null
                                   // (the rows in order)
  const int* ids;                  // (K,) global child ids
  int n_rows;                      // K
  int n_vars;
  int bits;
  float lo;
  float scale;
  ObjParams obj;
  int vblock;                      // rows per virtual block
  int n_vblocks;
  int n_shards;                    // runs of n_vblocks / n_shards blocks
  int sentinel;                    // the cross-block fold's start id
  int table;                       // Rastrigin: terms from the block's
                                   // table of levels (bits <= 8)
  const bool* live;                // (R,) 0 -> restart skipped, or null
  float* vals;                     // (R, K) each child's value
  unsigned long long* keys;        // (R, n_vblocks) all ones between launches
  int* ctl;                        // (R, 2) [work counter, ticket], 0 between
  float* out_val;                  // (R,)
  int* out_id;                     // (R,)
};

// A child at a position of the work order: its row and what the row holds.
struct Child {
  int row;
  int ok;
  int s;                           // its segment [s, e)
  int e;
  unsigned long long mask;         // hidden units to recompute (RS)
};

__device__ __forceinline__ Child child_at(const StepArgs& a, int idx) {
  const int row = a.order != nullptr ? a.order[idx] : idx;
  return Child{row, a.ok[row], a.starts[row], a.ends[row],
               a.masks != nullptr ? a.masks[row] : 0ull};
}

// Rastrigin's term of every level, 2^bits of them, one copy per bank:
// copy c of level l is word 32 l + c, and lane c reads copy c, so a warp's
// 32 lookups never conflict, whatever the levels.  Filled by every thread
// of the block from the parent's encoding (one precise cosf a level); a
// thread writes its level's copies starting at its own lane's bank, so
// the stores do not conflict either.
__device__ void fill_term_table(float* tab, int bits, float lo,
                                float scale) {
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x; l < (1 << bits); l += kThreads) {
    const float t = rastrigin_term(decode_level(l, lo, scale));
#pragma unroll 8
    for (int c = 0; c < 32; ++c) tab[32 * l + ((c + lane) & 31)] = t;
  }
}

// A child's Rastrigin value from the term table (``tab_l``: this lane's
// copy of level 0).  Its level of variable k is the parent's before the
// segment's first variable v_lo, the parent's XOR the tail (all ones when
// e - s is odd, else none) from the first variable wholly at or past e,
// v_hi, and dgo::child_level only for the variables in between, which the
// segment touches (one or two but at the top of the segment tree).  Lane
// l adds variables l, l + 32, ... in that order, as Objective::eval does
// over the decoded point, and total() is the same: the same bits.
__device__ __forceinline__ float table_value(const unsigned* plv,
                                             const float* tab_l, int n,
                                             int bits, int s, int e,
                                             unsigned even_mask, int lane) {
  const int v_lo = s / bits;
  const int v_hi = (e + bits - 1) / bits;
  const unsigned tail = ((e - s) & 1) ? (1u << bits) - 1u : 0u;
  float acc = 0.0f;
  int k = lane;
#pragma unroll 4
  for (; k < v_lo; k += 32) acc += tab_l[32 * plv[k]];
  for (; k < v_hi; k += 32)
    acc += tab_l[32 * child_level(plv[k], k, bits, s, e, even_mask)];
#pragma unroll 4
  for (; k < n; k += 32) acc += tab_l[32 * (plv[k] ^ tail)];
  return Objective<kRastrigin>::total(acc, n);
}

// Dynamic shared memory (floats): the parent's point and levels
// (2 * n_vars), the remote-sensing data (RS::smem_floats(m): the parent's
// hidden layer, the samples, the labels), one child point per warp
// (kWarps * n_vars), which first holds the parent's bit string; on
// Rastrigin's table path that area holds the term table (32 << bits)
// instead, and no child point is written.
template <int OBJ>
__global__ void __launch_bounds__(kThreads, 2)
    popstep_kernel(StepArgs a) {
  constexpr bool kReuse = OBJ == kRemoteSensing;
  // uniform across the grid: Rastrigin's terms read from a table
  const bool table = OBJ == kRastrigin && a.table;
  // restart r: its parent, its value buffer, its selection state and its
  // output pair; a restart that is not live does nothing
  const int r = blockIdx.y;
  if (a.live != nullptr && !a.live[r]) return;
  const signed char* parent =
      a.parent + static_cast<size_t>(r) * (a.n_vars * a.bits);
  float* vals = a.vals + static_cast<size_t>(r) * a.n_rows;
  unsigned long long* keys = a.keys + static_cast<size_t>(r) * a.n_vblocks;
  int* ctl = a.ctl + 2 * r;
  using RS = Objective<kRemoteSensing>;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xp = smem;
  unsigned* plv = reinterpret_cast<unsigned*>(smem + a.n_vars);
  float* data = smem + 2 * a.n_vars;
  float* xs0 = data + (kReuse ? RS::smem_floats(a.obj.m) : 0);
  float* xs = xs0 + warp * a.n_vars;

  // the warp's first child, read while the block prepares the parent: the
  // first positions of the work order go round the blocks, so that every
  // block starts with its share of the costliest children
  int idx = warp * gridDim.x + blockIdx.x;
  Child c = idx < a.n_rows ? child_at(a, idx) : Child{};

  // the parent, once per block: its bit string in one coalesced read (and
  // the remote-sensing samples beside it), then its levels and point, then
  // its hidden layer
  signed char* bits_s = reinterpret_cast<signed char*>(xs0);
  const int n_bits = a.n_vars * a.bits;
#pragma unroll 8
  for (int i = threadIdx.x; i < n_bits; i += kThreads)
    bits_s[i] = parent[i];
  if constexpr (kReuse) RS::stage(a.obj, data);
  __syncthreads();
  for (int v = threadIdx.x; v < a.n_vars; v += kThreads) {
    const unsigned level = parent_level(bits_s, v, a.bits);
    plv[v] = level;
    xp[v] = decode_level(level, a.lo, a.scale);
  }
  __syncthreads();
  if constexpr (kReuse) {
    RS::parent_hidden(xp, a.obj, data);
    __syncthreads();
  }
  const float* tab_l = xs0 + lane;
  if (table) {        // over the bit string, which the levels replaced
    fill_term_table(xs0, a.bits, a.lo, a.scale);
    __syncthreads();
  }

  // the children: the first dealt round the blocks, the rest from the
  // counter (taken one child ahead, so its latency hides behind the work)
  const unsigned even_mask = even_positions(a.bits);
  const int n_dealt = gridDim.x * kWarps;
  while (idx < a.n_rows) {
    int next = a.n_rows;
    if (n_dealt < a.n_rows && lane == 0)
      next = n_dealt + atomicAdd(ctl, 1);
    float v = CUDART_INF_F;
    if (c.ok && table) {                // uniform across the warp
      v = table_value(plv, tab_l, a.n_vars, a.bits, c.s, c.e, even_mask,
                      lane);
    } else if (c.ok) {
      // variables the pattern can touch: [s / bits, end of [s, e)), or to
      // the last variable when the segment's length is odd
      const int v_lo = c.s / a.bits;
      const int v_hi =
          ((c.e - c.s) & 1) ? a.n_vars : (c.e + a.bits - 1) / a.bits;
      for (int k = lane; k < a.n_vars; k += 32)
        xs[k] = (k >= v_lo && k < v_hi)
                    ? decode_level(child_level(plv[k], k, a.bits, c.s, c.e,
                                               even_mask),
                                   a.lo, a.scale)
                    : xp[k];
      __syncwarp();
      if constexpr (kReuse)
        v = RS::eval_reuse(xs, a.obj, lane, data, c.mask);
      else
        v = Objective<OBJ>::eval(xs, a.n_vars, a.obj, lane);
      __syncwarp();                     // xs is rewritten by the next child
    }
    if (lane == 0) {
      vals[c.row] = v;
      atomicMin(keys + c.row / a.vblock, cand_key(v, c.row));
    }
    idx = __shfl_sync(kFullMask, next, 0);
    if (idx < a.n_rows) c = child_at(a, idx);
  }

  // the last block to finish folds the virtual blocks' winners: the
  // barrier and thread 0's release order every warp's writes before the
  // block's ticket; in the last block the ticket's acquire and the barrier
  // order every block's writes before the fold's reads
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> ticket(ctl[1]);
    last = ticket.fetch_add(1, cuda::memory_order_acq_rel) ==
           static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  const auto cand_of = [&](int vb) {
    const unsigned long long k = __ldcg(keys + vb);
    if (k == ~0ull) return Cand{CUDART_INF_F, INT_MAX};
    return Cand{key_value(k, vals),
                static_cast<int>(static_cast<unsigned>(k))};
  };
  if (a.n_shards == 1)
    fold_vblocks(a.n_vblocks, cand_of, a.ids, a.sentinel, a.out_val + r,
                 a.out_id + r);
  else
    fold_shards(a.n_shards, a.n_vblocks / a.n_shards, cand_of, a.ids,
                a.sentinel, a.out_val + r, a.out_id + r);
  __syncthreads();
  for (int vb = threadIdx.x; vb < a.n_vblocks; vb += kThreads)
    keys[vb] = ~0ull;
  if (threadIdx.x == 0) {
    ctl[0] = 0;
    ctl[1] = 0;
  }
}

// The cross-block rule over partial (value, row) pairs in n_vblocks equal
// runs, each run first reduced by the in-block rule (NaN first, then value,
// then row).  One block; for checks of fold_vblocks.
__global__ void __launch_bounds__(kThreads)
    popstep_fold_kernel(const float* part_val, const int* part_row,
                        const int* ids, int n_vblocks, int parts_per_vblock,
                        int sentinel, float* out_val, int* out_id) {
  const int lane = threadIdx.x & 31;
  fold_vblocks(
      n_vblocks,
      [&](int vb) {
        Cand c{CUDART_INF_F, INT_MAX};
        for (int p = lane; p < parts_per_vblock; p += 32) {
          const int i = vb * parts_per_vblock + p;
          const Cand q{part_val[i], part_row[i]};
          if (nan_first_better(q, c)) c = q;
        }
        return warp_nan_first(c);
      },
      ids, sentinel, out_val, out_id);
}

using StepKernel = void (*)(StepArgs);

StepKernel kernel_of(int obj_id) {
  switch (obj_id) {
    case kQuadratic: return popstep_kernel<kQuadratic>;
    case kRastrigin: return popstep_kernel<kRastrigin>;
    case kAckley: return popstep_kernel<kAckley>;
    case kGriewank: return popstep_kernel<kGriewank>;
    case kShekel: return popstep_kernel<kShekel>;
    case kBeckerLago: return popstep_kernel<kBeckerLago>;
    case kSample2d: return popstep_kernel<kSample2d>;
    case kXor: return popstep_kernel<kXor>;
    case kRemoteSensing: return popstep_kernel<kRemoteSensing>;
    default: return nullptr;
  }
}

}  // namespace popstep

extern "C" {

// Blocks of kThreads threads and ``smem`` bytes of dynamic shared memory
// that the card holds at once for objective ``obj_id``: the persistent
// grid.  Also lifts the kernel's dynamic shared-memory limit to the card's.
int popstep_grid(int obj_id, int smem, int* blocks) {
  using namespace popstep;
  const StepKernel fn = kernel_of(obj_id);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (!err) err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err) err = cudaFuncGetAttributes(&attr, fn);
  if (!err) err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin - static_cast<int>(attr.sharedSizeBytes));
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, kThreads, static_cast<size_t>(smem));
  *blocks = sms * per_sm;
  return static_cast<int>(err);
}

// One step of ``restarts`` parents (R): every child's value in ``vals``
// (R, K), each parent's best child's (value, child id) in ``out_val``/
// ``out_id`` (R,); ``live`` (R,) or null skips restarts; the virtual blocks
// fold in ``n_shards`` runs (fold_shards; 1: one fold over all of them).
// ``table`` (Rastrigin at <= 8 bits only) reads the terms from the block's
// table of levels; ``smem`` must then hold it (32 << bits floats past the
// parent's point and levels).
// ``keys`` (R, n_vblocks) must hold all ones and ``ctl`` (R, 2) zeros, as
// the launch before on this stream leaves them.  ``blocks`` is the grid
// of each restart.
int popstep_step(const signed char* parent, float* vals, float* out_val,
                 int* out_id, const int* starts, const int* ends,
                 const int* ok, const unsigned long long* masks,
                 const int* order, const int* ids, int n_rows, int n_vars,
                 int bits, float lo, float scale, int obj_id, const float* c0,
                 const float* c1, int m, float param, int vblock,
                 int n_vblocks, int n_shards, int sentinel, int table,
                 unsigned long long* keys, int* ctl, int restarts,
                 const bool* live, int blocks, int smem, void* stream) {
  using namespace popstep;
  const StepKernel fn = kernel_of(obj_id);
  if (fn == nullptr || restarts < 1 || n_shards < 1 ||
      n_vblocks % n_shards != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (table && (obj_id != kRastrigin || bits > 8))
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a{parent, starts, ends, ok, masks, order, ids, n_rows, n_vars,
             bits, lo, scale, ObjParams{c0, c1, m, param}, vblock, n_vblocks,
             n_shards, sentinel, table, live, vals, keys, ctl, out_val,
             out_id};
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(fn), dim3(blocks, restarts),
      dim3(kThreads), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err ? err : cudaGetLastError());
}

// The cross-block rule alone, over partials: one block; writes (value,
// child id).
int popstep_fold(const float* part_val, const int* part_row, const int* ids,
                 int n_vblocks, int parts_per_vblock, int sentinel,
                 float* out_val, int* out_id, void* stream) {
  using namespace popstep;
  popstep_fold_kernel<<<1, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      part_val, part_row, ids, n_vblocks, parts_per_vblock, sentinel,
      out_val, out_id);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
