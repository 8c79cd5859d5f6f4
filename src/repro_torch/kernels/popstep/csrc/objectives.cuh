// Registry objectives as warp-cooperative device functions for popstep.cu.
//
// Objective<ID>::eval(x, n, p, lane) is called by all 32 lanes of a warp
// with the child's decoded point x[0..n) in shared memory and returns the
// objective value on every lane.  Lanes stride over the variables (or, for
// the data-driven objectives, over the samples) and a butterfly shuffle sum
// combines them in a fixed order, so a child's value does not depend on
// where or when it ran.  The ids match repro_torch/core/objectives.py
// OBJECTIVE_IDS; each function follows that module's batched PyTorch
// expression.  Transcendentals are the precise cosf/expf/tanhf/logf/sqrtf
// (the library is built without --use_fast_math).  The remote-sensing MLP
// is evaluated by eval_reuse instead, beside the parent's hidden layer.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dgo_device.cuh"

namespace popstep {

using dgo::kFullMask;

enum ObjectiveId {
  kQuadratic = 0,
  kRastrigin = 1,
  kAckley = 2,
  kGriewank = 3,
  kShekel = 4,
  kBeckerLago = 5,
  kSample2d = 6,
  kXor = 7,
  kRemoteSensing = 8,
};

// Constants of one objective: c0/c1 are row-major float32 arrays on the
// card (shekel: a (m, n) and c (m,); xor: X (m, 2) and Y (m,);
// remote_sensing: samples (m, 7) and one-hot labels (m, 8)); param is
// quadratic's shift.
struct ObjParams {
  const float* c0;
  const float* c1;
  int m;
  float param;
};

constexpr float kTwoPi = 6.283185307179586f;  // float32(2 * pi)
constexpr float kE = 2.718281828459045f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_prod(float v) {
  for (int o = 16; o > 0; o >>= 1) v *= __shfl_xor_sync(kFullMask, v, o);
  return v;
}

template <int ID>
struct Objective;

// sum (x - shift)^2
template <>
struct Objective<kQuadratic> {
  __device__ static float eval(const float* x, int n, const ObjParams& p,
                               int lane) {
    float acc = 0.0f;
    for (int v = lane; v < n; v += 32) {
      const float d = x[v] - p.param;
      acc += d * d;
    }
    return warp_sum(acc);
  }
};

// One term of Rastrigin's sum, x^2 - 10 cos(2 pi x), each operation
// rounded on its own, as the plain version computes it: no contraction
// that could depend on the surrounding code, so the cosine path below and
// popstep.cu's term table give a term the same bits.
__device__ __forceinline__ float rastrigin_term(float x) {
  return __fsub_rn(__fmul_rn(x, x),
                   __fmul_rn(10.0f, cosf(__fmul_rn(kTwoPi, x))));
}

// 10 n + sum (x^2 - 10 cos(2 pi x)).  A step at <= 8 bits and many
// variables reads the terms from a table of the 2^bits levels instead
// (popstep.cu, table_value): the cosine a term bounds eval by issue, the
// table by shared loads.  Both paths add lane l's terms of variables
// l, l + 32, ... in that order, then total() the lanes, so a child's
// value is the same bits on either.
template <>
struct Objective<kRastrigin> {
  __device__ __forceinline__ static float total(float acc, int n) {
    return __fadd_rn(__fmul_rn(10.0f, static_cast<float>(n)),
                     warp_sum(acc));
  }

  __device__ static float eval(const float* x, int n, const ObjParams&,
                               int lane) {
    float acc = 0.0f;
    for (int v = lane; v < n; v += 32) acc += rastrigin_term(x[v]);
    return total(acc, n);
  }
};

// -20 exp(-0.2 sqrt(mean x^2)) - exp(mean cos(2 pi x)) + 20 + e
template <>
struct Objective<kAckley> {
  __device__ static float eval(const float* x, int n, const ObjParams&,
                               int lane) {
    float sq = 0.0f, cs = 0.0f;
    for (int v = lane; v < n; v += 32) {
      const float xv = x[v];
      sq += xv * xv;
      cs += cosf(kTwoPi * xv);
    }
    const float s1 = sqrtf(warp_sum(sq) / static_cast<float>(n));
    const float s2 = warp_sum(cs) / static_cast<float>(n);
    return -20.0f * expf(-0.2f * s1) - expf(s2) + 20.0f + kE;
  }
};

// 1 + sum x^2 / 4000 - prod cos(x_i / sqrt(i)), i from 1
template <>
struct Objective<kGriewank> {
  __device__ static float eval(const float* x, int n, const ObjParams&,
                               int lane) {
    float sq = 0.0f, pr = 1.0f;
    for (int v = lane; v < n; v += 32) {
      const float xv = x[v];
      sq += xv * xv;
      pr *= cosf(xv / sqrtf(static_cast<float>(v + 1)));
    }
    return 1.0f + warp_sum(sq) / 4000.0f - warp_prod(pr);
  }
};

// -sum_j 1 / (|x - a_j|^2 + c_j); lanes stride over the m foxholes
template <>
struct Objective<kShekel> {
  __device__ static float eval(const float* x, int n, const ObjParams& p,
                               int lane) {
    float acc = 0.0f;
    for (int j = lane; j < p.m; j += 32) {
      float d = 0.0f;
      for (int k = 0; k < n; ++k) {
        const float t = x[k] - p.c0[j * n + k];
        d += t * t;
      }
      acc += 1.0f / (d + p.c1[j]);
    }
    return -warp_sum(acc);
  }
};

// sum (|x| - 5)^2
template <>
struct Objective<kBeckerLago> {
  __device__ static float eval(const float* x, int n, const ObjParams&,
                               int lane) {
    float acc = 0.0f;
    for (int v = lane; v < n; v += 32) {
      const float d = fabsf(x[v]) - 5.0f;
      acc += d * d;
    }
    return warp_sum(acc);
  }
};

// |x|^2 / 20 - cos(2 x0) cos(2 x1) + 1
template <>
struct Objective<kSample2d> {
  __device__ static float eval(const float* x, int n, const ObjParams&,
                               int lane) {
    float acc = 0.0f;
    for (int v = lane; v < n; v += 32) acc += x[v] * x[v];
    const float r2 = warp_sum(acc);
    return r2 / 20.0f - cosf(2.0f * x[0]) * cosf(2.0f * x[1]) + 1.0f;
  }
};

// 2-2-1 tanh network, sigmoid output, mean squared error over m samples;
// weights w[0:4] = W1 (2x2 row-major), w[4:6] = b1, w[6:8] = w2
template <>
struct Objective<kXor> {
  __device__ static float eval(const float* w, int, const ObjParams& p,
                               int lane) {
    float acc = 0.0f;
    for (int s = lane; s < p.m; s += 32) {
      const float x0 = p.c0[2 * s], x1 = p.c0[2 * s + 1];
      const float h0 = tanhf((x0 * w[0] + x1 * w[2]) + w[4]);
      const float h1 = tanhf((x0 * w[1] + x1 * w[3]) + w[5]);
      const float out = h0 * w[6] + h1 * w[7];
      const float err = 1.0f / (1.0f + expf(-out)) - p.c1[s];
      acc += err * err;
    }
    return warp_sum(acc) / static_cast<float>(p.m);
  }
};

// 7 -> 42 (tanh) -> 8 MLP, mean softmax cross-entropy over m samples.
// Weights: w[0:294] = W1 (7x42 row-major), w[294:336] = b1,
// w[336:672] = W2 (42x8 row-major), w[672:680] = b2.
//
// This is the compute-heavy objective (161,280 multiply-adds per child at
// m = 256).  Each lane takes kSpl samples per pass and keeps their inputs
// and logits in registers; the loop runs over hidden units so that each
// weight, read once from shared memory (a broadcast to the whole warp),
// feeds kSpl multiply-adds.
//
// Hidden unit j reads only W1[:, j] and b1[j].  parent_hidden computes the
// parent's units once per thread block; eval_reuse recomputes the units
// that ``mask`` marks (bit j) and reads the parent's for the rest.  Both
// go through hidden(), so an unmarked unit is bitwise what recomputing it
// would give, and the logits add the units in the order j = 0..41 either
// way: every child's value is bitwise that of a full evaluation (mask all
// ones).
template <>
struct Objective<kRemoteSensing> {
  static constexpr int kIn = 7, kHidden = 42, kClasses = 8, kSpl = 4;
  static constexpr int kB1 = kIn * kHidden;
  static constexpr int kW2 = kB1 + kHidden;
  static constexpr int kB2 = kW2 + kHidden * kClasses;

  // A pass takes 32 * kSpl samples: lane l holds samples l + 32 t.
  static constexpr int kPass = 32 * kSpl;

  __host__ __device__ static constexpr int slots(int m) {
    return kPass * ((m + kPass - 1) / kPass);
  }

  // Shared-memory floats of a block's data: the parent's hidden layer
  // (per pass, unit and lane, the lane's kSpl samples side by side: one
  // 16-byte load), then the samples (kIn x m) and the one-hot labels
  // (kClasses x m), both transposed so that lanes on consecutive samples
  // read consecutive words; rounded up so that what follows stays 16-byte
  // aligned.
  __host__ __device__ static constexpr int smem_floats(int m) {
    return (kHidden * slots(m) + (kIn + kClasses) * m + 3) / 4 * 4;
  }

  __device__ __forceinline__ static float hidden(const float (&x)[kIn],
                                                 const float (&w1)[kIn],
                                                 float b1) {
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < kIn; ++k) a += x[k] * w1[k];
    return tanhf(a + b1);
  }

  // The samples and the labels into the block's data (see smem_floats).
  // Called by every thread of the block; unrolled, so that a thread's
  // loads are in flight together.
  __device__ static void stage(const ObjParams& p, float* d) {
    float* xs = d + kHidden * slots(p.m);
    float* ys = xs + kIn * p.m;
#pragma unroll 8
    for (int i = threadIdx.x; i < kIn * p.m; i += blockDim.x)
      xs[(i % kIn) * p.m + i / kIn] = p.c0[i];
#pragma unroll 8
    for (int i = threadIdx.x; i < kClasses * p.m; i += blockDim.x)
      ys[(i % kClasses) * p.m + i / kClasses] = p.c1[i];
  }

  // The parent's hidden layer from its point ``w`` and the staged
  // samples.  Called by every thread of the block.  Each thread takes one
  // sample slot and a group of units, so that it loads the sample's inputs
  // once and a warp's stores of a unit are consecutive words (slot r of a
  // pass is lane r / kSpl, sample r % kSpl).
  __device__ static void parent_hidden(const float* w, const ObjParams& p,
                                       float* d) {
    const int n_slots = slots(p.m);
    float* hp = d;
    const float* xs = d + kHidden * n_slots;
    const int groups = max(1, static_cast<int>(blockDim.x) / n_slots);
    const int per_group = (kHidden + groups - 1) / groups;
    for (int i = threadIdx.x; i < n_slots * groups; i += blockDim.x) {
      const int r = i % n_slots;
      const int g = i / n_slots;
      const int q = r / kPass;
      const int lane = r % kPass / kSpl, t = r % kSpl;
      const int s = q * kPass + 32 * t + lane;
      if (s >= p.m) continue;
      float x[kIn];
#pragma unroll
      for (int k = 0; k < kIn; ++k) x[k] = xs[k * p.m + s];
      const int j_end = min(kHidden, (g + 1) * per_group);
#pragma unroll 2
      for (int j = g * per_group; j < j_end; ++j) {
        float w1[kIn];
#pragma unroll
        for (int k = 0; k < kIn; ++k) w1[k] = w[k * kHidden + j];
        hp[((q * kHidden + j) * 32 + lane) * kSpl + t] =
            hidden(x, w1, w[kB1 + j]);
      }
    }
  }

  __device__ static float eval_reuse(const float* w, const ObjParams& p,
                                     int lane, const float* d,
                                     unsigned long long mask) {
    static_assert(kSpl == 4, "a lane's parent units are one float4");
    const float4* hp = reinterpret_cast<const float4*>(d);
    const float* xs = d + kHidden * slots(p.m);
    const float* ys = xs + kIn * p.m;
    float total = 0.0f;
    for (int base = 0; base < p.m; base += kPass) {
      float xin[kSpl][kIn];
      float lg[kSpl][kClasses];
#pragma unroll
      for (int t = 0; t < kSpl; ++t) {
        const int s = base + t * 32 + lane;
        const bool live = s < p.m;
#pragma unroll
        for (int k = 0; k < kIn; ++k)
          xin[t][k] = live ? xs[k * p.m + s] : 0.0f;
#pragma unroll
        for (int c = 0; c < kClasses; ++c) lg[t][c] = 0.0f;
      }
      // this lane's samples of unit 0 of the parent's hidden layer (a dead
      // sample past m reads a word never written: its logits are not used)
      const float4* hpl = hp + base / kPass * kHidden * 32 + lane;
#pragma unroll 2
      for (int j = 0; j < kHidden; ++j, hpl += 32) {
        // W2[j, :] in two 16-byte loads (the child point is 16-byte
        // aligned and 680 floats long)
        const float4* w2v = reinterpret_cast<const float4*>(w + kW2) + 2 * j;
        const float4 lo4 = w2v[0], hi4 = w2v[1];
        const float w2[kClasses] = {lo4.x, lo4.y, lo4.z, lo4.w,
                                    hi4.x, hi4.y, hi4.z, hi4.w};
        const float4 hv = *hpl;
        float h[kSpl] = {hv.x, hv.y, hv.z, hv.w};
        if ((mask >> j) & 1ull) {       // uniform across the warp
          float w1[kIn];
#pragma unroll
          for (int k = 0; k < kIn; ++k) w1[k] = w[k * kHidden + j];
          const float b1 = w[kB1 + j];
#pragma unroll
          for (int t = 0; t < kSpl; ++t) h[t] = hidden(xin[t], w1, b1);
        }
#pragma unroll
        for (int t = 0; t < kSpl; ++t)
#pragma unroll
          for (int c = 0; c < kClasses; ++c) lg[t][c] += h[t] * w2[c];
      }
#pragma unroll
      for (int t = 0; t < kSpl; ++t) {
        const int s = base + t * 32 + lane;
        if (s >= p.m) continue;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < kClasses; ++c) {
          lg[t][c] += w[kB2 + c];
          mx = fmaxf(mx, lg[t][c]);
        }
        float se = 0.0f;
#pragma unroll
        for (int c = 0; c < kClasses; ++c) se += expf(lg[t][c] - mx);
        const float lse = logf(se);
        float loss = 0.0f;
#pragma unroll
        for (int c = 0; c < kClasses; ++c)
          loss -= ys[c * p.m + s] * ((lg[t][c] - mx) - lse);
        total += loss;
      }
    }
    return warp_sum(total) / static_cast<float>(p.m);
  }
};

}  // namespace popstep
