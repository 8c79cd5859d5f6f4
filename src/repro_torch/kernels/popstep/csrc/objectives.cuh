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
// (the library is built without --use_fast_math).
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

// 10 n + sum (x^2 - 10 cos(2 pi x))
template <>
struct Objective<kRastrigin> {
  __device__ static float eval(const float* x, int n, const ObjParams&,
                               int lane) {
    float acc = 0.0f;
    for (int v = lane; v < n; v += 32) {
      const float xv = x[v];
      acc += xv * xv - 10.0f * cosf(kTwoPi * xv);
    }
    return 10.0f * static_cast<float>(n) + warp_sum(acc);
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
template <>
struct Objective<kRemoteSensing> {
  static constexpr int kIn = 7, kHidden = 42, kClasses = 8, kSpl = 4;
  static constexpr int kB1 = kIn * kHidden;
  static constexpr int kW2 = kB1 + kHidden;
  static constexpr int kB2 = kW2 + kHidden * kClasses;

  __device__ static float eval(const float* w, int, const ObjParams& p,
                               int lane) {
    float total = 0.0f;
    for (int base = 0; base < p.m; base += 32 * kSpl) {
      float xin[kSpl][kIn];
      float lg[kSpl][kClasses];
#pragma unroll
      for (int t = 0; t < kSpl; ++t) {
        const int s = base + t * 32 + lane;
        const bool live = s < p.m;
#pragma unroll
        for (int k = 0; k < kIn; ++k)
          xin[t][k] = live ? p.c0[s * kIn + k] : 0.0f;
#pragma unroll
        for (int c = 0; c < kClasses; ++c) lg[t][c] = 0.0f;
      }
      for (int j = 0; j < kHidden; ++j) {
        float w1[kIn], w2[kClasses];
#pragma unroll
        for (int k = 0; k < kIn; ++k) w1[k] = w[k * kHidden + j];
#pragma unroll
        for (int c = 0; c < kClasses; ++c) w2[c] = w[kW2 + j * kClasses + c];
        const float b1 = w[kB1 + j];
#pragma unroll
        for (int t = 0; t < kSpl; ++t) {
          float a = 0.0f;
#pragma unroll
          for (int k = 0; k < kIn; ++k) a += xin[t][k] * w1[k];
          const float h = tanhf(a + b1);
#pragma unroll
          for (int c = 0; c < kClasses; ++c) lg[t][c] += h * w2[c];
        }
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
          loss -= p.c1[s * kClasses + c] * ((lg[t][c] - mx) - lse);
        total += loss;
      }
    }
    return warp_sum(total) / static_cast<float>(p.m);
  }
};

}  // namespace popstep
