// flash_attention: forward online-softmax attention, causal / sliding-window
// / GQA, float32 accumulators; float32 or bfloat16 inputs and output.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention (the
// Pallas TPU kernel, body _flash_kernel, behind repro.kernels.
// flash_attention.ops.flash_sdpa).  It computes what that kernel computes,
// softmax(q k^T * scale, masked) v per query row, but not in its grid: the
// TPU kernel walks a sequential (head, q block, kv block) grid and carries
// (m, l, acc) in VMEM scratch from one kv step to the next, which Hopper's
// unordered blocks cannot do.  Here one thread block owns one (b * Hq + h,
// q tile of kBQ rows) and loops over the K/V tiles itself:
//  * four threads share a query row, each holding a quarter of the row's q
//    and of its f32 accumulator in registers (float4 slices interleaved so
//    that the four read neighbouring 16-byte words of a K/V row in shared
//    memory: no bank conflict); a score is their partial dot products
//    summed by two warp shuffles;
//  * K and V tiles of kBK keys are staged in shared memory as float32
//    (bfloat16 is widened on the load), keys at or past S as zeros;
//  * the online softmax (running max m, sum l, accumulator) is updated
//    every kKC keys, with masked scores at -inf (a row that has seen no
//    key yet keeps l = 0); the output is acc / max(l, 1e-30), as the TPU
//    kernel's finalize;
//  * masks: causal q_pos >= k_pos, window k_pos > q_pos - window, and
//    k_pos < S.  S is an argument, so no padding is needed: the reference
//    wrapper's unmasked zero padding with causal=False cannot occur;
//  * tiles wholly outside the mask (above the causal diagonal, before the
//    window) are never loaded.  Causal q tiles are numbered from the last,
//    so the blocks with the most tiles start first.
//
// What bounds it: operations.  At the serving shape (B=4, S=1024, Hq=12,
// hd=128, causal) it does 4 * B * Hq * hd * S(S+1)/2 = 1.29e10 FLOP on
// 58.7 MB of q, k, v and o: 0.19 ms at 67 TFLOP/s float32 on the CUDA
// cores vs 0.018 ms at 3.35 TB/s.  This first version uses no tensor core,
// TMA or wgmma: one shared-memory load per four FMAs and one exp per
// 2 * hd / 4 FMAs per thread (expf, not __expf).
//
// Built by kernel.py (through kernels/_build.py) with nvcc for sm_90a into a
// shared library with a plain C interface; the entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace flash {

constexpr int kBQ = 64;                 // query rows per thread block
constexpr int kBK = 64;                 // keys per K/V tile
constexpr int kKC = 16;                 // keys per online-softmax update
constexpr int kTPR = 4;                 // threads per query row
constexpr int kThreads = kBQ * kTPR;    // 256

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// q: (B, S, Hq, HD), k/v: (B, S, Hkv, HD), o like q; all contiguous.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int Hq, int Hkv, float scale, int causal,
                           int window) {
  constexpr int kC4 = HD / 4;           // float4 columns of a row
  constexpr int kNV = kC4 / kTPR;       // float4 columns per thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);       // (kBK, HD)
  float* vs = ks + kBK * HD;                          // (kBK, HD)

  const int n_qt = gridDim.x;
  const int qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int r = threadIdx.x / kTPR;     // row in the tile
  const int part = threadIdx.x % kTPR;  // which quarter of the row
  const int q0 = qt * kBQ;
  const int qi = q0 + r;

  const long long q_row = static_cast<long long>(Hq) * HD;
  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const T* kb = k + static_cast<long long>(b) * S * kv_row + hk * HD;
  const T* vb = v + static_cast<long long>(b) * S * kv_row + hk * HD;

  float4 qv[kNV], acc[kNV];
  const T* qp = q + (static_cast<long long>(b) * S + qi) * q_row + h * HD;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    qv[i] = qi < S ? load4(qp + 4 * (part + kTPR * i))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -CUDART_INF_F, l = 0.f;

  // keys this q tile can see
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();                    // the previous tile is consumed
    for (int e = threadIdx.x; e < kBK * kC4; e += kThreads) {
      const int j = e / kC4, c = e % kC4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + j < S) {
        const long long off = (k0 + j) * kv_row + 4 * c;
        kx = load4(kb + off);
        vx = load4(vb + off);
      }
      store4(ks + j * HD + 4 * c, kx);
      store4(vs + j * HD + 4 * c, vx);
    }
    __syncthreads();

#pragma unroll 1
    for (int jc = 0; jc < kBK; jc += kKC) {
      float s[kKC];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        const float* kr = ks + (jc + jj) * HD;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kNV; ++i) {
          const float4 kx = *reinterpret_cast<const float4*>(
              kr + 4 * (part + kTPR * i));
          dot = fmaf(qv[i].x, kx.x, dot);
          dot = fmaf(qv[i].y, kx.y, dot);
          dot = fmaf(qv[i].z, kx.z, dot);
          dot = fmaf(qv[i].w, kx.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int kp = k0 + jc + jj;
        const bool ok = kp < S && (!causal || kp <= qi) &&
                        (window <= 0 || kp > qi - window);
        s[jj] = ok ? dot * scale : -CUDART_INF_F;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      // no key seen yet: subtract 0, so exp(-inf) = 0 and nothing is NaN
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m - m_use);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        const float p = expf(s[jj] - m_use);
        l += p;
        const float* vr = vs + (jc + jj) * HD;
#pragma unroll
        for (int i = 0; i < kNV; ++i) {
          const float4 vx = *reinterpret_cast<const float4*>(
              vr + 4 * (part + kTPR * i));
          acc[i].x = fmaf(p, vx.x, acc[i].x);
          acc[i].y = fmaf(p, vx.y, acc[i].y);
          acc[i].z = fmaf(p, vx.z, acc[i].z);
          acc[i].w = fmaf(p, vx.w, acc[i].w);
        }
      }
      m = m_new;
    }
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = o + (static_cast<long long>(b) * S + qi) * q_row + h * HD;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      store4(op + 4 * (part + kTPR * i),
             make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv,
                         acc[i].w * inv));
    }
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Hq, int Hkv, float scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr int kSmem = 2 * kBK * HD * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<HD, T>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int Hq, int Hkv, float scale,
                     int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16, T>(q, k, v, o, B, S, Hq, Hkv, scale, causal, window,
                           stream);
    case 32:
      return launch<32, T>(q, k, v, o, B, S, Hq, Hkv, scale, causal, window,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, o, B, S, Hq, Hkv, scale, causal, window,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, o, B, S, Hq, Hkv, scale, causal, window,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash

extern "C" {

// q: (B, S, Hq, hd), k/v: (B, S, Hkv, hd), o: (B, S, Hq, hd), contiguous,
// 16-byte aligned; hd in {16, 32, 64, 128}; Hq a multiple of Hkv;
// dtype 0 = float32, 1 = bfloat16; window 0 = global.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Hq, int Hkv, int hd, int dtype,
                        float scale, int causal, int window, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (dtype == 0) {
    err = flash::dispatch<float>(hd, q, k, v, o, B, S, Hq, Hkv, scale, causal,
                                 window, st);
  } else if (dtype == 1) {
    err = flash::dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, Hq, Hkv, scale,
                                         causal, window, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
