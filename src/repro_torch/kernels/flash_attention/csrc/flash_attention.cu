// flash_attention: forward online-softmax attention, causal / sliding-window
// / GQA, float32 accumulators; float32 or bfloat16 inputs and output.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention (the
// Pallas TPU kernel, body _flash_kernel, behind repro.kernels.
// flash_attention.ops.flash_sdpa).  It computes what that kernel computes,
// softmax(q k^T * scale, masked) v per query row, with P rounded to V's
// type before P.V (kernel.py:59-60: bfloat16 inputs round P to bfloat16,
// float32 inputs keep it in float32), but not in its grid: the TPU kernel
// walks a sequential (head, q block, kv block) grid and carries (m, l, acc)
// in VMEM scratch from one kv step to the next, which Hopper's unordered
// blocks cannot do.  Here a thread block owns a (b * Hq + h, q tile) at a
// time and loops over the K/V tiles itself.  Shared by both paths:
//  * masks: causal q_pos >= k_pos, window k_pos > q_pos - window, and
//    k_pos < S.  S is an argument, so no padding is needed; keys at or past
//    S arrive as zeros and are masked;
//  * online softmax in base 2 (scores times scale * log2(e)), masked scores
//    at -inf; a row that has seen no key yet subtracts 0, so nothing is NaN;
//    the output is acc / max(l, 1e-30), as the TPU kernel's finalize;
//  * tiles wholly outside the mask (above the causal diagonal, before the
//    window) are never loaded; causal q tiles are taken from the last, so
//    the work with the most tiles starts first.
//
// What bounds each path, and what the design does about it:
//
// float32 (flash_attention_f32_kernel; simt below): operations on the CUDA
// cores, 67 TFLOP/s (no TF32: it keeps ~3 decimal digits and misses the
// 1e-4 bar).  At the serving shape (B=4, S=1024, Hq=12, hd=128, causal)
// 1.29e10 FLOP take 0.19 ms, 58.7 MB of q, k, v, o 0.018 ms.  The FMA
// units are fed from registers, and what limits them is shared memory: a
// 16-byte load of a warp takes four of its 128-byte cycles.  So each of
// 256 threads (a 16 x 16 grid) computes an 8 x 4 micro-tile of the
// 128 x 64 score tile from float4 loads along hd (12 loads per 128 FMAs)
// and an 8 x (hd / 16) micro-tile of P.V (P through shared memory, 16
// loads per 256 FMAs at hd 128), in up to 255 registers, one block an SM.
// Q and K tiles are swizzled by 16-byte chunk (chunk ^ row) so a quarter
// warp's loads hit eight different bank groups.  K and V arrive by
// cp.async into single buffers, each refilled while the other is in use
// (K(t+1) during softmax and P.V of tile t, V(t+1) during Q.K(t+1)).
// Blocks start with every head's longest q tile (grid x = head), so the
// causal tail is short.
//
// bfloat16 (flash_attention_bf16_kernel; tc below): operations on the
// tensor cores, 989 TFLOP/s: 0.013 ms at the serving shape.  A block owns
// 128 query rows: two consumer warpgroups of 64 rows each run
// wgmma.mma_async m64n128k16 for S = Q.K^T (bf16 in, f32 accumulate) with
// Q and K read from shared memory, then the online softmax on the f32
// accumulator in registers, then O += P.V with m64n{64,128}k16 and P as
// wgmma's register A operand: the accumulator fragment of S converts in
// place to the A fragment (two bf16 a register), so P never passes through
// shared memory; V is the MN-major B operand (the transposed descriptor),
// so no transpose pass is needed.  A producer warpgroup (setmaxnreg: 40
// registers, the consumers 232) has one thread load Q and the K and V
// tiles of 128 keys by TMA (cp.async.bulk.tensor with a CUtensorMap per
// tensor, 4-D over (hd, H, S, B), so rows past S are zero-filled by the
// hardware) into a two-stage ring with mbarriers: full barriers for K and
// for V apart (S = Q.K^T starts before V lands), an empty barrier that the
// eight consumer warps release.  Tiles are 128-byte swizzled boxes of 64
// columns (a bf16 row of hd 128 is two boxes), the swizzle that the wgmma
// descriptors name; hd 16 and 32 load the same 64-column box, whose
// columns past hd the TMA fills with zeros (hd < 64 is off the main path
// and pays for 64), and hd 96 runs as hd 128: its second box, columns
// 64-127, reads columns 96-127 as zeros, which add nothing to Q.K^T and
// give P.V columns that the epilogue does not store.  The grid is persistent, one block an SM, walking the
// (q tile, head) items longest first in snake order; Q is double-buffered,
// so the next item's loads overlap this one's last tiles and its stores.
//
// Built by kernel.py (through kernels/_build.py, linked with -lcuda for
// cuTensorMapEncodeTiled) with nvcc for sm_90a into a shared library with
// a plain C interface; the entry point launches on the caller's stream and
// returns cudaGetLastError(), or 1000 + the CUresult when a tensor map
// cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int kp, int qp, int S, int causal,
                                        int window) {
  return kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// K/V tiles [first, last) that the q tile [q0, q0 + bq) can see.
__device__ __forceinline__ int2 tile_range(int q0, int bq, int bk, int S,
                                           int causal, int window) {
  const int k_end = causal ? min(S, q0 + bq) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  return make_int2(k_begin / bk, (k_end + bk - 1) / bk);
}

// 2^x by the special-function unit (ex2.approx: 2 ulp, -inf -> 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

namespace simt {

constexpr int kBQ = 128;                // query rows per thread block
constexpr int kBK = 64;                 // keys per K/V tile
constexpr int kThreads = 256;           // 16 x 16: ty owns rows ty + 16 i
constexpr int kRows = kBQ / 16;         // query rows a thread

// Q and K tiles are swizzled by 16-byte chunk: chunk c of a row lies at
// c ^ key(row), which spreads eight consecutive rows over eight bank
// groups.  key(row) depends only on row % 16, so it is one constant for
// all rows ty + 16 i (or tx + 16 j) of a thread.  (With 4 chunks a row,
// hd 16, two rows share 128 bytes and the key is taken from row / 2.)
__device__ __forceinline__ int swz_key(int row, int nc) {
  return nc >= 8 ? (row & 7) : ((row >> 1) & 3);
}

// The (kBQ, kBK) probability tile: chunk c of a row at c ^ 4 (row & 1),
// so the two rows a warp reads at once lie in other banks.
__device__ __forceinline__ int pswz(int row, int c) {
  return row * (kBK / 4) + (c ^ ((row & 1) << 2));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float lane4(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Rows [r0, r0 + ROWS) of one head (base, rows row_stride apart) into a
// (ROWS, HD) tile, swizzled (Q, K) or not (V: its rows are read whole);
// rows at or past S as zeros.
template <int HD, int ROWS, bool kSwizzle>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          long long row_stride, int r0,
                                          int S) {
  constexpr int kNC = HD / 4;
  const uint32_t t = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  for (int e = threadIdx.x; e < ROWS * kNC; e += kThreads) {
    const int r = e / kNC, c = e % kNC;
    const bool ok = r0 + r < S;
    const int at = r * kNC + (kSwizzle ? c ^ swz_key(r, kNC) : c);
    cp_async16(t + 16 * at, base + (ok ? (r0 + r) * row_stride + 4 * c : 0),
               ok);
  }
}

// q: (B, S, Hq, HD), k/v: (B, S, Hkv, HD), o like q; all contiguous.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, int S, int Hq, int Hkv,
                               float scale, int causal, int window) {
  constexpr int kNC = HD / 4;                  // 16-byte chunks a row
  constexpr int kCols = HD / 16;               // output columns a thread
  // output columns a vector: 4 where a thread's columns split into
  // float4s, else 2 (hd 32; hd 96's 6 columns as 3 float2s) or 1 (hd 16)
  constexpr int kVW = kCols % 4 == 0 ? 4 : kCols % 2 == 0 ? 2 : 1;
  constexpr int kNV = kCols / kVW;             // vectors a thread
  static_assert(kNC % (kNC >= 8 ? 8 : 4) == 0,
                "the swizzle keeps each chunk in its row");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * HD;
  float* vs = ks + kBK * HD;
  float* ps = vs + kBK * HD;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // blocks start in order of blockIdx.x, then .y: every head's longest
  // (causal: last) q tile first
  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - blockIdx.y : blockIdx.y;
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const long long q_row = static_cast<long long>(Hq) * HD;
  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const float* qb = q + static_cast<long long>(b) * S * q_row + h * HD;
  const float* kb = k + static_cast<long long>(b) * S * kv_row + hk * HD;
  const float* vb = v + static_cast<long long>(b) * S * kv_row + hk * HD;
  const int2 tiles = tile_range(q0, kBQ, kBK, S, causal, window);

  load_tile<HD, kBQ, true>(qs, qb, q_row, q0, S);
  load_tile<HD, kBK, true>(ks, kb, kv_row, tiles.x * kBK, S);
  cp_async_commit();
  load_tile<HD, kBK, false>(vs, vb, kv_row, tiles.x * kBK, S);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float acc[kRows][kCols], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = tiles.x; t < tiles.y; ++t) {
    const int k0 = t * kBK;
    cp_async_wait1();                   // Q and K(t); V(t) may be in flight
    __syncthreads();
    float s[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // chunk c of rows ty + 16 i and tx + 16 j: the swizzle key is one
    // constant a thread
    const int xq = swz_key(ty, kNC), xk = swz_key(tx, kNC);
#pragma unroll 4
    for (int c = 0; c < kNC; ++c) {
      float4 qv[kRows], kv[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = reinterpret_cast<const float4*>(qs)[(ty + 16 * i) * kNC +
                                                    (c ^ xq)];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = reinterpret_cast<const float4*>(ks)[(tx + 16 * j) * kNC +
                                                    (c ^ xk)];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();                    // K(t) and P(t - 1) are consumed
    if (t + 1 < tiles.y) load_tile<HD, kBK, true>(ks, kb, kv_row, k0 + kBK, S);
    cp_async_commit();

    const bool edge =
        k0 + kBK > S || (causal && k0 + kBK - 1 > q0) || window > 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * sl2;
        if (edge && !visible(k0 + tx + 16 * j, qp, S, causal, window)) {
          x = -CUDART_INF_F;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      }
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        l[i] += p;
        const int key = tx + 16 * j, row = ty + 16 * i;
        ps[4 * pswz(row, key / 4) + key % 4] = p;
      }
    }
    cp_async_wait1();                   // V(t); K(t + 1) may be in flight
    __syncthreads();                    // and P(t) is written

#pragma unroll 2
    for (int kc = 0; kc < kBK / 4; ++kc) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = reinterpret_cast<const float4*>(ps)[pswz(ty + 16 * i, kc)];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 4 * kc + e;
        float vv[kCols];
#pragma unroll
        for (int n = 0; n < kNV; ++n) {
          const int col = (tx + 16 * n) * kVW;
          const float* src = vs + key * HD + col;
          if constexpr (kVW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            vv[4 * n] = x.x;
            vv[4 * n + 1] = x.y;
            vv[4 * n + 2] = x.z;
            vv[4 * n + 3] = x.w;
          } else if constexpr (kVW == 2) {
            const float2 x = *reinterpret_cast<const float2*>(src);
            vv[2 * n] = x.x;
            vv[2 * n + 1] = x.y;
          } else {
            vv[n] = *src;
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = lane4(pv[i], e);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();                    // V(t) and P(t) are consumed
    if (t + 1 < tiles.y) load_tile<HD, kBK, false>(vs, vb, kv_row, k0 + kBK, S);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) {
      li += __shfl_xor_sync(0xffffffffu, li, w);
    }
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* op = o + (static_cast<long long>(b) * S + qp) * q_row + h * HD;
#pragma unroll
    for (int n = 0; n < kNV; ++n) {
      const int col = (tx + 16 * n) * kVW;
#pragma unroll
      for (int e = 0; e < kVW; ++e) op[col + e] = acc[i][kVW * n + e] * inv;
    }
  }
}

}  // namespace simt

namespace tc {

constexpr int kBQ = 128;                // two consumer warpgroups of 64 rows
constexpr int kBK = 128;                // keys per K/V tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + a producer warpgroup
constexpr int kProducerRegs = 40;       // setmaxnreg: 40 x 128 + 232 x 256
constexpr int kConsumerRegs = 232;      // registers fill the SM's 64 K
constexpr int kBox = 128 * 128;         // bytes of a TMA box: 128 rows x 64

// Shared memory, in bytes from a 1024-aligned base: two Q buffers, the K
// ring, the V ring (each tile kHalves boxes of 64 columns), then the
// barriers: Q full and Q empty a buffer, K full, V full and empty a stage.
template <int HDP>
struct Layout {
  static constexpr int kHalves = HDP / 64;
  static constexpr int kTile = kHalves * kBox;
  static constexpr int kK = 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (4 + 3 * kStages) + 1024;
  __device__ static uint32_t q_full(uint32_t base, int buf) {
    return base + kBar + 8 * buf;
  }
  __device__ static uint32_t q_empty(uint32_t base, int buf) {
    return base + kBar + 16 + 8 * buf;
  }
  __device__ static uint32_t k_full(uint32_t base, int st) {
    return base + kBar + 32 + 8 * st;
  }
  __device__ static uint32_t v_full(uint32_t base, int st) {
    return base + kBar + 32 + 8 * (kStages + st);
  }
  __device__ static uint32_t empty(uint32_t base, int st) {
    return base + kBar + 32 + 8 * (2 * kStages + st);
  }
};

// One work item: the 128-row q tile of one (batch, head).  Items are
// numbered longest first (causal: the last q tiles).
struct Item {
  int q0, b, h, hk;
  int2 tiles;
};

__device__ __forceinline__ Item item_at(int j, int B, int S, int Hq, int Hkv,
                                        int causal, int window) {
  const int n_qt = (S + kBQ - 1) / kBQ, bhs = B * Hq;
  const int qt = causal ? n_qt - 1 - j / bhs : j / bhs;
  Item w;
  w.b = (j % bhs) / Hq;
  w.h = (j % bhs) % Hq;
  w.hk = w.h / (Hq / Hkv);
  w.q0 = qt * kBQ;
  w.tiles = tile_range(w.q0, kBQ, kBK, S, causal, window);
  return w;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared
// memory; completion is counted in bytes on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// D (64 x 128, f32) (+)= A (64 x 16, shared, K-major) * B (128 x 16,
// shared, K-major)^T; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, shared,
// MN-major: the transposed descriptor).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, shared,
// MN-major: the transposed descriptor).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  if constexpr (HDP == 64) {
    wgmma_rs_n64(o, a0, a1, a2, a3, db);
  } else {
    wgmma_rs_n128(o, a0, a1, a2, a3, db);
  }
}

// The consumer warpgroups' work on item w, the n-th of this block: S = Q
// K^T, online softmax, O += P V for every visible tile of the ring (``it``
// counts the ring's tiles across items), then O / l stored in bf16.
template <int HDP>
__device__ __forceinline__ void consume(uint32_t base, int n, int& it,
                                        const Item& w, int S, int Hq, int hd,
                                        float scale, int causal, int window,
                                        __nv_bfloat16* __restrict__ o) {
  using L = Layout<HDP>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = w.q0, b = w.b, h = w.h;
  // warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile; this thread
  // holds rows r and r + 8 of the accumulators (wgmma's layout)
  const int wg = warp / 4;
  const int r = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int qp0 = q0 + r, qp1 = qp0 + 8;
  const int c0 = 2 * (lane % 4);       // first column within each 8
  const float sl2 = scale * kLog2e;
  const uint32_t qs = base + (n & 1) * L::kTile;
  float s[64], acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  mbar_wait(L::q_full(base, n & 1), (n >> 1) & 1);
  for (int t = w.tiles.x; t < w.tiles.y; ++t, ++it) {
    const int st = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int k0 = t * kBK;
    const uint32_t ks = base + L::kK + st * L::kTile;
    const uint32_t vs = base + L::kV + st * L::kTile;

    // S = Q K^T: hd / 16 steps of 16 columns, 32 bytes into a 128-byte row
    mbar_wait(L::k_full(base, st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_n128(s, desc128(qs + wg * 8192 + off, 16, 1024),
                    desc128(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax on the accumulator: s[i] is row r (i % 4 < 2) or r + 8,
    // key k0 + 8 (i / 4) + c0 + i % 2
    const bool edge = k0 + kBK > S ||
                      (causal && k0 + kBK - 1 > q0 + 64 * wg) || window > 0;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = s[i];
      const bool lo = (i & 2) == 0;
      if (edge && !visible(k0 + 8 * (i / 4) + c0 + (i & 1), lo ? qp0 : qp1,
                           S, causal, window)) {
        x = -CUDART_INF_F;
      }
      s[i] = x;
      if (lo) {
        mx0 = fmaxf(mx0, x);
      } else {
        mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0) * sl2;         // scale > 0: max and scale commute
    mx1 = quad_max(mx1) * sl2;
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float mu1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float al0 = fast_exp2(m0 - mu0), al1 = fast_exp2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const bool lo = (i & 2) == 0;
      const float p = fast_exp2(fmaf(s[i], sl2, -(lo ? mu0 : mu1)));
      s[i] = p;
      if (lo) {
        l0 += p;
      } else {
        l1 += p;
      }
    }
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] *= (i & 2) == 0 ? al0 : al1;
    uint32_t pa[32];
    // P in bf16 as wgmma's A fragment: keys 16 kk .. 16 kk + 15 are the
    // accumulator's column groups 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V: V (keys x hd, hd contiguous) is MN-major; 16 keys are 16
    // rows of 128 bytes, the two 64-column boxes kBox apart
    mbar_wait(L::v_full(base, st), ph);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_pv<HDP>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                    pa[4 * kk + 3], desc128(vs + kk * 2048, kBox, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(L::empty(base, st));
  }
  // every product that read this Q buffer has completed
  __syncwarp();
  if (lane == 0) mbar_arrive(L::q_empty(base, n & 1));

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const long long q_row = static_cast<long long>(Hq) * hd;
  __nv_bfloat16* op0 = o + (static_cast<long long>(b) * S + qp0) * q_row + h * hd;
  __nv_bfloat16* op1 = op0 + 8 * q_row;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + c0;
    if (col >= hd) continue;
    if (qp0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(op0 + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    }
    if (qp1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(op1 + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// q: (B, S, Hq, hd), k/v: (B, S, Hkv, hd) through their tensor maps; o like
// q, contiguous.  HDP: hd rounded up to 64 or 128.  A persistent grid of
// one block an SM walks the items (longest first, in snake order); the
// producer loads the next item's Q into the other buffer while the
// consumers finish this one.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o, int B, int S,
                                int Hq, int Hkv, int hd, float scale,
                                int causal, int window) {
  using L = Layout<HDP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int n_items = (S + kBQ - 1) / kBQ * B * Hq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the block's n-th item: rounds of gridDim.x items, every other round
  // taken in reverse, so a block that had a long item gets a short one
  const auto snake = [](int n) {
    return n * static_cast<int>(gridDim.x) +
           ((n & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                    : static_cast<int>(blockIdx.x));
  };

  if (threadIdx.x == 0) {
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(L::q_full(base, buf), 1);
      mbar_init(L::q_empty(base, buf), kConsumerWarps);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(L::k_full(base, st), 1);
      mbar_init(L::v_full(base, st), 1);
      mbar_init(L::empty(base, st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer warpgroup: gives up registers; one thread loads each item's
    // Q, then K and V of its visible tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      int it = 0;
      for (int n = 0, j = blockIdx.x; j < n_items; j = snake(++n)) {
        const Item w = item_at(j, B, S, Hq, Hkv, causal, window);
        const int qb = n & 1;
        mbar_wait(L::q_empty(base, qb), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(L::q_full(base, qb), L::kTile);
        for (int hf = 0; hf < L::kHalves; ++hf) {
          tma_load(base + qb * L::kTile + hf * kBox, &tq, L::q_full(base, qb),
                   64 * hf, w.h, w.q0, w.b);
        }
        for (int t = w.tiles.x; t < w.tiles.y; ++t, ++it) {
          const int st = it % kStages;
          mbar_wait(L::empty(base, st), ((it / kStages) & 1) ^ 1);
          const uint32_t ks = base + L::kK + st * L::kTile;
          const uint32_t vs = base + L::kV + st * L::kTile;
          mbar_expect_tx(L::k_full(base, st), L::kTile);
          for (int hf = 0; hf < L::kHalves; ++hf) {
            tma_load(ks + hf * kBox, &tk, L::k_full(base, st), 64 * hf, w.hk,
                     t * kBK, w.b);
          }
          mbar_expect_tx(L::v_full(base, st), L::kTile);
          for (int hf = 0; hf < L::kHalves; ++hf) {
            tma_load(vs + hf * kBox, &tv, L::v_full(base, st), 64 * hf, w.hk,
                     t * kBK, w.b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    int it = 0;
    for (int n = 0, j = blockIdx.x; j < n_items; j = snake(++n)) {
      const Item w = item_at(j, B, S, Hq, Hkv, causal, window);
      consume<HDP>(base, n, it, w, S, Hq, hd, scale, causal, window, o);
    }
  }
}

}  // namespace tc

// A (hd, H, S, B) tensor map over a (B, S, H, hd) bf16 tensor, boxes of
// 64 columns x 128 rows of one (head, batch), 128-byte swizzled; boxes
// past hd or S read zeros.
static CUresult encode_map(CUtensorMap* map, const void* ptr, int B, int S,
                           int H, int hd) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * sizeof(__nv_bfloat16);
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {64, 1, tc::kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Hq, int Hkv, int hd, float scale, int causal,
                int window, cudaStream_t stream) {
  static_assert(tc::kBQ == tc::kBK, "the Q tile shares the K/V box");
  CUtensorMap tq, tk, tv;
  CUresult cr = encode_map(&tq, q, B, S, Hq, hd);
  if (cr == CUDA_SUCCESS) cr = encode_map(&tk, k, B, S, Hkv, hd);
  if (cr == CUDA_SUCCESS) cr = encode_map(&tv, v, B, S, Hkv, hd);
  if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);
  constexpr int kSmem = tc::Layout<HDP>::kBytes;
  auto kernel = tc::flash_attention_bf16_kernel<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = (S + tc::kBQ - 1) / tc::kBQ * B * Hq;
  kernel<<<n_items < sms ? n_items : sms, tc::kThreads, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, Hq, Hkv, hd, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Hq, int Hkv, float scale, int causal, int window,
               cudaStream_t stream) {
  constexpr int kSmem = static_cast<int>(sizeof(float)) *
                        (simt::kBQ * HD + 2 * simt::kBK * HD +
                         simt::kBQ * simt::kBK);
  auto kernel = simt::flash_attention_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (S + simt::kBQ - 1) / simt::kBQ);
  kernel<<<grid, simt::kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq, Hkv, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

extern "C" {

// q: (B, S, Hq, hd), k/v: (B, S, Hkv, hd), o: (B, S, Hq, hd), contiguous,
// 16-byte aligned; hd in {16, 32, 64, 96, 128}; Hq a multiple of Hkv;
// dtype 0 = float32, 1 = bfloat16; window 0 = global.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Hq, int Hkv, int hd, int dtype,
                        float scale, int causal, int window, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1 && (hd == 16 || hd == 32 || hd == 64)) {
    return flash::launch_bf16<64>(q, k, v, o, B, S, Hq, Hkv, hd, scale,
                                  causal, window, st);
  }
  if (dtype == 1 && (hd == 96 || hd == 128)) {
    return flash::launch_bf16<128>(q, k, v, o, B, S, Hq, Hkv, hd, scale,
                                   causal, window, st);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16:
      return flash::launch_f32<16>(q, k, v, o, B, S, Hq, Hkv, scale, causal,
                                   window, st);
    case 32:
      return flash::launch_f32<32>(q, k, v, o, B, S, Hq, Hkv, scale, causal,
                                   window, st);
    case 64:
      return flash::launch_f32<64>(q, k, v, o, B, S, Hq, Hkv, scale, causal,
                                   window, st);
    case 96:
      return flash::launch_f32<96>(q, k, v, o, B, S, Hq, Hkv, scale, causal,
                                   window, st);
    case 128:
      return flash::launch_f32<128>(q, k, v, o, B, S, Hq, Hkv, scale, causal,
                                    window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
