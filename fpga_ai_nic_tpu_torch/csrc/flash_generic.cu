// Flash attention forward, dq and dk/dv for the operands the tensor-core
// kernels (flash_attn.cu, flash_bwd.cu) are not built for: float32,
// bfloat16 or float16 at any head_dim the JAX package's supported() takes
// (a multiple of 8, at most 256).  The tensor-core kernels take bf16 at
// head_dim 128, Llama-3's; this family runs everything else that tiles,
// as the Pallas kernels do for every dtype and head_dim.
//
// Replaces the Pallas TPU kernels of fpga_ai_nic_tpu/ops/flash_pallas.py
// for those operands:
//   flash_fwd_generic_kernel  <- _fwd_kernel  (:93)
//   flash_dq_generic_kernel   <- _dq_kernel   (:222)
//   flash_dkv_generic_kernel  <- _dkv_kernel  (:267)
//
// Layouts as in flash_attn.cu: q / out / dq / do are [B*H, Sq, hd], k / v /
// dk / dv are [B*Hkv, Sk, hd], all in one element type E; lse and delta
// are [B*H, Sq] f32.  Query head bh reads KV head bh / G; dk/dv sum the G
// query heads of their KV head in the kernel, in a fixed order.  bias is
// the Pallas kernels' has_bias channel: an f32 [B, Sk] row of additive key
// biases (BERT's padding mask, 0 or -1e30), or null when absent; the
// grid's head index h belongs to batch h / hpb (hpb = H, or Hkv in dk/dv).
//
// What computes: the Pallas kernels' arithmetic, all in f32 on the CUDA
// cores.  Elements are widened to f32 on load; s = (q . k) * sm_scale,
// then + bias[key] where there is a bias (before the online softmax and
// before the backward's p = exp(s - lse), as the Pallas kernels add it);
// causally masked scores are -1e30 before the online softmax (forward),
// masked p is 0 (backward), as the plain versions have it; lse = m + log l with the
// l == 0 guard; p and ds stay f32 through every product; one rounding to
// E at the store.  No atomics: two launches give the same bits.
//
// The q/k offsets (the Pallas kernels' off_ref pair, the global positions
// of q's and k's first rows) enter as their difference, shift = q_offset -
// k_offset under causal (0 without): key j is seen by query row i iff
// j <= i + shift.  A shift of 0 runs the arithmetic of the launches before
// the offsets existed.  A row that sees no key writes out 0 and lse
// -1e30, as the Pallas kernel does for a chunk wholly in its future.
//
// What bounds it: operations, at the f32 rate (67 TFLOP/s), for long
// sequences; at the tiny model's shapes (S = 128, head_dim 16) the launch.
// A simple design that is right: a block of 8 warps takes 32 rows, 4 a
// warp; tiles of 32 keys (or, in dk/dv, 32 query rows) are staged in
// shared memory as f32 with an odd row stride, one key a lane for the dot
// products, then the lane's columns (lane + 32 c) for the accumulation,
// each score broadcast by a shuffle.  Causal loops stop at the last key
// any row of the block sees (forward, dq) or start at the block's first
// key (dk/dv), each moved by the shift.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RW = 4;              // rows a warp owns
constexpr int ROWS = WARPS * RW;   // rows a block owns (32)
constexpr int KT = 32;             // rows of a staged tile: one a lane
constexpr int MAXC = 8;            // columns a lane owns: hd <= 256
constexpr int MAX_HD = 32 * MAXC;
constexpr float NEG = -1e30f;      // the Pallas kernels' "minus infinity"
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename E>
__device__ __forceinline__ E narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// rows [row0, row0 + n) of a [*, hd] tensor -> f32 shared, row stride sd
template <typename E>
__device__ __forceinline__ void stage(float* dst, const E* src, int row0,
                                      int n, int hd, int sd) {
  const E* s = src + (size_t)row0 * hd;
  for (int i = threadIdx.x; i < n * hd; i += THREADS) {
    const int r = i / hd, c = i - r * hd;
    dst[r * sd + c] = widen(s[i]);
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
flash_fwd_generic_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v,
                         const float* __restrict__ bias,
                         E* __restrict__ out, float* __restrict__ lse,
                         int G, int hpb, int Sq, int Sk, int hd, int causal,
                         float sm_scale, int shift) {
  extern __shared__ float sm[];
  const int sd = hd + 1;
  float* Qs = sm;                   // [ROWS][hd]
  float* Ks = Qs + ROWS * hd;       // [KT][sd]
  float* Vs = Ks + KT * sd;         // [KT][sd]
  const int bh = blockIdx.y, kvh = bh / G, r0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const E* kb = k + (size_t)kvh * Sk * hd;
  const E* vb = v + (size_t)kvh * Sk * hd;
  const float* brow = bias ? bias + (size_t)(bh / hpb) * Sk : nullptr;
  stage(Qs, q + (size_t)bh * Sq * hd, r0, ROWS, hd, hd);
  float m[RW], l[RW], o[RW][MAXC];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) o[r][c] = 0.f;
  }
  const int nk = causal ? max(0, min(Sk, r0 + ROWS + shift)) : Sk;
  for (int k0 = 0; k0 < nk; k0 += KT) {
    __syncthreads();                // the last tile is consumed
    stage(Ks, kb, k0, KT, hd, sd);
    stage(Vs, vb, k0, KT, hd, sd);
    __syncthreads();
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float kk = Ks[lane * sd + d];
#pragma unroll
      for (int r = 0; r < RW; ++r)
        s[r] = __fmaf_rn(Qs[(w * RW + r) * hd + d], kk, s[r]);
    }
    const int key = k0 + lane;
    const float kbias = brow ? brow[key] : 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = r0 + w * RW + r;
      float sr = __fmul_rn(s[r], sm_scale);
      if (brow) sr = __fadd_rn(sr, kbias);
      if (causal && key > row + shift) sr = NEG;
      const float mn = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - mn);
      const float p = expf(sr - mn);
      l[r] = __fmaf_rn(l[r], alpha, warp_sum(p));
#pragma unroll
      for (int c = 0; c < MAXC; ++c) o[r][c] = __fmul_rn(o[r][c], alpha);
      m[r] = mn;
      s[r] = p;
    }
    for (int j = 0; j < KT; ++j) {
      float pj[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) pj[r] = __shfl_sync(FULL, s[r], j);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int col = lane + 32 * c;
        if (col < hd) {
          const float vv = Vs[j * sd + col];
#pragma unroll
          for (int r = 0; r < RW; ++r) o[r][c] = __fmaf_rn(pj[r], vv, o[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const size_t row = (size_t)bh * Sq + r0 + w * RW + r;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    const bool dead = causal && r0 + w * RW + r + shift < 0;  // sees no key
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int col = lane + 32 * c;
      if (col < hd)
        out[row * hd + col] = narrow<E>(dead ? 0.f : __fdiv_rn(o[r][c], safe));
    }
    if (lane == 0) lse[row] = dead ? NEG : __fadd_rn(m[r], logf(safe));
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
flash_dq_generic_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias, E* __restrict__ dq,
                        int G, int hpb, int Sq, int Sk, int hd, int causal,
                        float sm_scale, int shift) {
  extern __shared__ float sm[];
  const int sd = hd + 1;
  float* Qs = sm;                   // [ROWS][hd]
  float* Ds = Qs + ROWS * hd;       // [ROWS][hd]  dO
  float* Ks = Ds + ROWS * hd;       // [KT][sd]
  float* Vs = Ks + KT * sd;         // [KT][sd]
  const int bh = blockIdx.y, kvh = bh / G, r0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const E* kb = k + (size_t)kvh * Sk * hd;
  const E* vb = v + (size_t)kvh * Sk * hd;
  const float* brow = bias ? bias + (size_t)(bh / hpb) * Sk : nullptr;
  stage(Qs, q + (size_t)bh * Sq * hd, r0, ROWS, hd, hd);
  stage(Ds, dout + (size_t)bh * Sq * hd, r0, ROWS, hd, hd);
  float lr[RW], dr[RW], acc[RW][MAXC];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const size_t row = (size_t)bh * Sq + r0 + w * RW + r;
    lr[r] = lse[row];
    dr[r] = delta[row];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[r][c] = 0.f;
  }
  const int nk = causal ? max(0, min(Sk, r0 + ROWS + shift)) : Sk;
  for (int k0 = 0; k0 < nk; k0 += KT) {
    __syncthreads();
    stage(Ks, kb, k0, KT, hd, sd);
    stage(Vs, vb, k0, KT, hd, sd);
    __syncthreads();
    float s[RW], dp[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = dp[r] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float kk = Ks[lane * sd + d], vv = Vs[lane * sd + d];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        s[r] = __fmaf_rn(Qs[(w * RW + r) * hd + d], kk, s[r]);
        dp[r] = __fmaf_rn(Ds[(w * RW + r) * hd + d], vv, dp[r]);
      }
    }
    const int key = k0 + lane;
    const float kbias = brow ? brow[key] : 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = r0 + w * RW + r;
      float t = __fmul_rn(s[r], sm_scale);
      if (brow) t = __fadd_rn(t, kbias);
      float p = expf(__fsub_rn(t, lr[r]));
      if (causal && key > row + shift) p = 0.f;
      s[r] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[r], dr[r])), sm_scale);
    }
    for (int j = 0; j < KT; ++j) {
      float dsj[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) dsj[r] = __shfl_sync(FULL, s[r], j);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int col = lane + 32 * c;
        if (col < hd) {
          const float kk = Ks[j * sd + col];
#pragma unroll
          for (int r = 0; r < RW; ++r)
            acc[r][c] = __fmaf_rn(dsj[r], kk, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const size_t row = (size_t)bh * Sq + r0 + w * RW + r;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int col = lane + 32 * c;
      if (col < hd) dq[row * hd + col] = narrow<E>(acc[r][c]);
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
flash_dkv_generic_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias,
                         E* __restrict__ dk, E* __restrict__ dv, int G,
                         int hpb, int Sq, int Sk, int hd, int causal,
                         float sm_scale, int shift) {
  extern __shared__ float sm[];
  const int sd = hd + 1;
  float* Kr = sm;                   // [ROWS][hd]  the block's keys
  float* Vr = Kr + ROWS * hd;       // [ROWS][hd]
  float* Qs = Vr + ROWS * hd;       // [KT][sd]
  float* Ds = Qs + KT * sd;         // [KT][sd]  dO
  float* Ls = Ds + KT * sd;         // [KT]
  float* Dl = Ls + KT;              // [KT]
  const int kvh = blockIdx.y, c0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  stage(Kr, k + (size_t)kvh * Sk * hd, c0, ROWS, hd, hd);
  stage(Vr, v + (size_t)kvh * Sk * hd, c0, ROWS, hd, hd);
  // the biases of this warp's keys: one per row it owns
  float kbias[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r)
    kbias[r] = bias ? bias[(size_t)(kvh / hpb) * Sk + c0 + w * RW + r] : 0.f;
  float gk[RW][MAXC], gv[RW][MAXC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) gk[r][c] = gv[r][c] = 0.f;
  // query rows before c0 - shift see none of the block's keys under the
  // mask; the loop starts at the tile (KT rows) that holds the first one
  const int first = c0 - shift;
  const int q_first = causal && first > 0 ? min(Sq, first / KT * KT) : 0;
  for (int g = 0; g < G; ++g) {
    const int bh = kvh * G + g;
    const E* qb = q + (size_t)bh * Sq * hd;
    const E* db = dout + (size_t)bh * Sq * hd;
    for (int q0 = q_first; q0 < Sq; q0 += KT) {
      __syncthreads();
      stage(Qs, qb, q0, KT, hd, sd);
      stage(Ds, db, q0, KT, hd, sd);
      if (threadIdx.x < KT) {
        Ls[threadIdx.x] = lse[(size_t)bh * Sq + q0 + threadIdx.x];
        Dl[threadIdx.x] = delta[(size_t)bh * Sq + q0 + threadIdx.x];
      }
      __syncthreads();
      float s[RW], dp[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = dp[r] = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float qq = Qs[lane * sd + d], dd = Ds[lane * sd + d];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          s[r] = __fmaf_rn(qq, Kr[(w * RW + r) * hd + d], s[r]);
          dp[r] = __fmaf_rn(dd, Vr[(w * RW + r) * hd + d], dp[r]);
        }
      }
      const int qrow = q0 + lane;
      const float lq = Ls[lane], dq_ = Dl[lane];
      float p[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int key = c0 + w * RW + r;
        float t = __fmul_rn(s[r], sm_scale);
        if (bias) t = __fadd_rn(t, kbias[r]);
        p[r] = expf(__fsub_rn(t, lq));
        if (causal && key > qrow + shift) p[r] = 0.f;
        s[r] = __fmul_rn(__fmul_rn(p[r], __fsub_rn(dp[r], dq_)), sm_scale);
      }
      for (int i = 0; i < KT; ++i) {
        float pi[RW], dsi[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          pi[r] = __shfl_sync(FULL, p[r], i);
          dsi[r] = __shfl_sync(FULL, s[r], i);
        }
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int col = lane + 32 * c;
          if (col < hd) {
            const float dd = Ds[i * sd + col], qq = Qs[i * sd + col];
#pragma unroll
            for (int r = 0; r < RW; ++r) {
              gv[r][c] = __fmaf_rn(pi[r], dd, gv[r][c]);
              gk[r][c] = __fmaf_rn(dsi[r], qq, gk[r][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const size_t row = (size_t)kvh * Sk + c0 + w * RW + r;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int col = lane + 32 * c;
      if (col < hd) {
        dk[row * hd + col] = narrow<E>(gk[r][c]);
        dv[row * hd + col] = narrow<E>(gv[r][c]);
      }
    }
  }
}

bool bad_shape(int G, int Sq, int Sk, int hd) {
  return G < 1 || Sq % ROWS || Sk % ROWS || hd % 8 || hd < 8 || hd > MAX_HD;
}

template <typename Kern>
int prep(Kern kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename E>
int fwd(const void* q, const void* k, const void* v, const void* bias,
        void* out, void* lse, int BH, int G, int hpb, int Sq, int Sk, int hd,
        int causal, float sm_scale, int shift, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (ROWS * hd + 2 * KT * (hd + 1));
  const int err = prep(flash_fwd_generic_kernel<E>, smem);
  if (err) return err;
  flash_fwd_generic_kernel<E><<<dim3(Sq / ROWS, BH), THREADS, smem, stream>>>(
      (const E*)q, (const E*)k, (const E*)v, (const float*)bias, (E*)out,
      (float*)lse, G, hpb, Sq, Sk, hd, causal, sm_scale, shift);
  return (int)cudaGetLastError();
}

template <typename E>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, const void* bias, void* dq_,
       int BH, int G, int hpb, int Sq, int Sk, int hd, int causal,
       float sm_scale, int shift, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * ROWS * hd + 2 * KT * (hd + 1));
  const int err = prep(flash_dq_generic_kernel<E>, smem);
  if (err) return err;
  flash_dq_generic_kernel<E><<<dim3(Sq / ROWS, BH), THREADS, smem, stream>>>(
      (const E*)q, (const E*)k, (const E*)v, (const E*)dout,
      (const float*)lse, (const float*)delta, (const float*)bias, (E*)dq_, G,
      hpb, Sq, Sk, hd, causal, sm_scale, shift);
  return (int)cudaGetLastError();
}

template <typename E>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* bias, void* dk,
        void* dv, int BHkv, int G, int hpb, int Sq, int Sk, int hd,
        int causal, float sm_scale, int shift, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * ROWS * hd + 2 * KT * (hd + 1) + 2 * KT);
  const int err = prep(flash_dkv_generic_kernel<E>, smem);
  if (err) return err;
  flash_dkv_generic_kernel<E><<<dim3(Sk / ROWS, BHkv), THREADS, smem,
                                stream>>>(
      (const E*)q, (const E*)k, (const E*)v, (const E*)dout,
      (const float*)lse, (const float*)delta, (const float*)bias, (E*)dk,
      (E*)dv, G, hpb, Sq, Sk, hd, causal, sm_scale, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (ops/flash_attention.py's
// GENERIC_DTYPES); bias: f32 [B, Sk] or null; hpb: H (forward, dq) or Hkv
// (dk/dv), the grid's heads a batch; q_offset / k_offset: the global
// positions of q's and k's first rows, last (they change nothing without
// causal)
extern "C" {

#define GENERIC_DISPATCH(FN, ...)                                          \
  switch (dtype) {                                                         \
    case 0: return FN<float>(__VA_ARGS__);                                 \
    case 1: return FN<__nv_bfloat16>(__VA_ARGS__);                         \
    case 2: return FN<__half>(__VA_ARGS__);                                \
  }                                                                        \
  return (int)cudaErrorInvalidValue;

int flash_fwd_generic_launch(const void* q, const void* k, const void* v,
                             const void* bias, void* out, void* lse,
                             int dtype, int BH, int G, int hpb, int Sq,
                             int Sk, int hd, int causal, float sm_scale,
                             int q_offset, int k_offset,
                             cudaStream_t stream) {
  if (bad_shape(G, Sq, Sk, hd) || hpb < 1) return (int)cudaErrorInvalidValue;
  const int shift = causal ? q_offset - k_offset : 0;
  GENERIC_DISPATCH(fwd, q, k, v, bias, out, lse, BH, G, hpb, Sq, Sk, hd,
                   causal, sm_scale, shift, stream)
}

int flash_dq_generic_launch(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* bias, void* dq_,
                            int dtype, int BH, int G, int hpb, int Sq, int Sk,
                            int hd, int causal, float sm_scale,
                            int q_offset, int k_offset,
                            cudaStream_t stream) {
  if (bad_shape(G, Sq, Sk, hd) || hpb < 1) return (int)cudaErrorInvalidValue;
  const int shift = causal ? q_offset - k_offset : 0;
  GENERIC_DISPATCH(dq, q, k, v, dout, lse, delta, bias, dq_, BH, G, hpb, Sq,
                   Sk, hd, causal, sm_scale, shift, stream)
}

int flash_dkv_generic_launch(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* bias, void* dk,
                             void* dv, int dtype, int BHkv, int G, int hpb,
                             int Sq, int Sk, int hd, int causal,
                             float sm_scale, int q_offset, int k_offset,
                             cudaStream_t stream) {
  if (bad_shape(G, Sq, Sk, hd) || hpb < 1) return (int)cudaErrorInvalidValue;
  const int shift = causal ? q_offset - k_offset : 0;
  GENERIC_DISPATCH(dkv, q, k, v, dout, lse, delta, bias, dk, dv, BHkv, G,
                   hpb, Sq, Sk, hd, causal, sm_scale, shift, stream)
}

#undef GENERIC_DISPATCH

}  // extern "C"
