// Flash attention forward for Hopper.  (The backward, dq and dk/dv, is in
// flash_bwd.cu.)
//
// Replaces the Pallas TPU kernel of fpga_ai_nic_tpu/ops/flash_pallas.py:
//   flash_fwd_kernel  <- _fwd_kernel  (:93)
//
// Layouts: q / out are [B*H, S, 128] bf16, k / v are [B*Hkv, S, 128] bf16,
// lse is [B*H, S] f32.  GQA is handled by indexing: query head bh reads KV
// head bh / G (G = H / Hkv).
//
// What computes: the Pallas kernel's arithmetic.  Scores s = (q . k) *
// sm_scale from bf16 products (exact in f32) summed in f32; online softmax
// with running max, normalizer and accumulator in f32; lse = m + log l
// with the l == 0 guard of _finish.  p stays f32 through the p.v product:
// nothing is rounded to bf16 or TF32 before the final store.
//
// What bounds it on this card: at Llama-3-8B's training shape (S = 4096,
// 32 heads, causal) it is bound by its operations (2*S^2*hd multiply-adds
// per GEMM-like product and head, halved by causality), hundreds of
// operations per byte moved.  The card's bf16 tensor cores would do them
// at 989 TFLOP/s; this first version runs them as f32 fused multiply-adds
// on the CUDA cores (67 TFLOP/s peak), so it is expected to sit well above
// the bound.
//
// What the design does about it: one block of 256 threads per 64-row
// tile; the TPU's sequential grid axis becomes a loop over the k tiles,
// staged through shared memory as f32 and read with padded strides (no
// bank conflicts); each thread owns a 4 x 4 block of scores and a 4 x 8
// block of the f32 accumulator in registers, so every shared-memory read
// feeds 4-8 multiply-adds.  The causal loop stops at the diagonal tile,
// skipping the masked half.  Blocks are ordered so the longest tiles
// start first.  Tensor-core tiles (wgmma, as flash_bwd.cu) are the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;        // head dim (Llama-3's); the only one built
constexpr int T = 64;          // rows of a q or k tile
constexpr int NT = 256;        // threads per block: 16 x 16
constexpr int SD = HD + 1;     // padded row stride of a [T][HD] f32 tile
constexpr int SP = T + 4;      // padded row stride of a [T][T] f32 tile
constexpr float NEG = -1e30f;  // the Pallas kernels' "minus infinity"

typedef __nv_bfloat16 bf16;

constexpr size_t TILE_FLOATS = (size_t)T * SD;

// [T][HD] bf16 rows at src (row stride HD) -> f32 shared tile (stride SD)
__device__ __forceinline__ void load_tile(float* dst, const bf16* src,
                                          int tid) {
  for (int v = tid; v < T * HD / 8; v += NT) {
    const int row = v / (HD / 8), col = (v % (HD / 8)) * 8;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + (size_t)row * HD + col);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    float* d = dst + row * SD + col;
#pragma unroll
    for (int t = 0; t < 8; ++t) d[t] = __bfloat162float(e[t]);
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[i][j] += A[ra + i][d] * B[rb + 16 j][d] over d: a 4 x 4 block of
// A . B^T from two [T][HD] shared tiles (A's rows broadcast, B's rows
// spread over the 16 lanes of a row group)
__device__ __forceinline__ void dot_tiles(float acc[4][4], const float* A,
                                          int ra, const float* B, int rb) {
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ra + i) * SD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(rb + 16 * j) * SD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
  }
}

// acc[i][jj] += sum_c P[ri + i][c] * V[c][tx + 16 jj]: 4 rows x 8 columns
// of P . V from a [T][T] tile (stride SP) and a [T][HD] tile (stride SD)
__device__ __forceinline__ void pv_tiles(float acc[4][8], const float* P,
                                         int ri, const float* V, int tx) {
#pragma unroll 4
  for (int c = 0; c < T; ++c) {
    float p[4], v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ri + i) * SP + c];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) v[jj] = V[c * SD + tx + 16 * jj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        acc[i][jj] = __fmaf_rn(p[i], v[jj], acc[i][jj]);
  }
}

__device__ __forceinline__ void store_rows(bf16* dst, const float acc[4][8],
                                           int ri, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      dst[(size_t)(ri + i) * HD + tx + 16 * jj] = __float2bfloat16(acc[i][jj]);
}

// ---------------------------------------------------------------------------
// forward: one block per (query head, q tile); loop over k tiles
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int G, int Sq, int Sk,
                 int causal, float sm_scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + TILE_FLOATS;
  float* sV = sK + TILE_FLOATS;
  float* sP = sK;  // scores reuse the K tile once it has been read
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, ri = ty * 4;
  const int bh = blockIdx.y, kvh = bh / G;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int q0 = qt * T;
  const bf16* kb = k + (size_t)kvh * Sk * HD;
  const bf16* vb = v + (size_t)kvh * Sk * HD;
  load_tile(sQ, q + ((size_t)bh * Sq + q0) * HD, tid);

  float m[4], l[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) o[i][jj] = 0.f;
  }
  int nk = Sk / T;
  if (causal) nk = min(nk, qt + 1);  // tiles past the diagonal see nothing
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * T;
    __syncthreads();
    load_tile(sK, kb + (size_t)k0 * HD, tid);
    load_tile(sV, vb + (size_t)k0 * HD, tid);
    __syncthreads();
    float s[4][4] = {};
    dot_tiles(s, sQ, ri, sK, tx);
    __syncthreads();  // every thread is done with sK before sP overwrites it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mb = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * sm_scale;
        if (causal && k0 + tx + 16 * j > q0 + ri + i) x = NEG;
        s[i][j] = x;
        mb = fmaxf(mb, x);
      }
      const float mn = fmaxf(m[i], max16(mb));
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        sP[(ri + i) * SP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + sum16(ps);
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) o[i][jj] *= alpha;
    }
    __syncthreads();
    pv_tiles(o, sP, ri, sV, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) o[i][jj] = o[i][jj] / safe;
    if (tx == 0) lse[(size_t)bh * Sq + q0 + ri + i] = m[i] + logf(safe);
  }
  store_rows(out + ((size_t)bh * Sq + q0) * HD, o, ri, tx);
}

template <typename K>
int launch_prep(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// C interface (ctypes).  BH = B * H query heads, G = H / Hkv; Sq and Sk
// are multiples of 64; every pointer is 16-byte aligned and contiguous.
// Each returns the launch's cudaError_t.
extern "C" {

int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int BH, int G, int Sq, int Sk, int causal,
                     float sm_scale, cudaStream_t stream) {
  const size_t smem = 3 * TILE_FLOATS * sizeof(float);
  int err = launch_prep(flash_fwd_kernel, smem);
  if (err) return err;
  flash_fwd_kernel<<<dim3(Sq / T, BH), NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, G, Sq, Sk, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
