// The attention forward's mainloop on Hopper's tensor cores, shared by
// flash_fwd_kernel (flash_attn.cu) and the paged prefill kernel
// (paged_attend.cu).  The two differ only in where Q and the K/V tiles
// come from and in which keys each row sees; both pass those in.
//
// A block is two consumer warpgroups, each owning 64 query rows, and one
// producer warp.  The producer fills a ring of FWD_STAGES K/V stages
// (a [64 keys][D] bf16 K tile and its V tile each) with 16-byte cp.async
// copies into the 128-byte swizzled layout; each lane waits for its own
// copies, fences them to the async proxy and arrives on the stage's
// "full" mbarrier (32 arrivals).  Both warpgroups read every stage and
// release it on its "empty" mbarrier (one arrival per warp, 8).  Per
// tile, a warpgroup runs
//   s = q . k^T          m64n64k16 wgmma, both operands in shared memory,
//                        one product per bf16 term of q (hi, then lo);
//   online softmax       in f32 on the s accumulator fragment, log2 units;
//   o += p . v           m64nDk16 wgmma with p packed from the s
//                        fragment as bf16 hi + lo A operands (two
//                        products), v read MN-major through the transpose
//                        bit.
// D, the head dim, is a template parameter (last, default HD = 128) of
// every piece here; flash_attn.cu also instantiates D = 64 (BERT's), where
// o is m64n64 (32 registers a thread) and a stage is half as large.
// The two warpgroups take turns to issue s (named barriers 1 and 2, FA3's
// ping-pong): while one runs its softmax the tensor cores work on the
// other's products.  Each row keeps a limit: key j is seen iff
// j <= lim[row]; the masked scores are -inf.  With BIAS (the Pallas
// kernels' has_bias channel, flash_attn.cu only) every score also takes
// an additive per-key bias before the softmax; without it the code is the
// mainloop the paged prefill shares, unchanged.

#pragma once

#include <math.h>

#include "hopper_mma.cuh"

namespace {

constexpr int FWD_STAGES = 4;              // K/V ring depth
constexpr int FWD_THREADS = 2 * NT + 32;   // two warpgroups + producer
constexpr float LN2 = 0.6931471805599453f;
constexpr float M_INIT = -1e30f;           // the Pallas kernels' -inf

// One block's shared memory, from a 1024-byte aligned base: the two
// warpgroups' Q tiles (NQT bf16 terms each), the K/V ring, then the
// full and empty mbarriers.
template <int NQT, int D = HD>
struct FwdSmem {
  static constexpr uint32_t RING = 2 * NQT * TILE_OF<D>;
  static constexpr uint32_t BARS = RING + FWD_STAGES * 2 * TILE_OF<D>;
  static constexpr size_t BYTES = BARS + 2 * FWD_STAGES * 8 + 1024;
};

// thread 0 only; then the block synchronises
__device__ __forceinline__ void fwd_init_barriers(uint32_t bars) {
  for (int s = 0; s < FWD_STAGES; ++s) {
    mbar_init(bars + 8 * s, 32);                  // full: producer lanes
    mbar_init(bars + 8 * (FWD_STAGES + s), 8);    // empty: consumer warps
  }
  mbar_init_fence();
}

// The producer warp: load_kv(k_dst, v_dst, it, lane) issues this lane's
// copies of K/V tile it; stage it % FWD_STAGES is refilled once both
// warpgroups have released its previous tile.
template <class LoadKV, int D = HD>
__device__ __forceinline__ void fwd_producer(uint32_t ring, uint32_t bars,
                                             int nk, int lane,
                                             LoadKV load_kv) {
  constexpr int TL = TILE_OF<D>;
  const uint32_t full = bars, empty = bars + 8 * FWD_STAGES;
  for (int it = 0; it < nk; ++it) {
    const int st = it % FWD_STAGES;
    if (it >= FWD_STAGES)
      mbar_wait(empty + 8 * st, ((it / FWD_STAGES) - 1) & 1);
    load_kv(ring + st * 2 * TL, ring + st * 2 * TL + TL, it, lane);
    cp_commit();
    if (it > 0) {  // tile it - 1 has landed (this lane's part of it)
      cp_wait<1>();
      proxy_fence();
      mbar_arrive(full + 8 * ((it - 1) % FWD_STAGES));
    }
  }
  if (nk > 0) {
    cp_wait<0>();
    proxy_fence();
    mbar_arrive(full + 8 * ((nk - 1) % FWD_STAGES));
  }
}

// Consumer warpgroup w (0 or 1) over the block's nk tiles: it computes
// the first nk_w and only releases the rest (both warpgroups walk all nk,
// so the turn-taking barriers stay paired).  sQ holds nq bf16 terms of
// this warpgroup's q tile, TILE_OF<D> bytes apart.  lim[h]: the last key
// seen by row r0 + 8 h of the tile (-1: none).  brow (BIAS only): the f32
// biases of this head's keys, in natural units.  Leaves o unnormalised, m
// in log2 units and l this thread's part of the row sums (fwd_finish
// completes them).
template <bool BIAS = false, int D = HD>
__device__ __forceinline__ void fwd_consumer(uint32_t ring, uint32_t bars,
                                             uint32_t sQ, int nq, int w,
                                             int nk, int nk_w,
                                             const int (&lim)[2],
                                             float scale2,
                                             float (&o)[D / 2],
                                             float (&m)[2], float (&l)[2],
                                             const float* brow = nullptr) {
  constexpr int TL = TILE_OF<D>;
  const int lane = threadIdx.x & 31, c0 = 2 * (lane & 3);
  const uint32_t full = bars, empty = bars + 8 * FWD_STAGES;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = M_INIT;
  l[0] = l[1] = 0.f;
  if (w == 1) bar_arrive(1, 2 * NT);  // warpgroup 0 issues first

  for (int it = 0; it < nk; ++it) {
    const int st = it % FWD_STAGES;
    const uint32_t sK = ring + st * 2 * TL, sV = sK + TL;
    const bool active = it < nk_w;
    mbar_wait(full + 8 * st, (it / FWD_STAGES) & 1);

    float s[32];
    bar_sync(1 + w, 2 * NT);  // this warpgroup's turn on the tensor cores
    if (active) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      pin(s);
      wg_fence();
      for (int t = 0; t < nq; ++t)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss(s, desc_k(sQ + t * TL, kk), desc_k(sK, kk), t | kk);
      wg_commit();
    }
    if (w == 0 || it + 1 < nk) bar_arrive(2 - w, 2 * NT);  // the other's turn

    if (active) {
      wg_wait<0>();
      pin(s);
      // raw scores: the max is taken before the scale (scale2 > 0), and
      // p = 2^(s * scale2 - m) is one fused multiply-add and one ex2; only
      // a tile that crosses a row's limit is masked.  With a bias the
      // scores are scaled first, t = s * scale2 + bias * log2(e) (a bias
      // can reorder them), and p = 2^(t - m).
      const int k0 = it * T;
      if constexpr (BIAS) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // this thread's column pair j
          const float2 b = __ldg(reinterpret_cast<const float2*>(
              brow + k0 + 8 * j + c0));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[4 * j + 2 * h] = __fmaf_rn(s[4 * j + 2 * h], scale2, b.x * LOG2E);
            s[4 * j + 2 * h + 1] =
                __fmaf_rn(s[4 * j + 2 * h + 1], scale2, b.y * LOG2E);
          }
        }
      }
      if (k0 + T - 1 > min(lim[0], lim[1])) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          if (k0 + 8 * (i >> 2) + c0 + (i & 1) > lim[h]) s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        mx[h] = fmaxf(mx[h], s[i]);
      }
      float alpha[2], nm[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        mx[h] = fmaxf(m[h], BIAS ? mx[h] : mx[h] * scale2);
        alpha[h] = ex2(m[h] - mx[h]);
        m[h] = mx[h];
        nm[h] = -mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const float p = BIAS ? ex2(s[i] + nm[h])
                             : ex2(__fmaf_rn(s[i], scale2, nm[h]));
        s[i] = p;
        l[h] += p;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t hi[4][4], lo[4][4];
      split(s, hi, lo);
      pin(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) mma_rs(o, hi[kk], desc_mn(sV, kk));
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) mma_rs(o, lo[kk], desc_mn(sV, kk));
      wg_commit();
      wg_wait<0>();
      pin(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done here
  }
}

// Complete the row sums over the quad of lanes that shares a row, divide
// o by them (the l == 0 guard of the Pallas kernels' _finish) and return
// lse = m + log l in natural units.
template <int D = HD>
__device__ __forceinline__ void fwd_finish(float (&o)[D / 2],
                                           const float (&m)[2],
                                           float (&l)[2], float (&lse)[2]) {
  float safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    safe[h] = l[h] == 0.f ? 1.f : l[h];
    lse[h] = m[h] * LN2 + logf(safe[h]);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = o[i] / safe[(i >> 1) & 1];
}

}  // namespace
