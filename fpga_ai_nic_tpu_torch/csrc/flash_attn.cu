// Flash attention forward for Hopper's tensor cores.  (The backward, dq
// and dk/dv, is in flash_bwd.cu.)
//
// Replaces the Pallas TPU kernel of fpga_ai_nic_tpu/ops/flash_pallas.py:
//   flash_fwd_kernel  <- _fwd_kernel  (:93)
//
// Layouts: q / out are [B*H, S, D] bf16, k / v are [B*Hkv, S, D] bf16,
// lse is [B*H, S] f32, with D (the head dim) 128 (Llama's) or 64 (BERT's),
// a template parameter of the kernel, last, so the head_dim-128 launch is
// the kernel it was before D existed.  GQA is handled by indexing: query
// head bh reads KV head bh / G (G = H / Hkv).  The key bias (the Pallas
// kernel's has_bias, BERT's padding mask) is an f32 [B, Sk] row added to
// every score of the batch's heads before the softmax; it is a template
// flag (BIAS), so the launch without it is the kernel it was before the
// channel existed.  The q/k offsets (the Pallas kernel's off_ref pair, the
// global positions of q's and k's first rows) enter only as their
// difference, shift = q_offset - k_offset under causal: key j is seen by
// query row i iff j <= i + shift.  A non-zero shift takes the OFF
// instantiation (a template flag, last), so a launch with zero offsets is
// the kernel it was before the channel existed.  With OFF, a row that sees
// no key writes out 0 and lse -1e30 (the Pallas kernel's skipped-block
// result), and a block none of whose rows sees a key writes just that.
//
// What computes: the Pallas kernel's arithmetic.  s = q . k^T is a bf16
// product summed in f32 (exact operands); the online softmax runs in f32;
// lse = m + log l with the l == 0 guard of _finish.  The contract keeps p
// in f32 through p . v, and the tensor cores take bf16, so p enters that
// product as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), both
// summed in f32: p is carried to about 16 bits (ops/flash_attention.py
// gives the CPU emulation's tol_ratio).  The output is rounded to bf16
// once, at the end.  No atomics: two launches give the same bits.
//
// What bounds it on this card: operations.  At Llama-3-8B's training shape
// (S = 4096, 32 heads, 8 KV heads, causal) it does 2 products of depth 128
// per visible (row, key) pair, hundreds of operations per byte moved; the
// split makes them 3 tensor-core passes.  Only the bf16 tensor cores
// (989 TFLOP/s) come near that bound.  At BERT's shape (head_dim 64,
// S = 512, a quarter of the keys padded) the bytes bound it (q, k, v and
// out once), a little above the operations of the valid pairs.
//
// What the design does about it: attn_fwd.cuh's mainloop.  A block takes
// two consecutive 64-row q tiles of one head, one per consumer warpgroup,
// which share a 4-stage ring of K/V tiles filled by a producer warp
// (cp.async into the 128-byte swizzle, mbarriers) and take turns on the
// tensor cores, so one's softmax overlaps the other's products.  Causal
// loops stop at each warpgroup's diagonal tile (the first warpgroup skips
// the block's last tile), and blocks are dealt longest first across all
// heads.  At head_dim 128, 160 KB of shared memory: one block an SM.  At
// head_dim 64 a tile row is one 128-byte swizzle atom, o is m64n64 (32
// registers) and a block takes about 81 KB (two 8 KB q tiles and four
// 16 KB K/V stages), so it is built for two blocks an SM (96 registers,
// no spills): at BERT's shape (S = 512, 96 heads) the grid is 384
// blocks, 1.5 waves on 132 SMs where one block an SM would take three
// (codec_probe.py --flash64 times both builds).

#include "attn_fwd.cuh"

namespace {

// blocks an SM each head dim's instantiation is built for
template <int D>
constexpr int FWD_BLOCKS = D == 128 ? 1 : 2;

// the causal k tiles a q tile (rows qt T .. qt T + 63) computes: the
// tiles up to the one holding its last row's last visible key
__device__ __forceinline__ int visible_tiles(int qt, int shift, int nkt) {
  const int last = qt * T + T - 1 + shift;
  return last < 0 ? 0 : min(nkt, last / T + 1);
}

template <bool BIAS, int D = HD, bool OFF = false>
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS<D>)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int G, int Sq, int Sk,
                 int causal, float sm_scale,
                 const float* __restrict__ bias, int H, int qk_shift) {
  using FlashSmem = FwdSmem<1, D>;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t ring = base + FlashSmem::RING;
  const uint32_t bars = base + FlashSmem::BARS;
  const int tid = threadIdx.x;
  // longest causal pairs first, across all heads
  const int BH = gridDim.y, id = blockIdx.x + gridDim.x * blockIdx.y;
  const int qp = gridDim.x - 1 - id / BH, bh = id % BH, kvh = bh / G;
  const int nqt = Sq / T, nkt = Sk / T;
  const int shift = OFF ? qk_shift : 0;
  int nkw[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int qt = 2 * qp + w;
    if constexpr (OFF)
      nkw[w] = qt >= nqt ? 0 : causal ? visible_tiles(qt, shift, nkt) : nkt;
    else
      nkw[w] = qt >= nqt ? 0 : causal ? min(nkt, qt + 1) : nkt;
  }
  const int nk = max(nkw[0], nkw[1]);
  if constexpr (OFF) {
    if (nk == 0) {  // no row of the block sees a key
      const int q0 = 2 * qp * T, rows = min(2 * T, Sq - q0);
      bf16* o = out + ((size_t)bh * Sq + q0) * D;
      for (int i = tid; i < rows * D; i += FWD_THREADS)
        o[i] = __float2bfloat16_rn(0.f);
      for (int i = tid; i < rows; i += FWD_THREADS)
        lse[(size_t)bh * Sq + q0 + i] = M_INIT;
      return;
    }
  }
  if (tid == 0) fwd_init_barriers(bars);
  __syncthreads();

  if (tid >= 2 * NT) {  // the producer warp
    const bf16* kb = k + (size_t)kvh * Sk * D;
    const bf16* vb = v + (size_t)kvh * Sk * D;
    auto load_kv = [&](uint32_t dk, uint32_t dv, int it, int lane) {
      load_tile_by<32, D>(dk, kb + (size_t)it * T * D, lane);
      load_tile_by<32, D>(dv, vb + (size_t)it * T * D, lane);
    };
    fwd_producer<decltype(load_kv), D>(ring, bars, nk, tid - 2 * NT,
                                       load_kv);
    return;
  }

  const int w = tid >> 7, t = tid & (NT - 1);
  const int qt = 2 * qp + w;
  const bool valid = qt < nqt;
  const uint32_t sQ = base + w * TILE_OF<D>;
  const size_t row0 = (size_t)bh * Sq + (size_t)qt * T;
  if (valid) load_tile<D>(sQ, q + row0 * D, t);
  cp_commit();
  cp_wait<0>();
  proxy_fence();
  bar_sync(3 + w, NT);  // this warpgroup's q tile is in place

  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2), c0 = 2 * (t & 3);
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lim[h] = causal ? qt * T + r0 + 8 * h + shift : Sk - 1;
  float o[D / 2], m[2], l[2], ls[2];
  fwd_consumer<BIAS, D>(ring, bars, sQ, 1, w, nk, w ? nkw[1] : nkw[0], lim,
                        sm_scale * LOG2E, o, m, l,
                        BIAS ? bias + (size_t)(bh / H) * Sk : nullptr);
  if (!valid) return;
  fwd_finish<D>(o, m, l, ls);
  if constexpr (OFF) {  // a row that saw no key: lse -1e30, as JAX's
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (l[h] == 0.f) ls[h] = M_INIT;
  }
  store_tile<D>(out + row0 * D, o, r0, c0);
  if ((t & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) lse[row0 + r0 + 8 * h] = ls[h];
  }
}

template <bool BIAS, int D, bool OFF>
int fwd(const void* q, const void* k, const void* v, const void* bias,
        void* out, void* lse, int BH, int G, int H, int Sq, int Sk,
        int causal, float sm_scale, int shift, cudaStream_t stream) {
  constexpr size_t smem = FwdSmem<1, D>::BYTES;
  int err = launch_prep(flash_fwd_kernel<BIAS, D, OFF>, smem);
  if (err) return err;
  const int pairs = (Sq / T + 1) / 2;
  flash_fwd_kernel<BIAS, D, OFF>
      <<<dim3(pairs, BH), FWD_THREADS, smem, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
          (float*)lse, G, Sq, Sk, causal, sm_scale, (const float*)bias, H,
          shift);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_at(const void* q, const void* k, const void* v, const void* bias,
           void* out, void* lse, int BH, int G, int H, int Sq, int Sk,
           int causal, float sm_scale, int shift, cudaStream_t stream) {
  if (shift)
    return bias ? fwd<true, D, true>(q, k, v, bias, out, lse, BH, G, H, Sq,
                                     Sk, causal, sm_scale, shift, stream)
                : fwd<false, D, true>(q, k, v, bias, out, lse, BH, G, H, Sq,
                                      Sk, causal, sm_scale, shift, stream);
  return bias ? fwd<true, D, false>(q, k, v, bias, out, lse, BH, G, H, Sq,
                                    Sk, causal, sm_scale, 0, stream)
              : fwd<false, D, false>(q, k, v, bias, out, lse, BH, G, H, Sq,
                                     Sk, causal, sm_scale, 0, stream);
}

}  // namespace

// C interface (ctypes).  BH = B * H query heads, G = H / Hkv; Sq and Sk
// are multiples of 64; every pointer is 16-byte aligned and contiguous;
// bias is f32 [B, Sk] or null (the kernel without the channel); hd, the
// head dim, picks the instantiation (128 or 64; any other is refused with
// cudaErrorInvalidValue, nothing launched).  Returns the launch's
// cudaError_t.  q_offset / k_offset: the global positions of q's and k's
// first rows; under causal their difference picks the instantiation (0:
// the one without offsets); without causal they change nothing.
extern "C" {

int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const void* bias, void* out, void* lse, int BH, int G,
                     int H, int Sq, int Sk, int causal, float sm_scale,
                     int hd, int q_offset, int k_offset,
                     cudaStream_t stream) {
  const int shift = causal ? q_offset - k_offset : 0;
  if (hd == 128)
    return fwd_at<128>(q, k, v, bias, out, lse, BH, G, H, Sq, Sk, causal,
                       sm_scale, shift, stream);
  if (hd == 64)
    return fwd_at<64>(q, k, v, bias, out, lse, BH, G, H, Sq, Sk, causal,
                      sm_scale, shift, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
