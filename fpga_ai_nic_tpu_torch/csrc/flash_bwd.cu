// Flash attention backward for Hopper's tensor cores: dq and dk/dv.
//
// Replaces the Pallas TPU kernels of fpga_ai_nic_tpu/ops/flash_pallas.py:
//   flash_dq_kernel   <- _dq_kernel   (:222)
//   flash_dkv_kernel  <- _dkv_kernel  (:267)
//
// Layouts: q / dout / dq are [B*H, S, D] bf16, k / v / dk / dv are
// [B*Hkv, S, D] bf16, lse / delta are [B*H, S] f32.  D, the head dim, is
// 128 (Llama's) or 64 (BERT's): a template parameter of both kernels,
// last, so the head_dim-128 launch is the kernel it was before D existed.
// At D = 64 s and dp take 4 k steps, the updates (dq = ds . k, dk =
// ds^T . q, dv = p^T . dO) are m64n64k16 products into 32 accumulators
// each, and a block takes about 49 KB (dq: Q, dO and two K/V stages of
// 8 KB tiles) or 50 KB (dk/dv: K, V and two Q/dO/lse/delta stages) of
// shared memory, so registers, not shared memory, decide how many blocks
// share an SM (DQ_BLOCKS, DKV_BLOCKS).  GQA is
// handled by indexing: query head bh reads KV head bh / G (G = H / Hkv);
// the dk/dv kernel sums the G query heads of its KV head itself, in a
// fixed order.
// The key bias (the Pallas kernels' has_bias, BERT's padding mask) is an
// f32 [B, Sk] row, a template flag (BIAS) of both kernels: with it, p is
// recomputed as exp(s * sm_scale + bias - lse) on every tile, so a masked
// key's p is 0 wherever it lies, not only where the causal index test of
// the diagonal tile reaches; without it the kernels are unchanged.
// The q/k offsets (the Pallas kernels' off_ref pair) enter only as their
// difference, shift = q_offset - k_offset under causal: key j is seen by
// query row i iff j <= i + shift.  A non-zero shift takes the OFF
// instantiation of each kernel (a template flag, last), so a launch with
// zero offsets is the kernel it was before the channel existed: dq walks
// the k tiles up to its last row's last visible key, dk/dv starts at the
// first q tile whose last row sees its first key, and the mask is applied
// on the tiles that straddle the boundary.  A tile with nothing to
// compute stores zeros (dq of rows that see no key, dk/dv of keys no row
// sees).
//
// What computes: the Pallas kernels' recompute.  s = q . k^T and
// dp = dO . v^T are bf16 products summed in f32 (exact operands);
// p = exp(s * sm_scale - lse) and ds = p * (dp - delta) * sm_scale are
// formed in f32 registers; dq = ds . k, dk = ds^T . q, dv = p^T . dO.
// The tensor cores take bf16 operands, so p and ds enter those three
// products as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), each
// product summed in f32: x is carried to about 16 bits where one bf16
// rounding keeps 8 (ops/flash_attention.py states why one rounding was
// refused).  Each output is rounded to bf16 once, at the end.  No atomics:
// every output element is summed by one block in a fixed order, so two
// launches on the same inputs give the same bits.
//
// What bounds it on this card: operations.  At Llama-3-8B's training shape
// (S = 4096, 32 heads, 8 KV heads, causal) the function needs 3 (dq) and
// 4 (dk/dv) products of depth 128 per visible (row, key) pair, hundreds of
// operations per byte moved; the split makes them 4 and 6 tensor-core
// passes.  The bf16 tensor cores (989 TFLOP/s) are the only unit that can
// come near that bound; the CUDA cores' f32 peak (67 TFLOP/s) cannot.
//
// What the design does about it: one warpgroup (128 threads) per 64-row
// output tile; every product is a wgmma (m64n64k16 for s and dp with both
// operands in shared memory, m64n128k16 for the updates with A = the
// hi/lo fragments straight from the s/dp accumulators' registers, as
// FlashAttention-3 does).  Tiles sit in shared memory in the 128-byte
// swizzled layout the wgmma descriptors read, filled by 16-byte cp.async
// copies through a two-stage ring, so the next tile's copy overlaps this
// tile's products.  Each tile is stored once, rows along the sequence:
// products that need it K-major (s, dp) and MN-major (dq, dk, dv: B runs
// along the sequence) read the same bytes, the latter through the
// descriptor's transpose bit.  At head_dim 128 blocks take about 97 KB of
// shared memory, so two share an SM.  Causal tiles past the diagonal are
// skipped, the mask is applied on the diagonal tile only, and blocks are
// dealt longest first across all heads.

#include "hopper_mma.cuh"

namespace {

// -- dq: one block per (query head, q tile); loop over k tiles ---------------

// blocks an SM each head dim's dq instantiation is built for
template <int D>
constexpr int DQ_BLOCKS = D == 128 ? 2 : 3;

template <bool BIAS, int D = HD, bool OFF = false>
__global__ void __launch_bounds__(NT, DQ_BLOCKS<D>)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int G, int Sq, int Sk, int causal, float sm_scale,
                const float* __restrict__ bias, int H, int qk_shift) {
  extern __shared__ uint8_t smem[];
  constexpr int TL = TILE_OF<D>;
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sDO = sQ + TL;
  const uint32_t sKV = sDO + TL;  // stage s: K at sKV + 2 s TL, V after
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int r0 = 16 * w + (l >> 2), c0 = 2 * (l & 3);
  // longest causal tiles first, across all heads
  const int BH = gridDim.y, id = blockIdx.x + gridDim.x * blockIdx.y;
  const int qt = gridDim.x - 1 - id / BH, bh = id % BH, kvh = bh / G;
  const int q0 = qt * T;
  const size_t row0 = (size_t)bh * Sq + q0;
  const bf16* kb = k + (size_t)kvh * Sk * D;
  const bf16* vb = v + (size_t)kvh * Sk * D;
  const int shift = OFF ? qk_shift : 0;
  int nk = Sk / T;
  if constexpr (OFF) {  // tiles past the last row's last key see nothing
    const int last = q0 + T - 1 + shift;
    if (causal) nk = last < 0 ? 0 : min(nk, last / T + 1);
  } else if (causal) {
    nk = min(nk, qt + 1);  // tiles past the diagonal see nothing
  }

  load_tile<D>(sQ, q + row0 * D, tid);
  load_tile<D>(sDO, dout + row0 * D, tid);
  load_tile<D>(sKV, kb, tid);
  load_tile<D>(sKV + TL, vb, tid);
  cp_commit();
  const float scale2 = sm_scale * LOG2E;
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lr[h] = lse[row0 + r0 + 8 * h] * LOG2E;
    dr[h] = delta[row0 + r0 + 8 * h];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t sK = sKV + (kt & 1) * 2 * TL, sV = sK + TL;
    if (kt + 1 < nk) {  // the other stage was released at the end of kt - 1
      const uint32_t nK = sKV + ((kt + 1) & 1) * 2 * TL;
      load_tile<D>(nK, kb + (size_t)(kt + 1) * T * D, tid);
      load_tile<D>(nK + TL, vb + (size_t)(kt + 1) * T * D, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    stage_ready();

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(s, desc_k(sQ, kk), desc_k(sK, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(dp, desc_k(sDO, kk), desc_k(sV, kk), kk);
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);

    // key kt T + c is seen by query q0 + r iff c <= r + e
    const int e = OFF ? q0 + shift - kt * T : 0;
    const bool diag = causal && (OFF ? e < T - 1 : kt == qt);
    if constexpr (BIAS) {  // s * scale2 + bias * log2(e), every tile
      const float* brow = bias + (size_t)(bh / H) * Sk + kt * T;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b =
            __ldg(reinterpret_cast<const float2*>(brow + 8 * j + c0));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[4 * j + 2 * h] = s[4 * j + 2 * h] * scale2 + b.x * LOG2E;
          s[4 * j + 2 * h + 1] = s[4 * j + 2 * h + 1] * scale2 + b.y * LOG2E;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = ex2((BIAS ? s[i] : s[i] * scale2) - lr[h]);
      if (diag && 8 * (i >> 2) + c0 + (i & 1) > r0 + 8 * h + e) p = 0.f;
      dp[i] = p * (dp[i] - dr[h]) * sm_scale;  // ds
    }
    uint32_t hi[4][4], lo[4][4];
    split(dp, hi, lo);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) mma_rs(acc, hi[kk], desc_mn(sK, kk));
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) mma_rs(acc, lo[kk], desc_mn(sK, kk));
    wg_commit();
    wg_wait<0>();
    pin(acc);
    __syncthreads();  // this stage is free for the copy of tile kt + 2
  }
  cp_wait<0>();
  store_tile<D>(dq + row0 * D, acc, r0, c0);
}

// -- dk/dv: one block per (KV head, k tile); loop over (query head of the
// group, q tile), summing the group inside the block ---------------------------

// the first q tile whose last row (shifted) sees key k0
__device__ __forceinline__ int first_q_tile(int k0, int shift) {
  const int x = k0 - shift - (T - 1);
  return x <= 0 ? 0 : (x + T - 1) / T;
}

// blocks an SM each head dim's dk/dv instantiation is built for
template <int D>
constexpr int DKV_BLOCKS = D == 128 ? 2 : 3;

template <bool BIAS, int D = HD, bool OFF = false>
__global__ void __launch_bounds__(NT, DKV_BLOCKS<D>)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int G, int Sq, int Sk, int causal,
                 float sm_scale, const float* __restrict__ bias, int Hkv,
                 int qk_shift) {
  extern __shared__ uint8_t smem[];
  constexpr int TL = TILE_OF<D>;
  const uint32_t raw = smem_u32(smem);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + TL;
  const uint32_t sQD = sV + TL;       // stage s: Q at sQD + 2 s TL, dO after
  const uint32_t sLD = sQD + 4 * TL;  // stage s: lse at sLD + 512 s, delta +256
  const float* ld = reinterpret_cast<const float*>(smem + (sLD - raw));
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int r0 = 16 * w + (l >> 2), c0 = 2 * (l & 3);
  // low k tiles (the most rows under the causal mask) first, all heads
  const int BHkv = gridDim.y, id = blockIdx.x + gridDim.x * blockIdx.y;
  const int kt = id / BHkv, kvh = id % BHkv, k0 = kt * T;
  const int shift = OFF ? qk_shift : 0;
  // q tiles wholly before: no key seen (with OFF: before the first q tile
  // whose last row sees key k0)
  const int qt_first = causal ? (OFF ? first_q_tile(k0, shift) : kt) : 0;
  const int nqs = max(Sq / T - qt_first, 0), steps = G * nqs;
  const size_t krow0 = (size_t)kvh * Sk + k0;

  auto load_step = [&](int it, int st) {
    const int bh = kvh * G + it / nqs, q0 = (qt_first + it % nqs) * T;
    const size_t row0 = (size_t)bh * Sq + q0;
    load_tile<D>(sQD + st * 2 * TL, q + row0 * D, tid);
    load_tile<D>(sQD + st * 2 * TL + TL, dout + row0 * D, tid);
    if (tid < 16) load_row(sLD + 512 * st, lse + row0, tid);
    else if (tid < 32) load_row(sLD + 512 * st + 256, delta + row0, tid - 16);
  };

  load_tile<D>(sK, k + krow0 * D, tid);
  load_tile<D>(sV, v + krow0 * D, tid);
  if (steps > 0) load_step(0, 0);
  cp_commit();
  const float scale2 = sm_scale * LOG2E;
  // the bias of this thread's keys (rows r0, r0 + 8) is the same every
  // step: at head_dim 64 it is read once, here; at 128, where the kernel
  // sits at 255 registers, it is read each step, so that no two more
  // registers live across the loop
  constexpr bool BIAS_ONCE = BIAS && D == 64;
  float hb0 = 0.f, hb1 = 0.f;
  if constexpr (BIAS_ONCE) {
    const float* brow = bias + (size_t)(kvh / Hkv) * Sk + k0 + r0;
    hb0 = __ldg(brow) * LOG2E;
    hb1 = __ldg(brow + 8) * LOG2E;
  }
  float ak[D / 2], av[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int st = it & 1;
    const uint32_t sQ = sQD + st * 2 * TL, sDO = sQ + TL;
    const float* sL = ld + 128 * st;
    const float* sD = sL + 64;
    if (it + 1 < steps) {  // the other stage was released at the end of it - 1
      load_step(it + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    stage_ready();

    // transposed recompute: rows are this block's keys, columns q rows
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(s, desc_k(sK, kk), desc_k(sQ, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(dp, desc_k(sV, kk), desc_k(sDO, kk), kk);
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);

    // key k0 + r is seen by query (qt_first + it % nqs) T + c iff
    // r <= c + e
    const int e = OFF ? (qt_first + it % nqs) * T + shift - k0 : 0;
    const bool diag =
        causal && (OFF ? e < T - 1 : qt_first + it % nqs == kt);
    if constexpr (BIAS) {  // s * scale2 + bias * log2(e), every step
      float b0 = hb0, b1 = hb1;
      if constexpr (!BIAS_ONCE) {
        const float* brow = bias + (size_t)(kvh / Hkv) * Sk + k0 + r0;
        b0 = __ldg(brow) * LOG2E;
        b1 = __ldg(brow + 8) * LOG2E;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = s[i] * scale2 + ((i >> 1) & 1 ? b1 : b0);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + c0 + (i & 1);
      float p = ex2((BIAS ? s[i] : s[i] * scale2) - sL[c] * LOG2E);
      if (diag && r0 + 8 * ((i >> 1) & 1) > c + e) p = 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - sD[c]) * sm_scale;  // ds^T
    }
    uint32_t hi[4][4], lo[4][4];
    split(s, hi, lo);
    pin(av);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) mma_rs(av, hi[kk], desc_mn(sDO, kk));
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) mma_rs(av, lo[kk], desc_mn(sDO, kk));
    wg_commit();
    uint32_t dhi[4][4], dlo[4][4];
    split(dp, dhi, dlo);  // overlaps the dv products
    pin(ak);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) mma_rs(ak, dhi[kk], desc_mn(sQ, kk));
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) mma_rs(ak, dlo[kk], desc_mn(sQ, kk));
    wg_commit();
    wg_wait<0>();
    pin(av);
    pin(ak);
    __syncthreads();  // this stage is free for the copy of step it + 2
  }
  cp_wait<0>();
  store_tile<D>(dk + krow0 * D, ak, r0, c0);
  store_tile<D>(dv + krow0 * D, av, r0, c0);
}

template <int D>
constexpr size_t DQ_SMEM = 6 * TILE_OF<D> + 1024;
template <int D>
constexpr size_t DKV_SMEM = 6 * TILE_OF<D> + 1024 + 1024;

template <bool BIAS, int D, bool OFF>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, const void* bias, void* dq_,
       int BH, int G, int H, int Sq, int Sk, int causal, float sm_scale,
       int shift, cudaStream_t stream) {
  int err = launch_prep(flash_dq_kernel<BIAS, D, OFF>, DQ_SMEM<D>);
  if (err) return err;
  flash_dq_kernel<BIAS, D, OFF>
      <<<dim3(Sq / T, BH), NT, DQ_SMEM<D>, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          (const float*)lse, (const float*)delta, (bf16*)dq_, G, Sq, Sk,
          causal, sm_scale, (const float*)bias, H, shift);
  return (int)cudaGetLastError();
}

template <bool BIAS, int D, bool OFF>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* bias, void* dk,
        void* dv, int BHkv, int G, int Hkv, int Sq, int Sk, int causal,
        float sm_scale, int shift, cudaStream_t stream) {
  int err = launch_prep(flash_dkv_kernel<BIAS, D, OFF>, DKV_SMEM<D>);
  if (err) return err;
  flash_dkv_kernel<BIAS, D, OFF>
      <<<dim3(Sk / T, BHkv), NT, DKV_SMEM<D>, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, G,
          Sq, Sk, causal, sm_scale, (const float*)bias, Hkv, shift);
  return (int)cudaGetLastError();
}

// the instantiation for a bias pointer (null or not) and a shift (zero or
// not) at head dim D
template <int D>
int dq_at(const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, const void* bias, void* dq_,
          int BH, int G, int H, int Sq, int Sk, int causal, float sm_scale,
          int shift, cudaStream_t stream) {
  if (shift)
    return bias ? dq<true, D, true>(q, k, v, dout, lse, delta, bias, dq_, BH,
                                    G, H, Sq, Sk, causal, sm_scale, shift,
                                    stream)
                : dq<false, D, true>(q, k, v, dout, lse, delta, bias, dq_, BH,
                                     G, H, Sq, Sk, causal, sm_scale, shift,
                                     stream);
  return bias ? dq<true, D, false>(q, k, v, dout, lse, delta, bias, dq_, BH,
                                   G, H, Sq, Sk, causal, sm_scale, 0, stream)
              : dq<false, D, false>(q, k, v, dout, lse, delta, bias, dq_, BH,
                                    G, H, Sq, Sk, causal, sm_scale, 0, stream);
}

template <int D>
int dkv_at(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* bias, void* dk,
           void* dv, int BHkv, int G, int Hkv, int Sq, int Sk, int causal,
           float sm_scale, int shift, cudaStream_t stream) {
  if (shift)
    return bias ? dkv<true, D, true>(q, k, v, dout, lse, delta, bias, dk, dv,
                                     BHkv, G, Hkv, Sq, Sk, causal, sm_scale,
                                     shift, stream)
                : dkv<false, D, true>(q, k, v, dout, lse, delta, bias, dk, dv,
                                      BHkv, G, Hkv, Sq, Sk, causal, sm_scale,
                                      shift, stream);
  return bias ? dkv<true, D, false>(q, k, v, dout, lse, delta, bias, dk, dv,
                                    BHkv, G, Hkv, Sq, Sk, causal, sm_scale, 0,
                                    stream)
              : dkv<false, D, false>(q, k, v, dout, lse, delta, bias, dk, dv,
                                     BHkv, G, Hkv, Sq, Sk, causal, sm_scale,
                                     0, stream);
}

}  // namespace

// C interface (ctypes).  BH = B * H query heads, G = H / Hkv; Sq and Sk
// are multiples of 64; every pointer is 16-byte aligned and contiguous;
// bias is f32 [B, Sk] or null (the kernels without the channel); H / Hkv
// are the heads a batch of the grid's head index; hd, the head dim, picks
// the instantiation (128 or 64 for both; any other is refused with
// cudaErrorInvalidValue, nothing launched); q_offset / k_offset are the
// global positions of q's and k's first rows (under causal their
// difference picks the instantiation, 0 the one without offsets; without
// causal they change nothing).  Each returns the launch's cudaError_t.
extern "C" {

int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* bias, void* dq_, int BH, int G, int H,
                    int Sq, int Sk, int causal, float sm_scale, int hd,
                    int q_offset, int k_offset, cudaStream_t stream) {
  const int shift = causal ? q_offset - k_offset : 0;
  if (hd == 128)
    return dq_at<128>(q, k, v, dout, lse, delta, bias, dq_, BH, G, H, Sq, Sk,
                      causal, sm_scale, shift, stream);
  if (hd == 64)
    return dq_at<64>(q, k, v, dout, lse, delta, bias, dq_, BH, G, H, Sq, Sk,
                     causal, sm_scale, shift, stream);
  return (int)cudaErrorInvalidValue;
}

int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* bias, void* dk, void* dv, int BHkv, int G,
                     int Hkv, int Sq, int Sk, int causal, float sm_scale,
                     int hd, int q_offset, int k_offset,
                     cudaStream_t stream) {
  const int shift = causal ? q_offset - k_offset : 0;
  if (hd == 128)
    return dkv_at<128>(q, k, v, dout, lse, delta, bias, dk, dv, BHkv, G, Hkv,
                       Sq, Sk, causal, sm_scale, shift, stream);
  if (hd == 64)
    return dkv_at<64>(q, k, v, dout, lse, delta, bias, dk, dv, BHkv, G, Hkv,
                      Sq, Sk, causal, sm_scale, shift, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
