// Flash attention backward for Hopper's tensor cores: dq and dk/dv.
//
// Replaces the Pallas TPU kernels of fpga_ai_nic_tpu/ops/flash_pallas.py:
//   flash_dq_kernel   <- _dq_kernel   (:222)
//   flash_dkv_kernel  <- _dkv_kernel  (:267)
//
// Layouts: q / dout / dq are [B*H, S, 128] bf16, k / v / dk / dv are
// [B*Hkv, S, 128] bf16, lse / delta are [B*H, S] f32.  GQA is handled by
// indexing: query head bh reads KV head bh / G (G = H / Hkv); the dk/dv
// kernel sums the G query heads of its KV head itself, in a fixed order.
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
// descriptor's transpose bit.  Blocks take about 97 KB of shared memory,
// so two share an SM.  Causal tiles past the diagonal are skipped, the
// mask is applied on the diagonal tile only, and blocks are dealt longest
// first across all heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;                    // head dim; the only one built
constexpr int T = 64;                      // rows of a q or k tile
constexpr int NT = 128;                    // one warpgroup
constexpr int HALF = T * 64 * 2;           // [64 rows][64 cols] bf16: 8 KB
constexpr int TILE = 2 * HALF;             // [64 rows][128 cols] bf16
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- copies ------------------------------------------------------------------

// A [64][128] bf16 tile at src (row stride 128) into shared memory at dst
// (1024-byte aligned) as two [64][64] halves, columns 0-63 then 64-127,
// each row 128 bytes with 16-byte chunk c of row r at chunk c ^ (r % 8):
// the 128-byte swizzle of the wgmma descriptors.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < T * HD / 8 / NT; ++i) {
    const int c = tid + i * NT, row = c >> 4, cc = c & 15;
    const uint32_t d =
        dst + (cc >> 3) * HALF + row * 128 + (((cc & 7) ^ (row & 7)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + row * HD + cc * 8)
                 : "memory");
  }
}

// 64 f32 (256 bytes) at src into dst: threads 0-15, one 16-byte chunk each
__device__ __forceinline__ void load_row(uint32_t dst, const float* src,
                                         int t) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   dst + 16 * t),
               "l"(src + 4 * t)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the copies of this thread have landed; make them visible to the
// tensor cores' (async proxy) reads, then to every thread
__device__ __forceinline__ void stage_ready() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// -- wgmma -------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major: the tile's 64 rows along M (or N), head-dim columns
// 16 kk .. 16 kk + 15 along K; 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * HALF + (kk & 3) * 32, 16, 1024);
}

// MN-major (B transposed): the tile's rows 16 kk .. 16 kk + 15 along K,
// all 128 head-dim columns along N (two 64-column halves HALF apart)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, HALF, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(i)                                                          \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]),                \
      "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]),            \
      "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (the s/dp
// accumulator layout, packed as bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F8

// -- elementwise -------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// A fragments of one m64n64 f32 accumulator x, as bf16 hi and lo terms:
// k step kk's register i holds x[8 kk + 2 i] (low half) and x[8 kk + 2 i + 1]
// (the m64n64 accumulator and the k16 A operand share rows and columns)
__device__ __forceinline__ void split(const float (&x)[32],
                                      uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = x[8 * kk + 2 * i], b = x[8 * kk + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][i] = bits(h);
      lo[kk][i] = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
    }
}

// an m64n128 accumulator (rows r0, r0 + 8 of the thread) to bf16 rows
__device__ __forceinline__ void store_tile(bf16* dst, const float (&d)[64],
                                           int r0, int c0) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + 8 * h) * HD + 8 * j +
                                         c0) =
          __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
}

// -- dq: one block per (query head, q tile); loop over k tiles ---------------

__global__ void __launch_bounds__(NT, 2)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int G, int Sq, int Sk, int causal, float sm_scale) {
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sDO = sQ + TILE;
  const uint32_t sKV = sDO + TILE;  // stage s: K at sKV + 2 s TILE, V after
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int r0 = 16 * w + (l >> 2), c0 = 2 * (l & 3);
  // longest causal tiles first, across all heads
  const int BH = gridDim.y, id = blockIdx.x + gridDim.x * blockIdx.y;
  const int qt = gridDim.x - 1 - id / BH, bh = id % BH, kvh = bh / G;
  const int q0 = qt * T;
  const size_t row0 = (size_t)bh * Sq + q0;
  const bf16* kb = k + (size_t)kvh * Sk * HD;
  const bf16* vb = v + (size_t)kvh * Sk * HD;
  int nk = Sk / T;
  if (causal) nk = min(nk, qt + 1);  // tiles past the diagonal see nothing

  load_tile(sQ, q + row0 * HD, tid);
  load_tile(sDO, dout + row0 * HD, tid);
  load_tile(sKV, kb, tid);
  load_tile(sKV + TILE, vb, tid);
  cp_commit();
  const float scale2 = sm_scale * LOG2E;
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lr[h] = lse[row0 + r0 + 8 * h] * LOG2E;
    dr[h] = delta[row0 + r0 + 8 * h];
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t sK = sKV + (kt & 1) * 2 * TILE, sV = sK + TILE;
    if (kt + 1 < nk) {  // the other stage was released at the end of kt - 1
      const uint32_t nK = sKV + ((kt + 1) & 1) * 2 * TILE;
      load_tile(nK, kb + (size_t)(kt + 1) * T * HD, tid);
      load_tile(nK + TILE, vb + (size_t)(kt + 1) * T * HD, tid);
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
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss(s, desc_k(sQ, kk), desc_k(sK, kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss(dp, desc_k(sDO, kk), desc_k(sV, kk), kk);
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);

    const bool diag = causal && kt == qt;  // key k0 + c vs query q0 + r
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = ex2(s[i] * scale2 - lr[h]);
      if (diag && 8 * (i >> 2) + c0 + (i & 1) > r0 + 8 * h) p = 0.f;
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
  store_tile(dq + row0 * HD, acc, r0, c0);
}

// -- dk/dv: one block per (KV head, k tile); loop over (query head of the
// group, q tile), summing the group inside the block ---------------------------

__global__ void __launch_bounds__(NT, 2)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int G, int Sq, int Sk, int causal,
                 float sm_scale) {
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + TILE;
  const uint32_t sQD = sV + TILE;       // stage s: Q at sQD + 2 s TILE, dO after
  const uint32_t sLD = sQD + 4 * TILE;  // stage s: lse at sLD + 512 s, delta +256
  const float* ld = reinterpret_cast<const float*>(smem + (sLD - raw));
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int r0 = 16 * w + (l >> 2), c0 = 2 * (l & 3);
  // low k tiles (the most rows under the causal mask) first, all heads
  const int BHkv = gridDim.y, id = blockIdx.x + gridDim.x * blockIdx.y;
  const int kt = id / BHkv, kvh = id % BHkv, k0 = kt * T;
  const int qt_first = causal ? kt : 0;  // q tiles wholly before: no key seen
  const int nqs = max(Sq / T - qt_first, 0), steps = G * nqs;
  const size_t krow0 = (size_t)kvh * Sk + k0;

  auto load_step = [&](int it, int st) {
    const int bh = kvh * G + it / nqs, q0 = (qt_first + it % nqs) * T;
    const size_t row0 = (size_t)bh * Sq + q0;
    load_tile(sQD + st * 2 * TILE, q + row0 * HD, tid);
    load_tile(sQD + st * 2 * TILE + TILE, dout + row0 * HD, tid);
    if (tid < 16) load_row(sLD + 512 * st, lse + row0, tid);
    else if (tid < 32) load_row(sLD + 512 * st + 256, delta + row0, tid - 16);
  };

  load_tile(sK, k + krow0 * HD, tid);
  load_tile(sV, v + krow0 * HD, tid);
  if (steps > 0) load_step(0, 0);
  cp_commit();
  const float scale2 = sm_scale * LOG2E;
  float ak[64], av[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) ak[i] = av[i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int st = it & 1;
    const uint32_t sQ = sQD + st * 2 * TILE, sDO = sQ + TILE;
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
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss(s, desc_k(sK, kk), desc_k(sQ, kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss(dp, desc_k(sV, kk), desc_k(sDO, kk), kk);
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);

    const bool diag = causal && qt_first + it % nqs == kt;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + c0 + (i & 1);
      float p = ex2(s[i] * scale2 - sL[c] * LOG2E);
      if (diag && r0 + 8 * ((i >> 1) & 1) > c) p = 0.f;
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
  store_tile(dk + krow0 * HD, ak, r0, c0);
  store_tile(dv + krow0 * HD, av, r0, c0);
}

constexpr size_t DQ_SMEM = 6 * TILE + 1024;
constexpr size_t DKV_SMEM = 6 * TILE + 1024 + 1024;

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

int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int BH, int G, int Sq, int Sk, int causal,
                    float sm_scale, cudaStream_t stream) {
  int err = launch_prep(flash_dq_kernel, DQ_SMEM);
  if (err) return err;
  flash_dq_kernel<<<dim3(Sq / T, BH), NT, DQ_SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, G, Sq, Sk, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int BHkv, int G, int Sq, int Sk,
                     int causal, float sm_scale, cudaStream_t stream) {
  int err = launch_prep(flash_dkv_kernel, DKV_SMEM);
  if (err) return err;
  flash_dkv_kernel<<<dim3(Sk / T, BHkv), NT, DKV_SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, G, Sq,
      Sk, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
