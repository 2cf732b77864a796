// Hopper building blocks shared by the attention kernels (flash_attn.cu,
// flash_bwd.cu, paged_attend.cu): 16-byte cp.async copies into the
// 128-byte swizzled tile layout that wgmma's shared-memory descriptors
// read, the descriptors themselves, the wgmma products (m64n64k16 with
// both operands in shared memory, m64n128k16 and m64n64k16 with A from
// registers), the packing of an f32 accumulator into bf16 hi + lo A
// fragments, mbarriers and named barriers.  Everything is in an anonymous
// namespace: each source that includes it gets its own copy.
//
// The tile layout: a [64 rows][128 cols] bf16 tile is two [64][64] halves
// (columns 0-63, then 64-127), each row 128 bytes with 16-byte chunk c of
// row r at chunk c ^ (r % 8).  A [64 rows][64 cols] tile (head_dim 64,
// BERT's) is one such half: a row is exactly one 128-byte swizzle atom.
// The helpers whose work depends on the head dim take it as a template
// parameter D, last, defaulting to HD = 128; swz, desc_k and desc_mn
// serve both widths unchanged (at D = 64 the chunk index stays below 8,
// the k step below 4, and N spans one half, so the offset to a second
// half is never used).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;                    // head dim (Llama's); the default
constexpr int T = 64;                      // rows of a q or k tile
constexpr int NT = 128;                    // one warpgroup
constexpr int HALF = T * 64 * 2;           // [64 rows][64 cols] bf16: 8 KB
template <int D>
constexpr int TILE_OF = T * D * 2;         // [64 rows][D cols] bf16
constexpr int TILE = TILE_OF<HD>;          // [64 rows][128 cols] bf16
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- copies ------------------------------------------------------------------

// byte offset of 16-byte chunk cc (0-15) of row `row` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int row, int cc) {
  return (cc >> 3) * HALF + row * 128 + (((cc & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16 bytes from src, or 16 zero bytes (nothing read) where !valid
__device__ __forceinline__ void cp16_or_zero(uint32_t dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// A [64][D] bf16 tile at src (row stride D) into shared memory at dst
// (1024-byte aligned) in the swizzled layout, by NTHR threads (tid < NTHR)
template <int NTHR, int D = HD>
__device__ __forceinline__ void load_tile_by(uint32_t dst, const bf16* src,
                                             int tid) {
  static_assert(D == 64 || D == 128, "tiles are built for head_dim 64, 128");
  constexpr int SH = D == 128 ? 4 : 3;  // log2 of the 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < T * D / 8 / NTHR; ++i) {
    const int c = tid + i * NTHR, row = c >> SH, cc = c & ((1 << SH) - 1);
    cp16(dst + swz(row, cc), src + row * D + cc * 8);
  }
}

// the same, by one warpgroup
template <int D = HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int tid) {
  load_tile_by<NT, D>(dst, src, tid);
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
// all 128 head-dim columns along N (two 64-column halves HALF apart; a
// 64-column tile is one half and an N=64 product reads no second one)
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

// d[64 x 64] += A[64 x 16] . B[16 x 64]: the same with N = 64 (a
// head_dim-64 update, B one 64-column half)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
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

// an m64nD accumulator (rows r0, r0 + 8 of the thread) to bf16 rows of D
template <int D = HD>
__device__ __forceinline__ void store_tile(bf16* dst, const float (&d)[D / 2],
                                           int r0, int c0) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + 8 * h) * D + 8 * j +
                                         c0) =
          __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
}

// -- barriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// named barriers (id 0 is __syncthreads'): wait for `count` threads, or
// count this thread towards them without waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// this thread's generic-proxy writes to shared memory (st.shared, landed
// cp.async copies) become visible to the tensor cores' async-proxy reads
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a kernel may use `smem` bytes of dynamic shared memory (above 48 KB
// only after this call); returns the cudaError_t
template <typename K>
int launch_prep(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
