// Sublane int8 encode and decode for Hopper.
//
// Replaces the Pallas TPU kernels of the JAX package, compress/int8.py
// _encode_kernel (wrapper int8_encode_pallas) and _decode_kernel (wrapper
// int8_decode_pallas).  Bit spec: compress/golden.py int8_encode /
// int8_decode with layout="sublane":
//   scale = bf16_rne(max|x| * f32(1/127))        (1.0 for an all-zero block)
//   q     = clip(floor(x / scale + u), -127, 127)  (stochastic)
//         = clip(rint(x / scale), -127, 127)       (nearest, ties to even)
//   x_hat = (float)q * (float)scale                 (exact in f32)
// with u = (fmix32(bits(x) ^ stamp) >> 8) * 2^-24, the murmur3 finalizer
// over the value's own bit pattern; stamp = seed * 0x9E3779B9 mod 2^32 is
// computed on the host.
//
// What bounds them on the card: bytes.  Encode reads 4 bytes and writes
// 1 + 2/B per element, decode the reverse, with a hash, a division and a
// few compares between: far below the H100's ridge point, so the least
// time is the bytes over the 3.35 TB/s of HBM3.  The layout is BFP's
// (bfp_codec.cu, bfp.cuh): one thread owns four neighbouring lanes of one
// (B, 128) tile, loads its B rows as float4 (a warp reads 512 contiguous
// bytes per row), keeps the four block maxima in registers and stores char4
// rows and one 8-byte group of four bf16 scales; no shared memory, no
// second pass.  Decode runs within 1.2x its bound.
//
// What held the encode, as measured on an H100 (PERF.md; codec_probe.py):
// not its conversion or MUFU instructions (on data without subnormals it
// ran 8% above a copy with the same loads and stores) but the slow path of
// the IEEE division: __fdiv_rn branches to a called subroutine whenever an
// operand is subnormal, and one subnormal among a warp's 2048 elements
// holds the whole warp; a branch per element, even one never taken, also
// kept the compiler from interleaving the elements' work.  So the encode
// divides no element and branches on none: it takes each block's
// reciprocal once and corrects the quotient with one FMA (div_rn below),
// exact for every element of a block whose scale is normal and whose max
// is finite; the rare other blocks go to an out-of-line exact route
// (exact_lanes).  Floor (or rint), clip and conversion are one cvt and an
// integer clamp, and the rounding is a template argument, so the common
// path is one straight run of arithmetic between the loads and the
// stores, and the bytes set the pace again: within 5% of the copy, on any
// data.
//
// Numerics: built with -fmad=false -ftz=false -prec-div=true and no fast
// math; every FMA is an explicit __fmaf_rn.  The block max propagates NaN
// as np.max does, and then, as in the golden, NaN > 0 is false and the
// block takes scale 1.0.  A NaN quotient converts to 0 (cvt's rule, and
// the int8 cast's in the golden), an infinite one saturates and clamps to
// +-127, as the golden's clip does.
#include <cuda_bf16.h>

#include "bfp.cuh"

using namespace bfp;

namespace {

// f32(1/127): the double rounded once to f32, as the reference spells it.
constexpr float INV127 = (float)(1.0 / 127.0);
// Below TINY, x (or its quotient) is too small for the residual of div_rn
// to be exact, so x is scaled by UP first and the quotient back by DOWN.
constexpr float TINY = 0x1p-60f, UP = 0x1p64f, DOWN = 0x1p-64f;
// Scales whose reciprocal is a normal float and for which x * UP stays
// finite (a finite block max gives at most 2^121.01); the rest (0, a
// subnormal bf16, infinity) divide exactly.
constexpr float S_MIN = 0x1p-100f, S_MAX = 0x1p122f;

__device__ __forceinline__ float hash_u01(float x, uint32_t stamp) {
  uint32_t z = __float_as_uint(x) ^ stamp;
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return __uint2float_rn(z >> 8) * 5.9604644775390625e-08f;   // 2^-24
}

// |x| into a running max that keeps NaN once it has seen one.
__device__ __forceinline__ float max_abs(float m, float x) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(fabsf(x)));
  return r;
}

__device__ __forceinline__ unsigned short scale_bits(float maxabs) {
  const float s = maxabs > 0.0f ? maxabs * INV127 : 1.0f;
  return __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float((uint32_t)b << 16);
}

// One block's divisor: its scale s, r = RN(1/s), and whether div_rn holds
// for every element of the block (s in [S_MIN, S_MAX], max not NaN, so
// every element finite).
struct Divisor {
  float s, r;
  bool ok;
};

__device__ __forceinline__ Divisor divisor(unsigned short bits, float m) {
  const float s = bf16_bits_to_float(bits);
  const bool ok = s >= S_MIN && s <= S_MAX && m == m;
  return {s, ok ? __frcp_rn(s) : 0.0f, ok};
}

// RN(x / s), bit for bit __fdiv_rn's, for a finite x of a block whose
// divisor is ok.  With r = RN(1/s), y = RN(x r) is within 1.5 ulp of x/s;
// e = x - s y is exact (an FMA), and y + e r lies within 2^-23 ulp of
// x/s, which is never closer than 2^-9 ulp to a rounding midpoint (s has
// 8 significant bits), so RN(y + e r) is the correctly rounded quotient
// (Markstein's construction).  That needs x and y normal with room for e
// below them: scaling x by 2^64 where |x| or |y| is below 2^-60 makes them
// so, and the scale back is exact for every normal quotient.  A quotient
// below 2^-126 (x tiny under a large s) reaches the output only as its
// sign and whether it is zero, which the scaled route keeps (x/s cannot
// lie within 2^-24 of 2^-150, where the rounding to zero turns).
// tests/test_torch_int8.py emulates this step by step; chip_smoke.py
// checks the kernel on every pair of an f32 and a bf16 significand.
__device__ __forceinline__ float div_rn(float x, const Divisor& d) {
  const float y0 = x * d.r;
  const bool small = fabsf(x) < TINY || fabsf(y0) < TINY;
  const float xs = small ? x * UP : x;
  float y = xs * d.r;
  const float e = __fmaf_rn(-d.s, y, xs);
  y = __fmaf_rn(e, d.r, y);
  return small ? y * DOWN : y;
}

// clip(floor(v + u), -127, 127) or clip(rint(v), -127, 127) as int8, with
// u hashed from x: cvt.rmi / cvt.rni saturate to int32 and take NaN to 0,
// so an integer clamp finishes the clip.
__device__ __forceinline__ signed char to_int8(float v, float x,
                                               uint32_t stamp, bool nearest) {
  const int k = nearest ? __float2int_rn(v)
                        : __float2int_rd(__fadd_rn(v, hash_u01(x, stamp)));
  return (signed char)min(max(k, -127), 127);
}

// The exact route for the lanes (bits of ok clear) whose block's divisor
// is not ok: each element reloaded and divided with __fdiv_rn, its byte
// rewritten.  Out of line, so the common path carries none of it.
__device__ __noinline__ void exact_lanes(const float* x, signed char* q,
                                         long long base, int B, float4 s,
                                         unsigned ok, uint32_t stamp,
                                         bool nearest) {
  for (int r = 0; r < B; ++r) {
    for (int c = 0; c < 4; ++c) {
      if (ok >> c & 1) continue;
      const float sc = c == 0 ? s.x : c == 1 ? s.y : c == 2 ? s.z : s.w;
      const long long i = base + (long long)r * LANES + c;
      q[i] = to_int8(__fdiv_rn(x[i], sc), x[i], stamp, nearest);
    }
  }
}

}  // namespace

template <int B, bool NEAREST>
__global__ void __launch_bounds__(THREADS)
int8_encode_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                   unsigned short* __restrict__ scale, long long n_threads,
                   uint32_t stamp) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_threads) return;
  const long long t = gid / QUADS;
  const int qd = (int)(gid % QUADS);
  const long long base = t * (long long)(B * LANES) + 4 * qd;
  float4 v[B];
#pragma unroll
  for (int r = 0; r < B; ++r)
    v[r] = *reinterpret_cast<const float4*>(x + base + r * LANES);
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
#pragma unroll
  for (int r = 0; r < B; ++r) {
    m0 = max_abs(m0, v[r].x);
    m1 = max_abs(m1, v[r].y);
    m2 = max_abs(m2, v[r].z);
    m3 = max_abs(m3, v[r].w);
  }
  const unsigned short b0 = scale_bits(m0), b1 = scale_bits(m1);
  const unsigned short b2 = scale_bits(m2), b3 = scale_bits(m3);
  const Divisor d0 = divisor(b0, m0), d1 = divisor(b1, m1);
  const Divisor d2 = divisor(b2, m2), d3 = divisor(b3, m3);
#pragma unroll
  for (int r = 0; r < B; ++r) {
    const float4 w = v[r];
    *reinterpret_cast<char4*>(q + base + r * LANES) = make_char4(
        to_int8(div_rn(w.x, d0), w.x, stamp, NEAREST),
        to_int8(div_rn(w.y, d1), w.y, stamp, NEAREST),
        to_int8(div_rn(w.z, d2), w.z, stamp, NEAREST),
        to_int8(div_rn(w.w, d3), w.w, stamp, NEAREST));
  }
  const unsigned ok = d0.ok | d1.ok << 1 | d2.ok << 2 | d3.ok << 3;
  if (ok != 15)
    exact_lanes(x, q, base, B, make_float4(d0.s, d1.s, d2.s, d3.s), ok,
                stamp, NEAREST);
  *reinterpret_cast<uint2*>(scale + t * LANES + 4 * qd) =
      make_uint2((uint32_t)b0 | ((uint32_t)b1 << 16),
                 (uint32_t)b2 | ((uint32_t)b3 << 16));
}

template <int B>
__global__ void __launch_bounds__(THREADS)
int8_decode_kernel(const signed char* __restrict__ q,
                   const unsigned short* __restrict__ scale,
                   float* __restrict__ out, long long n_threads) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_threads) return;
  const long long p = 4 * gid;                  // first of four elements
  const long long t = p / (B * LANES);
  const long long l = p % LANES;
  const char4 m = *reinterpret_cast<const char4*>(q + p);
  const uint2 s = *reinterpret_cast<const uint2*>(scale + t * LANES + l);
  *reinterpret_cast<float4*>(out + p) = make_float4(
      (float)m.x * __uint_as_float(s.x << 16),
      (float)m.y * __uint_as_float(s.x & 0xFFFF0000u),
      (float)m.z * __uint_as_float(s.y << 16),
      (float)m.w * __uint_as_float(s.y & 0xFFFF0000u));
}

// n_elems % (block_size * 128) == 0; pointers 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int int8_encode_launch(const float* x, signed char* q,
                                  unsigned short* scale, long long n_elems,
                                  int block_size, unsigned int stamp,
                                  int nearest, cudaStream_t stream) {
  const long long n_threads = n_elems / (4LL * block_size);
#define ENC(BS)                                                              \
  if (nearest)                                                               \
    int8_encode_kernel<BS, true><<<grid_for(n_threads), THREADS, 0,          \
                                   stream>>>(x, q, scale, n_threads, stamp); \
  else                                                                       \
    int8_encode_kernel<BS, false><<<grid_for(n_threads), THREADS, 0,         \
                                    stream>>>(x, q, scale, n_threads, stamp)
  BFP_DISPATCH_BLOCK(block_size, ENC)
#undef ENC
  return (int)cudaGetLastError();
}

extern "C" int int8_decode_launch(const signed char* q,
                                  const unsigned short* scale, float* out,
                                  long long n_elems, int block_size,
                                  cudaStream_t stream) {
  const long long n_threads = n_elems / 4;
#define DEC(BS)                                                          \
  int8_decode_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(   \
      q, scale, out, n_threads)
  BFP_DISPATCH_BLOCK(block_size, DEC)
#undef DEC
  return (int)cudaGetLastError();
}
