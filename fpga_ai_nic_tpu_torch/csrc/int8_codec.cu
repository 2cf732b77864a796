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
// time is the bytes over the 3.35 TB/s of HBM3.  The design is BFP's
// (bfp_codec.cu, bfp.cuh): one thread owns four neighbouring lanes of one
// (B, 128) tile, loads its B rows as float4 (a warp reads 512 contiguous
// bytes per row), keeps the four block maxima in registers and stores char4
// rows and one 8-byte group of four bf16 scales; no shared memory, no
// second pass.
//
// Numerics: built with -fmad=false -ftz=false -prec-div=true and no fast
// math; the division and the sum are spelled __fdiv_rn / __fadd_rn anyway so
// no contraction or approximation can creep in.  The block max propagates
// NaN as np.max does, and then, as in the golden, NaN > 0 is false and the
// block takes scale 1.0; the clip keeps NaN, which the int8 cast maps to 0.
// Non-finite inputs are outside the bit contract all the same.
#include <cuda_bf16.h>

#include "bfp.cuh"

using namespace bfp;

namespace {

// f32(1/127): the double rounded once to f32, as the reference spells it.
constexpr float INV127 = (float)(1.0 / 127.0);

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
  const float a = fabsf(x);
  return (a > m || a != a) ? a : m;
}

__device__ __forceinline__ unsigned short scale_bits(float maxabs) {
  const float s = maxabs > 0.0f ? maxabs * INV127 : 1.0f;
  return __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float((uint32_t)b << 16);
}

__device__ __forceinline__ signed char quantize_int8(float x, float scale,
                                                     uint32_t stamp,
                                                     int nearest) {
  float v = __fdiv_rn(x, scale);
  v = nearest ? rintf(v) : floorf(__fadd_rn(v, hash_u01(x, stamp)));
  v = v < -127.0f ? -127.0f : (v > 127.0f ? 127.0f : v);   // NaN stays
  return (signed char)__float2int_rz(v);                   // NaN -> 0
}

}  // namespace

template <int B>
__global__ void __launch_bounds__(THREADS)
int8_encode_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                   unsigned short* __restrict__ scale, long long n_threads,
                   uint32_t stamp, int nearest) {
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
  const float s0 = bf16_bits_to_float(b0), s1 = bf16_bits_to_float(b1);
  const float s2 = bf16_bits_to_float(b2), s3 = bf16_bits_to_float(b3);
#pragma unroll
  for (int r = 0; r < B; ++r) {
    *reinterpret_cast<char4*>(q + base + r * LANES) =
        make_char4(quantize_int8(v[r].x, s0, stamp, nearest),
                   quantize_int8(v[r].y, s1, stamp, nearest),
                   quantize_int8(v[r].z, s2, stamp, nearest),
                   quantize_int8(v[r].w, s3, stamp, nearest));
  }
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
#define ENC(BS)                                                          \
  int8_encode_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(   \
      x, q, scale, n_threads, stamp, nearest)
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
