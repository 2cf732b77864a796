// Device helpers shared by the port's BFP codec and ring kernels.
//
// The "sublane" BFP layout (ops/bfp_golden.py, layout="sublane"): a tile of
// B*128 consecutive f32 holds 128 blocks; block (t, l) is the B elements
// t*B*128 + r*128 + l (r = 0..B-1) and its int8 scale exponent sits at
// t*128 + l.  One thread owns four neighbouring lanes (a "quad") of one
// tile: it loads B float4 rows, so the 32 threads of a warp read 512
// contiguous bytes per row, stores B char4 mantissa rows and one char4 of
// scales.  Every block's exponent max stays in the thread's registers.
//
// Bit contract (ops/bfp_golden.py):
//   scale_e = clamp(emax - 127 - (m - 2), -126, 126)
//   q       = clamp(round(x * 2^-scale_e), -(2^(m-1)-1), 2^(m-1)-1)
//   x_hat   = q * 2^scale_e
// round is rintf (ties to even, as jnp.round and np.rint) or truncf (rtz).
// Both powers of two are built from exponent bits and are normal numbers,
// so each product is exact; the sources are compiled without fast math and
// with denormals kept, so subnormal inputs scale exactly as on the TPU.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bfp {

constexpr int LANES = 128;
constexpr int QUADS = LANES / 4;   // threads covering one tile row
constexpr int THREADS = 256;       // threads per CUDA block

__device__ __forceinline__ int biased_exp(float x) {
  return (int)((__float_as_uint(x) >> 23) & 0xFFu);
}

__device__ __forceinline__ float exp2_int(int e) {   // 2^e, e in [-126, 127]
  return __uint_as_float((uint32_t)(e + 127) << 23);
}

__device__ __forceinline__ int scale_exp(int emax, int mant_bits) {
  return min(max(emax - 127 - (mant_bits - 2), -126), 126);
}

__device__ __forceinline__ signed char quantize(float x, float inv, float lim,
                                                int rtz) {
  float q = x * inv;
  q = rtz ? truncf(q) : rintf(q);
  q = fminf(fmaxf(q, -lim), lim);
  return (signed char)(int)q;
}

// Encode one quad column of B rows: v[r] holds lanes 4q..4q+3 of row r.
template <int B>
__device__ __forceinline__ void encode_quad(const float4 (&v)[B], int mant_bits,
                                            int rtz, char4 (&m)[B], char4& s) {
  int e0 = 0, e1 = 0, e2 = 0, e3 = 0;
#pragma unroll
  for (int r = 0; r < B; ++r) {
    e0 = max(e0, biased_exp(v[r].x));
    e1 = max(e1, biased_exp(v[r].y));
    e2 = max(e2, biased_exp(v[r].z));
    e3 = max(e3, biased_exp(v[r].w));
  }
  const int s0 = scale_exp(e0, mant_bits), s1 = scale_exp(e1, mant_bits);
  const int s2 = scale_exp(e2, mant_bits), s3 = scale_exp(e3, mant_bits);
  const float i0 = exp2_int(-s0), i1 = exp2_int(-s1);
  const float i2 = exp2_int(-s2), i3 = exp2_int(-s3);
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
#pragma unroll
  for (int r = 0; r < B; ++r) {
    m[r] = make_char4(quantize(v[r].x, i0, lim, rtz),
                      quantize(v[r].y, i1, lim, rtz),
                      quantize(v[r].z, i2, lim, rtz),
                      quantize(v[r].w, i3, lim, rtz));
  }
  s = make_char4((signed char)s0, (signed char)s1, (signed char)s2,
                 (signed char)s3);
}

__device__ __forceinline__ float4 decode4(char4 m, char4 s) {
  return make_float4((float)m.x * exp2_int(s.x), (float)m.y * exp2_int(s.y),
                     (float)m.z * exp2_int(s.z), (float)m.w * exp2_int(s.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Launch helper: one thread per quad, THREADS per block.
inline unsigned grid_for(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

}  // namespace bfp

// Instantiate KERNEL_CALL(B) for the supported block sizes; anything else
// is refused with cudaErrorInvalidValue (the Python wrappers check first).
#define BFP_DISPATCH_BLOCK(block_size, KERNEL_CALL)  \
  switch (block_size) {                              \
    case 2: KERNEL_CALL(2); break;                   \
    case 4: KERNEL_CALL(4); break;                   \
    case 8: KERNEL_CALL(8); break;                   \
    case 16: KERNEL_CALL(16); break;                 \
    case 32: KERNEL_CALL(32); break;                 \
    default: return (int)cudaErrorInvalidValue;      \
  }
