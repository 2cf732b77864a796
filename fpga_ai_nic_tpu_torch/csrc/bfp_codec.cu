// Sublane BFP encode and decode for Hopper.
//
// Replaces the Pallas TPU kernels of the JAX package, ops/bfp_pallas.py
// _encode_kernel (wrapper bfp_encode_inline) and _decode_kernel (wrapper
// bfp_decode_inline).  Bit spec: ops/bfp_golden.py, layout="sublane".
//
// What bounds them on the card: bytes.  Encode reads 4 bytes and writes
// 1 + 1/B bytes per element with a handful of integer and float operations
// between, decode the reverse; both sit far below the H100's ridge point,
// so the least time is the bytes over the 3.35 TB/s of HBM3.  The design
// keeps every byte touched once: one thread per quad of lanes holds its
// four blocks' B rows in registers (the block max never leaves the thread,
// no shared memory, no second pass), loads are float4 and stores char4 so a
// warp moves whole 128-byte lines, and neighbouring threads own
// neighbouring lanes.  The codec route (compress/bfp.py, the unfused
// ops/ring.py rings) launches these two; the fused rings (ring_rs.cu,
// ring_ag.cu) run the same encode_quad / decode4 inside their own kernels.
#include "bfp.cuh"

using namespace bfp;

template <int B>
__global__ void __launch_bounds__(THREADS)
bfp_encode_kernel(const float* __restrict__ x, signed char* __restrict__ mant,
                  signed char* __restrict__ scale, long long n_threads,
                  int mant_bits, int rtz) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_threads) return;
  const long long t = gid / QUADS;
  const int q = (int)(gid % QUADS);
  const long long base = t * (long long)(B * LANES) + 4 * q;
  float4 v[B];
#pragma unroll
  for (int r = 0; r < B; ++r)
    v[r] = *reinterpret_cast<const float4*>(x + base + r * LANES);
  char4 m[B];
  char4 s;
  encode_quad<B>(v, mant_bits, rtz, m, s);
#pragma unroll
  for (int r = 0; r < B; ++r)
    *reinterpret_cast<char4*>(mant + base + r * LANES) = m[r];
  *reinterpret_cast<char4*>(scale + t * LANES + 4 * q) = s;
}

template <int B>
__global__ void __launch_bounds__(THREADS)
bfp_decode_kernel(const signed char* __restrict__ mant,
                  const signed char* __restrict__ scale,
                  float* __restrict__ out, long long n_threads) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_threads) return;
  const long long p = 4 * gid;                  // first of four elements
  const long long t = p / (B * LANES);
  const long long l = p % LANES;
  const char4 m = *reinterpret_cast<const char4*>(mant + p);
  const char4 s = *reinterpret_cast<const char4*>(scale + t * LANES + l);
  *reinterpret_cast<float4*>(out + p) = decode4(m, s);
}

// n_elems % (block_size * 128) == 0; pointers 16-byte (f32) / 4-byte (int8)
// aligned.  Returns cudaGetLastError() after the launch.
extern "C" int bfp_encode_launch(const float* x, signed char* mant,
                                 signed char* scale, long long n_elems,
                                 int block_size, int mant_bits, int rtz,
                                 cudaStream_t stream) {
  const long long n_threads = n_elems / (4LL * block_size);
#define ENC(BS)                                                         \
  bfp_encode_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(   \
      x, mant, scale, n_threads, mant_bits, rtz)
  BFP_DISPATCH_BLOCK(block_size, ENC)
#undef ENC
  return (int)cudaGetLastError();
}

extern "C" int bfp_decode_launch(const signed char* mant,
                                 const signed char* scale, float* out,
                                 long long n_elems, int block_size,
                                 cudaStream_t stream) {
  const long long n_threads = n_elems / 4;
#define DEC(BS)                                                         \
  bfp_decode_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(   \
      mant, scale, out, n_threads)
  BFP_DISPATCH_BLOCK(block_size, DEC)
#undef DEC
  return (int)cudaGetLastError();
}
