// One forwarding hop of the loopback BFP ring all-gather.
//
// Replaces the Pallas TPU kernels of the JAX package, ops/ring_pallas.py
// _ag_kernel (VMEM-resident, wrapper _ag_call) and _ag_stream_kernel (HBM
// streaming in segments, wrapper _ag_stream_call).  Both compute the same
// function bit for bit (frames forward verbatim, blocks never straddle a
// slice or segment), so one kernel covers both.  Bit spec:
// ops/ring_golden.py ring_all_gather(layout="sublane").
//
// The gather as the port runs it: each rank's owned chunk is encoded once
// (a bfp_encode launch over the [n, C] owned shards) and decoded into the
// rank's own slot (bfp_decode launches).  Then hop s = 1..n-1 is one launch
// of this kernel: rank i takes the frame rank i-1 held (the frame of rank
// (i-s) % n), forwards it verbatim into its own hold buffer for the next
// hop, and decodes it into slot (i-s) % n of its [n*C] replica.  Every
// replica decodes the same bytes, so all n come out bitwise equal.
//
// What bounds it on the card: bytes.  The output alone is n*n*C*4 bytes;
// per element a hop reads 1 + 1/B frame bytes, writes them again (not on
// the last hop) and writes 4 bytes of f32.  One thread per four lanes of a
// tile: char4 frame loads and stores and float4 output stores.  Hold
// buffers alternate by hop parity, so a launch never reads what it writes.
#include "bfp.cuh"

using namespace bfp;

template <int B>
__global__ void __launch_bounds__(THREADS)
ring_ag_hop_kernel(const signed char* __restrict__ fm_in,
                   const signed char* __restrict__ fs_in,
                   signed char* __restrict__ fm_out,
                   signed char* __restrict__ fs_out, float* __restrict__ out,
                   int n, long long C, int s) {
  const long long per_rank = C / (4LL * B);
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= per_rank * n) return;
  const int i = (int)(gid / per_rank);
  const long long rem = gid % per_rank;
  const long long t = rem / QUADS;
  const int q = (int)(rem % QUADS);
  const long long off = t * (long long)(B * LANES) + 4 * q;
  const long long soff = t * LANES + 4 * q;
  const long long sC = C / B;
  const int src = (i + n - 1) % n;                 // upstream neighbour
  const int slot = ((i - s) % n + n) % n;          // origin of the frame

  const char4 sc = *reinterpret_cast<const char4*>(fs_in + src * sC + soff);
  const signed char* fm = fm_in + (long long)src * C + off;
  float* o = out + (long long)i * n * C + (long long)slot * C + off;
  char4 m[B];
#pragma unroll
  for (int r = 0; r < B; ++r) {
    m[r] = *reinterpret_cast<const char4*>(fm + r * LANES);
    *reinterpret_cast<float4*>(o + r * LANES) = decode4(m[r], sc);
  }
  if (fm_out != nullptr) {
    signed char* om = fm_out + (long long)i * C + off;
#pragma unroll
    for (int r = 0; r < B; ++r)
      *reinterpret_cast<char4*>(om + r * LANES) = m[r];
    *reinterpret_cast<char4*>(fs_out + i * sC + soff) = sc;
  }
}

// One launch = hop s of every rank.  fm_out == null on the last hop.
extern "C" int ring_ag_hop_launch(const signed char* fm_in,
                                  const signed char* fs_in,
                                  signed char* fm_out, signed char* fs_out,
                                  float* out, int n, long long C, int s,
                                  int block_size, cudaStream_t stream) {
  const long long n_threads = (long long)n * (C / (4LL * block_size));
#define HOP(BS)                                                          \
  ring_ag_hop_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(   \
      fm_in, fs_in, fm_out, fs_out, out, n, C, s)
  BFP_DISPATCH_BLOCK(block_size, HOP)
#undef HOP
  return (int)cudaGetLastError();
}
