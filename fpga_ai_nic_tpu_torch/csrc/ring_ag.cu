// The whole loopback BFP ring all-gather in one launch.
//
// Replaces the Pallas TPU kernels of the JAX package, ops/ring_pallas.py
// _ag_kernel (VMEM-resident, wrapper _ag_call) and _ag_stream_kernel (HBM
// streaming in segments, wrapper _ag_stream_call).  Both compute the same
// function bit for bit (frames forward verbatim, blocks never straddle a
// slice or segment), so one kernel covers both.  Bit spec:
// ops/ring_golden.py ring_all_gather(layout="sublane").
//
// The ring: rank j encodes its owned chunk once, keeps its own decoded
// copy, and the frames travel n-1 hops verbatim; every rank decodes each
// arriving frame into slot j of its [n*C] replica.  Forwarding never
// changes a frame, so every replica's slot j is decode(encode(owned[j])),
// and the sublane BFP block (B rows of one lane inside one (B, 128) tile,
// bfp.cuh) keeps each output element a function of the owned element at
// the same offset alone.  So one thread owns one quad (4 lanes x B rows) of
// one rank's chunk: it loads owned[j, off] once, encodes it as bfp_encode
// does, decodes those frame bytes in registers and stores the decoded rows
// into out[r, j*C + off] for every rank r.  Every replica is written from
// the same decoded registers, so the n replicas are bitwise equal by
// construction.  The frames never leave registers; what the design gives
// up is the per-hop wire, which rings across cards (ROADMAP A.11) bring
// back as a different kernel.  The bytes a wire would carry
// (fused_update.wire_bytes_for) are unchanged.
//
// What bounds it on the card: bytes.  It reads the owned chunks once
// (4*n*C bytes) and writes n replicas (4*n*n*C), about 10 operations per
// element read; at the MLP shape (n=8, C=5,246,976) that is 1,511 MB,
// 0.451 ms at 3.35 TB/s.  Loads and stores are float4, and a warp covers
// the 32 quads of one tile row, so every store of a warp is a contiguous
// 512-byte row.  The grid is plain: one thread per quad of each rank's
// chunk, 256 a block, 64-bit offsets.
#include "bfp.cuh"

using namespace bfp;

template <int B>
__global__ void __launch_bounds__(THREADS)
ring_ag_kernel(const float* __restrict__ owned, float* __restrict__ out,
               int n, long long C, int mant_bits, int rtz) {
  const long long per_chunk = C / (4LL * B);
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= per_chunk * n) return;
  const int j = (int)(gid / per_chunk);                 // origin rank
  const long long rem = gid % per_chunk;
  const long long off = (rem / QUADS) * (long long)(B * LANES) +
                        4 * (rem % QUADS);
  const float* src = owned + (long long)j * C + off;

  float4 v[B];
#pragma unroll
  for (int k = 0; k < B; ++k)
    v[k] = *reinterpret_cast<const float4*>(src + k * LANES);
  char4 m[B];
  char4 s;
  encode_quad<B>(v, mant_bits, rtz, m, s);
#pragma unroll
  for (int k = 0; k < B; ++k) v[k] = decode4(m[k], s);

  float* o = out + (long long)j * C + off;
  const long long replica = (long long)n * C;
  for (int r = 0; r < n; ++r, o += replica) {
#pragma unroll
    for (int k = 0; k < B; ++k)
      *reinterpret_cast<float4*>(o + k * LANES) = v[k];
  }
}

// One launch = the whole gather: [n, C] owned chunks -> [n, n*C] replicas.
extern "C" int ring_ag_launch(const float* owned, float* out, int n,
                              long long C, int block_size, int mant_bits,
                              int rtz, cudaStream_t stream) {
  const long long n_threads = (long long)n * (C / (4LL * block_size));
#define AG(BS)                                                        \
  ring_ag_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(    \
      owned, out, n, C, mant_bits, rtz)
  BFP_DISPATCH_BLOCK(block_size, AG)
#undef AG
  return (int)cudaGetLastError();
}
