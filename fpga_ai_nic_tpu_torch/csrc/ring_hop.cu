// One hop of the BFP ring across processes: the reduce-scatter hop with the
// fused update on the last, and the all-gather hop.  Each process holds one
// rank; a hop's outgoing frame is written straight into the right
// neighbour's receive buffer, memory that process allocated and this one
// opened through CUDA IPC (ops/ring_procs.py).
//
// Replaces the Pallas TPU kernels of the JAX package in their own form, one
// rank a device: ops/ring_pallas.py _rs_kernel / _rs_stream_kernel (the
// hop's decode-add-encode, the fused update on the owned shard) and
// _ag_kernel / _ag_stream_kernel (forward the frame verbatim, decode it into
// its slot), whose pltpu.make_async_remote_copy to device_id=right is the
// store into the peer's buffer here.  The loopback kernels (ring_rs.cu,
// ring_ag.cu) run every rank of one card in one launch and keep the frames
// in registers; this kernel puts them on the wire.
//
// Schedule (ops/ring_golden.py, layout="sublane"): rank i's launch k (k =
// 0 .. n-1) works on chunk (i - k - 1) mod n of its row.  Launch 0 encodes
// that chunk of x and sends it; launch k of 1 .. n-2 adds the frame that
// arrived from rank i-1 at hop k-1 into x's chunk (x + decode(frame), the
// golden's add order) and sends the encoded sum; launch n-1 lands on the
// owned chunk i: the sum is the reduced gradient, and with an optimizer the
// update of ring_update.cuh runs on it (g = sum / n, the formula and the
// bits of ring_rs.cu).  The all-gather's launch 0 encodes the owned chunk,
// decodes it into its own slot and sends the frame; launch k decodes the
// frame of origin (i - k) mod n into that slot and forwards the bytes
// unchanged, the last one only decodes.
//
// The frame of a chunk is the loopback kernels' wire (csrc/ring_rs.cu, its
// checksum pair): slice s of the chunk (tiles_per_slice (B, 128) tiles,
// ops/ring_cuda.pick_slice_elems) is its int8 mantissas, row-major (R =
// slice/128 rows x 128 lanes), then its int8 scale exponents (R/B rows x
// 128), the slices one after another.  block_size 0 carries the chunk as
// raw f32 (no codec), one element a thread.
//
// Hops are synchronous: the caller synchronises its stream and meets the
// other ranks at a barrier between launches, so the frame a launch reads
// was written whole by the neighbour's previous launch; receive buffers
// alternate by hop parity, since a rank writes hop k's frame while its
// neighbour still reads hop k-1's.
//
// What bounds a hop on the card: bytes.  A reduce-scatter hop reads its
// chunk of x (4C bytes) and a frame (C + C/B) and writes a frame; the last
// reads and writes the master and optimizer shards instead.  At the
// canonical MLP's row over W = 4 ranks (C = 10,493,952) a middle hop moves
// 64.7 MB, 0.0193 ms at 3.35 TB/s; through a peer's memory over NVLink the
// frame's store would be bounded by 450 GB/s each way.  Every thread owns
// one quad (4 lanes x B rows of one tile, bfp.cuh), loads float4 and
// stores char4, so a warp's accesses are contiguous rows.
#include "bfp.cuh"
#include "ring_update.cuh"

using namespace bfp;

struct HopArgs {
  const float* x;              // [C]: this launch's chunk (RS), owned (AG 0)
  const signed char* recv;     // frame from the left neighbour, or null
  signed char* send;           // the right neighbour's buffer, or null
  float* out;                  // RS: [C] reduced sum (last launch); AG: slot
  const float* w;              // [C] master shard (RS last launch)
  float* w_out;
  const float* m_in;           // [C] momentum / first moment, or null
  float* m_out;
  const float* v_in;           // [C] second moment, or null
  float* v_out;
  const float* hyper;          // f32[8], optim.fused_hyperparams
  int n;
  long long C;
  long long tiles_per_slice;
  int mant_bits;
  int rtz;
  int opt_kind;
};

// Byte offsets of a quad's mantissa row 0 and of its scales in the frame.
template <int B>
__device__ __forceinline__ void frame_offsets(const HopArgs& a, long long tile,
                                              int q, long long& mant,
                                              long long& scale) {
  const long long slice_elems = a.tiles_per_slice * B * LANES;
  const long long base =
      (tile / a.tiles_per_slice) * (slice_elems + slice_elems / B);
  const long long tl = tile % a.tiles_per_slice;
  mant = base + tl * B * LANES + 4 * q;
  scale = base + slice_elems + tl * LANES + 4 * q;
}

template <int B>
__global__ void __launch_bounds__(THREADS) ring_hop_rs_kernel(HopArgs a) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= a.C / (4LL * B)) return;
  const long long tile = gid / QUADS;
  const int q = (int)(gid % QUADS);
  const long long off = tile * (long long)(B * LANES) + 4 * q;
  long long fm, fs;
  frame_offsets<B>(a, tile, q, fm, fs);

  float4 v[B];
#pragma unroll
  for (int k = 0; k < B; ++k)
    v[k] = *reinterpret_cast<const float4*>(a.x + off + k * LANES);
  if (a.recv != nullptr) {
    const char4 s = *reinterpret_cast<const char4*>(a.recv + fs);
#pragma unroll
    for (int k = 0; k < B; ++k)
      v[k] = add4(v[k], decode4(*reinterpret_cast<const char4*>(
                                    a.recv + fm + k * LANES), s));
  }
  if (a.send != nullptr) {
    char4 m[B];
    char4 s;
    encode_quad<B>(v, a.mant_bits, a.rtz, m, s);
#pragma unroll
    for (int k = 0; k < B; ++k)
      *reinterpret_cast<char4*>(a.send + fm + k * LANES) = m[k];
    *reinterpret_cast<char4*>(a.send + fs) = s;
  }
  if (a.out == nullptr) return;
#pragma unroll
  for (int k = 0; k < B; ++k)
    *reinterpret_cast<float4*>(a.out + off + k * LANES) = v[k];
  if (a.opt_kind == OPT_NONE) return;
  update_quad<B>(a.opt_kind, a.hyper, a.n, v, a.w, a.w_out, a.m_in, a.m_out,
                 a.v_in, a.v_out, off);
}

template <int B>
__global__ void __launch_bounds__(THREADS) ring_hop_ag_kernel(HopArgs a) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= a.C / (4LL * B)) return;
  const long long tile = gid / QUADS;
  const int q = (int)(gid % QUADS);
  const long long off = tile * (long long)(B * LANES) + 4 * q;
  long long fm, fs;
  frame_offsets<B>(a, tile, q, fm, fs);

  char4 m[B];
  char4 s;
  if (a.recv == nullptr) {                 // launch 0: the owned chunk
    float4 v[B];
#pragma unroll
    for (int k = 0; k < B; ++k)
      v[k] = *reinterpret_cast<const float4*>(a.x + off + k * LANES);
    encode_quad<B>(v, a.mant_bits, a.rtz, m, s);
  } else {
#pragma unroll
    for (int k = 0; k < B; ++k)
      m[k] = *reinterpret_cast<const char4*>(a.recv + fm + k * LANES);
    s = *reinterpret_cast<const char4*>(a.recv + fs);
  }
  if (a.send != nullptr) {                 // forwarded verbatim
#pragma unroll
    for (int k = 0; k < B; ++k)
      *reinterpret_cast<char4*>(a.send + fm + k * LANES) = m[k];
    *reinterpret_cast<char4*>(a.send + fs) = s;
  }
#pragma unroll
  for (int k = 0; k < B; ++k)
    *reinterpret_cast<float4*>(a.out + off + k * LANES) = decode4(m[k], s);
}

// block_size 0: raw f32 frames, one element a thread.
__global__ void __launch_bounds__(THREADS) ring_hop_rs_f32_kernel(HopArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.C) return;
  float v = a.x[i];
  if (a.recv != nullptr) v = v + reinterpret_cast<const float*>(a.recv)[i];
  if (a.send != nullptr) reinterpret_cast<float*>(a.send)[i] = v;
  if (a.out == nullptr) return;
  a.out[i] = v;
  if (a.opt_kind == OPT_NONE) return;
  float w2, m2, v2;
  fused_update(a.opt_kind, a.hyper, v / (float)a.n, a.w[i],
               a.m_in != nullptr ? a.m_in[i] : 0.f,
               a.v_in != nullptr ? a.v_in[i] : 0.f, w2, m2, v2);
  a.w_out[i] = w2;
  if (a.m_out != nullptr) a.m_out[i] = m2;
  if (a.v_out != nullptr) a.v_out[i] = v2;
}

__global__ void __launch_bounds__(THREADS) ring_hop_ag_f32_kernel(HopArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.C) return;
  const float v = a.recv != nullptr
                      ? reinterpret_cast<const float*>(a.recv)[i] : a.x[i];
  if (a.send != nullptr) reinterpret_cast<float*>(a.send)[i] = v;
  a.out[i] = v;
}

static int check_frames(int block_size, long long C, long long tps) {
  if (block_size == 0) return 0;
  if (tps < 1 || C % (tps * block_size * LANES))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One reduce-scatter hop (see the header for which pointers a launch
// sets).  opt_kind OPT_NONE leaves w .. v_out unread.
extern "C" int ring_hop_rs_launch(const float* x, const signed char* recv,
                                  signed char* send, float* out,
                                  const float* w, float* w_out,
                                  const float* m_in, float* m_out,
                                  const float* v_in, float* v_out,
                                  const float* hyper, int n, long long C,
                                  long long tiles_per_slice, int block_size,
                                  int mant_bits, int rtz, int opt_kind,
                                  cudaStream_t stream) {
  if (int err = check_frames(block_size, C, tiles_per_slice)) return err;
  const HopArgs a{x, recv, send, out, w, w_out, m_in, m_out, v_in, v_out,
                  hyper, n, C, tiles_per_slice, mant_bits, rtz, opt_kind};
  if (block_size == 0) {
    ring_hop_rs_f32_kernel<<<grid_for(C), THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const long long n_threads = C / (4LL * block_size);
#define HOP(BS) \
  ring_hop_rs_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(a)
  BFP_DISPATCH_BLOCK(block_size, HOP)
#undef HOP
  return (int)cudaGetLastError();
}

// One all-gather hop: recv null encodes `owned`; out is the replica's slot.
extern "C" int ring_hop_ag_launch(const float* owned, const signed char* recv,
                                  signed char* send, float* out, long long C,
                                  long long tiles_per_slice, int block_size,
                                  int mant_bits, int rtz,
                                  cudaStream_t stream) {
  if (int err = check_frames(block_size, C, tiles_per_slice)) return err;
  const HopArgs a{owned, recv, send, out, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, 1, C, tiles_per_slice,
                  mant_bits, rtz, OPT_NONE};
  if (block_size == 0) {
    ring_hop_ag_f32_kernel<<<grid_for(C), THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const long long n_threads = C / (4LL * block_size);
#define HOP(BS) \
  ring_hop_ag_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(a)
  BFP_DISPATCH_BLOCK(block_size, HOP)
#undef HOP
  return (int)cudaGetLastError();
}
