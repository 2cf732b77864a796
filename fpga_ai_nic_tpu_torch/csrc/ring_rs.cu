// The whole loopback BFP ring reduce-scatter in one launch, with the fused
// ZeRO-1 optimizer update where each chunk's sum completes.
//
// Replaces the Pallas TPU kernels of the JAX package, ops/ring_pallas.py
// _rs_kernel (VMEM-resident, wrapper _rs_call) and _rs_stream_kernel (HBM
// streaming, wrapper _rs_stream_call), both with opt_kind in {None, sgd,
// momentum, adamw}.  The two compute the same function bit for bit; on the
// TPU they differ only in on-chip residency, which Hopper does not share,
// so one kernel covers both.  Bit spec: ops/ring_golden.py
// ring_reduce_scatter(layout="sublane") composed with
// optim.golden_fused_apply.
//
// The n ranks are virtual: rank i's gradient is row i of x [n, L], L = n*C.
// Schedule (ops/ring.py): at hop h rank i sends chunk (i-h-1) % n to rank
// i+1, which adds the decoded frame into its own copy of that chunk and
// sends the sum on at hop h+1.  Followed through the ring, chunk c is one
// chain: it starts at rank c+1 as x[c+1, c], and each later rank r of
// c+2, ..., c adds its x[r, c] to the roundtrip decode(encode(.)) of the
// sum so far, ending at rank c, which owns it.  So
//   p_0 = x[c+1, c];  p_j = x[c+1+j, c] + decode(encode(p_{j-1}));
//   g[c] = p_{n-1}
// with ranks mod n, the add order of ops/ring_golden.py.
//
// Why one thread can run a chain: the "sublane" BFP block is B rows of one
// lane inside one (B, 128) tile (bfp.cuh), and every rank's chunks are
// whole tiles, so each output element depends only on the inputs at the
// same offset in each rank's chunk c.  One thread owns one quad (4 lanes x
// B rows) at offset `off` of one chunk and walks the n ranks of its chain:
// the frame rank r would send to rank r+1 is encoded and decoded in the
// thread's registers and never leaves them.  The encode, decode, add order
// and update are those of every (rank, hop) of the hop-by-hop ring, so the
// bits are the same; the bytes that would cross a wire between cards
// (fused_update.wire_bytes_for) are unchanged.  What the design gives up is
// the per-hop frame itself: across cards (ROADMAP A.11) the wire comes
// back, as a different kernel.  Chains share nothing, so the grid is plain
// (one thread per quad of each chunk, 256 a block, n from 2 up, 64-bit
// offsets) and needs no barrier.
//
// On the final rank (c itself) it writes the reduced sum and, with an
// optimizer, updates the master shard:
//   g = sum / n;  sgd: w' = fmaf(-lr, fmaf(wd, w, g), w)
// and the momentum / adamw forms of optim.fused_apply_blocks, each
// contraction site an explicit __fmaf_rn (sources build with -fmad=false).
//
// What bounds it on the card: bytes.  Per element it reads x once (4*n*L
// bytes in all) and writes g (4*n*C); with SGD it reads and writes w (8*n*C
// more; momentum and AdamW add their state), against about 11 integer and
// float operations per element of x.  At the MLP shape (n=8, 41,975,808
// elements, SGD) that is 1,847 MB, 0.551 ms at 3.35 TB/s.  Loads are
// float4 and a warp covers the 32 quads of one tile row (512 contiguous
// bytes); the next rank's loads do not depend on the roundtrip, so they
// issue ahead of it.
//
// The integrity variant (ring_pallas.py integrity=True: _frame_checksum,
// _emission_weight) adds the checksum pair.  Slice k of a chunk is a frame
// of R = slice/128 rows: its mantissa bytes row-major, then its scale bytes
// (R/B rows x 128), each byte zero-extended; chk(F) = sum_pos (2 pos + 1) *
// byte_pos (mod 2^32).  Rank r's k-th slice at hop h is emission q =
// h * S + k (S slices a chunk), and
//   send[r] += (2q + 1) * chk(F),   recv[r + 1] += (2q + 1) * chk(F')
// with F' the bytes rank r+1's decode reads.  Unlike the TPU kernel, the
// frame's tile-padding rows are not summed.  In loopback F' is F in the
// same registers, so on one card the pair checks the encode/decode bytes,
// not a link.  The sums are uint32 and wrap, so the order of the atomics
// does not change them: the pair is the same on every run.
//
// The ablate= stages (ring_pallas.py _rs_kernel ablate=, :450-464, and
// _rs_stream_kernel, :816-827) compile one part of the same chain walk, so
// timing each variant attributes the ring's time to its stages
// (ops/ring_cost.py).  The stage is the kernel's last template parameter,
// a mask of these flags (Stage below), each the counterpart of a flag of
// the TPU kernels:
//   ld    hop 0's load of x[c+1], and without decode the load of each
//         sender's x that the next encode reads (the TPU's slice load);
//   stld  each later rank's load of its x[r, c] (the store-load);
//   enc   the encode; rdma the hand-off of the frame to the next rank;
//   dec   the decode and add; wb the owner's write of g; upd the update.
// ST_ALL is the kernel as it was (ablate=None): the template parameter was
// added last, the other stages' code is compiled out of it, so it keeps its
// SASS and its bits.  The TPU's VMEM-resident kernel reads x and writes g
// through the pallas_call's own DMAs whatever ablate says, so on the card
// the resident stages each carry ld, stld and wb (ops/ring_cuda.py
// ABLATE_MASKS); the streaming ones are JAX's do_* sets.
//
// An ablated variant computes garbage by design (JAX's too), but all of
// it: a stage's result feeds a word each thread writes, so the compiler
// removes nothing the variant times.  What stands in for a missing stage:
// registers seeded from the thread index, and a decode without its encode
// reads a stale frame with the running sum's bits XORed into it (one logic
// op a word), so each hop's decode depends on the hop before, as it does
// through the encode, and none is hoisted or dropped.
// On one card rdma has no wire: the frame is the thread's registers, so
// its variant reads near the skeleton's time, and only rings across cards
// (ROADMAP A.11) give the wire a time of its own.
#include <cstring>

#include "bfp.cuh"
#include "ring_update.cuh"

using namespace bfp;

// The ablate= stage flags (header); ST_ALL = ablate=None.
enum Stage {
  ST_LD = 1, ST_ENC = 2, ST_RDMA = 4, ST_STLD = 8, ST_DEC = 16, ST_WB = 32,
  ST_UPD = 64, ST_ALL = 127
};

struct RsArgs {
  const float* x;                 // [n, n*C] gradients, read-only
  float* g_out;                   // [n, C]   reduced sums
  const float* w;                 // [n, C]   master shards (optimizer only)
  float* w_out;
  const float* m_in;              // [n, C]   momentum / first moment
  float* m_out;
  const float* v_in;              // [n, C]   second moment
  float* v_out;
  const float* hyper;             // f32[8]
  unsigned* pair;                 // [n, 2] (send, recv) checksums, or null
  int n;
  long long C;
  long long tiles_per_slice;      // frame size of the checksum pair
  int mant_bits;
  int rtz;
  int opt_kind;
};

__device__ __forceinline__ unsigned as_u32(char4 c) {
  unsigned u;
  memcpy(&u, &c, 4);
  return u;
}

// sum_t (2(p+t)+1) * byte_t (mod 2^32) over the 4 bytes of a char4 (lane
// order x, y, z, w), each byte zero-extended: (2p+1) * sum + 2 * sum t*b.
__device__ __forceinline__ unsigned weighted4(char4 c, unsigned p) {
  const unsigned u = as_u32(c);
  return (2u * p + 1u) * __dp4a(u, 0x01010101u, 0u) +
         2u * __dp4a(u, 0x03020100u, 0u);
}

// This quad's part of its frame's checksum.  The frame of a slice is its
// mantissa bytes (R = slice/128 rows x 128 lanes, row-major) then its scale
// bytes (R/B rows x 128); the quad holds lanes 4*ql .. 4*ql+3 of rows
// tl*B .. tl*B+B-1 and of scale row tl.
template <int B>
__device__ __forceinline__ unsigned frame_part(const char4 (&m)[B], char4 s,
                                               unsigned tl, unsigned ql,
                                               unsigned slice_elems) {
  unsigned part = weighted4(s, slice_elems + tl * LANES + 4u * ql);
#pragma unroll
  for (int k = 0; k < B; ++k)
    part += weighted4(m[k], (tl * B + k) * LANES + 4u * ql);
  return part;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// What the ablated variants put where a stage is compiled out (header).
__device__ __forceinline__ unsigned fold4(float4 v) {
  return __float_as_uint(v.x) ^ __float_as_uint(v.y) ^ __float_as_uint(v.z) ^
         __float_as_uint(v.w);
}

__device__ __forceinline__ float4 xor4(float4 a, float4 b) {
  return make_float4(__uint_as_float(__float_as_uint(a.x) ^ __float_as_uint(b.x)),
                     __uint_as_float(__float_as_uint(a.y) ^ __float_as_uint(b.y)),
                     __uint_as_float(__float_as_uint(a.z) ^ __float_as_uint(b.z)),
                     __uint_as_float(__float_as_uint(a.w) ^ __float_as_uint(b.w)));
}

__device__ __forceinline__ char4 xor_c4(char4 c, unsigned k) {
  unsigned u = as_u32(c) ^ k;
  char4 out;
  memcpy(&out, &u, 4);
  return out;
}

template <int B>
__device__ __forceinline__ unsigned fold_frame(const char4 (&m)[B], char4 s) {
  unsigned f = as_u32(s);
#pragma unroll
  for (int k = 0; k < B; ++k) f ^= as_u32(m[k]);
  return f;
}

// Values in [1, 2) from the thread index: the running sum without a load.
template <int B>
__device__ __forceinline__ void seed_quad(long long gid, float4 (&v)[B]) {
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const unsigned h = ((unsigned)gid * 0x9E3779B9u) ^ (unsigned)(k * 0x85EBCA6B);
    v[k] = make_float4(__uint_as_float(0x3F800000u | (h & 0x7FFFFFu)),
                       __uint_as_float(0x3F800000u | ((h >> 3) & 0x7FFFFFu)),
                       __uint_as_float(0x3F800000u | ((h >> 6) & 0x7FFFFFu)),
                       __uint_as_float(0x3F800000u | ((h >> 9) & 0x7FFFFFu)));
  }
}

// A frame without an encode: mantissa bytes from the thread index, scale
// exponents in [-4, 3].
template <int B>
__device__ __forceinline__ void seed_frame(long long gid, char4 (&m)[B],
                                           char4& s) {
#pragma unroll
  for (int k = 0; k < B; ++k)
    m[k] = xor_c4(make_char4(0, 0, 0, 0), (unsigned)gid * 0x01000193u + k);
  const signed char e = (signed char)((gid & 7) - 4);
  s = make_char4(e, e, e, e);
}

// One thread's chain: the quad at offset `off` of chunk c through every
// rank, then the owner's writes.  With CHK, each hop's frame checksum is
// summed over the warp (one tile row of one chunk: the same slice, sender
// and receiver) and added to the block's per-rank partials `spair`.
template <int B, bool CHK, int ST = ST_ALL>
__device__ __forceinline__ void rs_chain(const RsArgs& a, long long gid,
                                         unsigned* spair) {
  constexpr bool LD = ST & ST_LD, ENC = ST & ST_ENC, STLD = ST & ST_STLD;
  constexpr bool DEC = ST & ST_DEC, WB = ST & ST_WB, UPD = ST & ST_UPD;
  constexpr bool ABL = ST != ST_ALL;        // an ablate= variant
  static_assert(!ABL || !CHK, "ablated variants carry no checksum pair");
  static_assert(!ABL || !(ENC && DEC), "encode with decode is ST_ALL");
  const long long per_chunk = a.C / (4LL * B);
  const int c = (int)(gid / per_chunk);                      // the chunk
  const long long rem = gid % per_chunk;
  const long long tile = rem / QUADS;                        // in the chunk
  const long long off = tile * (long long)(B * LANES) +
                        4 * (rem % QUADS);                   // in the chunk
  const long long row = (long long)a.n * a.C;                // one rank's x
  const float* xc = a.x + (long long)c * a.C + off;
  // the checksum pair: slice ks of the chunk, tile tl of that slice
  unsigned ks = 0u, tl = 0u, slice_elems = 0u, n_slices = 0u;
  if constexpr (CHK) {
    ks = (unsigned)(tile / a.tiles_per_slice);
    tl = (unsigned)(tile % a.tiles_per_slice);
    slice_elems = (unsigned)(a.tiles_per_slice * B * LANES);
    n_slices = (unsigned)(a.C / slice_elems);
  }

  float4 v[B];
  int r = (c + 1) % a.n;                  // hop 0: rank c+1 sends x as is
  [[maybe_unused]] unsigned sink = 0u;    // an ablated variant's result
  if constexpr (LD) {
    const float* xs = xc + r * row;
#pragma unroll
    for (int k = 0; k < B; ++k)
      v[k] = *reinterpret_cast<const float4*>(xs + k * LANES);
    if constexpr (ABL) {                  // a decode may overwrite it
#pragma unroll
      for (int k = 0; k < B; ++k) sink ^= fold4(v[k]);
    }
  } else {
    seed_quad<B>(gid, v);
  }
  [[maybe_unused]] char4 stale[B];        // the frame without an encode
  [[maybe_unused]] char4 stale_s;
  if constexpr (!ENC) seed_frame<B>(gid, stale, stale_s);
  for (int j = 1; j < a.n; ++j) {         // rank r+1 receives r's frame
    const int sender = r;
    r = (r + 1 == a.n) ? 0 : r + 1;
    const float* xs = xc + r * row;
    char4 m[B];
    char4 s;
    if constexpr (ENC) {
      encode_quad<B>(v, a.mant_bits, a.rtz, m, s);
    } else {
      // a decode's stale frame takes the running sum's bits, so each hop
      // depends on the one before, as through the encode
#pragma unroll
      for (int k = 0; k < B; ++k)
        m[k] = DEC ? xor_c4(stale[k], __float_as_uint(v[k].x)) : stale[k];
      s = DEC ? xor_c4(stale_s, __float_as_uint(v[0].y) & 0x01010101u)
              : stale_s;
    }
    if constexpr (ABL) {
      sink ^= (unsigned)sender;
      if constexpr (ENC) sink ^= fold_frame<B>(m, s);
    }
    if constexpr (CHK) {
      // the emission checksum of the bytes encode_quad made; the bytes
      // decode4 reads below are these registers, so the arrival checksum
      // is the same sum: in loopback the wire is the thread's registers
      const unsigned part =
          warp_sum(frame_part<B>(m, s, tl, (unsigned)(rem % QUADS),
                                 slice_elems));
      if ((threadIdx.x & 31) == 0) {
        const unsigned q = (unsigned)(j - 1) * n_slices + ks;  // emission
        const unsigned hw = 2u * q + 1u;                        // hop_weight
        atomicAdd(spair + 2 * sender, hw * part);
        atomicAdd(spair + 2 * r + 1, hw * part);
      }
    }
    if constexpr (DEC) {
#pragma unroll
      for (int k = 0; k < B; ++k) {
        float4 xk;
        if constexpr (STLD)
          xk = *reinterpret_cast<const float4*>(xs + k * LANES);
        else
          xk = v[k];
        v[k] = add4(xk, decode4(m[k], s));
      }
    } else if constexpr (LD || STLD) {
      // no sum: the load is the next encode's input (ld), or kept alive
      // in the running registers (stld, the hbm and resident variants)
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const float4 xk = *reinterpret_cast<const float4*>(xs + k * LANES);
        v[k] = (ENC || !STLD) ? xk : xor4(v[k], xk);
      }
    }
    if constexpr (ABL && !ENC && !DEC) sink ^= fold_frame<B>(m, s);
  }

  // r == c: the owner of the chunk
  const long long own = (long long)c * a.C + off;
  if constexpr (WB) {
    if constexpr (ABL)                    // the variant's other results
      v[0].x = __uint_as_float(__float_as_uint(v[0].x) ^ sink);
#pragma unroll
    for (int k = 0; k < B; ++k)
      *reinterpret_cast<float4*>(a.g_out + own + k * LANES) = v[k];
  } else {
    // one word a thread: the variant's registers folded together
#pragma unroll
    for (int k = 0; k < B; ++k) sink ^= fold4(v[k]);
    a.g_out[own] = __uint_as_float(sink);
  }
  if constexpr (!UPD) return;
  if (a.opt_kind == OPT_NONE) return;
  update_quad<B>(a.opt_kind, a.hyper, a.n, v, a.w, a.w_out, a.m_in, a.m_out,
                 a.v_in, a.v_out, own);
}

// CHK = false is the kernel as it was before the checksum pair existed.
// CHK = true adds each hop's frame checksums: warp sums into a per-block
// [n, 2] table in shared memory, then one atomicAdd a nonzero entry into
// a.pair.  Whole warps are live or dead together (a chunk is whole tiles,
// 32 quads each), so the shuffles see all 32 lanes.  Two blocks an SM (at
// most 128 registers a thread) for B <= 16: left free, the compiler gave
// the B = 16 kernel 164 registers once rs_chain became a function, one
// block an SM, and 0.80 ms in place of 0.67 at the MLP shape.
template <int B, bool CHK, int ST = ST_ALL>
__global__ void __launch_bounds__(THREADS, B <= 16 ? 2 : 1)
    ring_rs_kernel(RsArgs a) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long live = a.C / (4LL * B) * a.n;
  if constexpr (!CHK) {
    if (gid >= live) return;
    rs_chain<B, false, ST>(a, gid, nullptr);
  } else {
    extern __shared__ unsigned spair[];                  // [n, 2]
    for (int i = threadIdx.x; i < 2 * a.n; i += blockDim.x) spair[i] = 0u;
    __syncthreads();
    if (gid < live) rs_chain<B, true>(a, gid, spair);
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * a.n; i += blockDim.x)
      if (spair[i] != 0u) atomicAdd(a.pair + i, spair[i]);
  }
}

// One launch = the whole reduce-scatter (and update) of every rank.
// opt_kind == OPT_NONE leaves w .. v_out unread (they may be null).  With
// `pair` (zeroed [n, 2] uint32) the launch also accumulates the checksum
// pair of every frame, sliced tiles_per_slice tiles to a frame.
extern "C" int ring_rs_launch(const float* x, float* g_out, const float* w,
                              float* w_out, const float* m_in, float* m_out,
                              const float* v_in, float* v_out,
                              const float* hyper, int n, long long C,
                              int block_size, int mant_bits, int rtz,
                              int opt_kind, unsigned* pair,
                              long long tiles_per_slice, cudaStream_t stream) {
  const RsArgs a{x, g_out, w, w_out, m_in, m_out, v_in, v_out, hyper, pair,
                 n, C, tiles_per_slice, mant_bits, rtz, opt_kind};
  const long long n_threads = (long long)n * (C / (4LL * block_size));
  if (pair != nullptr &&
      (tiles_per_slice < 1 || C % (tiles_per_slice * block_size * LANES)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = pair != nullptr ? 2 * n * sizeof(unsigned) : 0;
#define RS(BS)                                                              \
  if (pair != nullptr)                                                      \
    ring_rs_kernel<BS, true><<<grid_for(n_threads), THREADS, smem, stream>>>( \
        a);                                                                 \
  else                                                                      \
    ring_rs_kernel<BS, false><<<grid_for(n_threads), THREADS, 0, stream>>>(a)
  BFP_DISPATCH_BLOCK(block_size, RS)
#undef RS
  return (int)cudaGetLastError();
}

// One launch of an ablate= variant (the Stage mask `stage`): no checksum
// pair; the masks ops/ring_cuda.py ABLATE_MASKS names, anything else
// refused with cudaErrorInvalidValue.
extern "C" int ring_rs_ablate_launch(const float* x, float* g_out,
                                     const float* w, float* w_out,
                                     const float* m_in, float* m_out,
                                     const float* v_in, float* v_out,
                                     const float* hyper, int n, long long C,
                                     int block_size, int mant_bits, int rtz,
                                     int opt_kind, int stage,
                                     cudaStream_t stream) {
  const RsArgs a{x, g_out, w, w_out, m_in, m_out, v_in, v_out, hyper,
                 nullptr, n, C, 0, mant_bits, rtz, opt_kind};
  const long long n_threads = (long long)n * (C / (4LL * block_size));
  constexpr int IO = ST_LD | ST_STLD | ST_WB;   // the resident form's DMAs
#define RS_ST(BS, MASK)                                                     \
  case MASK:                                                                \
    ring_rs_kernel<BS, false, MASK><<<grid_for(n_threads), THREADS, 0,     \
                                      stream>>>(a);                         \
    break
#define RS_ABL(BS)                                                          \
  switch (stage) {                                                          \
    RS_ST(BS, 0);                                                           \
    RS_ST(BS, ST_LD | ST_ENC);                                              \
    RS_ST(BS, ST_RDMA);                                                     \
    RS_ST(BS, ST_STLD | ST_DEC | ST_WB);                                    \
    RS_ST(BS, IO);                                                          \
    RS_ST(BS, ST_UPD);                                                      \
    RS_ST(BS, IO | ST_ENC);                                                 \
    RS_ST(BS, IO | ST_RDMA);                                                \
    RS_ST(BS, IO | ST_DEC);                                                 \
    RS_ST(BS, IO | ST_UPD);                                                 \
    default:                                                                \
      return (int)cudaErrorInvalidValue;                                    \
  }
  BFP_DISPATCH_BLOCK(block_size, RS_ABL)
#undef RS_ABL
#undef RS_ST
  return (int)cudaGetLastError();
}
