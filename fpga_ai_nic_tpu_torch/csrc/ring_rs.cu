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
#include "bfp.cuh"

using namespace bfp;

enum OptKind { OPT_NONE = 0, OPT_SGD = 1, OPT_MOMENTUM = 2, OPT_ADAMW = 3 };
// optim.py hyper layout: H_LR, H_WD, H_MOM, H_B2, H_EPS, H_RC1, H_RC2
enum Hyper { H_LR = 0, H_WD, H_MOM, H_B2, H_EPS, H_RC1, H_RC2 };

__device__ __forceinline__ void fused_update(int kind, const float* h, float g,
                                             float w, float m, float v,
                                             float& w2, float& m2, float& v2) {
  const float lr = h[H_LR], wd = h[H_WD];
  if (kind == OPT_SGD) {
    w2 = __fmaf_rn(-lr, __fmaf_rn(wd, w, g), w);
  } else if (kind == OPT_MOMENTUM) {
    m2 = __fmaf_rn(h[H_MOM], m, g);
    const float t1 = __fmaf_rn(-lr, m2, w);
    w2 = __fmaf_rn(-(lr * wd), w, t1);
  } else {  // OPT_ADAMW
    m2 = __fmaf_rn(1.0f - h[H_MOM], g - m, m);
    v2 = __fmaf_rn(1.0f - h[H_B2], __fmaf_rn(g, g, -v), v);
    const float num = h[H_RC1] * m2;
    const float den = __fsqrt_rn(h[H_RC2] * v2) + h[H_EPS];
    const float upd = __fmaf_rn(wd, w, __fdiv_rn(num, den));
    w2 = __fmaf_rn(-lr, upd, w);
  }
}

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
  int n;
  long long C;
  int mant_bits;
  int rtz;
  int opt_kind;
};

template <int B>
__global__ void __launch_bounds__(THREADS) ring_rs_kernel(RsArgs a) {
  const long long per_chunk = a.C / (4LL * B);
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= per_chunk * a.n) return;
  const int c = (int)(gid / per_chunk);                      // the chunk
  const long long rem = gid % per_chunk;
  const long long off = (rem / QUADS) * (long long)(B * LANES) +
                        4 * (rem % QUADS);                   // in the chunk
  const long long row = (long long)a.n * a.C;                // one rank's x
  const float* xc = a.x + (long long)c * a.C + off;

  float4 v[B];
  int r = (c + 1) % a.n;                  // hop 0: rank c+1 sends x as is
  {
    const float* xs = xc + r * row;
#pragma unroll
    for (int k = 0; k < B; ++k)
      v[k] = *reinterpret_cast<const float4*>(xs + k * LANES);
  }
  for (int j = 1; j < a.n; ++j) {         // rank r+1 receives r's frame
    r = (r + 1 == a.n) ? 0 : r + 1;
    const float* xs = xc + r * row;
    char4 m[B];
    char4 s;
    encode_quad<B>(v, a.mant_bits, a.rtz, m, s);
#pragma unroll
    for (int k = 0; k < B; ++k)
      v[k] = add4(*reinterpret_cast<const float4*>(xs + k * LANES),
                  decode4(m[k], s));
  }

  // r == c: the owner of the chunk
  const long long own = (long long)c * a.C + off;
#pragma unroll
  for (int k = 0; k < B; ++k)
    *reinterpret_cast<float4*>(a.g_out + own + k * LANES) = v[k];
  if (a.opt_kind == OPT_NONE) return;
  const float nf = (float)a.n;
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const long long e = own + k * LANES;
    const float g[4] = {v[k].x / nf, v[k].y / nf,
                        v[k].z / nf, v[k].w / nf};
    const float4 w4 = *reinterpret_cast<const float4*>(a.w + e);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
    float m[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
    if (a.m_in != nullptr) {
      const float4 m4 = *reinterpret_cast<const float4*>(a.m_in + e);
      m[0] = m4.x; m[1] = m4.y; m[2] = m4.z; m[3] = m4.w;
    }
    if (a.v_in != nullptr) {
      const float4 v4 = *reinterpret_cast<const float4*>(a.v_in + e);
      vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
    }
    float w2[4], m2[4], v2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      fused_update(a.opt_kind, a.hyper, g[q], w[q], m[q], vv[q], w2[q],
                   m2[q], v2[q]);
    *reinterpret_cast<float4*>(a.w_out + e) =
        make_float4(w2[0], w2[1], w2[2], w2[3]);
    if (a.m_out != nullptr)
      *reinterpret_cast<float4*>(a.m_out + e) =
          make_float4(m2[0], m2[1], m2[2], m2[3]);
    if (a.v_out != nullptr)
      *reinterpret_cast<float4*>(a.v_out + e) =
          make_float4(v2[0], v2[1], v2[2], v2[3]);
  }
}

// One launch = the whole reduce-scatter (and update) of every rank.
// opt_kind == OPT_NONE leaves w .. v_out unread (they may be null).
extern "C" int ring_rs_launch(const float* x, float* g_out, const float* w,
                              float* w_out, const float* m_in, float* m_out,
                              const float* v_in, float* v_out,
                              const float* hyper, int n, long long C,
                              int block_size, int mant_bits, int rtz,
                              int opt_kind, cudaStream_t stream) {
  const RsArgs a{x, g_out, w, w_out, m_in, m_out, v_in, v_out, hyper,
                 n, C, mant_bits, rtz, opt_kind};
  const long long n_threads = (long long)n * (C / (4LL * block_size));
#define RS(BS) \
  ring_rs_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(a)
  BFP_DISPATCH_BLOCK(block_size, RS)
#undef RS
  return (int)cudaGetLastError();
}
